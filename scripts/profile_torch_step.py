"""Where the time of the port's FULL-mode step goes, on one CUDA GPU.

    python3 scripts/profile_torch_step.py [num_ptcls] [steps]

Sets up bench_torch's configuration (120k gmsh mesh, default 10M
particles), runs one warm-up step, then ``steps`` steps (default 10)
untraced for the host wall and enqueue time per step, then ``steps`` more under
torch.profiler for the device time per step by kernel name.  Prints one
JSON line with both, the device idle share (1 - device busy time / wall
time), and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from pumipic_torch.mesh.core import Mesh2D  # noqa: E402
from pumipic_torch.mesh.gmsh import read_msh  # noqa: E402
from pumipic_torch.models.pseudo_xgcm import XGCmConfig, make_dp_setup  # noqa: E402

MESH = os.path.join(os.path.dirname(HERE), "data", "xgc_like_120k.msh.gz")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    dev = torch.device("cuda")
    coords, tris, cls = read_msh(MESH)
    mesh = Mesh2D.from_arrays(coords, tris, cls, device=dev)
    cfg = XGCmConfig(num_ptcls=n, mdl_face=max(int(cls.max()) // 2, 2),
                     deg_per_push=15.0, max_search_iters=64)
    state, step = make_dp_setup(mesh, cfg, dev)
    state, _ = step(state)
    torch.cuda.synchronize()

    # wall time without the profiler (and the host's enqueue time: the
    # launches return before the device is done), then device time with it
    t0 = time.perf_counter()
    for _ in range(steps):
        state, fields = step(state)
    enqueue = (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, fields = step(state)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops; their kernels are listed
        by_kernel[ev.key.split("(")[0]] = ev.self_device_time_total / 1e3 / steps
    busy = sum(by_kernel.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "num_ptcls": n, "steps": steps,
        "wall_ms_per_step": wall * 1e3,
        "host_enqueue_ms_per_step": enqueue * 1e3,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_per_step_by_kernel": dict(
            sorted(by_kernel.items(), key=lambda kv: -kv[1])),
        "alive": int(state["active"].sum()),
    }))


if __name__ == "__main__":
    main()
