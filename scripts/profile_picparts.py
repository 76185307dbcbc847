"""Where the time of the distributed picparts step goes, on one card.

    python3 scripts/profile_picparts.py [num_ptcls] [steps] [arm ...]

Each arm runs ``bench_torch``'s picparts mode (the balancer, the
neighbour exchange, cap factor 1.5) as rank processes on this card:
``120k`` (the gmsh mesh, RCB, the walk; 4 gloo ranks), ``120k-1`` (the
same on 1 NCCL rank), ``annulus`` (the 23,976-triangle annulus, the
analytic locate and the banded route; 4 gloo ranks).  Every rank runs one
warm-up step, ``steps`` steps (default 5) for the wall time and rank
0's stream split (``group.SplitTimer``: compute, collective, glue), then
``steps`` more under torch.profiler with each part a ``pp:<label>``
range.  Prints one JSON line per arm from rank 0: wall ms/step, device
busy ms/step (kernels and copies), the device ms of each range and of
each kernel, and host ms of each range; writes rank 0's Chrome trace of
the profiled steps to ``chiprun_out/picparts_trace_<arm>.json.gz``.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

MESH = os.path.join(ROOT, "data", "xgc_like_120k.msh.gz")
ARMS = {  # arm -> (ranks, backend, bench_torch.setup_picparts keywords)
    "120k": (4, "gloo", {"mesh_path": MESH}),
    "120k-1": (1, "nccl", {"mesh_path": MESH}),
    "annulus": (4, "gloo", {"mesh_path": "annulus", "mesh_elems": 24_000}),
}


def rank(arm: str, n: int, steps: int, trace_dir: str) -> dict:
    import bench_torch
    from pumipic_torch.parallel import group

    dev = group.device()
    _, state, step, info = bench_torch.setup_picparts(
        dev, n, cap_factor=1.5, **ARMS[arm][2])
    state, _ = step(state)
    torch.cuda.synchronize()
    timer = group.SplitTimer()
    group.set_split_timer(timer)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, f = step(state)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    split = {k: v / steps for k, v in timer.totals().items()}
    group.set_split_timer(None, record=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, f = step(state)
        torch.cuda.synchronize()
    group.set_split_timer(None)
    kernels, ranges, host = {}, {}, {}
    for ev in prof.key_averages():
        if ev.key.startswith("pp:"):
            ranges[ev.key] = ev.device_time_total / 1e3 / steps
            host[ev.key] = ev.cpu_time_total / 1e3 / steps
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + ev.self_device_time_total / 1e3 / steps
    if group.rank() == 0:
        path = os.path.join(trace_dir, f"picparts_trace_{arm}.json")
        prof.export_chrome_trace(path)
    return {"arm": arm, "tag": info["tag"], "ranks": group.num_ranks(),
            "backend": torch.distributed.get_backend(), "num_ptcls": n, "steps": steps,
            "wall_ms_per_step": wall * 1e3, "stream_split_ms_per_step": split,
            "device_busy_ms_per_step": sum(kernels.values()),
            "range_device_ms_per_step": ranges, "range_host_ms_per_step": host,
            "kernel_device_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:40]),
            "alive": int(f["stats"]["alive"])}


def main() -> None:
    from pumipic_torch.kernels import _build
    from pumipic_torch.parallel import group

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    arms = sys.argv[3:] or list(ARMS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    _build.build()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for arm in arms:
        ranks, backend, _ = ARMS[arm]
        tmp = tempfile.mkdtemp()
        res = group.launch("profile_picparts:rank", ranks,
                           {"arm": arm, "n": n, "steps": steps, "trace_dir": tmp},
                           backend=backend, device="cuda", timeout=900,
                           extra_paths=[HERE])
        src = os.path.join(tmp, f"picparts_trace_{arm}.json")
        with open(src, "rb") as fi, gzip.open(os.path.join(
                out_dir, f"picparts_trace_{arm}.json.gz"), "wb") as fo:
            shutil.copyfileobj(fi, fo)
        shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(dict(res[0], card=smi)), flush=True)


if __name__ == "__main__":
    main()
