"""Where the time of the distributed picparts step goes, on one card.

    python3 scripts/profile_picparts.py [num_ptcls] [steps] [arm ...]
        [--buffer LAYERS] [--save-x2 [PATH]]

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
each kernel, host ms of each range, and the glue ranges' kernels split
by the function they lie in (``glue_by_site``: ``repartition``,
``migrate``, ``migrate_structure``, ``reduce_comm_array`` or the step's
own ``step``) and by the
outermost aten op that launched them (``glue_by_op``; a kernel launched
outside an aten op, as the port's own through ctypes, under its own
name), each as [device ms, launches] a step; writes rank 0's Chrome
trace of the profiled steps to ``chiprun_out/picparts_trace_<arm>.json.gz``.
``--buffer`` sets the picparts' BFS buffer layers (default ``bench_torch``'s).

``--save-x2`` (the 120k arm) saves rank 0's kernel X2 inputs of step
``--x2-step`` (default 1, the warm-up's: the layout right after seeding)
to PATH (default
``chip_tree/x2_step_inputs.pt``, git-ignored; ``scripts/ab_sort_place.py
--x2-saved PATH`` times them), prints how each step's admitted leavers lie
in the slots (their count, the share of warps holding one, the mean run:
``chip_smoke.leaver_layout``) and the same for phase c's synthetic case
(``chip_smoke.x2_step_case``, which takes the 12-layer buffer: give
``--buffer 12`` to compare like with like), and whether they agree within
25%.  Its step times include those reads: time with a run without it.
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


def watch_x2(path: str, layouts: list, save_call: int = 1) -> None:
    """Wrap kernel X2's wrapper: save the inputs of its ``save_call``-th
    call to ``path`` (host tensors) and append each call's leaver layout
    to ``layouts``."""
    import chip_smoke as cs
    from pumipic_torch.ops import exchange as ex

    wrapped = ex.pack_send

    def pack_send(state, key, rank, counts, quota, rows, cap, new_elem, elem_gid):
        out = wrapped(state, key, rank, counts, quota, rows, cap, new_elem, elem_gid)
        if len(layouts) + 1 == save_call:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            torch.save({"state": {k: v.cpu() for k, v in state.items()}, "key": key.cpu(),
                        "rank": rank.cpu(), "counts": counts.cpu(), "quota": quota.cpu(),
                        "rows": list(rows), "cap": cap, "new_elem": new_elem.cpu(),
                        "elem_gid": elem_gid.cpu()}, path)
        layouts.append(cs.leaver_layout(out[2]))
        return out
    ex.pack_send = pack_send


# functions the steps call through their modules, each profiled as a
# ``site:<name>`` range: a glue range inside none of them is the step's own
SITES = (("pumipic_torch.parallel.balancer", "repartition"),
         ("pumipic_torch.parallel.migrate", "migrate"),
         ("pumipic_torch.parallel.migrate", "migrate_structure"),
         ("pumipic_torch.parallel.reduce", "reduce_comm_array"))


def mark_sites() -> None:
    """Wrap each of :data:`SITES` in its ``site:`` range."""
    import importlib

    for mod, name in SITES:
        m = importlib.import_module(mod)

        def wrapped(*args, _fn=getattr(m, name), _label="site:" + name, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)
        setattr(m, name, wrapped)


def glue_site(ev) -> str:
    """The site of a ``pp:glue`` range: the innermost ``site:`` range
    around it, else the step's own code."""
    p = ev.cpu_parent
    while p is not None:
        if p.name.startswith("site:"):
            return p.name[5:]
        p = p.cpu_parent
    return "step"


def glue_split(prof, steps: int):
    """({site: [ms, launches]}, {op: [ms, launches]}) a step of the kernels
    launched inside the ``pp:glue`` ranges."""
    sites, ops = {}, {}

    def add(table, key, us):
        row = table.setdefault(key, [0.0, 0])
        row[0] += us / 1e3 / steps
        row[1] += 1 / steps

    def walk(ev, site, op):
        for c in ev.cpu_children:
            name = op or (c.name if c.name.startswith("aten::") else None)
            for k in c.kernels:
                add(ops, name or k.name.split("(")[0], k.duration)
                add(sites, site, k.duration)
            walk(c, site, name)

    for ev in prof.events():
        if ev.name == "pp:glue" and (ev.cpu_parent is None
                                     or ev.cpu_parent.name != "pp:glue"):
            walk(ev, glue_site(ev), None)
    order = lambda t: dict(sorted(t.items(), key=lambda kv: -kv[1][0]))  # noqa: E731
    return order(sites), order(ops)


def rank(arm: str, n: int, steps: int, trace_dir: str, buffer: int = 0,
         save_x2: str = "", x2_step: int = 1) -> dict:
    import bench_torch
    from pumipic_torch.parallel import group

    dev = group.device()
    layouts = []
    mark_sites()
    if save_x2 and group.rank() == 0:
        watch_x2(save_x2, layouts, x2_step)
    _, state, step, info = bench_torch.setup_picparts(
        dev, n, cap_factor=1.5, buffer_layers=buffer or None, **ARMS[arm][2])
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
        if ev.key.startswith(("pp:", "site:")):
            ranges[ev.key] = ev.device_time_total / 1e3 / steps
            host[ev.key] = ev.cpu_time_total / 1e3 / steps
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + ev.self_device_time_total / 1e3 / steps
    glue_sites, glue_ops = glue_split(prof, steps)
    if group.rank() == 0:
        path = os.path.join(trace_dir, f"picparts_trace_{arm}.json")
        prof.export_chrome_trace(path)
    return {"arm": arm, "tag": info["tag"], "ranks": group.num_ranks(),
            "backend": torch.distributed.get_backend(), "num_ptcls": n, "steps": steps,
            "wall_ms_per_step": wall * 1e3, "stream_split_ms_per_step": split,
            "device_busy_ms_per_step": sum(kernels.values()),
            "range_device_ms_per_step": ranges, "range_host_ms_per_step": host,
            "kernel_device_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:40]),
            "glue_by_site": glue_sites, "glue_by_op": glue_ops,
            "alive": int(f["stats"]["alive"]), "x2_layouts": layouts}


def synthetic_layout(dev, buffer: int) -> dict:
    """Phase c's X2 case at the step's layout (``chip_smoke.x2_step_case``),
    its admitted leavers' layout."""
    import chip_smoke as cs
    from pumipic_torch.ops import exchange as ex

    lpp = cs.exchange_picpart(dev)
    state, key, new_elem = cs.x2_step_case(dev, lpp)
    D = cs.X_RANKS - 1
    rank, counts = ex.rank_in_key(key, D)
    quota = torch.clamp(counts[:D], max=cs.X_SLOTS // 8)
    out = ex.pack_send(state, key, rank, counts, quota, quota.tolist(), cs.X_SLOTS // 8,
                       new_elem, lpp.elem_gid)
    return dict(cs.leaver_layout(out[2]), buffer_layers=cs.E_BUFFER, asked_buffer=buffer)


def main() -> None:
    import argparse

    from pumipic_torch.kernels import _build
    from pumipic_torch.parallel import group

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num_ptcls", nargs="?", type=int, default=10_000_000)
    ap.add_argument("steps", nargs="?", type=int, default=5)
    ap.add_argument("arms", nargs="*")
    ap.add_argument("--buffer", type=int, default=0, help="BFS buffer layers")
    ap.add_argument("--save-x2", nargs="?", const=os.path.join(ROOT, "chip_tree",
                                                                "x2_step_inputs.pt"),
                    default="", help="save rank 0's X2 inputs of a step")
    ap.add_argument("--x2-step", type=int, default=1,
                    help="the step whose X2 inputs --save-x2 saves (1: the warm-up)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n, steps = args.num_ptcls, args.steps
    arms = args.arms or list(ARMS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    _build.build()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for arm in arms:
        ranks, backend, _ = ARMS[arm]
        tmp = tempfile.mkdtemp()
        save = args.save_x2 if arm == "120k" else ""
        res = group.launch("profile_picparts:rank", ranks,
                           {"arm": arm, "n": n, "steps": steps, "trace_dir": tmp,
                            "buffer": args.buffer, "save_x2": save,
                            "x2_step": args.x2_step},
                           backend=backend, device="cuda", timeout=900,
                           extra_paths=[HERE])
        src = os.path.join(tmp, f"picparts_trace_{arm}.json")
        with open(src, "rb") as fi, gzip.open(os.path.join(
                out_dir, f"picparts_trace_{arm}.json.gz"), "wb") as fo:
            shutil.copyfileobj(fi, fo)
        shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(dict(res[0], card=smi)), flush=True)
        if save:
            step = res[0]["x2_layouts"][args.x2_step - 1]
            synth = synthetic_layout(torch.device("cuda"), args.buffer)
            agree = all(abs(synth[k] - step[k]) <= 0.25 * step[k]
                        for k in ("leavers", "warp_share", "mean_run"))
            print(json.dumps({"x2_step": args.x2_step, "x2_layout_step": step,
                              "x2_layout_steps": res[0]["x2_layouts"],
                              "x2_layout_synthetic": synth, "within_25_percent": agree,
                              "saved": save, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
