"""A/B of kernel L's dense plain walk (every slot written: the setup's gyro
ring points, ``search_mesh_2d``, the locator-less step) against a parent's,
on one CUDA GPU.

    python3 scripts/ab_dense_walk.py PARENT_SRC_DIR [num_ptcls] [OUT_JSON]
        [--variants NAME=DEFINE:VALUE[,DEFINE:VALUE...][;NAME=...]]
        [--steps 1,5] [--timed-only NAME[,NAME]]

PARENT_SRC_DIR holds the parent's ``locate.cu`` (``git show
HEAD:pumipic_torch/kernels/csrc/locate.cu > chip_tree/parent_csrc/locate.cu``);
a ``locate.cu`` with ``pp_walk_dense`` is launched through it, an earlier
one through ``pp_walk_locate`` with no cell rows (the first version's
walk).  This
checkout's ``locate.cu`` is ``new``; ``--variants`` adds builds of it with
``#define`` constants changed in the text written to the variant's build
directory (e.g. ``t256=WD_THREADS:256``).  Each version is
its own library (``locate.cu`` and the headers beside it, the package's
flags).  The cases:

- ``(c)``: the 120k mesh's gyro ring points (``px.gyro_ring_points``,
  1,481,280), budget 100, as ``build_gyro_mapping`` walks them;
- ``(d) step k``: the locator-less dp step's walk at ``num_ptcls``
  (``bench_torch.setup(use_locator=False)``, default 10M): the particles
  after k - 1 steps, pushed once by kernel P, each walked from its
  element, budget 64 (``--steps``, default 1 and 5).

Every version must equal ``walk_locate_plain`` bit for bit (a
``--timed-only`` one is timed, not compared).  Times are device-only
(``chip_smoke.device_ms``, warm), in turns: the versions in order, then
reversed.  Each case prints one JSON line: the times, the walkers, the
rows they read (48 bytes a step), the distinct rows, the warp steps of
one thread a slot (a warp waiting for its longest walk) and of two
walkers a lane on tiles of 64 (a design that was tried), the bound (each
slot's destination, start, mask and
outputs once, and the distinct rows, over 3.35 TB/s) and the rows' bytes
at ``L2_ESTIMATE_BYTES_PER_S`` (an estimate, not a bound); then each
version's ptxas report and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20
# an L2 read rate the card has reached: kernel M's far-target walk, its
# rows' bytes over its time (PERF.md, "L2-row")
L2_ESTIMATE_BYTES_PER_S = 4.8e12
CSRC = os.path.join(ROOT, "pumipic_torch", "kernels", "csrc")


class Version:
    def __init__(self, name: str, text: str, headers: dict):
        self.name, self.text, self.headers = name, text, headers
        self.lib, self.report = None, ""

    @property
    def dense(self) -> bool:
        return "pp_walk_dense" in self.text


def read_headers(d: str) -> dict:
    return {f: open(os.path.join(d, f)).read() for f in os.listdir(d) if f.endswith(".cuh")}


def make_versions(parent: str, variants: str) -> list:
    pv = Version("parent", open(os.path.join(parent, "locate.cu")).read(),
                 read_headers(CSRC) | read_headers(parent))
    text = open(os.path.join(CSRC, "locate.cu")).read()
    versions = [pv, Version("new", text, read_headers(CSRC))]
    for spec in filter(None, variants.split(";")):
        name, _, defines = spec.partition("=")
        t = text
        for item in defines.split(","):
            macro, _, value = item.partition(":")
            pattern = re.compile(rf"^#define {re.escape(macro)} .*$", re.M)
            if len(pattern.findall(t)) != 1:
                raise ValueError(f"variant {name}: #define {macro} not found once")
            t = pattern.sub(f"#define {macro} {value}", t)
        versions.append(Version(f"new {name}", t, read_headers(CSRC)))
    return versions


def build_all(versions) -> None:
    """Each version's locate.cu, one nvcc each, all at once, into a library
    of its own."""
    from pumipic_torch.kernels import _build

    nvcc = _build.nvcc_path()
    jobs = []
    for v in versions:
        out = _build.BUILD_DIR / f"abd_{re.sub(r'[^A-Za-z0-9_]+', '_', v.name)}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for f, t in v.headers.items():
            (out / f).write_text(t)
        src = out / "locate.cu"
        src.write_text(v.text)
        obj = out / "locate.o"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((v, out, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
    for v, out, obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {v.name}:\n{err}")
        v.report = err
        lib = out / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib), str(obj)], check=True)
        v.lib = ctypes.CDLL(str(lib))
        for fn in ("pp_walk_locate", "pp_walk_dense"):
            if hasattr(v.lib, fn):
                getattr(v.lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(v.lib, fn).restype = ctypes.c_int


def walk_fn(v: Version, geom, dx, dy, start, act, max_iters):
    """A call of version ``v``'s dense walk, returning (elem, active,
    iters, all_found) as ``walk_locate`` does."""
    from pumipic_torch.kernels import stream_handle

    P = ctypes.c_void_p
    n = dx.shape[0]
    elem = torch.empty(n, dtype=torch.int32, device=dx.device)
    out = torch.empty(n, dtype=torch.bool, device=dx.device)
    stats = torch.zeros(2, dtype=torch.int32, device=dx.device)

    def run():
        stats.zero_()
        if v.dense:
            err = v.lib.pp_walk_dense(P(dx.data_ptr()), P(dy.data_ptr()), P(start.data_ptr()),
                                      P(act.data_ptr()), P(geom.data_ptr()),
                                      geom.shape[0], max_iters,
                                      P(elem.data_ptr()), P(out.data_ptr()),
                                      P(stats.data_ptr()), n, P(stream_handle()))
        else:
            err = v.lib.pp_walk_locate(P(dx.data_ptr()), P(dy.data_ptr()), P(start.data_ptr()),
                                       P(act.data_ptr()), P(geom.data_ptr()), geom.shape[0],
                                       P(None), P(None), 0.0, 0.0, 0.0, 0.0, 1, 1, max_iters,
                                       0, P(elem.data_ptr()), P(out.data_ptr()),
                                       P(stats.data_ptr()), n, P(stream_handle()))
        if err:
            raise RuntimeError(f"{v.name}: cudaError {err}")
        return elem, out, stats[0], stats[1] == 0
    return run


def warp_steps(steps: np.ndarray, k: int) -> int:
    """Warp steps of k walkers a lane, tiles of 32·k slots (lane l: slots
    l, 32 + l, ...): each tile's longest walk."""
    t = np.pad(steps, (0, -steps.size % (32 * k))).reshape(-1, 32 * k)
    return int(t.max(1).sum())


def run_case(name, versions, timed_only, geom, dx, dy, start, act, max_iters,
             results) -> None:
    from pumipic_torch.ops import search as se

    want = se.walk_locate_plain(geom, dx, dy, start, act, max_iters)
    fns = {}
    for v in versions:
        fn = walk_fn(v, geom, dx, dy, start, act, max_iters)
        if v.name not in timed_only:
            got = fn()
            bad = cs.mismatches(got, want)
            if bad or cs.max_err(got, want) != 0.0:
                raise AssertionError(f"{name} {v.name}: {bad} mismatches against the plain "
                                     f"version")
        fns[v.name] = fn
    # yardstick: this checkout's sparse schedule (walk_plain.cuh) with every
    # active slot a walker, in place (no output for the other slots)
    base = torch.full_like(start, -1)
    st4 = torch.zeros(4, dtype=torch.int32, device=dx.device)
    fns["sparse schedule, in place (yardstick)"] = lambda: se.walk_locate_into(
        geom, dx, dy, start, act, max_iters, base, st4)
    names = list(fns)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(cs.device_ms(fns[k], REPS))
    steps, distinct = cs.plain_walk_rows(geom, dx, dy, start, act, max_iters)
    s = steps.cpu().numpy()
    n, w, rows = s.size, int(act.sum()), int(s.sum())
    moved = cs.nbytes(dx, dy, start, act, *want[:2]) + distinct * 48
    case = {"case": name, "slots": n, "walkers": w, "rows": rows,
            "rows_per_walker": rows / max(w, 1), "distinct_rows": distinct,
            "max_steps": int(s.max(initial=0)), "iters": int(want[2]),
            "all_found": bool(want[3]),
            "warp_steps": {f"{k} a lane": warp_steps(s, k) for k in (1, 2)},
            "ms": ms, "bound_ms": moved / cs.PEAK_BYTES_PER_S * 1e3,
            "l2_row_estimate_ms": rows * 48 / L2_ESTIMATE_BYTES_PER_S * 1e3}
    print(json.dumps(case), flush=True)
    results.append(case)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=cs.NUM_PTCLS)
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--variants", default="")
    ap.add_argument("--steps", default="1,5")
    ap.add_argument("--timed-only", default="")
    args = ap.parse_args()
    import bench_torch
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops

    dev = torch.device("cuda")
    versions = make_versions(args.parent, args.variants)
    timed_only = {f"new {t}" for t in args.timed_only.split(",") if t}
    build_all(versions)
    for v in versions:
        print(json.dumps({"version": v.name, "dense_launcher": v.dense,
                          "ptxas": cs.ptxas_functions(v.report)}), flush=True)
    results = []
    mesh = Mesh2D.from_arrays(*read_msh(cs.MESH), device=dev)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, px.GyroConfig()))
    gact = torch.ones(gpx.shape[0], dtype=torch.bool, device=dev)
    run_case("(c) ring points", versions, timed_only, mesh.walk_geom, gpx, gpy,
             gstart.to(torch.int32), gact, 100, results)
    del gpx, gpy, gstart, gact
    _, state, step, info = bench_torch.setup(dev, num_ptcls=args.num_ptcls, mesh_path=cs.MESH,
                                             use_locator=False)
    model = step.model
    done = 0
    for k in sorted(int(x) for x in args.steps.split(",") if x):
        while done < k - 1:
            state, _ = step(state)
            done += 1
        s = state
        tx, ty = push_ops.push_banded(s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"],
                                      s["elem"], s["active"], model.rot, 0.0, 0.0, 0.9)[:2]
        run_case(f"(d) step {k}", versions, timed_only, mesh.walk_geom, tx, ty,
                 s["elem"], s["active"], 64, results)
    card = cs.smi_query("name,power.limit")
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cases": results, "card": card,
                       "versions": {v.name: v.report for v in versions}}, f, indent=1)


if __name__ == "__main__":
    main()
