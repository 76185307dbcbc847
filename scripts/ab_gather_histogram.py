"""A/B of kernels G (row gather) and H (histogram) on one CUDA GPU: this
checkout's kernels against another version's sources, on the same inputs,
in turns.

    python3 scripts/ab_gather_histogram.py OTHER_CSRC [num_ptcls] [OUT_JSON]

``OTHER_CSRC`` holds the other version's ``gather.cu`` and
``histogram.cu`` (for example a parent commit's, written out with ``git
show`` into a git-ignored directory).  They are built with this checkout's
nvcc flags into a library of their own, whose ``pp_row_gather``,
``pp_histogram`` and ``pp_histogram_rings`` must take this checkout's
arguments (``pumipic_torch/kernels/_build.py``, ``SIGNATURES``).

Inputs, at ``num_ptcls`` (default 10M) on the 120k mesh with bench_torch's
settings:

- H: the FULL-mode cartesian arm's located particles after step 1 and after
  step 20, in their own order; the step-20 keys in a random permutation;
  key mode (per-particle gyro radius, E·R counters) at the step-20 order.
- G: the columns (fields and key lane) and the slot map ``src`` of a
  rebuild: ``chip_smoke.py`` phase c's (a Sell-C-σ structure of the
  initial particles in their step-1 elements, rebuilt after a push from
  the initial positions: most particles stay), and the Sell-C-σ app's at
  step 1 and at step 20; the step-20 columns at a random
  permutation of the slots; the rows form at the TPU probe T2's shape
  (24,576 x 14 f32 table, 10M indices).

Every variant's output must equal the plain version's.  Each variant is
timed twice (CUDA events, mean of ``REPS`` calls), in the order other,
new, new, other.  Each
case also gets its bound (bytes: each input read once, each output written
once, over 3.35 TB/s) and the time of one PyTorch call that computes it.
Prints the card, both builds' ptxas reports and one JSON line per case,
and writes them all to ``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (timing and byte-count helpers)

REPS = 50
P = ctypes.c_void_p


def build(csrc: str, tag: str):
    """Compile ``csrc``'s gather.cu and histogram.cu with the package's
    flags into one library; returns (loaded library, ptxas report)."""
    from pumipic_torch.kernels import _build

    out_dir = _build.BUILD_DIR / f"ab_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    objs, report = [], []
    for name in ("gather.cu", "histogram.cu"):
        obj = out_dir / (name + ".o")
        res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(obj), os.path.join(csrc, name)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {tag} {name}:\n{res.stderr}")
        objs.append(str(obj))
        report.append(f"{tag} {name}:\n{res.stderr}")
    lib_path = out_dir / "lib.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("pp_row_gather", "pp_histogram", "pp_histogram_rings"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, "\n".join(report)


def other_gather(lib, cols, idx, form_rows: bool):
    """The other version's row gather, launched as ``rows.row_gather`` does."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import rows

    n = idx.shape[0]
    outs = [torch.empty((n,) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
            for c in cols]
    for j0 in range(0, len(cols), rows.MAX_GATHER_ARRAYS):
        m = min(rows.MAX_GATHER_ARRAYS, len(cols) - j0)
        err = lib.pp_row_gather(
            P(idx.data_ptr()), n, m,
            (P * m)(*(c.data_ptr() for c in cols[j0:j0 + m])),
            (P * m)(*(o.data_ptr() for o in outs[j0:j0 + m])),
            (ctypes.c_int * m)(*(rows.lanes_of(c) for c in cols[j0:j0 + m])),
            P(stream_handle()))
        if err:
            raise RuntimeError(f"other pp_row_gather: cudaError {err}")
    return outs[0] if form_rows else outs


def other_histogram(lib, elem, active, E, rg=None, R=1, rmax=0.0):
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import scatter as sc

    if rg is None:
        counts = torch.zeros(E, dtype=torch.int32, device=elem.device)
        err = lib.pp_histogram(P(elem.data_ptr()), P(active.data_ptr()), E,
                               P(counts.data_ptr()), elem.shape[0], P(stream_handle()))
    else:
        counts = torch.zeros(E * R, dtype=torch.int32, device=elem.device)
        err = lib.pp_histogram_rings(P(elem.data_ptr()), P(active.data_ptr()),
                                     P(rg.data_ptr()), sc._ring_width(rmax, R), E, R,
                                     P(counts.data_ptr()), elem.shape[0],
                                     P(stream_handle()))
    if err:
        raise RuntimeError(f"other histogram: cudaError {err}")
    return counts


def bits(t):
    if isinstance(t, (list, tuple)):
        return [bits(x) for x in t]
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def ab_case(name: str, variants: dict, plain, bound_bytes: int, library, extra=None):
    """Check each variant against the plain output, then time them in
    turns (order, then reversed), with the host's share (``ms``) and on
    the device alone (``device_ms``, as the library call); returns the
    case's record."""
    want = bits(plain())
    for v, fn in variants.items():
        if cs.mismatches(bits(fn()), want):
            raise AssertionError(f"{name}: variant {v} differs from the plain version")
    order = list(variants)
    times = {v: [] for v in order}
    dev_times = {v: [] for v in order}
    for v in order + order[::-1]:
        times[v].append(cs.cuda_ms(variants[v], REPS))
        dev_times[v].append(cs.device_ms(variants[v], REPS))
    rec = {"case": name, "ms": {v: sum(t) / len(t) for v, t in times.items()},
           "device_ms": {v: sum(t) / len(t) for v, t in dev_times.items()},
           "ms_turns": times, "device_ms_turns": dev_times,
           "bound_ms": bound_bytes / cs.PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": cs.device_ms(library, REPS) if library else None,
           **(extra or {})}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    other_csrc = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000_000
    import bench_torch
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import rows
    from pumipic_torch.ops import scatter as sc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    other, other_report = build(other_csrc, "other")
    _, new_report = build(os.path.join(ROOT, "pumipic_torch", "kernels", "csrc"), "new")
    print(other_report + "\n" + new_report, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = []

    # FULL-mode cartesian arm: the located particles after steps 1 and 20
    mesh, state, step, _ = bench_torch.setup(dev, n, mesh_path=cs.MESH)
    E = mesh.nelems
    state0 = {k: v.clone() for k, v in state.items()}
    located = {}
    for i in range(1, 21):
        state, _ = step(state)
        if i in (1, 20):
            located[i] = (state["elem"].clone(), state["active"].clone())
    grid = step.model.locator
    del state

    # chip_smoke.py phase c's order: a Sell-C-σ structure of the initial
    # particles placed in their step-1 elements, rebuilt after a push from
    # the initial positions and a locate (so most particles stay: close to
    # an identity permutation)
    cfg = dataclasses.replace(cs._cfg(px, mesh, structure="scs"), num_ptcls=n)
    ps = cs.scs_of_located(dev, E, state0, *located[1])
    bands = push_ops.BandClasses.build(
        push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), dev)
    new_elem = cs.located_after_push(mesh, ps, cfg, grid, bands)
    with cs.gathers_at({1: "phase c"}) as captured:
        ps.rebuild(new_elem)
    del state0, ps, new_elem

    def h_case(name, elem, active, rg=None, R=1, rmax=0.0):
        if rg is None:
            key = torch.where(active, elem, E)
            lib_fn = lambda: torch.bincount(key, minlength=E + 1)  # noqa: E731
            nb = cs.nbytes(elem, active) + 4 * E
        else:
            keys = cs.ring_key_streams(elem, active, rg, E, R, rmax)
            lib_fn = lambda: torch.bincount(keys, minlength=E * R + 1)  # noqa: E731
            nb = cs.nbytes(elem, active, rg) + 4 * E * R
        cases.append(ab_case(
            name,
            {"other": lambda: other_histogram(other, elem, active, E, rg, R, rmax),
             "new": lambda: sc.histogram(elem, active, E, rg, R, rmax)},
            lambda: sc.histogram_plain(elem, active, E, rg, R, rmax), nb, lib_fn,
            {"kernel": "H", "particles": elem.shape[0], "counters": E * R}))

    h_case("H, FULL cartesian, step-1 order", *located[1])
    h_case("H, FULL cartesian, step-20 order", *located[20])
    perm = torch.randperm(n, device=dev, generator=gen)
    h_case("H, step-20 keys, random permutation", located[20][0][perm].contiguous(),
           located[20][1][perm].contiguous())
    del perm
    gyro = px.GyroConfig(per_particle_radius=True)
    rg = px.initial_state(mesh, dataclasses.replace(cfg, gyro=gyro), device=dev)["rg"]
    h_case("H key mode, step-20 order", *located[20], rg, gyro.num_rings, gyro.rmax)
    del located, rg
    torch.cuda.empty_cache()

    # the Sell-C-σ app: the rebuild gathers of steps 1 and 20
    app = px.PseudoXGCm(mesh, cfg, device=dev, locator=grid)
    with cs.gathers_at({1: "app step 1", 20: "app step 20"}) as app_gathers:
        app.run(20, verbose=False)
    captured.update(app_gathers)
    del app
    cols20, src20 = captured["app step 20"]
    C = src20.shape[0]
    perm = torch.randperm(C, device=dev, generator=gen).to(torch.int32)
    for name, (cols, src) in (("G columns, phase c src", captured["phase c"]),
                              ("G columns, app step-1 src", captured["app step 1"]),
                              ("G columns, app step-20 src", captured["app step 20"]),
                              ("G columns, random permutation", (cols20, perm))):
        outs = rows.row_gather_plain(cols, src)
        variants = {"other": lambda: other_gather(other, cols, src, False),
                    "new": lambda: rows.row_gather(cols, src)}
        lanes = sum(rows.lanes_of(c) for c in cols)
        cases.append(ab_case(
            name, variants, lambda: rows.row_gather_plain(cols, src),
            cs.nbytes(src, *cols, *outs),
            lambda: [c[src.long()] for c in cols],
            {"kernel": "G", "slots": C, "arrays": len(cols), "lanes": lanes,
             "no_reuse_sector_ms": (32 * C * len(cols) + cs.nbytes(src, *outs))
             / cs.PEAK_BYTES_PER_S * 1e3}))
        del outs
    del captured, cols20, perm
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(size=(24_576, 14)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 24_576, n).astype(np.int32), device=dev)
    out = rows.row_gather_plain(table, idx)
    cases.append(ab_case(
        "G rows form, T2 probe",
        {"other": lambda: other_gather(other, [table], idx, True),
         "new": lambda: rows.row_gather(table, idx)},
        lambda: rows.row_gather_plain(table, idx), cs.nbytes(table, idx, out),
        lambda: torch.index_select(table, 0, idx), {"kernel": "G", "rows": n}))

    if len(sys.argv) > 3:
        with open(sys.argv[3], "w") as f:
            json.dump({"card": smi, "reps": REPS, "ptxas": other_report + "\n" + new_report,
                       "cases": cases}, f, indent=1)


if __name__ == "__main__":
    main()
