"""A/B of kernels U1 (the reshuffle's split, counts and mover list) and U2
(its placement) on one CUDA GPU: this checkout's ``reshuffle.cu`` against
other versions', in turns.

    python3 scripts/ab_reshuffle.py OTHER[,OTHER...] [OUT_JSON]
        [--variants NAME=DEFINE:VALUE[,DEFINE:VALUE...][;NAME=...]]
        [--timed-only NAME[,NAME...]]

Each ``OTHER`` is a directory holding another version's ``reshuffle.cu``
(``pp_reshuffle_count`` and ``pp_reshuffle_place``), written into a
git-ignored directory such as ``chip_tree/``; its name in the output is
the directory's base name.  A source whose U2 takes ``num_ovf`` writes the
fields in place (each such version gets its own copy of the fields, made
once, outside the timing); an earlier, out-of-place one writes into a clone of
the fields, made in each timed call as its wrapper did, with its four
memsets.  This checkout's is ``new``; ``--variants`` adds builds of this
checkout's source with some of its ``#define`` constants set otherwise in
the text written to the variant's build directory (``NAME=DEFINE:VALUE``,
e.g. ``s1=U1_STAGE:1`` or ``t256=U2_THREADS:256``).  Each version is built
alone into a library of its own with the package's nvcc flags.  Versions
named in ``--timed-only`` (the stripped builds, ``U1_STAGE`` < 5 or
``U2_STAGE`` < 2, which compute less than the kernels) are timed and
never compared (an out-of-place one skips U2's cases).

Inputs: pseudoPushAndSearch's auto-rebuild structures at 10M particles on
the 16^3 Kuhn box (``bench_torch.setup_pps3d(..., rebuild="auto")``:
Sell-C-σ chunks of 8 and CabM, extra padding 0.15) and the destinations of
one push of ``chip_smoke.AUTO_DIST`` (2.7% movers), of 2 and 4 times it
(5.4%, 10.7%) and, for U1, of the default push (84% movers: the
fallback).  U2's inputs are the
rebuild's own (U1's counts, kernel C's mover slots, kernel G's staged
rows, from the package's kernels).  Every version must equal the plain
version but the ``--timed-only`` ones.  Each is timed on the device alone
(``chip_smoke.device_ms``, the mean of ``REPS`` calls with their memsets;
an out-of-place U2 with its fields' clone) in turns, in the order built and then
reversed.  Prints the card, each
build's ptxas report and one JSON line per case; writes them to
``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from pumipic_torch import kernels  # noqa: E402
from pumipic_torch.kernels import _build  # noqa: E402
from pumipic_torch.ops import rebuild as rb  # noqa: E402
from pumipic_torch.particles import structure as st  # noqa: E402

REPS = 20
P = ctypes.c_void_p
NAMES = ("pp_reshuffle_count_words", "pp_reshuffle_count", "pp_reshuffle_place")


def build(name: str, src_dir: str, out_dir: str) -> tuple:
    """One version's library, ptxas report and whether its U2 writes the
    fields in place (the ``num_ovf`` interface)."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libreshuffle_{name}.so")
    src = os.path.join(src_dir, "reshuffle.cu")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", lib, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stderr}")
    in_place = "num_ovf" in open(src).read()
    handle = ctypes.CDLL(lib)
    for fn in NAMES:
        argtypes = list(_build.SIGNATURES[fn])
        if fn == "pp_reshuffle_place" and not in_place:
            argtypes.insert(-1, P)                # num and ovf apart
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle, res.stderr, in_place


def count_fn(lib, elem, ps, MB: int):
    E, C = ps.num_elems, ps.capacity
    dev = elem.device

    def run():
        cnt = torch.empty(lib.pp_reshuffle_count_words(C, E), dtype=torch.int32, device=dev)
        out = [torch.empty(n, dtype=torch.int32, device=dev) for n in (E, MB, MB, 2)]
        num = torch.empty((), dtype=torch.int32, device=dev)
        _build.check(lib.pp_reshuffle_count(
            P(elem.data_ptr()), P(ps.elem.data_ptr()), P(ps.seg_cap.data_ptr()), E, C, MB,
            P(cnt.data_ptr()), *(P(t.data_ptr()) for t in out), P(num.data_ptr()),
            P(kernels.stream_handle())), "reshuffle_count")
        return rb.ReshuffleCount(out[3], cnt[:E], cnt[E:2 * E], out[0], out[1], out[2], num)
    return run


def place_fn(lib, args, in_place: bool):
    """One call of a version's U2: in place into its own copy of the fields
    (``num_ovf`` interface), or into a clone made in the call (out of place)."""
    elem, old, offs, cap, mcnt, mstart, fields, staged, stride, ovf_in, r2e = args
    C, E = elem.shape[0], cap.shape[0]
    names = list(fields)
    m = len(names)
    mine = {k: fields[k].clone() for k in names} if in_place else None
    dev = elem.device
    head = (*(P(t.data_ptr()) for t in (elem, old, offs, cap, mcnt, mstart)),
            P(r2e.data_ptr() if r2e is not None else 0), 0 if r2e is None else r2e.shape[0],
            E, C, stride, P(ovf_in.data_ptr()), m,
            (P * m)(*(staged[k].data_ptr() for k in names)))
    row_bytes = (ctypes.c_int * m)(*(rb._row_bytes(fields[k]) for k in names))

    def run():
        out = mine if in_place else {k: fields[k].clone() for k in names}
        e_out = torch.empty(C, dtype=torch.int32, device=dev)
        a_out = torch.empty(C, dtype=torch.bool, device=dev)
        ptrs = (P * m)(*(out[k].data_ptr() for k in names))
        if in_place:
            num_ovf = torch.empty(2, dtype=torch.int32, device=dev)
            tail = (P(num_ovf.data_ptr()),)
            num, ovf = num_ovf[0], num_ovf[1:].view(torch.uint8)[0].view(torch.bool)
        else:
            num = torch.empty((), dtype=torch.int32, device=dev)
            ovf = torch.empty((), dtype=torch.bool, device=dev)
            tail = (P(num.data_ptr()), P(ovf.data_ptr()))
        _build.check(lib.pp_reshuffle_place(
            *head, ptrs, row_bytes, P(e_out.data_ptr()), P(a_out.data_ptr()), *tail,
            P(kernels.stream_handle())), "reshuffle_place")
        return e_out, a_out, out, num, ovf
    return run


def same_count(got, want, MB: int) -> bool:
    n_mov = int(want.info[1])
    k = min(n_mov, MB)
    ok = torch.equal(got.info, want.info) and torch.equal(got.num, want.num) and \
        torch.equal(got.msrc[:k], want.msrc[:k]) and torch.equal(got.mkey[:k], want.mkey[:k])
    if n_mov <= MB:                 # the counts U1 computes only within the budget
        ok = ok and torch.equal(got.stay_cnt, want.stay_cnt) and \
            torch.equal(got.mov_cnt, want.mov_cnt) and \
            torch.equal(got.mov_start, want.mov_start)
    return ok


def same_place(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in ((got[0], want[0]), (got[1], want[1]),
                                             (got[3], want[3]), (got[4], want[4]))) and \
        all(torch.equal(got[2][k], want[2][k]) for k in want[2])


def timed(case: str, fns: dict, extra: dict) -> dict:
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(cs.device_ms(fns[k], REPS))
    rec = {"case": case, **extra, "ms": ms}
    print(json.dumps(rec), flush=True)
    return rec


def variant_sources(variants: str, out_dir: str) -> list:
    """(name, directory) of each ``--variants`` build: this checkout's
    source with the named ``#define`` values replaced."""
    text = open(os.path.join(_build.CSRC, "reshuffle.cu")).read()
    out = []
    for spec in filter(None, variants.split(";")):
        name, defs = spec.split("=", 1)
        src = text
        for d in defs.split(","):
            key, value = d.split(":")
            src, n = re.subn(rf"^#define {key} .*$", f"#define {key} {value}", src,
                             flags=re.M)
            if n != 1:
                raise ValueError(f"variant {name}: no #define {key}")
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "reshuffle.cu"), "w") as f:
            f.write(src)
        out.append((name, d))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("others", nargs="?", default="")
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--variants", default="")
    ap.add_argument("--timed-only", default="")
    a = ap.parse_args()
    timed_only = set(filter(None, a.timed_only.split(",")))
    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)
    out_dir = os.path.join(ROOT, "chip_tree", "ab_reshuffle")
    versions = {}
    builds = [("new", str(_build.CSRC))]
    builds += [(os.path.basename(os.path.normpath(d)), d) for d in a.others.split(",") if d]
    builds += variant_sources(a.variants, out_dir)
    in_place = {}
    for name, src in builds:
        versions[name], report, in_place[name] = build(name, src, out_dir)
        print(f"{name} ptxas:\n{report}", flush=True)
    out_json = a.out_json
    dev = torch.device("cuda")
    records = []
    for layout in ("scs", "cabm"):
        _, ps, _, _ = bench_torch.setup_pps3d(dev, 10_000_000, structure=layout, kuhn="auto",
                                              rebuild="auto", distance=cs.AUTO_DIST)
        kuhn, direction, wrap, default = push_of(ps)
        stride = ps.chunk_size if layout == "scs" else 1
        MB = st._reshuffle_mover_budget(ps.capacity)
        for dist in (cs.AUTO_DIST, 2 * cs.AUTO_DIST, 4 * cs.AUTO_DIST) + (
                (default,) if layout == "scs" else ()):
            elem = cs.pushed_elem(kuhn, ps, direction, wrap, dist)
            want = rb.reshuffle_count_plain(elem, ps.elem, ps.seg_cap, MB)
            fits, n_mov = want.info.tolist()
            fns = {k: count_fn(lib, elem, ps, MB) for k, lib in versions.items()}
            for k, fn in fns.items():
                if k not in timed_only and not same_count(fn(), want, MB):
                    raise AssertionError(f"U1 {k} differs from the plain version")
            extra = {"movers": n_mov, "share": n_mov / 10_000_000, "fits": bool(fits),
                     "card": smi}
            records.append(timed(f"U1 {layout}, push {dist}", fns, extra))
            if not fits:
                continue
            take = rb.key_sort(want.mkey[:n_mov], ps.num_elems - 1, values=want.msrc[:n_mov])
            staged, _ = st._gather_fields(ps.fields, take)
            args = (elem, ps.elem, ps.elem_offsets, ps.seg_cap, want.mov_cnt, want.mov_start,
                    ps.fields, staged, stride, ps.overflowed, ps.row_to_elem)
            ref = rb.reshuffle_place_plain(*args[:6], {k: v.clone() for k, v in
                                                       ps.fields.items()}, *args[7:])
            fns = {k: place_fn(lib, args, in_place[k]) for k, lib in versions.items()
                   if in_place[k] or k not in timed_only}
            for k, fn in fns.items():
                if k not in timed_only and not same_place(fn(), ref):
                    raise AssertionError(f"U2 {k} differs from the plain version")
            records.append(timed(f"U2 {layout}, push {dist}", fns, extra))
        del ps
        torch.cuda.empty_cache()
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"card": smi, "records": records}, f)


def push_of(ps):
    """Kernel K's box, the pps3d push's direction and wrap, and its default
    distance."""
    import numpy as np

    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.mesh.locator import detect_box_kuhn
    from pumipic_torch.models import pseudo_push_and_search as pps

    mesh = Mesh3D.from_arrays(*box_tet_mesh(16, 16, 16), device=ps.device)
    coords = mesh.coords.cpu().numpy()
    kuhn = detect_box_kuhn(coords, mesh.elem2verts.cpu().numpy(), device=ps.device)
    d = np.asarray(pps.PushSearchConfig().push_dir, np.float64)
    return (kuhn, (d / np.linalg.norm(d)).astype(np.float32),
            (coords.min(axis=0), coords.max(axis=0) - coords.min(axis=0)),
            pps.PushSearchConfig().distance)


if __name__ == "__main__":
    main()
