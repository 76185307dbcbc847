"""A/B of kernels U1 (the reshuffle's split, counts and mover list), U2
(its placement), U3 (the movers' destination order) and Z (the Sell-C-σ
row order) on one CUDA GPU: this checkout's ``reshuffle.cu`` against other
versions', in turns.

    python3 scripts/ab_reshuffle.py OTHER[,OTHER...] [OUT_JSON]
        [--variants NAME=DEFINE:VALUE[,DEFINE:VALUE...][;NAME=...]]
        [--timed-only NAME[,NAME...]] [--cases u,order]

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
rebuild's own (U1's counts, kernel U3's mover slots, kernel G's staged
rows, from the package's kernels).  Every version must equal the plain
version but the ``--timed-only`` ones.  Each is timed on the device alone
(``chip_smoke.device_ms``, the mean of ``REPS`` calls with their memsets;
an out-of-place U2 with its fields' clone) in turns, in the order built and then
reversed.

The ``order`` cases (``--cases``; both kinds by default) time the movers'
order and the row order of each ``OTHER`` against this checkout's U3 and Z,
in turns: OTHER, new, new, OTHER.  An ``OTHER`` directory's
``reshuffle.cu`` is built with its ``rebuild.cu`` (this checkout's where it
has none) into one library; a version without U3 and Z (one whose Z is a
key and maps kernel, ``pp_scs_row_keys``) orders the movers with kernel
C's payload form and makes the row order from Z's key, C and Z's maps, as
that tree's wrappers did.  Cases: the row order on PseudoXGCm's seeded counts on the 120k mesh
(122,603 elements, ``seed_particles_per_element``) and on the
pps3d-scs-auto structure's padded counts (24,576 tets); the movers' order
on U1's movers after pushes of 1, 2 and 4 times ``chip_smoke.AUTO_DIST``
(2.7%, 5.4% and 10.7% of the particles) in both layouts.  Every version
must equal the plain version.  Prints the card, each build's ptxas report
and one JSON line per case; writes them to ``OUT_JSON`` where one is given.
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
# the row order's and the movers' order's launchers of any version: an
# earlier Z (key, maps) around C, or U3 and Z
ORDER_SIGNATURES = {
    "pp_scs_row_keys": [P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P],
    "pp_scs_row_maps": [P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P, P],
    **{k: _build.SIGNATURES[k] for k in (
        "pp_key_sort", "pp_key_sort_scratch", "pp_scs_row_order",
        "pp_scs_row_order_scratch_words",
        "pp_reshuffle_order", "pp_reshuffle_order_scratch", "pp_reshuffle_order_turns",
        "pp_reshuffle_order_grid")}}


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


def build_order(name: str, src_dir: str, out_dir: str):
    """One version's library of the row order and the movers' order: its
    ``reshuffle.cu`` and its ``rebuild.cu`` (this checkout's where the
    directory has none), and its ptxas report."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"liborder_{name}.so")
    reb = os.path.join(src_dir, "rebuild.cu")
    srcs = [os.path.join(src_dir, "reshuffle.cu"),
            reb if os.path.exists(reb) else str(_build.CSRC / "rebuild.cu")]
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", lib, *srcs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stderr}")
    handle = ctypes.CDLL(lib)
    for fn, argtypes in ORDER_SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    return handle, res.stderr


class with_lib:
    """The package's wrappers launch ``lib``'s kernels inside the block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved, _build._LIB = _build.lib(), self.lib

    def __exit__(self, *exc):
        _build._LIB = self.saved


def row_order_fn(lib, counts, R: int, chunk: int, bits: int):
    """One call of a version's row order (one window): Z, or an earlier Z's
    key, kernel C and Z's maps."""
    E, dev = counts.shape[0], counts.device
    if not hasattr(lib, "pp_scs_row_keys"):
        def run():
            with with_lib(lib):
                return rb.scs_row_order(counts, R, 2**30, chunk, bits)
        return run

    def run():
        key = torch.empty(R, dtype=torch.int32, device=dev)
        _build.check(lib.pp_scs_row_keys(P(counts.data_ptr()), E, R, R, bits,
                                         P(key.data_ptr()), P(kernels.stream_handle())),
                     "scs_row_keys")
        with with_lib(lib):
            order = rb.key_sort(key, (1 << (bits + 1)) - 1)
        e2r = torch.empty(E, dtype=torch.int32, device=dev)
        width = torch.empty(R // chunk, dtype=torch.int32, device=dev)
        _build.check(lib.pp_scs_row_maps(P(order.data_ptr()), P(counts.data_ptr()), E, R,
                                         chunk, P(e2r.data_ptr()), P(width.data_ptr()),
                                         P(kernels.stream_handle())), "scs_row_maps")
        return order, e2r, width
    return run


def mover_order_fn(lib, mkey, msrc, mov_start):
    """One call of a version's movers' order: U3, or kernel C's payload form."""
    E = mov_start.shape[0]

    def run():
        with with_lib(lib):
            if hasattr(lib, "pp_reshuffle_order"):
                return rb.reshuffle_order(mkey, msrc, mov_start)
            return rb.key_sort(mkey, E - 1, values=msrc)
    return run


def order_cases(others: list, variants: list, timed_only: set, out_dir: str,
                smi: str) -> list:
    """The row order and the movers' order of each other version against
    this checkout's and its variants, in turns (OTHER, new, variants, then
    back); versions in ``timed_only`` are not compared.  Also both at a
    tiny size (8 rows; 192 movers): the launch's fixed cost."""
    import numpy as np

    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops.scatter import histogram

    dev = torch.device("cuda")
    libs = {}
    for name, src in others:
        libs[name], report = build_order(name, src, out_dir)
        print(f"{name} (order) ptxas:\n{report}", flush=True)
    libs["new"] = _build.lib()
    for name, src in variants:
        libs[name], report = build_order(name, src, out_dir)
        print(f"{name} (order) ptxas:\n{report}", flush=True)
    records = []

    def row_case(what, counts, num_ptcls):
        E, chunk = counts.shape[0], 8
        R = -(-E // chunk) * chunk
        bits = st._scs_key_bits(1, E, num_ptcls, 0.0)
        want = rb.scs_row_order_plain(counts, R, 2**30, chunk, bits)
        fns = {k: row_order_fn(lib, counts, R, chunk, bits) for k, lib in libs.items()}
        differ = [k for k, fn in fns.items() if k not in timed_only
                  and not all(torch.equal(a, b) for a, b in zip(fn(), want))]
        check(differ, f"row order, {what}")
        records.append(timed(f"row order, {what}", fns, {"rows": R, "card": smi,
                                                          "differ": differ}))

    def check(differ, what):
        """A version that differs from the plain version: the parent and
        this checkout's raise, a variant is recorded as differing."""
        if set(differ) & (set(libs) - {name for name, _ in variants}):
            raise AssertionError(f"{what}: {differ} differ from the plain version")

    row_case("tiny (5 elements)", torch.tensor([3, 0, 9, 9, 1], dtype=torch.int32,
                                                device=dev), 22)
    tiny = torch.arange(192, dtype=torch.int32, device=dev)
    starts = torch.zeros(24_576, dtype=torch.int32, device=dev)
    starts[7:] = 192
    fns = {k: mover_order_fn(lib, torch.full_like(tiny, 6), tiny, starts)
           for k, lib in libs.items()}
    records.append(timed("movers' order, tiny (192 movers, 24,576 keys)", fns, {"card": smi}))
    mesh = Mesh2D.from_arrays(*read_msh(cs.MESH), device=dev)
    ppe = px.seed_particles_per_element(mesh, cs._cfg(px, mesh),
                                        np.random.default_rng(px.ELEMENT_SEED))
    row_case(f"app scs's seeded counts ({mesh.nelems} elements)",
             torch.as_tensor(np.asarray(ppe, np.int32), device=dev), int(np.sum(ppe)))
    del mesh
    for layout in ("scs", "cabm"):
        _, ps, _, _ = bench_torch.setup_pps3d(dev, 10_000_000, structure=layout, kuhn="auto",
                                              rebuild="auto", distance=cs.AUTO_DIST)
        E = ps.num_elems
        if layout == "scs":
            counts = st._scs_pad_counts(histogram(ps.elem, ps.active, E), 0.15,
                                        "proportionally").to(torch.int32)
            row_case(f"pps3d-scs-auto's padded counts ({E} tets)", counts, ps.capacity)
        kuhn, direction, wrap, _ = push_of(ps)
        MB = st._reshuffle_mover_budget(ps.capacity)
        for dist in (cs.AUTO_DIST, 2 * cs.AUTO_DIST, 4 * cs.AUTO_DIST):
            elem = cs.pushed_elem(kuhn, ps, direction, wrap, dist)
            c = rb.reshuffle_count(elem, ps.elem, ps.seg_cap, MB)
            n_mov = int(c.info[1])
            args = (c.mkey[:n_mov], c.msrc[:n_mov], c.mov_start)
            want = rb.reshuffle_order_plain(*args)
            fns = {k: mover_order_fn(lib, *args) for k, lib in libs.items()}
            differ = [k for k, fn in fns.items()
                      if k not in timed_only and not torch.equal(fn(), want)]
            check(differ, f"movers' order, {layout}, push {dist}")
            records.append(timed(f"movers' order, {layout}, push {dist}", fns,
                                 {"movers": n_mov, "share": n_mov / 10_000_000,
                                  "card": smi, "differ": differ}))
        del ps
        torch.cuda.empty_cache()
    return records


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
    ap.add_argument("--cases", default="u,order")
    a = ap.parse_args()
    cases = set(a.cases.split(","))
    timed_only = set(filter(None, a.timed_only.split(",")))
    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)
    out_dir = os.path.join(ROOT, "chip_tree", "ab_reshuffle")
    versions = {}
    others = [(os.path.basename(os.path.normpath(d)), d) for d in a.others.split(",") if d]
    builds = [("new", str(_build.CSRC))] + others
    builds += variant_sources(a.variants, out_dir) if "u" in cases else []
    in_place = {}
    for name, src in builds if "u" in cases else []:
        versions[name], report, in_place[name] = build(name, src, out_dir)
        print(f"{name} ptxas:\n{report}", flush=True)
    out_json = a.out_json
    dev = torch.device("cuda")
    variants = variant_sources(a.variants, out_dir) if "order" in cases else []
    records = order_cases(others, variants, timed_only, out_dir, smi) \
        if "order" in cases else []
    for layout in ("scs", "cabm") if "u" in cases else ():
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
            take = rb.reshuffle_order(want.mkey[:n_mov], want.msrc[:n_mov], want.mov_start)
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
