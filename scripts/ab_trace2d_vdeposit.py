"""A/B of kernels M2 (the 2D walk modes) and V (the deterministic deposit)
on one CUDA GPU: this checkout's ``trace2d.cu`` and ``vdeposit.cu`` against
other versions' and against probes of the first versions, on phase c's
inputs, in turns.

    python3 scripts/ab_trace2d_vdeposit.py OTHER[,OTHER...] [num_ptcls] [OUT_JSON]
        [--probes] [--variants NAME=FLAGS[;NAME=FLAGS...]]

Each ``OTHER`` is a directory holding another version's ``trace2d.cu`` and
``vdeposit.cu`` (either may be missing), for example a parent commit's,
written out with ``git show`` into a git-ignored directory such as
``chip_tree/``; its name in the output is the directory's base name.  This
checkout's own build is ``new``; ``--variants`` adds builds of this
checkout's sources with extra nvcc flags (``NAME=FLAGS``, the flags
space-separated, e.g. ``R0_16=-DM2_R0=16`` or ``tile8=-DV_TILE=8``).  Every
build uses the package's nvcc flags.

``--probes`` builds, from the first ``OTHER``'s sources, which must be the
first M2 and V (``git show 12ee88a:pumipic_torch/kernels/csrc/trace2d.cu``,
and ``vdeposit.cu``), probes, each that source with one edit of ``PROBES``;
each computes another function and is timed, not compared:

- ``M2 first step only``: every walker stops after its first step (deleted,
  or marked and recovered with recover): the least time any walk can take;
- ``V distinct addresses``: each term's two atomics aimed at output
  ``(i·k + j) mod n_out``, no two lanes of a warp on one address;
- ``V plain store``: the atomics replaced by plain stores.

It also counts, with the plain versions on the card: each M2 case's walk
steps and the warp steps of the first M2's schedule and of the pool
(``scripts/count_walk_steps.py``), and V's distinct keys in each warp's 32
particles (per term column) and in each block tile of ``BLOCK_TILE``
particles (all columns), in each order.

Inputs, at ``num_ptcls`` (default 10M): phase c's located particles on the
120k mesh (``count_walk_steps.located_2d``) and its draws (generator seed
7): M2 with reflect + record from the plain start and through the
cartesian peel, remove + record, reflect with a budget of 2 and recovery,
far targets (random points of the mesh's box, 200 steps); V as the charge
deposit (``scatter_to_verts_bcc`` of the first case's result with a charge
of 0.5 + U(0, 1)) and the weighted ``particles_per_element``, each in the
particles' own order (the path's, grouped by element) and in a random
order.  Every compared version must equal the plain version
(``trace_2d_plain``, ``vertex_deposit_plain``) bit for bit.  Each is timed
on the device alone (``chip_smoke.device_ms``, the mean of ``REPS`` calls)
in turns, in the order built and then reversed, beside the bound that
``chip_smoke.py`` gives the case, M2's L2-row floor (the walk's rows × 48
bytes over ``L2_BYTES_PER_S``) and V's f32 ``index_add_`` time.  Prints the
card, each build's ptxas report (registers, stack, shared memory and spills
of each entry function), M2's resident blocks per SM, one JSON line per
case and a summary; writes them all to ``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (setup, timing and bound helpers)
import count_walk_steps as cw  # noqa: E402
from ab_boris_trace3d import edited, same  # noqa: E402

REPS = 20
P = ctypes.c_void_p
SOURCES = ("trace2d.cu", "vdeposit.cu")
# the L2 rate kernel M's walk reached at the gitr step and on far targets
# (PERF.md §7: 4.2 and 4.8 TB/s); M2's floor takes the faster
L2_BYTES_PER_S = 4.8e12
ROW_BYTES = 48
BLOCK_TILE = 1024          # particles between two flushes of V's table

# probe name -> (source file, [(anchor, replacement), ...]) edits of the
# first M2 and V
_ATOMICS = ("      atomicAdd(a.acc + 2 * (size_t)key, (unsigned long long)h);\n"
            "      atomicAdd(a.acc + 2 * (size_t)key + 1, (unsigned long long)lo);\n")
PROBES = {
    "M2 first step only": ("trace2d.cu", [(
        "  if (w.steps >= a.budget) at_limit(a, w, my_unf);\n",
        "  if (w.steps >= min(a.budget, 1)) at_limit(a, w, my_unf);   // probe\n")]),
    "V distinct addresses": ("vdeposit.cu", [(
        _ATOMICS,
        "      const size_t o = (size_t)((i * a.k + j) % a.n_out);   // probe\n"
        "      atomicAdd(a.acc + 2 * o, (unsigned long long)h);\n"
        "      atomicAdd(a.acc + 2 * o + 1, (unsigned long long)lo);\n")]),
    "V plain store": ("vdeposit.cu", [(
        _ATOMICS,
        "      a.acc[2 * (size_t)key] = (unsigned long long)h;   // probe\n"
        "      a.acc[2 * (size_t)key + 1] = (unsigned long long)lo;\n")]),
}


@dataclasses.dataclass
class Version:
    name: str
    texts: dict                 # source file -> text (the sources it has)
    flags: tuple = ()
    compared: bool = True       # False: computes another function, timed only
    lib: object = None
    report: str = ""

    def has(self, fname: str) -> bool:
        return fname in self.texts


def build_all(versions) -> None:
    """Compile every version's sources with the package's flags, one nvcc
    per source, all at once; link each version into a library of its own."""
    from pumipic_torch.kernels import _build

    nvcc = _build.nvcc_path()
    jobs = []
    for v in versions:
        out_dir = _build.BUILD_DIR / f"ab_{re.sub(r'[^A-Za-z0-9_]+', '_', v.name)}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for fname, text in v.texts.items():
            path = out_dir / fname
            path.write_text(text)
            obj = out_dir / (path.stem + ".o")
            cmd = [nvcc, *_build.NVCC_FLAGS, *v.flags, "-Xptxas", "-v", "-c", "-o",
                   str(obj), str(path)]
            jobs.append((v, fname, obj, out_dir, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = {}
    for v, fname, obj, out_dir, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {v.name} {fname}:\n{err}")
        v.report += f"{v.name} {fname}:\n{err}"
        objs.setdefault(v.name, (v, out_dir, []))[2].append(str(obj))
    for v, out_dir, obj_list in objs.values():
        lib_path = out_dir / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib_path), *obj_list], check=True)
        v.lib = ctypes.CDLL(str(lib_path))
        names = (["pp_trace_2d", "pp_trace_2d_blocks_per_sm"] if v.has("trace2d.cu")
                 else []) + (["pp_vdeposit"] if v.has("vdeposit.cu") else [])
        for name in names:
            fn = getattr(v.lib, name)
            argtypes = list(_build.SIGNATURES[name])
            if name == "pp_vdeposit" and not _v_flags(v):
                argtypes.pop(10)        # a V before its flag words: no flags
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def ptr(t):
    return P(None if t is None else t.data_ptr())


def _v_flags(v: Version) -> bool:
    """Whether ``v``'s V takes the non-finite terms' flag words."""
    return "unsigned int* flags" in v.texts["vdeposit.cu"]


def launch_m2(v: Version, mesh, orig, dest, e0, act, max_iters, handler, record,
              recover="off", grid=None):
    """``v``'s kernel M2, launched as ``search.trace_2d`` does (the cartesian
    grid only); returns the fields of ``chip_smoke.trace_fields``."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import search as se

    n, dev = dest.shape[0], dest.device
    reflect = handler is se.reflect_on_exit_2d
    tangents = se.reflect_tangents(mesh) if reflect else None
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    new_dest = torch.empty_like(dest) if (reflect or recover == "project") else None
    rec = (torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty_like(dest)) if record else (None, None, None)
    it0 = 0 if grid is None else 1
    (ox, oy), (ihx, ihy), nx, ny = ((0.0, 0.0), (0.0, 0.0), 1, 1) if grid is None else \
        (grid.origin, grid.inv_h, grid.nx, grid.ny)
    err = v.lib.pp_trace_2d(
        ptr(orig), ptr(dest), ptr(e0), ptr(act), ptr(mesh.walk_geom), mesh.nelems,
        ptr(tangents), ptr(mesh.coords), ptr(mesh.elem2verts),
        ptr(None if grid is None else grid.cell_rows), ptr(None), ox, oy, ihx, ihy, nx, ny,
        max_iters, it0, int(reflect), int(record), int(recover == "project"), ptr(elem),
        ptr(out), ptr(new_dest), *(ptr(t) for t in rec), ptr(stats), n,
        P(stream_handle()))
    if err:
        raise RuntimeError(f"{v.name} pp_trace_2d: cudaError {err}")
    fields = [elem, out, stats[0] + it0, stats[1] == 0,
              dest if new_dest is None else new_dest]
    if record:
        fields += list(rec)
    if recover == "project":
        fields.append(stats[2])
    return tuple(fields)


def plain_m2(mesh, *args):
    """The plain version's result in :func:`launch_m2`'s field order."""
    from pumipic_torch.ops import search as se

    r = se.trace_2d_plain(mesh, *args)
    out = [r.elem_ids, r.active, r.iters, r.all_found, r.dest]
    if r.num_hits is not None:
        out += [r.exit_side, r.num_hits, r.hit]
    if r.num_recovered is not None:
        out.append(r.num_recovered)
    return tuple(out)


def launch_v(v: Version, w, q, elem, active, elem2verts, n_out):
    """``v``'s kernel V, launched as ``scatter.vertex_deposit`` does."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import scatter as sc

    n, dev = elem.shape[0], elem.device
    k = 1 if w.dim() == 1 else w.shape[1]
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    acc = torch.empty(n_out, 2, dtype=torch.int64, device=dev)
    max_bits = torch.zeros(1, dtype=torch.int32, device=dev)
    flags = [ptr(torch.empty(n_out, dtype=torch.int32, device=dev))] if _v_flags(v) else []
    err = v.lib.pp_vdeposit(
        ptr(w), ptr(q), ptr(elem), ptr(active), ptr(elem2verts), k,
        0 if elem2verts is None else elem2verts.shape[0], n_out, sc._log2_terms(n * k),
        ptr(acc), *flags, ptr(max_bits), ptr(out), n, P(stream_handle()))
    if err:
        raise RuntimeError(f"{v.name} pp_vdeposit: cudaError {err}")
    return (out.view(torch.int32),)


def timed_case(name: str, fns: dict, want, compared: dict, bound_ms: float,
               extra: dict, timer) -> dict:
    """Check each compared version against ``want`` (twice: a second run
    gives the same bits), then time all in turns (the order given, then
    reversed)."""
    for vname, fn in fns.items():
        if not compared[vname]:
            print(f"{name}: {vname} timed only, its output not compared", flush=True)
            continue
        for _ in range(2):
            got = fn()
            if len(got) != len(want) or not all(same(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: {vname} differs from its plain version")
    order = list(fns)
    turns = {v: [] for v in order}
    for vname in order + order[::-1]:
        turns[vname].append(timer(fns[vname], REPS))
    ms = {v: sum(t) / len(t) for v, t in turns.items()}
    rec = {"case": name, "device_ms": ms, "device_ms_turns": turns,
           "share_of_bound": {v: bound_ms / t for v, t in ms.items()},
           "bound_ms": bound_ms, "bound_by": "bytes",
           "compared": {v: "plain" if c else "not compared" for v, c in compared.items()},
           **extra}
    print(json.dumps(rec), flush=True)
    return rec


def distinct_keys(keys, n_out: int, group: int, per_column: bool) -> float:
    """The mean number of distinct kept keys among ``group`` consecutive
    particles' terms ((N, k) keys, ``n_out`` where dropped), per term column
    or over all columns."""
    n, k = keys.shape
    t = torch.nn.functional.pad(keys.T, (0, -n % group), value=n_out).reshape(k, -1, group)
    if not per_column:
        t = t.permute(1, 0, 2).reshape(1, -1, k * group)
    t = t.sort(dim=2).values
    new = torch.ones_like(t, dtype=torch.bool)
    new[:, :, 1:] = t[:, :, 1:] != t[:, :, :-1]
    return float((new & (t < n_out)).sum()) / (t.shape[0] * t.shape[1])


def run(versions, n: int, dev, timer, probes: bool) -> list:
    """Every case on ``versions`` (built); returns the case records."""
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    cases = []
    compared = {v.name: v.compared for v in versions}
    mesh, grid, x, elem, active = cw.located_2d(dev, n)
    gen = torch.Generator(dev).manual_seed(7)        # phase c's draws
    dest = cs.walker_targets(mesh, x, gen)
    lo, hi = mesh.coords.amin(0), mesh.coords.amax(0)
    far = (lo + (hi - lo) * torch.rand(x.shape, generator=gen, device=dev)).contiguous()
    n_act = int(active.sum())
    reflect, remove = se.reflect_on_exit_2d, se.remove_on_exit
    it, far_it = cs.TRACE2D_ITERS, cs.TRACE2D_FAR_ITERS
    ms = [v for v in versions if v.has("trace2d.cu")]
    first = None
    for name, full in (
            ("M2 reflect+record, plain start",
             (x, dest, elem, active, it, reflect, True, "off", None)),
            ("M2 reflect+record, peel", (x, dest, elem, active, it, reflect, True, "off", grid)),
            ("M2 remove+record, plain start",
             (x, dest, elem, active, it, remove, True, "off", None)),
            ("M2 reflect, budget 2 + recover",
             (x, dest, elem, active, 2, reflect, False, "project", None)),
            ("M2 far targets, reflect+record",
             (x, far, elem, active, far_it, reflect, True, "off", None))):
        handler, record, recover, g = full[5:9]
        want = plain_m2(mesh, *full)
        if first is None:
            first = want
        extra = {"particles": n, "iters": int(want[2]), "alive": int(want[1].sum()),
                 "resident_blocks_per_sm": {
                     v.name: v.lib.pp_trace_2d_blocks_per_sm(int(handler is reflect),
                                                             int(record)) for v in ms}}
        if record:
            extra["walkers_hit_wall"] = int((want[6] > 0).sum())
        if probes and recover == "off":
            steps = cw.walk_steps_2d(mesh, *full)
            extra["walk_steps"] = cw.warp_steps(steps)
            extra["l2_row_floor_ms"] = (extra["walk_steps"]["lane_steps"] * ROW_BYTES
                                        / L2_BYTES_PER_S * 1e3)
        bound = cs.trace2d_bytes(mesh, handler, record, recover, g, n_act, n)
        fns = {v.name: (lambda v=v: launch_m2(v, mesh, *full)) for v in ms}
        cases.append(timed_case(name, fns, want, {v.name: compared[v.name] for v in ms},
                                bound / cs.PEAK_BYTES_PER_S * 1e3, extra, timer))
        del want
    del far
    # V on the first case's result
    e1, a1, d1 = first[0], first[1], first[4]
    del first
    bcc = cs.barycentric_2d(mesh, e1, d1)
    q = (0.5 + torch.rand(n, generator=torch.Generator(dev).manual_seed(8),
                          device=dev)).contiguous()
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    V, E = mesh.nverts, mesh.nelems
    vs = [v for v in versions if v.has("vdeposit.cu")]
    for order, p in (("path order", None), ("random order", perm)):
        pe, pa = (e1, a1) if p is None else (e1[p].contiguous(), a1[p].contiguous())
        pb, pq = (bcc, q) if p is None else (bcc[p].contiguous(), q[p].contiguous())
        keys_v = torch.where(pa[:, None], mesh.elem2verts[torch.clamp(pe, min=0).long()], V)
        keys_e = torch.where(pa & (pe >= 0), pe, E).long()
        for name, args, terms, keys, n_out in (
                (f"V scatter_to_verts_bcc, {order}", (pb, pq, pe, pa, mesh.elem2verts, V),
                 (pb * pq[:, None]).reshape(-1), keys_v, V),
                (f"V weighted particles_per_element, {order}", (pq, None, pe, pa, None, E),
                 pq, keys_e[:, None], E)):
            want = (sc.vertex_deposit_plain(*args).view(torch.int32),)
            kl = keys.reshape(-1).long()
            lib_ms = timer(lambda: torch.zeros(n_out + 1, device=dev).index_add_(
                0, kl, terms), REPS)
            extra = {"particles": n, "library_ms": lib_ms,
                     "library": "torch.Tensor.index_add_ (f32)"}
            if probes:
                kk = keys.reshape(n, -1)
                extra["distinct_keys_per_warp_column"] = distinct_keys(kk, n_out, 32, True)
                extra["distinct_keys_per_block_tile"] = distinct_keys(
                    kk, n_out, BLOCK_TILE, False)
            inputs = [t for t in args[:5] if t is not None]
            bound = cs.nbytes(*inputs) + 4 * n_out
            fns = {v.name: (lambda v=v: launch_v(v, *args)) for v in vs}
            cases.append(timed_case(name, fns, want, {v.name: compared[v.name] for v in vs},
                                    bound / cs.PEAK_BYTES_PER_S * 1e3, extra, timer))
    return cases


def make_versions(others, probes: bool, variants: str) -> list:
    def read(d):
        return {f: open(os.path.join(d, f)).read() for f in SOURCES
                if os.path.exists(os.path.join(d, f))}

    versions = [Version(os.path.basename(os.path.normpath(d)), read(d)) for d in others]
    csrc = os.path.join(ROOT, "pumipic_torch", "kernels", "csrc")
    versions.append(Version("new", read(csrc)))
    for spec in filter(None, variants.split(";")):
        name, _, flags = spec.partition("=")
        versions.append(Version(f"new {name}", read(csrc), tuple(flags.split())))
    if probes:
        base = versions[0].texts
        for probe, (fname, edits) in PROBES.items():
            versions.append(Version(probe, {fname: edited(base[fname], edits)},
                                    compared=False))
    return versions


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", help="directories of other versions, comma-separated")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=10_000_000)
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--probes", action="store_true",
                    help="probes of the first M2 and V, edits of the first OTHER's sources")
    ap.add_argument("--variants", default="",
                    help="builds of this checkout's sources with extra nvcc flags: "
                         "NAME=FLAGS[;NAME=FLAGS...]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)
    versions = make_versions([d for d in args.others.split(",") if d], args.probes,
                             args.variants)
    build_all(versions)
    for v in versions:
        print(v.report, flush=True)
        print(json.dumps({"version": v.name, "flags": v.flags,
                          "ptxas": cs.ptxas_functions(v.report)}), flush=True)
    cases = run(versions, args.num_ptcls, torch.device("cuda"), cs.device_ms, args.probes)
    for c in cases:                       # a summary: ms, share of the bound
        floor = c.get("l2_row_floor_ms")
        print(f"{c['case']}: bound {c['bound_ms']:.4f} ms"
              + (f", L2-row floor {floor:.4f} ms" if floor else "")
              + (f", {c['library']} {c['library_ms']:.4f} ms" if "library_ms" in c else ""),
              flush=True)
        for vname, t in c["device_ms"].items():
            blocks = c.get("resident_blocks_per_sm", {}).get(vname, "")
            print(f"  {vname:28s} {t:9.4f} ms  {c['bound_ms'] / t:6.1%}  {blocks}",
                  flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "reps": REPS,
                       "ptxas": {v.name: cs.ptxas_functions(v.report) for v in versions},
                       "cases": cases}, f, indent=1)


if __name__ == "__main__":
    main()
