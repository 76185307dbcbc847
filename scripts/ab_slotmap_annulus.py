"""A/B of kernels S (the sorted rebuild's slot map) and A (the
structured-annulus locate) on one CUDA GPU: this checkout's kernels against
another version's sources, on the same inputs, in turns.

    python3 scripts/ab_slotmap_annulus.py OTHER_CSRC[,OTHER_CSRC...] [num_ptcls] [OUT_JSON]

Each ``OTHER_CSRC`` holds another version's ``slotmap.cu``, ``annulus.cu``
or both (for example a parent commit's, written out with ``git show``
into a git-ignored directory such as ``chip_tree/``, or a variant of this
checkout's source); its name in the output is the directory's base name,
this checkout's is ``new``.  Each is built with this checkout's nvcc flags
into a library of its own.  Its ``pp_slot_map`` must take this checkout's
arguments; an ``annulus.cu``
whose ``pp_annulus_locate`` takes no sector table (the earlier interface,
cos/sin computed per particle) is called without one.

A third build, ``probe``, measures what bounded the earlier S: its one
thread per slot with the binary search over the offsets replaced by a
segment id per slot read from memory (``seg``, made beforehand with
``torch.searchsorted``; its 4 bytes a slot are in its time).  Where it
runs far below the earlier kernel, the search was the bound.

Cases, at ``num_ptcls`` (default 10M) on the 120k mesh with bench_torch's
settings:

- S scs and cabm at ``chip_smoke.py`` phase c's shapes (a Sell-C-σ
  structure of the FULL-mode particles in their step-1 elements, rebuilt
  after one push; 11,999,376 slots at 10M);
- S at the Sell-C-σ and CabM apps' own order: the arguments of their 20th
  step's slot map;
- A on the bench annulus (``make_default_mesh(24000)``, 54 rings x 222
  sectors) at the annulus arm's pushed targets, in the generator's element
  order and through a random element permutation.

Every variant's output must equal the plain version's.  Each is timed in
turns (others, new, new, others reversed) with the host's share and on the
device alone, the mean of ``REPS`` calls each (``ab_gather_histogram.ab_case``),
beside its bound (bytes over 3.35 TB/s: each input read once, each output
written once).  Prints the card, the builds' ptxas reports, the SASS of each
kernel counted by opcode class, and one JSON line per case; writes them all
to ``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (setup, capture and timing helpers)
from ab_band_deposit import sass_counts  # noqa: E402
from ab_gather_histogram import REPS, ab_case  # noqa: E402

P = ctypes.c_void_p
_I, _L, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the earlier kernel A interface: no sector table
ANNULUS_NO_TABLE = [P, P, P, _L, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I,
                    P, P, P, P]
SOURCES = ("slotmap.cu", "annulus.cu")

# the earlier S (one thread per slot, grid capped at 16 blocks per SM)
# with its per-slot search replaced by seg[j]
PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void slot_map_seg_kernel(int cabm, const int* __restrict__ order,
    const int* __restrict__ start, const int* __restrict__ offsets,
    const int* __restrict__ seg, int n_seg, const int* __restrict__ row_to_elem,
    int n_rows, int chunk, int n_elems, long long C, int M, int* __restrict__ src,
    int* __restrict__ elem_c, uint8_t* __restrict__ pre_valid) {
  const long long needed = offsets[n_seg];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < C;
       j += stride) {
    const int s = seg[j];
    const int o = (int)(j - offsets[s]);
    int elem_j, rank;
    if (cabm) {
      elem_j = s;
      rank = o;
    } else {
      rank = o / chunk;
      const int local_row = o - rank * chunk;
      int row = s * chunk + local_row;
      if (row > n_rows - 1) row = n_rows - 1;
      elem_j = row_to_elem[row];
    }
    int ec = elem_j < 0 ? 0 : elem_j;
    if (ec > n_elems - 1) ec = n_elems - 1;
    const int src_pos0 = start[ec] + rank;
    const int src_pos = src_pos0 < M - 1 ? src_pos0 : M - 1;
    const bool guard = elem_j >= 0 && elem_j < n_elems && rank >= 0 && j < needed;
    src[j] = order[src_pos];
    elem_c[j] = ec;
    pre_valid[j] = (guard && src_pos0 <= M - 1) ? 1 : 0;
  }
}

extern "C" int probe_slot_map_seg(int cabm, const int* order, const int* start,
    const int* offsets, const int* seg, int n_seg, const int* row_to_elem,
    int n_rows, int chunk, int n_elems, long long C, int M, int* src, int* elem_c,
    uint8_t* pre_valid, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (C + 255) / 256;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  slot_map_seg_kernel<<<(unsigned)blocks, 256, 0, stream>>>(cabm, order, start,
      offsets, seg, n_seg, row_to_elem, n_rows, chunk, n_elems, C, M, src,
      elem_c, pre_valid);
  return (int)cudaGetLastError();
}
"""
PROBE_ARGS = [_I, P, P, P, P, _I, P, _I, _I, _I, _L, _I, P, P, P, P]


@dataclasses.dataclass
class Version:
    name: str
    lib: object
    annulus_table: bool      # pp_annulus_locate takes the sector table
    report: str
    sass: dict


def build(paths, name: str) -> Version:
    """Compile ``paths`` (.cu files) with the package's flags into one
    library; counts the SASS of its kernels by opcode class."""
    from pumipic_torch.kernels import _build

    out_dir = _build.BUILD_DIR / f"ab_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    objs, report, sass, table = [], [], {}, True
    for path in (p for p in paths if os.path.exists(p)):
        obj = str(out_dir / (os.path.basename(path) + ".o"))
        res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                              path], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {name} {path}:\n{res.stderr}")
        objs.append(obj)
        report.append(f"{name} {os.path.basename(path)}:\n{res.stderr}")
        sass.update(sass_counts(subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                                               text=True, check=True).stdout))
        if os.path.basename(path) == "annulus.cu":
            table = "const float* table" in open(path).read()
    lib_path = out_dir / "lib.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in (("pp_slot_map", _build.SIGNATURES["pp_slot_map"]),
                              ("pp_annulus_locate", _build.SIGNATURES["pp_annulus_locate"]
                               if table else ANNULUS_NO_TABLE),
                              ("probe_slot_map_seg", PROBE_ARGS)):
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return Version(name, lib, table, "\n".join(report), sass)


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: cudaError {err}")


def outputs(C: int, dev):
    return (torch.empty(C, dtype=torch.int32, device=dev),
            torch.empty(C, dtype=torch.int32, device=dev),
            torch.empty(C, dtype=torch.bool, device=dev))


def slot_map(v: Version, sargs):
    """``v``'s kernel S, launched as ``rows.slot_map`` does."""
    from pumipic_torch.kernels import stream_handle

    layout, order, start, offsets, r2e, chunk, C, M = sargs
    out = outputs(C, order.device)
    cabm = layout == "cabm"
    check(v.lib.pp_slot_map(int(cabm), P(order.data_ptr()), P(start.data_ptr()),
                            P(offsets.data_ptr()), offsets.shape[0] - 1,
                            P(None if cabm else r2e.data_ptr()),
                            0 if cabm else r2e.shape[0], chunk, start.shape[0] - 1, C, M,
                            *(P(t.data_ptr()) for t in out), P(stream_handle())),
          f"{v.name} pp_slot_map")
    return out


def slot_map_seg(v: Version, sargs, seg):
    """The probe: the earlier S with each slot's segment read from ``seg``."""
    from pumipic_torch.kernels import stream_handle

    layout, order, start, offsets, r2e, chunk, C, M = sargs
    out = outputs(C, order.device)
    cabm = layout == "cabm"
    check(v.lib.probe_slot_map_seg(int(cabm), P(order.data_ptr()), P(start.data_ptr()),
                                   P(offsets.data_ptr()), P(seg.data_ptr()),
                                   offsets.shape[0] - 1, P(None if cabm else r2e.data_ptr()),
                                   0 if cabm else r2e.shape[0], chunk, start.shape[0] - 1,
                                   C, M, *(P(t.data_ptr()) for t in out),
                                   P(stream_handle())),
          "probe_slot_map_seg")
    return out


def annulus_locate(v: Version, loc, px, py, active):
    """``v``'s kernel A, launched as ``locate.annulus_locate`` does."""
    from pumipic_torch.kernels import stream_handle

    n = px.shape[0]
    elem = torch.empty(n, dtype=torch.int32, device=px.device)
    act = torch.empty(n, dtype=torch.bool, device=px.device)
    sc = loc.scalars()
    table = [P(loc.sector_table(px.device).data_ptr())] if v.annulus_table else []
    check(v.lib.pp_annulus_locate(
        P(px.data_ptr()), P(py.data_ptr()), P(active.data_ptr()), n, loc.cx, loc.cy,
        loc.theta0, sc["two_pi"], sc["dth"], sc["m"], loc.r_in, loc.dr, sc["lo"], sc["hi"],
        loc.n_rings, loc.n_sectors, *table,
        P(None if loc.perm is None else loc.perm.data_ptr()), P(elem.data_ptr()),
        P(act.data_ptr()), P(stream_handle())), f"{v.name} pp_annulus_locate")
    return elem, act


def s_case(name: str, versions, probe: Version, sargs):
    from pumipic_torch.ops import rows

    layout, order, start, offsets, r2e, _, C, M = sargs
    n_seg = offsets.shape[0] - 1
    j = torch.arange(C, dtype=torch.int32, device=order.device)
    seg = torch.searchsorted(offsets[1:n_seg].contiguous(), j, right=True, out_int32=True)
    del j
    variants = {v.name: (lambda v=v: slot_map(v, sargs)) for v in versions
                if hasattr(v.lib, "pp_slot_map")}
    variants["probe (earlier S, no search)"] = lambda: slot_map_seg(probe, sargs, seg)
    out = rows.slot_map_plain(*sargs)
    return ab_case(name, variants, lambda: rows.slot_map_plain(*sargs),
                   cs.nbytes(order, start, offsets, r2e, *out), None,
                   {"kernel": "S", "layout": layout, "slots": C, "rows": M, "segments": n_seg,
                    "needed": int(offsets[-1]), "probe_extra_bytes": 4 * C})


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    other_dirs = [d for d in sys.argv[1].split(",") if d]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000_000
    import bench_torch
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops

    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)
    csrc = os.path.join(ROOT, "pumipic_torch", "kernels", "csrc")
    probe_path = os.path.join(ROOT, "pumipic_torch", "kernels", "_build", "ab_probe.cu")
    os.makedirs(os.path.dirname(probe_path), exist_ok=True)
    with open(probe_path, "w") as f:
        f.write(PROBE_CU)
    versions = [build([os.path.join(d, s) for s in SOURCES], os.path.basename(os.path.normpath(d)))
                for d in other_dirs] + [build([os.path.join(csrc, s) for s in SOURCES], "new")]
    probe = build([probe_path], "probe")
    for v in versions + [probe]:
        print(v.report, flush=True)
        for fn, rec in v.sass.items():
            print(json.dumps({"version": v.name, "function": fn, "all": rec["all"]}), flush=True)
    dev = torch.device("cuda")
    cases = []

    # S at phase c's shapes: the FULL-mode particles in their step-1
    # elements, rebuilt after one push
    mesh, state, step, _ = bench_torch.setup(dev, n, mesh_path=cs.MESH)
    E = mesh.nelems
    state0 = {k: v.clone() for k, v in state.items()}
    state, _ = step(state)
    grid = step.model.locator
    cfg = dataclasses.replace(cs._cfg(px, mesh, structure="scs"), num_ptcls=n)
    ps = cs.scs_of_located(dev, E, state0, state["elem"], state["active"])
    del state, state0, step
    bands = push_ops.BandClasses.build(
        push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), dev)
    modes, _ = cs.slot_map_inputs(ps, cs.located_after_push(mesh, ps, cfg, grid, bands), E)
    del ps
    for layout, sargs in modes.items():
        cases.append(s_case(f"S {layout}, phase c shapes", versions, probe, sargs))
    del modes
    torch.cuda.empty_cache()

    # S at the apps' own order: the 20th step's slot map
    for structure in ("scs", "cabm"):
        app = px.PseudoXGCm(mesh, dataclasses.replace(cfg, structure=structure), device=dev,
                            locator=grid)
        with cs.slot_maps_at({20: "step 20"}) as maps:
            app.run(20, verbose=False)
        del app
        cases.append(s_case(f"S {structure}, app step-20 order", versions, probe,
                            maps["step 20"]))
        del maps
        torch.cuda.empty_cache()

    # A on the bench annulus, generator ids and a random element permutation
    loc, tx, ty, active = cs.annulus_targets(dev)
    E_a = 2 * loc.n_rings * loc.n_sectors
    perm = torch.randperm(E_a, device=dev, generator=torch.Generator(dev).manual_seed(2))
    for what, lc in (("generator ids", loc),
                     ("permuted ids", dataclasses.replace(loc, perm=perm.to(torch.int32)))):
        out = lo.annulus_locate_plain(lc, tx, ty, active)
        cases.append(ab_case(
            f"A, annulus arm pushed targets, {what}",
            {v.name: (lambda v=v, lc=lc: annulus_locate(v, lc, tx, ty, active))
             for v in versions if hasattr(v.lib, "pp_annulus_locate")},
            lambda lc=lc: lo.annulus_locate_plain(lc, tx, ty, active),
            cs.nbytes(tx, ty, active, lc.sector_table(dev), lc.perm, *out), None,
            {"kernel": "A", "particles": tx.shape[0], "rings": loc.n_rings,
             "sectors": loc.n_sectors}))

    if len(sys.argv) > 3:
        with open(sys.argv[3], "w") as f:
            json.dump({"card": smi, "reps": REPS,
                       "ptxas": {v.name: v.report for v in versions + [probe]},
                       "sass": {v.name: v.sass for v in versions + [probe]}, "cases": cases},
                      f, indent=1)


if __name__ == "__main__":
    main()
