"""A/B of kernel L3 (the tet peel + BCC walk) on one CUDA GPU: this
checkout's ``locate3d.cu`` against other versions' and against probes of
the first version, on the same inputs, in turns.

    python3 scripts/ab_locate3d.py OTHER[,OTHER...] [num_ptcls] [OUT_JSON]
        [--probes] [--timed-only DIR[,DIR...]]

Each ``OTHER`` is a directory holding another version's ``locate3d.cu``
(for example a parent commit's, written out with ``git show`` into a
git-ignored directory such as ``chip_tree/``, or a variant of this
checkout's source); its name in the output is the directory's base name.
This checkout's own build is ``new``.  Every build uses the package's nvcc
flags.  A source whose ``pp_walk_locate_3d`` takes ``cell_ids`` is given
the grid's (n_cells, 2) i32 candidate pair; an earlier one its 26-column
``cell_rows``.  A source without ``pp_walk_locate_3d_blocks_per_sm`` is
built with that occupancy query appended (its kernel is unchanged).

``--probes`` builds, from the first ``OTHER``'s source, which must be the
first L3 (one thread per particle, a grid-stride loop over at most SMs x 8
blocks of 256 threads, a 104-byte cell row read as thirteen 8-byte loads,
walkers never compacted: ``git show 2f20aa3:pumipic_torch/kernels/csrc/
locate3d.cu``), four probes, each that source with one edit of
``PROBES`` (text replaced at anchors that must each occur once).  That
``OTHER``, built unedited, is their baseline:

- ``probe resident grid``: the grid capped at the blocks that are resident
  at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs); the
  kernel itself is the baseline's;
- ``probe launch_bounds(256, 8)``: registers capped so that 8 blocks fit;
- ``probe peel only``: a particle the peel misses is counted in
  ``stats[1]`` and not walked (its output is candidate A), compared with
  that function's own plain version (:func:`peel_only_plain`);
- ``probe A first``: candidate A's 13 columns first, B's only where A
  does not contain the point.

The two peel probes differ from the baseline only behind the peel and are
not run on the plain walk.  Every other version is compared with the plain
version (``walk_locate_3d_plain``) and must equal it, except a directory
given to ``--timed-only``: a variant that computes another function (for
example this checkout's source with every walker deleted at the peel, the
least time any walk behind that peel can take), timed and reported as not
compared.

Cases, at ``num_ptcls`` (default 10M) on pseudoPushAndSearch's walk arm
(the 16^3 Kuhn box, 24,576 tets, DPS, periodic wall, the cpe-16 grid):
the targets of step 1 and of step 20 from their previous tets, peel + walk;
the plain walk (no grid) on step 1's targets; and step 1's particles in
one random order, both modes (the cell rows and tets lose their locality).
Each version is timed in turns (the order given, then reversed) with the
host's share and on the device alone, the mean of ``REPS`` calls each,
beside two byte bounds (``chip_smoke.locate3d_bytes`` over 3.35 TB/s):
with the 26-column rows, and with the (n_cells, 2) id pair in their place.
Prints the card, each build's ptxas report and resident blocks per SM, the
walker share (active particles the peel misses) and one JSON line per
case; writes them all to ``OUT_JSON`` where one is given.
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

import chip_smoke as cs  # noqa: E402  (setup, timing and byte-count helpers)

REPS = 50
P = ctypes.c_void_p
MAX_ITERS = 64
THREADS = 256

# probe name -> (anchor, replacement) edits of the first L3's source
PROBES = {
    "probe resident grid": [(
        "  const long long cap = (long long)num_sms() * 8;\n",
        "  int resident = 0;\n"
        "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, walk_locate_3d_kernel,\n"
        "                                                WALK_THREADS, 0);\n"
        "  const long long cap = (long long)num_sms() * resident;\n")],
    "probe launch_bounds(256, 8)": [(
        "__launch_bounds__(WALK_THREADS)", "__launch_bounds__(WALK_THREADS, 8)")],
    "probe peel only": [(
        "          fbg = start;\n          done = false;\n",
        "          ++my_unfinished;  // probe: counted, not walked\n")],
    "probe A first": [(
        """#pragma unroll
        for (int j = 0; j < 13; ++j) {
          const float2 v = __ldg(r2 + j);
          r[2 * j] = v.x;
          r[2 * j + 1] = v.y;
        }
        const bool in_a = bary3(r, dx, dy, dz).inside;
        const bool in_b = bary3(r + 13, dx, dy, dz).inside;
""",
        """#pragma unroll
        for (int j = 0; j < 7; ++j) {   // probe: A's columns and its id
          const float2 v = __ldg(r2 + j);
          r[2 * j] = v.x;
          r[2 * j + 1] = v.y;
        }
        const bool in_a = bary3(r, dx, dy, dz).inside;
        bool in_b = false;
        if (!in_a) {                    // B's only where A misses
#pragma unroll
          for (int j = 7; j < 13; ++j) {
            const float2 v = __ldg(r2 + j);
            r[2 * j] = v.x;
            r[2 * j + 1] = v.y;
          }
          in_b = bary3(r + 13, dx, dy, dz).inside;
        }
""")],
}
PEEL_PROBES = ("probe peel only", "probe A first")

OCCUPANCY_QUERY = """
extern "C" int pp_walk_locate_3d_blocks_per_sm(void) {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, walk_locate_3d_kernel, 256, 0);
  return b;
}
"""


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"probe anchor found {text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text


@dataclasses.dataclass
class Version:
    name: str
    lib: object
    takes_ids: bool          # the table is the (n_cells, 2) i32 id pair
    report: str
    blocks_per_sm: int
    compared: str = "plain"  # "plain", "peel only" (its own plain version) or "not compared"
    peel_cases_only: bool = False


def ptxas_regs(report: str):
    """(registers, static shared bytes, spill bytes) of the report's first
    entry function."""
    f = cs.ptxas_functions(report)
    return (f[0].get("registers"), f[0].get("smem_bytes"), f[0].get("spill_bytes")) \
        if f else (None, None, None)


def build(text: str, name: str, **kw) -> Version:
    """Compile the source ``text`` with the package's flags into a library
    of its own (with the occupancy query appended where it lacks one)."""
    from pumipic_torch.kernels import _build

    out_dir = _build.BUILD_DIR / f"ab_{re.sub(r'[^A-Za-z0-9_]+', '_', name)}"
    out_dir.mkdir(parents=True, exist_ok=True)
    if "pp_walk_locate_3d_blocks_per_sm" not in text:
        text += OCCUPANCY_QUERY
    path = out_dir / "locate3d.cu"
    path.write_text(text)
    nvcc = _build.nvcc_path()
    obj = str(out_dir / "locate3d.o")
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                          str(path)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{res.stderr}")
    lib_path = out_dir / "lib.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), obj], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.pp_walk_locate_3d
    fn.argtypes = _build.SIGNATURES["pp_walk_locate_3d"]
    fn.restype = ctypes.c_int
    occ = lib.pp_walk_locate_3d_blocks_per_sm
    occ.argtypes, occ.restype = [], ctypes.c_int
    return Version(name, lib, "cell_ids" in text, f"{name}:\n{res.stderr}", occ(), **kw)


def launch(v: Version, walk_geom, dest, e0, act, grid, ids):
    """``v``'s kernel L3, launched as ``search.walk_locate_3d`` does."""
    from pumipic_torch.kernels import stream_handle

    n, E = dest.shape[0], walk_geom.shape[0]
    dev = dest.device
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    it0 = 0 if grid is None else 1
    oh = (ctypes.c_float * 6)(*((0.0,) * 6 if grid is None else (*grid.origin, *grid.inv_h)))
    nxyz = (1, 1, 1) if grid is None else (grid.nx, grid.ny, grid.nz)
    table = None if grid is None else (ids if v.takes_ids else grid.cell_rows)
    err = v.lib.pp_walk_locate_3d(
        P(dest.data_ptr()), P(e0.data_ptr()), P(act.data_ptr()), P(walk_geom.data_ptr()), E,
        P(None if table is None else table.data_ptr()), oh, *nxyz, MAX_ITERS, it0,
        P(elem.data_ptr()), P(out.data_ptr()), P(stats.data_ptr()), n, P(stream_handle()))
    if err:
        raise RuntimeError(f"{v.name} pp_walk_locate_3d: cudaError {err}")
    return elem, out, stats[0] + it0, stats[1] == 0, stats[1]


def peel_only_plain(grid, dest, e0, act):
    """Plain version of the peel-only probe: candidate A (or B where B
    alone contains the point) for every active particle, the peel's
    misses counted as deleted and none walked."""
    from pumipic_torch.ops import search as se

    e, inside = se._peel_3d(grid, *dest.unbind(1))
    elem = torch.where(act, e, -1)
    missed = (act & ~inside).sum().to(torch.int32)
    return elem, elem >= 0, torch.ones((), dtype=torch.int32, device=dest.device), \
        missed == 0, missed


def case(name: str, versions, mesh, dest, e0, act, grid, ids) -> dict:
    """Check, then time every applicable version in turns."""
    from pumipic_torch.ops import search as se

    wg = mesh.walk_geom
    peel = grid is not None
    vs = [v for v in versions if peel or not v.peel_cases_only]
    want = {"plain": se.walk_locate_3d_plain(wg, dest, e0, act, MAX_ITERS, grid)}
    if peel:
        want["peel only"] = peel_only_plain(grid, dest, e0, act)
    fns = {v.name: (lambda v=v: launch(v, wg, dest, e0, act, grid, ids)) for v in vs}
    for v in vs:
        if v.compared == "not compared":
            print(f"{name}: {v.name} timed only, its output not compared", flush=True)
        elif cs.mismatches(fns[v.name](), want[v.compared]):
            raise AssertionError(f"{name}: {v.name} differs from its plain version")
    extra = {}
    n_act = int(act.sum())
    if peel:
        inside = se._peel_3d(grid, *dest.unbind(1))[1]
        extra["walker_share"] = int((act & ~inside).sum()) / max(n_act, 1)
    order = list(fns)
    times = {v: [] for v in order}
    dev_times = {v: [] for v in order}
    for v in order + order[::-1]:
        times[v].append(cs.cuda_ms(fns[v], REPS))
        dev_times[v].append(cs.device_ms(fns[v], REPS))
    out = want["plain"][:2]
    rec = {"case": name, "particles": dest.shape[0], "active": n_act,
           "iters": int(want["plain"][2]), "unfinished": int(want["plain"][4]),
           "alive": int(want["plain"][1].sum()),
           "ms": {v: sum(t) / len(t) for v, t in times.items()},
           "device_ms": {v: sum(t) / len(t) for v, t in dev_times.items()},
           "ms_turns": times, "device_ms_turns": dev_times,
           "compared": {v.name: v.compared for v in vs},
           "bound_ms_rows": cs.locate3d_bytes(wg, dest, e0, act, out, grid,
                                              grid.cell_rows if peel else None)
           / cs.PEAK_BYTES_PER_S * 1e3,
           "bound_ms_ids": cs.locate3d_bytes(wg, dest, e0, act, out, grid,
                                             ids if peel else None)
           / cs.PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **extra}
    print(json.dumps(rec), flush=True)
    return rec


def walk_arm_targets(dev, n: int):
    """pseudoPushAndSearch's walk arm at ``n`` particles: the mesh, its
    grid, and the (dest, previous tet, active) of step 1 and of step 20."""
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import push as push_ops

    mesh = cs.pps3d_mesh(dev)
    cfg = pps.PushSearchConfig(num_ptcls=n, structure="dps", wall="periodic",
                               max_search_iters=MAX_ITERS, kuhn="off")
    app = pps.PseudoPushAndSearch(mesh, cfg, device=dev)

    def targets(ps):
        return (push_ops.push_and_wrap(ps.get("x"), app.step_vector, app.wrap),
                ps.elem.clone(), ps.active.clone())

    t1 = targets(app.ptcls)
    for _ in range(19):
        app.ptcls, _ = app.step_fn(app.ptcls)
    t20 = targets(app.ptcls)
    return mesh, app.locator, t1, t20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", help="directories of other versions, comma-separated")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=10_000_000)
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--probes", action="store_true",
                    help="probes of the first L3, edits of the first OTHER's source")
    ap.add_argument("--timed-only", default="",
                    help="directories of variants timed and not compared, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = args.num_ptcls
    smi = cs.smi_query("name,power.limit")
    print(f"card: {smi}", flush=True)

    def source(d):
        with open(os.path.join(d, "locate3d.cu")) as f:
            return f.read()

    def name(d):
        return os.path.basename(os.path.normpath(d))

    others = [d for d in args.others.split(",") if d]
    versions = [build(source(d), name(d)) for d in others]
    with open(os.path.join(ROOT, "pumipic_torch", "kernels", "csrc", "locate3d.cu")) as f:
        versions.append(build(f.read(), "new"))
    if args.probes:
        base = source(others[0])
        for probe, edits in PROBES.items():
            kw = {"peel_cases_only": probe in PEEL_PROBES}
            if probe == "probe peel only":
                kw["compared"] = "peel only"
            versions.append(build(edited(base, edits), probe, **kw))
    versions += [build(source(d), name(d), compared="not compared", peel_cases_only=True)
                 for d in args.timed_only.split(",") if d]
    for v in versions:
        print(v.report, flush=True)
        print(json.dumps({"version": v.name, "resident_blocks_per_sm": v.blocks_per_sm,
                          "ptxas": ptxas_regs(v.report), "compared": v.compared}), flush=True)
    dev = torch.device("cuda")
    mesh, grid, t1, t20 = walk_arm_targets(dev, n)
    ids = grid.candidate_ids(mesh.walk_geom)
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(3))
    tp = tuple(t[perm].contiguous() for t in t1)
    cases = [case("step 1, peel + walk", versions, mesh, *t1, grid, ids),
             case("step 20, peel + walk", versions, mesh, *t20, grid, ids),
             case("step 1, plain walk", versions, mesh, *t1, None, ids),
             case("step 1, random order, peel + walk", versions, mesh, *tp, grid, ids),
             case("step 1, random order, plain walk", versions, mesh, *tp, None, ids)]
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "reps": REPS,
                       "ptxas": {v.name: v.report for v in versions},
                       "resident_blocks_per_sm": {v.name: v.blocks_per_sm for v in versions},
                       "cases": cases}, f, indent=1)


if __name__ == "__main__":
    main()
