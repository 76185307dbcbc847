"""A/B of kernels R (grid E + Boris push) and M (the 3D walk modes) on one
CUDA GPU: this checkout's ``boris.cu`` and ``trace3d.cu`` against other
versions' and against probes of the first versions, on the same inputs, in
turns.

    python3 scripts/ab_boris_trace3d.py OTHER[,OTHER...] [num_ptcls] [OUT_JSON]
        [--probes] [--variants NAME=FLAGS[;NAME=FLAGS...]]

Each ``OTHER`` is a directory holding another version's ``boris.cu`` and
``trace3d.cu`` (for example a parent commit's, written out with ``git
show`` into a git-ignored directory such as ``chip_tree/``); its name in the
output is the directory's base name.  This checkout's own build is ``new``;
``--variants`` adds builds of this checkout's sources with extra nvcc flags
(``NAME=FLAGS``, the flags space-separated, e.g. a ``-D`` that a source
reads).  Every build uses the package's nvcc flags.  Interfaces: a ``trace3d.cu`` whose
``pp_trace_3d`` takes ``normals`` gets the mesh's reflect normal table
(``search.reflect_normals``), an earlier one ``face2verts``; a ``boris.cu``
that reads ``grid_corner_rows`` gets the grid's corner table, an earlier one
the grid; every version gets the 13 parameters (an earlier one reads the
first 12).  A
``trace3d.cu`` without ``pp_trace_3d_blocks_per_sm`` is built with that
occupancy query appended (its kernel is unchanged).

``--probes`` builds, from the first ``OTHER``'s sources, which must be the
first R and M (one thread per particle; ``git show 4dd205b:pumipic_torch/
kernels/csrc/boris.cu``, and ``trace3d.cu``), probes, each that source with
one edit of ``PROBES`` (text replaced at anchors that must each occur
once); that ``OTHER``, built unedited, is their baseline:

- ``M select``: the neighbour picked by a select chain over the row's
  registers in place of an index by the exit face (no stack frame);
- ``M resident grid``: the grid capped at the blocks resident at once, a
  grid-stride loop over the particles;
- ``M launch_bounds(128, 8)``: registers capped so that 8 blocks fit;
- ``M first step only``: every walker stops after its first step (deleted,
  or recovered with ``recover``): the least time any walk can take, timed
  and not compared (another function);
- ``R corner rows``: the 8 corners read as six 16-byte loads of the cell's
  row of ``grid_corner_rows``;
- ``R staged streams``: x and v staged through shared memory with 16-byte
  loads, x' and v' stored the same way.

Every other version is compared with the plain version
(``trace_3d_plain``, ``boris_push_grid_plain``) and must equal it bit for
bit.  Cases, at ``num_ptcls`` (default 10M): R on the GITR-style app's
seeded state (the 32^3 box, its (33, 33, 33, 3) E grid); M on R's targets
from the seeded tets, in each core with reflect and with remove, each with
``record_exit`` (the gitr step: intersection); on far targets (random
points of the box, 200 steps); at a budget of 2 with
``recover="project"``; and M's peel form (BCC, reflect) on
pseudoPushAndSearch's reflect arm's first targets (the 16^3 box, the
cpe-16 grid).  Each applicable version is timed on the device alone
(``chip_smoke.device_ms``, the mean of ``REPS`` calls) in turns, in the
order built and then reversed, beside the bound ``chip_smoke.py`` gives
the case.  Prints the card, each build's ptxas report (registers, stack,
shared memory and spills of each entry function), its resident blocks per
SM for each M template the cases run, and one JSON line per case; writes
them all to ``OUT_JSON`` where one is given.
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

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (setup, timing and bound helpers)

REPS = 20
P = ctypes.c_void_p
SOURCES = ("boris.cu", "trace3d.cu")

# probe name -> (source file, [(anchor, replacement), ...]) edits of the
# first R and M
PROBES = {
    "M select": ("trace3d.cu", [(
        "        const int nxt = (int)g[NB + c.k];\n",
        "        const int nxt = (int)(c.k == 0 ? g[NB] : c.k == 1 ? g[NB + 1]  // probe\n"
        "                              : c.k == 2 ? g[NB + 2] : g[NB + 3]);\n")]),
    "M resident grid": ("trace3d.cu", [
        ("  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  int my_steps = 0, my_unf = 0, my_rec = 0;\n"
         "  if (i < a.n) {\n",
         "  int my_steps = 0, my_unf = 0, my_rec = 0;\n"
         "  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;\n"
         "       i += (long long)gridDim.x * blockDim.x) {   // probe: grid-stride\n"),
        ("      my_steps = steps;\n", "      my_steps = max(my_steps, steps);\n"),
        ("        my_rec = 1;\n", "        ++my_rec;\n"),
        ("        my_unf = 1;\n", "        ++my_unf;\n"),
        ("template <int CORE>\nstatic void launch_core(",
         "template <typename K>\n"
         "static unsigned resident_wave(K kernel, unsigned blocks) {   // probe\n"
         "  int b = 0, sms = 0, dev = 0;\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, M_THREADS, 0);\n"
         "  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         "  const unsigned wave = (unsigned)(b * sms);\n"
         "  return blocks < wave ? blocks : wave;\n"
         "}\n\n"
         "template <int CORE>\nstatic void launch_core("),
        *[(f"    trace_3d_kernel<CORE, {r}, {c}><<<blocks, M_THREADS, 0, stream>>>(a);\n",
           f"    trace_3d_kernel<CORE, {r}, {c}><<<resident_wave(trace_3d_kernel<CORE, {r}, "
           f"{c}>, blocks), M_THREADS, 0, stream>>>(a);\n")
          for r, c in (("true", "true"), ("true", "false"), ("false", "true"),
                       ("false", "false"))]]),
    "M launch_bounds(128, 8)": ("trace3d.cu", [(
        "__global__ void __launch_bounds__(M_THREADS) trace_3d_kernel",
        "__global__ void __launch_bounds__(M_THREADS, 8) trace_3d_kernel")]),
    "M first step only": ("trace3d.cu", [(
        "      while (!done && steps < a.budget) {\n",
        "      while (!done && steps < min(a.budget, 1)) {   // probe\n")]),
    "R corner rows": ("boris.cu", [(
        """  float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int di = 0; di < 2; ++di)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float w = (di ? f[0] : 1.0f - f[0]) * (dj ? f[1] : 1.0f - f[1]) *
                        (dk ? f[2] : 1.0f - f[2]);
        const float* g = grid + 3 * ((size_t)((idx[0] + di) * ny + idx[1] + dj) * nz +
                                     idx[2] + dk);
#pragma unroll
        for (int c = 0; c < 3; ++c) e[c] = e[c] + __ldg(g + c) * w;
      }
""",
        """  // probe: grid is the cell-major grid_corner_rows table
  const float4* row = reinterpret_cast<const float4*>(grid) +
                      8 * ((size_t)(idx[0] * (ny - 1) + idx[1]) * (nz - 1) + idx[2]);
  float g[24];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float4 q = __ldg(row + j);
    g[4 * j] = q.x;
    g[4 * j + 1] = q.y;
    g[4 * j + 2] = q.z;
    g[4 * j + 3] = q.w;
  }
  float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int di = m >> 2, dj = (m >> 1) & 1, dk = m & 1;
    const float w = (di ? f[0] : 1.0f - f[0]) * (dj ? f[1] : 1.0f - f[1]) *
                    (dk ? f[2] : 1.0f - f[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) e[c] = e[c] + g[3 * m + c] * w;
  }
""")]),
    "R staged streams": ("boris.cu", [
        ("__global__ void __launch_bounds__(R_THREADS) boris_grid_kernel(",
         """// probe: cnt floats between global and shared memory, 16-byte accesses
// where the global pointer is 16-byte aligned, the ragged end one by one
__device__ __forceinline__ void stage_in(const float* src, float* dst, int cnt) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int j = threadIdx.x; j < cnt / 4; j += R_THREADS)
      reinterpret_cast<float4*>(dst)[j] = __ldcs(reinterpret_cast<const float4*>(src) + j);
    done = cnt & ~3;
  }
  for (int j = done + threadIdx.x; j < cnt; j += R_THREADS) dst[j] = __ldcs(src + j);
}
__device__ __forceinline__ void stage_out(const float* src, float* dst, int cnt) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int j = threadIdx.x; j < cnt / 4; j += R_THREADS)
      __stcs(reinterpret_cast<float4*>(dst) + j, reinterpret_cast<const float4*>(src)[j]);
    done = cnt & ~3;
  }
  for (int j = done + threadIdx.x; j < cnt; j += R_THREADS) __stcs(dst + j, src[j]);
}

__global__ void __launch_bounds__(R_THREADS) boris_grid_kernel("""),
        ("""  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float xi[3], vi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = x[3 * i + c];
    vi[c] = v[3 * i + c];
  }
""",
         """  __shared__ __align__(16) float sx[3 * R_THREADS];
  __shared__ __align__(16) float sv[3 * R_THREADS];
  const long long first = (long long)blockIdx.x * R_THREADS;
  const int cnt = (int)min((long long)R_THREADS, n - first);
  stage_in(x + 3 * first, sx, 3 * cnt);
  stage_in(v + 3 * first, sv, 3 * cnt);
  __syncthreads();
  const int t = threadIdx.x;
  float xi[3], vi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = t < cnt ? sx[3 * t + c] : 0.0f;
    vi[c] = t < cnt ? sv[3 * t + c] : 0.0f;
  }
"""),
        ("""    const float vn = vm[c] + coeff * cr[c] + qe[c];
    v_out[3 * i + c] = vn;
    x_out[3 * i + c] = xi[c] + vn * p.dt;
  }
}
""",
         """    const float vn = vm[c] + coeff * cr[c] + qe[c];
    if (t < cnt) {
      sv[3 * t + c] = vn;
      sx[3 * t + c] = xi[c] + vn * p.dt;
    }
  }
  __syncthreads();
  stage_out(sx, x_out + 3 * first, 3 * cnt);
  stage_out(sv, v_out + 3 * first, 3 * cnt);
}
""")]),
}
TIMED_ONLY = ("M first step only",)

# resident blocks per SM of each template, appended to a trace3d.cu without
# the query (the kernel template trace_3d_kernel<CORE, REFLECT, RECORD>)
OCCUPANCY_QUERY = """
extern "C" int pp_trace_3d_blocks_per_sm(int core, int reflect, int record) {
  int b = 0;
#define PP_Q(C, R, D)                                                          \\
  if (core == C && reflect == R && record == D)                                \\
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, trace_3d_kernel<C, R, D>, \\
                                                  M_THREADS, 0);
  PP_Q(0, false, false) PP_Q(0, false, true) PP_Q(0, true, false) PP_Q(0, true, true)
  PP_Q(1, false, false) PP_Q(1, false, true) PP_Q(1, true, false) PP_Q(1, true, true)
  PP_Q(2, false, false) PP_Q(2, false, true) PP_Q(2, true, false) PP_Q(2, true, true)
  return b;
}
"""
CORES = {"bcc": 0, "hybrid": 1, "intersection": 2}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"probe anchor found {text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text


@dataclasses.dataclass
class Version:
    name: str
    texts: dict                 # source file -> text (the sources it has)
    flags: tuple = ()
    compared: bool = True       # False: computes another function, timed only
    lib: object = None
    report: str = ""

    @property
    def has_m(self) -> bool:
        return "trace3d.cu" in self.texts

    @property
    def has_r(self) -> bool:
        return "boris.cu" in self.texts

    @property
    def m_takes_normals(self) -> bool:
        return "normals" in self.texts.get("trace3d.cu", "")

    @property
    def r_takes_rows(self) -> bool:
        return "grid_corner_rows" in self.texts.get("boris.cu", "")


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
            if fname == "trace3d.cu" and "pp_trace_3d_blocks_per_sm" not in text:
                text += OCCUPANCY_QUERY
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
        names = (["pp_trace_3d", "pp_trace_3d_blocks_per_sm"] if v.has_m else []) + \
            (["pp_boris_grid"] if v.has_r else [])
        for name in names:
            fn = getattr(v.lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int


def ptxas_table(report: str) -> list:
    """Each entry function of the report: name, registers, stack, shared
    memory and spills."""
    return cs.ptxas_functions(report)


def launch_m(v: Version, mesh, orig, dest, e0, act, max_iters, method, handler,
             record, recover, grid):
    """``v``'s kernel M, launched as ``search.trace_3d`` does; returns
    (elem, active, iters, all_found, dest, exit_side, num_hits, hit,
    num_recovered)."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import search as se

    n, dev = dest.shape[0], dest.device
    reflect = handler is se.reflect_on_exit_3d
    table = mesh.walk_planes if method == "intersection" else mesh.walk_geom
    third = (se.reflect_normals(mesh) if reflect else None) if v.m_takes_normals \
        else mesh.face2verts
    ids = None if grid is None else grid.candidate_ids(mesh.walk_geom)
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    new_dest = torch.empty_like(dest) if (reflect or recover == "project") else None
    rec = (torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty_like(dest)) if record else (None, None, None)
    it0 = 0 if grid is None else 1
    oh = (ctypes.c_float * 6)(*((0.0,) * 6 if grid is None else (*grid.origin, *grid.inv_h)))
    nxyz = (1, 1, 1) if grid is None else (grid.nx, grid.ny, grid.nz)

    def ptr(t):
        return P(None if t is None else t.data_ptr())

    err = v.lib.pp_trace_3d(
        ptr(orig), ptr(dest), ptr(e0), ptr(act), ptr(table), ptr(mesh.walk_geom),
        ptr(mesh.elem2faces), ptr(third), ptr(mesh.coords), ptr(mesh.elem2verts),
        mesh.nelems, ptr(ids), oh, *nxyz, max_iters, it0, CORES[method], int(reflect),
        int(record), int(recover == "project"), ptr(elem), ptr(out), ptr(new_dest),
        *(ptr(t) for t in rec), ptr(stats), n, P(stream_handle()))
    if err:
        raise RuntimeError(f"{v.name} pp_trace_3d: cudaError {err}")
    return (elem, out, stats[0] + it0, stats[1] == 0,
            dest if new_dest is None else new_dest, *(t for t in rec if t is not None),
            *((stats[2],) if recover == "project" else ()))


def plain_m(mesh, orig, dest, e0, act, max_iters, method, handler, record, recover, grid):
    """The plain version's result in :func:`launch_m`'s field order."""
    from pumipic_torch.ops import search as se

    r = se.trace_3d_plain(mesh, orig, dest, e0, act, max_iters, method, handler, record,
                          recover, grid)
    out = [r.elem_ids, r.active, r.iters, r.all_found, r.dest]
    if record:
        out += [r.exit_side, r.num_hits, r.hit]
    if recover == "project":
        out.append(r.num_recovered)
    return tuple(out)


def launch_r(v: Version, x, vel, e_grid, rows, params, n_xyz):
    from pumipic_torch.kernels import stream_handle

    x_out, v_out = torch.empty_like(x), torch.empty_like(vel)
    table = rows if v.r_takes_rows else e_grid
    err = v.lib.pp_boris_grid(P(x.data_ptr()), P(vel.data_ptr()), P(table.data_ptr()),
                              *n_xyz, params, P(x_out.data_ptr()), P(v_out.data_ptr()),
                              x.shape[0], P(stream_handle()))
    if err:
        raise RuntimeError(f"{v.name} pp_boris_grid: cudaError {err}")
    return x_out, v_out


def same(a, b) -> bool:
    """Equal values, NaN where the other is NaN."""
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def timed_case(name: str, fns: dict, want, compared: dict, bound_ms: float,
               extra: dict, timer) -> dict:
    """Check each compared version against ``want``, then time all in
    turns (the order given, then reversed)."""
    for vname, fn in fns.items():
        if not compared[vname]:
            print(f"{name}: {vname} timed only, its output not compared", flush=True)
            continue
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


def gitr_setup(dev, n: int):
    """The GITR-style app's mesh and seeded state at ``n`` particles, as
    chip_smoke's phase c builds them."""
    import bench_torch
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models.gitr_like import GitrConfig, GitrLike

    n_side = int(round((cs.GITR_ELEMS / 6) ** (1.0 / 3.0)))
    mesh = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=dev)
    grid, o, h = bench_torch.gitr_field(n_side)
    cfg = GitrConfig(num_ptcls=n, dt=bench_torch.GITR_DT, b_field=bench_torch.GITR_B,
                     wall="reflect", max_search_iters=100)
    return mesh, cfg, GitrLike(mesh, cfg, grid, o, h, seed=0, device=dev)


def peel_setup(dev, n: int):
    """pseudoPushAndSearch's reflect arm: the mesh, the cpe-16 grid and the
    first pushed targets (no wrap) of its ``n`` seeded particles."""
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import push as push_ops

    mesh = cs.pps3d_mesh(dev)
    cfg = pps.PushSearchConfig(num_ptcls=n, structure="dps", wall="reflect",
                               max_search_iters=64, kuhn="off")
    app = pps.PseudoPushAndSearch(mesh, cfg, device=dev)
    ps = app.ptcls
    x = ps.get("x").contiguous()
    d = np.asarray(cfg.push_dir, np.float64)
    step = push_ops.step_vector((d / np.linalg.norm(d)).astype(np.float32), cfg.distance)
    return mesh, app.locator, x, push_ops.push_and_wrap(x, step), ps.elem.clone(), \
        ps.active.clone(), cfg.max_search_iters


def run(versions, n: int, dev, timer) -> list:
    """Every case on ``versions`` (built); returns the case records."""
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    cases = []
    mesh, cfg, app = gitr_setup(dev, n)
    s = app.state
    compared = {v.name: v.compared for v in versions}
    # R: the step's field and push
    rs = [v for v in versions if v.has_r]
    rows = push_ops.grid_corner_rows(app.e_grid)
    qp, two_qp = push_ops.boris_factors(cfg.dt, cfg.charge, cfg.amu)
    o, h, bv = (push_ops._vec3(a) for a in (app.e_origin, app.e_spacing, app.b_field))
    params = (ctypes.c_float * 13)(*o, *h, *bv, qp, two_qp, float(np.float32(cfg.dt)),
                                   push_ops.boris_coeff(bv, qp, two_qp))
    rargs = (s["x"], s["v"], app.e_grid, rows, params, tuple(app.e_grid.shape[:3]))
    want_r = push_ops.boris_push_grid_plain(s["x"], s["v"], app.e_grid, app.e_origin,
                                            app.e_spacing, app.b_field, cfg.dt, cfg.charge,
                                            cfg.amu)
    cases.append(timed_case(
        f"R grid E + Boris push ({n} particles, {tuple(app.e_grid.shape)} grid)",
        {v.name: (lambda v=v: launch_r(v, *rargs)) for v in rs}, want_r,
        {v.name: compared[v.name] for v in rs},
        cs.nbytes(s["x"], s["v"], app.e_grid, *want_r) / cs.PEAK_BYTES_PER_S * 1e3,
        {"particles": n}, timer))
    x_new = want_r[0]
    del want_r, rows
    ms = [v for v in versions if v.has_m]

    def m_case(name, mesh, args, grid=None):
        method, handler, record, recover = args[5:9]
        want = plain_m(mesh, *args, grid)
        hits = int((want[6] > 0).sum()) if record else None
        extra = {"particles": args[1].shape[0], "iters": int(want[2]),
                 "alive": int(want[1].sum()), "walkers_hit_wall": hits,
                 "resident_blocks_per_sm": {
                     v.name: v.lib.pp_trace_3d_blocks_per_sm(
                         CORES[method], int(handler is se.reflect_on_exit_3d), int(record))
                     for v in ms}}
        bound = cs.trace3d_bytes(mesh, method, handler, record, recover, grid,
                                 int(args[3].sum()), args[1].shape[0])
        fns = {v.name: (lambda v=v: launch_m(v, mesh, *args, grid)) for v in ms}
        cases.append(timed_case(name, fns, want, {v.name: compared[v.name] for v in ms},
                                bound / cs.PEAK_BYTES_PER_S * 1e3, extra, timer))

    for method in ("intersection", "bcc", "hybrid"):
        for hname, handler in (("reflect", se.reflect_on_exit_3d),
                               ("remove", se.remove_on_exit)):
            m_case(f"M {method} {hname} record_exit (gitr step 1)", mesh,
                   (s["x"], x_new, s["elem"], s["active"], cfg.max_search_iters, method,
                    handler, True, "off"))
    g = torch.Generator(device=dev).manual_seed(5)
    far = torch.rand(n, 3, device=dev, generator=g)
    m_case("M intersection reflect record_exit, far targets", mesh,
           (s["x"], far, s["elem"], s["active"], 200, "intersection",
            se.reflect_on_exit_3d, True, "off"))
    del far
    m_case("M intersection reflect record_exit recover, budget 2", mesh,
           (s["x"], x_new, s["elem"], s["active"], 2, "intersection",
            se.reflect_on_exit_3d, True, "project"))
    del app, s, x_new
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pmesh, grid, x, xt, e0, act, max_iters = peel_setup(dev, n)
    m_case("M peel + bcc reflect (pps3d-dps-reflect step 1)", pmesh,
           (x, xt, e0, act, max_iters, "bcc", se.reflect_on_exit_3d, False, "off"), grid)
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
                                    compared=probe not in TIMED_ONLY))
    return versions


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", help="directories of other versions, comma-separated")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=10_000_000)
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--probes", action="store_true",
                    help="probes of the first R and M, edits of the first OTHER's sources")
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
                          "ptxas": ptxas_table(v.report)}), flush=True)
    cases = run(versions, args.num_ptcls, torch.device("cuda"), cs.device_ms)
    for c in cases:                       # a summary: ms, share of the bound
        print(f"{c['case']}: bound {c['bound_ms']:.4f} ms", flush=True)
        for vname, ms in c["device_ms"].items():
            blocks = c.get("resident_blocks_per_sm", {}).get(vname, "")
            print(f"  {vname:28s} {ms:9.4f} ms  {c['bound_ms'] / ms:6.1%}  {blocks}",
                  flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "reps": REPS,
                       "ptxas": {v.name: ptxas_table(v.report) for v in versions},
                       "cases": cases}, f, indent=1)


if __name__ == "__main__":
    main()
