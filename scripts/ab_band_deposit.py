"""A/B of kernels B (flux-band cell id) and D (gyro-ring deposit) on one
CUDA GPU: this checkout's kernels against other versions' sources, on the
same inputs, in turns.

    python3 scripts/ab_band_deposit.py OTHER_CSRC[,OTHER_CSRC...] [num_ptcls] [OUT_JSON]

Each ``OTHER_CSRC`` holds another version's ``band.cu``, ``deposit.cu`` or
both (for example a parent commit's, written out with ``git show`` into a
git-ignored directory, or a variant of this checkout's source); its name
in the output is the directory's base name, this checkout's is ``new``.
Each is built with this checkout's nvcc flags into a library of its own.
Its ``pp_deposit_*`` must take this checkout's arguments
(``pumipic_torch/kernels/_build.py``, ``SIGNATURES``).  A ``band.cu``
that defines ``BandParams`` takes its launch parameters from the host, as
this checkout's does; one that does not takes the packed coefficients on
the device and the grid's shape as scalars (the earlier interface).

Inputs, at ``num_ptcls`` (default 10M) on the 120k mesh with bench_torch's
settings:

- B: the flux-band arm's pushed targets (``chip_smoke.py`` phase c's).
- D: both passes from the FULL-mode cartesian arm's counts after step 1
  and after step 20, and each pass alone at step 20; pass 1 from (E, R)
  counts: the (element, ring) counts of the step-20 particles with the
  per-particle gyro radii of the pprad arm's initial state.

Every variant's output must equal the plain version's.  Each variant is
timed twice (CUDA events, mean of ``REPS`` calls, with the host's share
and on the device alone), in the order others, new, new, others reversed.
Each case also gets its bound (bytes over 3.35 TB/s; B: f32 operations
over 67 TFLOP/s, and the floor of its uncontracted instruction stream) and
the time of one PyTorch call that computes it (D: ``torch.mv`` of a CSR
matrix, ``chip_smoke.gyro_composite`` and ``ring_incidence``).  For each
band.cu, the SASS of its kernels (``cuobjdump -sass`` on the object) is
counted by opcode class, in the whole function and in each loop (a range
that ends in a backward branch).  Prints the card, the builds' ptxas
reports, the SASS counts and one JSON line per case, and writes them all
to ``OUT_JSON`` where one is given.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (setup, timing and yardstick helpers)
from ab_gather_histogram import REPS, ab_case  # noqa: E402

P = ctypes.c_void_p
_I, _L, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the earlier kernel B interface: px py n cx cy coefs(device) K T J P rank
# n_inv newton cells stream
BAND_DEVICE_COEFS = [P, P, _L, _F, _F, P, _I, _I, _I, _I, _I, _I, _I, P, P]
# the deposit's pass 2 before the owner reduction's send rows
MAPPED_NO_SEND = [P, P, P, _I, _I, P, P]
SOURCES = ("band.cu", "deposit.cu")
SASS_CLASSES = {"FADD": "FADD/FMUL", "FMUL": "FADD/FMUL", "FFMA": "FFMA", "LDS": "LDS",
                "LDC": "LDC", "ULDC": "LDC", "MUFU": "MUFU"}


@dataclasses.dataclass
class Version:
    name: str
    lib: object
    band_host_params: Optional[bool]   # band.cu's interface (None: no band.cu)
    report: str
    sass: dict
    mapped_send: bool = False          # pp_deposit_mapped takes the send rows


def sass_counts(text: str) -> dict:
    """function -> {"all": {class: n}, "loops": [{"from", "to", class: n}]}
    for each kernel in ``cuobjdump -sass`` output; a loop is the range from
    a backward branch's target to the branch."""
    out, name, code = {}, None, []

    def close():
        if name is None:
            return
        counts = lambda rows: {c: sum(1 for _, k, _ in rows if k == c)  # noqa: E731
                               for c in sorted({k for _, k, _ in code})}
        loops = [{"from": hex(t), "to": hex(a), **counts([r for r in code if t <= r[0] <= a])}
                 for a, _, t in code if t is not None and t < a]
        out[name] = {"all": counts(code), "loops": loops}

    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            close()
            name, code = m.group(1), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(.*)",
                     line)
        if m and name is not None:
            op = m.group(2)
            target = None
            if op == "BRA":
                t = re.search(r"0x([0-9a-f]+)", m.group(4))
                target = int(t.group(1), 16) if t else None
            code.append((int(m.group(1), 16), SASS_CLASSES.get(op, "other"), target))
    close()
    return out


def build(csrc: str, name: str) -> Version:
    """Compile ``csrc``'s band.cu and deposit.cu (those it holds) with the
    package's flags into one library; counts the SASS of its band kernels."""
    from pumipic_torch.kernels import _build

    out_dir = _build.BUILD_DIR / f"ab_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    objs, report, sass, band_host, mapped_send = [], [], {}, None, False
    for src in SOURCES:
        path = os.path.join(csrc, src)
        if not os.path.exists(path):
            continue
        obj = str(out_dir / (src + ".o"))
        res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                              path], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {name} {src}:\n{res.stderr}")
        objs.append(obj)
        report.append(f"{name} {src}:\n{res.stderr}")
        if src == "deposit.cu":
            mapped_send = "send_row_of" in open(path).read()
        if src == "band.cu":
            band_host = "BandParams" in open(path).read()
            sass = sass_counts(subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                                              text=True, check=True).stdout)
    if not objs:
        raise RuntimeError(f"{csrc} holds neither of {SOURCES}")
    lib_path = out_dir / "lib.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = argtypes if fn_name != "pp_band_cell" or band_host \
                else BAND_DEVICE_COEFS
            if fn_name == "pp_deposit_mapped" and not mapped_send:
                fn.argtypes = MAPPED_NO_SEND
            fn.restype = ctypes.c_int
    return Version(name, lib, band_host, "\n".join(report), sass, mapped_send)


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: cudaError {err}")


def band_cell(v: Version, grid, px, py):
    """``v``'s kernel B, launched as ``locate.band_cell_of`` does."""
    from pumipic_torch.kernels import stream_handle

    n = px.shape[0]
    cells = torch.empty(n, dtype=torch.int32, device=px.device)
    if v.band_host_params:
        err = v.lib.pp_band_cell(P(px.data_ptr()), P(py.data_ptr()), n,
                                 grid.launch_params.ctypes.data_as(P),
                                 P(cells.data_ptr()), P(stream_handle()))
    else:
        packed = torch.cat([c.reshape(-1) for c in (grid.coef_v, grid.coef_u, grid.inv_coef)])
        err = v.lib.pp_band_cell(P(px.data_ptr()), P(py.data_ptr()), n, grid.cx, grid.cy,
                                 P(packed.data_ptr()), grid.n_bands, grid.n_theta,
                                 grid.n_harm, grid.n_cheb, grid.rank, grid.inv_coef.shape[0],
                                 grid.newton_iters, P(cells.data_ptr()), P(stream_handle()))
    check(err, f"{v.name} pp_band_cell")
    return cells


def deposit_rings(v: Version, counts, mesh, R: int):
    """``v``'s kernel D pass 1, launched as ``scatter.deposit_rings`` does."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import scatter as sc

    out = torch.empty(mesh.nverts, R, dtype=torch.float32, device=counts.device)
    args = [P(t.data_ptr()) for t in (counts, mesh.vert2elem_offsets, mesh.vert2elem_vals)]
    if counts.dim() == 2:
        err = v.lib.pp_deposit_rings_er(*args, mesh.nverts, R, P(out.data_ptr()),
                                        P(stream_handle()))
    else:
        err = v.lib.pp_deposit_rings(*args, mesh.nverts, R, *sc.ring_pair(R),
                                     P(out.data_ptr()), P(stream_handle()))
    check(err, f"{v.name} pp_deposit_rings")
    return out


def deposit_mapped(v: Version, ring, gmap, Pr: int):
    """``v``'s kernel D pass 2, launched as ``scatter.scatter_to_mapped_verts``
    does."""
    from pumipic_torch.kernels import stream_handle

    out = torch.empty(ring.shape[0], dtype=torch.float32, device=ring.device)
    rows = (P(None), P(None)) if v.mapped_send else ()
    check(v.lib.pp_deposit_mapped(P(ring.data_ptr()), P(gmap.offsets.data_ptr()),
                                  P(gmap.src.data_ptr()), ring.shape[0], Pr,
                                  P(out.data_ptr()), *rows, P(stream_handle())),
          f"{v.name} pp_deposit_mapped")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    other_dirs = [d for d in sys.argv[1].split(",") if d]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000_000
    import bench_torch
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc

    smi = cs.smi_query("name,power.limit")
    mhz = float(cs.smi_query("clocks.max.sm", units=False))
    print(f"card: {smi}; max SM clock {mhz:.0f} MHz", flush=True)
    versions = [build(d, os.path.basename(os.path.normpath(d))) for d in other_dirs]
    versions.append(build(os.path.join(ROOT, "pumipic_torch", "kernels", "csrc"), "new"))
    for v in versions:
        print(v.report, flush=True)
        for fn, rec in v.sass.items():
            print(json.dumps({"version": v.name, "function": fn, **rec}), flush=True)
    dev = torch.device("cuda")
    cases = []

    # D: the FULL-mode cartesian arm's counts after steps 1 and 20
    mesh, state, step, _ = bench_torch.setup(dev, n, mesh_path=cs.MESH)
    model = step.model
    cfg = cs._cfg(px, mesh)
    R, Pr = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    gmap = model.gyro_fwd
    E = mesh.nelems
    located = {}
    for i in range(1, 21):
        state, _ = step(state)
        if i in (1, 20):
            located[i] = (state["elem"].clone(), state["active"].clone())
    del state
    composite = cs.gyro_composite(mesh, gmap, R, Pr, dev)
    dep = [v for v in versions if hasattr(v.lib, "pp_deposit_mapped")]
    for i in (1, 20):
        counts = sc.histogram(*located[i], E)
        ring = sc.deposit_rings(counts, mesh, R)
        cf = counts.to(torch.float32)
        nb = cs.nbytes(counts, mesh.vert2elem_offsets, mesh.vert2elem_vals, gmap.offsets,
                       gmap.src) + 4 * mesh.nverts * (R + 1)
        cases.append(ab_case(
            f"D both passes, FULL cartesian step-{i} counts",
            {v.name: (lambda v=v: deposit_mapped(v, deposit_rings(v, counts, mesh, R),
                                                 gmap, Pr)) for v in dep},
            lambda: sc.mapped_plain(sc.ring_accum_plain(counts, mesh, R), gmap,
                                    mesh.nverts, R, Pr),
            nb, lambda: torch.mv(composite, cf), {"kernel": "D", "V": mesh.nverts,
                                                   "map_entries": gmap.src.shape[0]}))
    cases.append(ab_case(
        "D pass 1 from (E,) counts, step 20",
        {v.name: (lambda v=v: deposit_rings(v, counts, mesh, R)) for v in dep},
        lambda: sc.ring_accum_plain(counts, mesh, R),
        cs.nbytes(counts, mesh.vert2elem_offsets, mesh.vert2elem_vals, ring), None,
        {"kernel": "D"}))
    cases.append(ab_case(
        "D pass 2 (gyro map), step 20",
        {v.name: (lambda v=v: deposit_mapped(v, ring, gmap, Pr)) for v in dep},
        lambda: sc.mapped_plain(ring, gmap, mesh.nverts, R, Pr),
        cs.nbytes(ring, gmap.offsets, gmap.src) + 4 * mesh.nverts, None, {"kernel": "D"}))
    del composite

    # D pass 1 from (E, R): the step-20 particles' (element, ring) counts
    gyro = px.GyroConfig(per_particle_radius=True)
    rg = px.initial_state(mesh, dataclasses.replace(cfg, num_ptcls=n, gyro=gyro),
                          device=dev)["rg"]
    er = sc.histogram(*located[20], E, rg, gyro.num_rings, gyro.rmax).view(E, gyro.num_rings)
    incidence = cs.ring_incidence(mesh, gyro.num_rings, dev)
    erf = er.reshape(-1).to(torch.float32)
    cases.append(ab_case(
        "D pass 1 from (E, R) counts, step 20",
        {v.name: (lambda v=v: deposit_rings(v, er, mesh, gyro.num_rings)) for v in dep},
        lambda: sc.ring_accum_plain(er, mesh, gyro.num_rings),
        cs.nbytes(er, mesh.vert2elem_offsets, mesh.vert2elem_vals) + 4 * E * gyro.num_rings,
        lambda: torch.mv(incidence, erf), {"kernel": "D"}))
    del located, rg, er, incidence, model, step
    torch.cuda.empty_cache()

    # B: the flux-band arm's pushed targets
    cfg = cs._cfg(px, mesh, band_locator="force")
    s, bstep = px.make_dp_setup(mesh, dataclasses.replace(cfg, num_ptcls=n), dev)
    grid = bstep.model.locator
    tx, ty, _, _ = cs._push(push_ops, s, bstep.model, cfg)
    del s
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = 1450.0 * tx.shape[0]
    cases.append(ab_case(
        "B, flux-band arm pushed targets",
        {v.name: (lambda v=v: band_cell(v, grid, tx, ty))
         for v in versions if v.band_host_params is not None},
        lambda: lo.band_cell_of_plain(grid, tx, ty), 12 * tx.shape[0], None,
        {"kernel": "B", "points": tx.shape[0],
         "bound_ms": ops / cs.PEAK_F32_OPS_PER_S * 1e3, "bound_by": "operations",
         "uncontracted_floor_ms": ops / (sms * 128 * mhz * 1e6) * 1e3}))

    if len(sys.argv) > 3:
        with open(sys.argv[3], "w") as f:
            json.dump({"card": smi, "max_sm_clock_mhz": mhz, "reps": REPS,
                       "ptxas": {v.name: v.report for v in versions},
                       "sass": {v.name: v.sass for v in versions}, "cases": cases}, f,
                      indent=1)


if __name__ == "__main__":
    main()
