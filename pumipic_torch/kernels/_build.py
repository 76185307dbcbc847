"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds); ``csrc/*.cuh``
holds device code that two sources share.  Each source compiles in its
own nvcc process, all started together, and one more nvcc links the
objects.  The library is built on first use into ``kernels/_build/``
(ignored by git), named by a hash of the sources, headers and flags, so a
changed source rebuilds and an unchanged one loads the cached file.

Flags: ``-fmad=false`` keeps every kernel equal to its plain PyTorch
version element for element (a contracted a*b+c rounds once, the plain
version twice, and a moved rounding moves a containment test at a shared
side); ``-ftz=false -prec-div=true -prec-sqrt=true`` and no
``--use_fast_math`` keep denormals and IEEE division.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# compile flags of every source; the link adds -shared
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "-fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the exported launchers (each returns cudaGetLastError())
SIGNATURES = {
    "pp_push_banded": [
        _P, _P, _P, _P, _P, _P, _P,          # x0 x1 cphi sphi b elem active
        _P, _I, _P, _P,                      # starts n_starts cd_tab sd_tab
        _F, _F, _F,                          # h k d
        _P, _P, _P, _P,                      # tx ty cphi_out sphi_out
        _L, _P],                             # n stream
    "pp_push_table": [
        _P, _P, _P, _P, _P, _P, _P,          # x0 x1 cphi sphi b elem active
        _P, _I, _F, _F, _F,                  # table n_rows h k d
        _P, _P, _P, _P,                      # tx ty cphi_out sphi_out
        _L, _P],                             # n stream
    "pp_push_phi": [
        _P, _P, _P, _P, _P,                  # xy phi b active cls
        _P, _I, _I, _I,                      # starts n_starts v0 band_form
        _F, _F, _F, _F,                      # deg h k d
        _P, _P, _P, _P,                      # tx ty xy_out phi_out
        _L, _P],                             # n stream
    "pp_walk_locate": [
        _P, _P, _P, _P,                      # dest_x dest_y elem_start active
        _P, _I,                              # walk_geom n_elems
        _P, _P,                              # cell_rows cells
        _F, _F, _F, _F, _I, _I,              # ox oy ihx ihy nx ny
        _I, _I,                              # max_iters it0
        _P, _P, _P,                          # elem_out active_out stats
        _L, _P],                             # n stream
    "pp_walk_dense": [
        _P, _P, _P, _P,                      # dest_x dest_y elem_start active
        _P, _I, _I,                          # walk_geom n_elems max_iters
        _P, _P, _P, _L, _P],                 # elem_out active_out stats n stream
    "pp_slot_counts": [
        _P, _P, _P, _P, _P,                  # terms kinds n_slots outs subs (host arrays)
        _I, _P, _P],                         # n_counts acc stream
    "pp_rank_stats": [_P, _I, _I, _I, _P, _P],   # g R W max_col out stream
    "pp_walk_plain": [
        _P, _L, _P, _L,                      # dest_x stride_x dest_y stride_y
        _P, _P, _P, _I, _I,                  # elem_start walkers walk_geom n_elems max_iters
        _P, _P, _I, _L, _P],                 # elem_out stats zero_stats n stream
    "pp_check_parents": [
        _I, _P, _P, _P, _P,                  # dim elem_init active origin[3] strides[3]
        _P, _I, _I,                          # walk_geom row_w n_elems
        _P, _P, _P, _L, _P],                 # elem_out bad_out stats n stream
    "pp_kuhn_push_locate": [
        _P, _P, _L, _I, _I,                  # x active n push wrap
        _P, _P, _I, _I, _I, _P,              # s|lo|ext origin|inv_h nx ny nz tol
        _P, _P, _P, _P],                     # perm x_out elem_out stream
    "pp_push_wrap": [_P, _L, _I, _I, _P, _P, _P],  # x n push wrap s|lo|ext x_out stream
    "pp_walk_locate_3d": [
        _P, _P, _P,                          # dest (N, 3) elem_start active
        _P, _I,                              # walk_geom n_elems
        _P, _P, _I, _I, _I,                  # cell_ids origin|inv_h nx ny nz
        _I, _I,                              # max_iters it0
        _P, _P, _P,                          # elem_out active_out stats
        _L, _P],                             # n stream
    "pp_walk_locate_3d_blocks_per_sm": [],
    "pp_walk_plain_3d": [
        _P, _L, _P, _L, _P, _L,              # dest x|y|z and their strides
        _P, _P, _P, _I, _I,                  # elem_start walkers walk_geom n_elems max_iters
        _P, _P, _L, _P],                     # elem_out stats n stream
    "pp_trace_3d": [
        _P, _P, _P, _P,                      # orig dest elem_start active
        _P, _P,                              # walk table (geom|planes) walk_geom
        _P, _P, _P, _P, _I,                  # elem2faces normals coords elem2verts n_elems
        _P, _P, _I, _I, _I,                  # cell_ids origin|inv_h nx ny nz
        _I, _I, _I, _I, _I, _I,              # max_iters it0 core reflect record recover
        _P, _P, _P,                          # elem_out active_out dest_out
        _P, _P, _P, _P,                      # exit_side num_hits hit_out stats
        _L, _P],                             # n stream
    "pp_trace_3d_blocks_per_sm": [_I, _I, _I],   # core reflect record
    "pp_trace_2d": [
        _P, _P, _P, _P,                      # orig dest elem_start active
        _P, _I,                              # walk_geom n_elems
        _P, _P, _P,                          # tangents coords elem2verts
        _P, _P, _F, _F, _F, _F, _I, _I,      # cell_rows cells ox oy ihx ihy nx ny
        _I, _I, _I, _I, _I,                  # max_iters it0 reflect record recover
        _P, _P, _P,                          # elem_out active_out dest_out
        _P, _P, _P, _P,                      # exit_side num_hits hit_out stats
        _L, _P],                             # n stream
    "pp_trace_2d_blocks_per_sm": [_I, _I],       # reflect record
    "pp_vdeposit": [
        _P, _P, _P, _P, _P,                  # w q elem active elem2verts
        _I, _I, _I, _I,                      # k n_elems n_out log2_terms
        _P, _P, _P, _P,                      # acc flags max_bits out
        _L, _P],                             # n stream
    "pp_boris_grid": [
        _P, _P, _P, _I, _I, _I,              # x v corner_rows nx ny nz
        _P, _P, _P, _L, _P],                 # params(host) x_out v_out n stream
    "pp_band_cell": [_P, _P, _L, _P, _P, _P],  # px py n params(host) cells stream
    "pp_annulus_locate": [
        _P, _P, _P, _L,                      # px py active n
        _F, _F, _F, _F, _F, _F,              # cx cy theta0 two_pi dth m
        _F, _F, _F, _F, _I, _I,              # r_in dr lo hi n_rings n_sectors
        _P, _P, _P, _P, _P],                 # table perm elem_out active_out stream
    "pp_histogram": [_P, _P, _I, _P, _L, _P],
    "pp_wall_tally": [_P, _P, _P, _I, _P, _L, _P],  # side mask weight n_faces counts n stream
    "pp_histogram_rings": [_P, _P, _P, _F, _I, _I, _P, _L, _P],
    "pp_deposit_rings": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "pp_deposit_rings_er": [_P, _P, _P, _I, _I, _P, _P],
    "pp_deposit_mapped": [_P, _P, _P, _I, _I, _P, _P, _P, _P],  # ... out send_row_of send stream
    "pp_row_gather": [_P, _L, _I, _P, _P, _P, _P],  # idx n_rows n_arrays srcs dsts widths stream
    "pp_rank_in_key": [_P, _L, _I, _P, _P, _P, _P],  # key n n_keys rank counts scratch stream
    "pp_rank_in_key_scratch": [_L, _I, _I],   # n n_keys ranked
    "pp_pack_send": [
        _P, _P, _L, _I, _P, _I, _P,          # key rank n n_buckets quota cap offsets
        _P, _P, _I, _P, _P, _P,              # new_elem elem_gid n_fields srcs lanes is_bool
        _I, _P, _P, _P, _P, _P, _P],         # width send kept leaving counts overflow stream
    "pp_place_arrivals": [
        _P, _P, _L,                          # staying new_elem n
        _P, _L, _I, _P, _P, _I,              # recv m width gid_sorted gid_perm E
        _I, _P, _P, _P, _P,                  # n_fields dsts lanes is_bool offs
        _P, _P, _P, _P, _P, _P],             # scratch stats overflow elem active stream
    "pp_place_arrivals_scratch": [_L, _L],
    "pp_owner_gather": [_P, _I, _P, _L, ctypes.c_uint, _P, _P],  # field w ids n fill out stream
    "pp_owner_fan_in": [
        _P, _P, _I, _I, _P, _P, _I, _I,      # field recv w V offsets rows op is_int
        ctypes.c_uint, _P, _P, _P],          # neutral out back stream
    "pp_owner_fan_out": [_P, _I, _P, _L, _P, _P],  # back w send_ids n_rows field stream
    "pp_gitr_update": [
        _P, _P, _P, _P, _P, _P, _P, _P,      # x v v_new dest hit elem num_hits active
        _I, _F, _P, _P, _P, _P,              # reflect tiny x_out v_out active_out lost
        _L, _P],                             # n stream
    "pp_rebuild_mask": [
        _I, _P, _P, _P, _I, _P,              # mode a m b n_elems needed
        _P, _P, _P, _L, _P],                 # elem_out active_out num n stream
    "pp_key_sort": [
        _P, _P, _P, _I, _L, _I,              # key elem active fill n bits
        _P, _P, _P,                          # key_out order scratch
        _P, _P, _P, _P, _P, _P, _P],         # ka ia kb ib spare values stream
    "pp_key_sort_scratch": [_L],
    "pp_reshuffle_count_words": [_L, _I],    # C E
    "pp_reshuffle_count": [
        _P, _P, _P, _I, _L, _I,              # elem old_elem seg_cap E C MB
        _P, _P, _P, _P, _P, _P, _P],         # cnt mov_start msrc mkey info num stream
    "pp_reshuffle_place": [
        _P, _P, _P, _P, _P, _P,              # elem old_elem offsets seg_cap mov_cnt mov_start
        _P, _I, _I, _L, _I,                  # row_to_elem n_rows E C chunk
        _P, _I, _P, _P, _P,                  # ovf_in n_fields staged fields row_bytes
        _P, _P, _P, _P],                     # elem_out active_out num_ovf stream
    "pp_reshuffle_order": [
        _P, _P, _P, _I, _I,                  # mkey msrc mov_start E n
        _P, _P, _P],                         # take scratch stream
    "pp_reshuffle_order_turns": [_I],        # E
    "pp_reshuffle_order_grid": [_I],         # E
    "pp_reshuffle_order_scratch": [_I, _I],  # E n
    "pp_scs_row_order_cluster_blocks": [],
    "pp_scs_row_order": [
        _P, _I, _I, _I, _I,                  # counts E R sigma chunk
        _P, _P, _P, _P, _P],                 # row_to_elem elem_to_row chunk_width scratch stream
    "pp_scs_row_order_scratch_words": [],
    "pp_route_decode": [
        _I, _P, _P, _P, _P, _L, _I, _I,      # form table params elem_in active n me R
        _P, _P, _P, _P, _P, _P, _P],         # dest sbar noncore live elem_out gelem stream
    "pp_route_params_bytes": [],
    "pp_balance_keys": [
        _P, _P, _P, _P, _L, _I, _I, _I,      # dest sbar live noncore n me S R
        _P, _P, _P, _P, _P],                 # w_key f_key c_key immovable stream
    "pp_balance_select": [
        _P, _P, _P, _P, _L, _I, _I, _I,      # key rank counts dest n S noncore_form P
        _P, _P, _P, _P, _P, _P],             # e_dst cumsum sbar_base sbar_total out stream
    "pp_slot_map": [
        _I, _P, _P, _P, _I,                  # cabm order start offsets n_seg
        _P, _I, _I, _I, _L, _I,              # row_to_elem n_rows chunk E C M
        _P, _P, _P, _P],                     # src elem_c pre_valid stream
}

_LIB = None
# source file name -> ptxas's report (registers, shared memory, spills) of
# the last verbose build in this process
REPORTS = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpumipic_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if it is not cached; returns its path.  With
    ``verbose``, prints ptxas's register and spill report of each source
    and keeps it in ``REPORTS``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in sources():
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in jobs:              # wait for every compiler
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        elif verbose:
            REPORTS[src.name] = err
            print(f"{src.name}:\n{err}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(obj) for _, obj, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
