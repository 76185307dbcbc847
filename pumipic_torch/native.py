"""Host preprocessing loops in C++ (port of ``pumipic_tpu.native``).

The repo's ``csrc/meshcore.cpp`` (BFS layers, sbar set hashing, exchange
lists, side dedup; a plain C ABI) is built with g++ on first use into
``pumipic_torch/kernels/_build/libmeshcore.so`` and loaded with ctypes.
Each entry point has a numpy counterpart that gives the same result; the
dispatchers take the library where it built and numpy otherwise (or with
``PUMIPIC_TORCH_NO_NATIVE=1``), and :func:`path` says which one ran and,
for numpy, why.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why = "not built yet"

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "meshcore.cpp"
_SO = Path(__file__).resolve().parent / "kernels" / "_build" / "libmeshcore.so"

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
INF = np.iinfo(np.int32).max


def _build() -> ctypes.CDLL:
    if not _SRC.exists():
        raise FileNotFoundError(f"{_SRC} is missing")
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"libmeshcore.{os.getpid()}.so")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                        str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    lib.pp_bfs_layers.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                  _i64p, _u8p, ctypes.c_int64, _i64p]
    lib.pp_bfs_layers.restype = None
    lib.pp_sbar_map.argtypes = [ctypes.c_int64, ctypes.c_int64, _u8p, _i64p,
                                _i64p, _i64p, ctypes.c_int64]
    lib.pp_sbar_map.restype = ctypes.c_int64
    lib.pp_exchange_lists.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, _i64p, _i64p, _i64p,
                                      ctypes.c_int64]
    lib.pp_exchange_lists.restype = ctypes.c_int64
    lib.pp_unique_sides.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p,
                                    _i64p, _i64p]
    lib.pp_unique_sides.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The built library, or None (then :func:`path` says why)."""
    global _lib, _tried, _why
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            if os.environ.get("PUMIPIC_TORCH_NO_NATIVE") == "1":
                _why = "PUMIPIC_TORCH_NO_NATIVE=1"
            else:
                try:
                    _lib = _build()
                    _why = ""
                except (OSError, subprocess.SubprocessError) as e:
                    _why = f"g++ build failed: {e}"
            _tried = True
    return _lib


def path() -> str:
    """Which implementation the dispatchers run: ``"g++ (<library>)"`` or
    ``"numpy (<reason>)"``."""
    return f"g++ ({_SO.name})" if get_lib() is not None else f"numpy ({_why})"


# ---------------------------------------------------------------- BFS layers

def bfs_layers_numpy(elem_keys: np.ndarray, nkeys: int, seed_mask: np.ndarray,
                     max_layers: int) -> np.ndarray:
    """BFS distance in bridge-entity hops from the seed elements, INF beyond
    ``max_layers`` (vectorized frontier sweep)."""
    E = elem_keys.shape[0]
    seed = np.asarray(seed_mask, bool)
    dist = np.full(E, INF, np.int64)
    dist[seed] = 0
    frontier = seed.copy()
    for layer in range(1, max_layers + 1):
        vmask = np.zeros(nkeys, bool)
        vmask[elem_keys[frontier].reshape(-1)] = True
        new = vmask[elem_keys].any(axis=1) & (dist > layer)
        if not new.any():
            break
        dist[new] = layer
        frontier = new
    return dist


def bfs_layers_native(elem_keys: np.ndarray, nkeys: int, seed_mask: np.ndarray,
                      max_layers: int) -> np.ndarray:
    lib = get_lib()
    E, k = elem_keys.shape
    dist = np.empty(E, np.int64)
    lib.pp_bfs_layers(E, nkeys, k, np.ascontiguousarray(elem_keys, np.int64),
                      np.ascontiguousarray(seed_mask, np.uint8), max_layers, dist)
    return np.where(dist <= max_layers, dist, INF)


def bfs_layers(elem_keys, nkeys, seed_mask, max_layers) -> np.ndarray:
    if get_lib() is not None:
        return bfs_layers_native(elem_keys, nkeys, seed_mask, max_layers)
    return bfs_layers_numpy(elem_keys, nkeys, seed_mask, max_layers)


# ---------------------------------------------------------------- sbar map

def sbar_map_numpy(safe_by_rank: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(R, Eg) safe flags -> (sbar of each global element (-1 where fewer
    than two ranks hold it safe), member ranks of each sbar); sbars are
    numbered in the order of their first element."""
    R, Eg = safe_by_rank.shape
    safe = np.asarray(safe_by_rank, bool)
    if R <= 63:
        key = (safe.astype(np.int64) << np.arange(R)[:, None]).sum(axis=0)
    else:
        key = np.unique(safe.T, axis=0, return_inverse=True)[1].reshape(-1)
    multi = safe.sum(axis=0) >= 2
    sbar_of = np.full(Eg, -1, np.int64)
    if not multi.any():
        return sbar_of, []
    uniq, first, inv = np.unique(key[multi], return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank_of = np.empty(len(uniq), np.int64)
    rank_of[order] = np.arange(len(uniq))
    sbar_of[multi] = rank_of[inv.reshape(-1)]
    g_first = np.nonzero(multi)[0][first[order]]
    members = [np.nonzero(safe[:, g])[0].astype(np.int64) for g in g_first]
    return sbar_of, members


def sbar_map_native(safe_by_rank: np.ndarray):
    lib = get_lib()
    R, Eg = safe_by_rank.shape
    sbar_of = np.empty(Eg, np.int64)
    cap = R * Eg + 1
    members = np.empty(cap, np.int64)
    off = np.empty(Eg + 2, np.int64)
    S = lib.pp_sbar_map(R, Eg, np.ascontiguousarray(safe_by_rank, np.uint8),
                        sbar_of, members, off, cap)
    if S < 0:
        raise RuntimeError(f"pp_sbar_map failed ({S})")
    return sbar_of, [members[off[s]:off[s + 1]].copy() for s in range(S)]


def sbar_map(safe_by_rank: np.ndarray):
    if get_lib() is not None and safe_by_rank.shape[0] <= 64:
        return sbar_map_native(safe_by_rank)
    return sbar_map_numpy(safe_by_rank)


# ---------------------------------------------------------------- exchange lists

def exchange_lists_numpy(ent_gid: np.ndarray, ent_owner: np.ndarray,
                         n_global: int) -> np.ndarray:
    """(R, Nmax) gids and owners (-1 pad) -> (n, 4) rows [src rank, owner,
    src local id, owner local id] of every copy held off its owner, in
    (src, local id) order."""
    R = ent_gid.shape[0]
    owner_lid = np.full(n_global, -1, np.int64)
    rr, ll = np.nonzero((ent_gid >= 0) & (ent_owner == np.arange(R)[:, None]))
    owner_lid[ent_gid[rr, ll]] = ll
    rr, ll = np.nonzero((ent_gid >= 0) & (ent_owner >= 0)
                        & (ent_owner != np.arange(R)[:, None]))
    lo = owner_lid[ent_gid[rr, ll]]
    if (lo < 0).any():
        raise AssertionError("owner must hold a copy of its entity")
    return np.stack([rr, ent_owner[rr, ll], ll, lo], axis=1).astype(np.int64)


def exchange_lists_native(ent_gid: np.ndarray, ent_owner: np.ndarray,
                          n_global: int) -> np.ndarray:
    lib = get_lib()
    R, Nmax = ent_gid.shape
    cap = int((ent_gid >= 0).sum()) + 1
    out = np.empty((cap, 4), np.int64)
    n = lib.pp_exchange_lists(R, Nmax, n_global,
                              np.ascontiguousarray(ent_gid, np.int64),
                              np.ascontiguousarray(ent_owner, np.int64),
                              out.reshape(-1), cap)
    if n < 0:
        raise RuntimeError(f"pp_exchange_lists failed ({n})")
    return out[:n]


def exchange_lists(ent_gid, ent_owner, n_global) -> np.ndarray:
    if get_lib() is not None:
        return exchange_lists_native(ent_gid, ent_owner, n_global)
    return exchange_lists_numpy(ent_gid, ent_owner, n_global)


# ---------------------------------------------------------------- side dedup

def unique_sides_numpy(side_verts_sorted: np.ndarray):
    """(n_occ, k) row-sorted vertex tuples -> (unique id of each occurrence,
    first occurrence of each unique side), ids numbered in order of first
    occurrence."""
    rows = np.ascontiguousarray(side_verts_sorted, np.int64)
    _, first, inv = np.unique(rows, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank_of = np.empty(len(first), np.int64)
    rank_of[order] = np.arange(len(first))
    return rank_of[inv.reshape(-1)], first[order]


def unique_sides_native(side_verts_sorted: np.ndarray):
    lib = get_lib()
    n_occ, k = side_verts_sorted.shape
    inv = np.empty(n_occ, np.int64)
    first = np.empty(n_occ, np.int64)
    n = lib.pp_unique_sides(n_occ, k,
                            np.ascontiguousarray(side_verts_sorted, np.int64),
                            inv, first)
    return inv, first[:n]


def unique_sides(side_verts_sorted: np.ndarray):
    if get_lib() is not None:
        return unique_sides_native(side_verts_sorted)
    return unique_sides_numpy(side_verts_sorted)
