"""The picparts step's routing and the balancer's selection: kernels Y1,
Y2 and Y3 (``kernels/csrc/route.cu``).

- :func:`route_packed`, :func:`route_g2l` and :func:`route_banded` are
  kernel Y1's three input forms: each particle's destination rank (its
  element's owner where it left the safe zone, else this rank), sbar and
  non-core flag, and the step's live mask ``active & (elem >= 0)``, from
  ``pack_route``'s table at the local element, from the ``[g2l | route]``
  row at the global element (writing the local element too), or from the
  banded formulas on the global element (likewise).  They return a
  :class:`Routed`.
- :func:`balance_keys` is kernel Y2: ``repartition``'s three key arrays
  (the staying weights', the forced migrations', the candidates') and the
  immovable count, which kernel X1 then counts and ranks.
- :func:`balance_select` is kernel Y3: ``select_particles`` after X1's
  ranks, the new destination of each particle.

Each runs its plain PyTorch version (``*_plain``: the JAX package's
arithmetic, ``pumipic_tpu/parallel/migrate.py``, ``banded_route.py`` and
``balancer.py``) on CPU tensors and launches its kernel on CUDA tensors
(one launch counted, under its name).  The decodes divide in f32 as the
reference does (by 0-d tensors in the plain versions: IEEE on the card
too), and every output is an integer or a mask, so the two are equal bit
for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

INVALID = -1
# Y1's forms, as route.cu numbers them
Y1_PACKED, Y1_G2L, Y1_BANDED = 0, 1, 2
# sbar runs Y1's banded form takes, and edges of a rank Y3 takes, as
# route.cu defines them
Y1_MAX_RUNS = 128
Y3_MAX_EDGES = 6144

_P = ctypes.c_void_p
I32 = torch.int32


def _ptr(t: Optional[torch.Tensor]):
    return _P(t.data_ptr() if t is not None else 0)


def _stream():
    return _P(kernels.stream_handle())


class Routed(NamedTuple):
    dest: torch.Tensor             # (N,) i32 destination rank
    sbar: torch.Tensor             # (N,) i32 sbar, -1 for none or not live
    noncore: torch.Tensor          # (N,) bool: live, its element owned elsewhere
    live: torch.Tensor             # (N,) bool: active & (local element >= 0)
    elem: Optional[torch.Tensor]   # (N,) i32 local element (g2l, banded forms)
    gelem: Optional[torch.Tensor]  # (N,) i32 global element where elem >= 0, else -1


# ---------------------------------------------------------------------------
# Y1: the route
# ---------------------------------------------------------------------------

def route_decode_plain(v, ok, my_rank: int, num_ranks: int):
    """Decode pre-gathered ``pack_route`` values in the JAX package's f32
    arithmetic (``route_decode``): (dest, sbar, noncore)."""
    Rf = v.new_full((), float(num_ranks))
    t = torch.floor(v / Rf)
    owner_f = v - t * Rf
    half = torch.floor(t / v.new_full((), 2.0))
    safe = (t - half * 2.0) > 0.5
    sbar = half.to(I32) - 2
    me_f = float(my_rank)
    dest = torch.where(ok & ~safe, owner_f, v.new_full((), me_f)).to(I32)
    sbar = torch.where(ok, sbar, -1)
    noncore = ok & (owner_f != me_f)
    return dest, sbar, noncore


def route_packed_plain(route, elem, active, my_rank: int, num_ranks: int) -> Routed:
    """Plain version of Y1's packed form: ``route_particles`` with the live
    mask."""
    live = active & (elem >= 0)
    v = route[torch.clamp(elem, min=0).long()]
    return Routed(*route_decode_plain(v, live, my_rank, num_ranks), live, None, None)


def route_g2l_plain(g2l, e_gl, active, my_rank: int, num_ranks: int,
                    gelem: bool = True) -> Routed:
    """Plain version of Y1's g2l form: the ``[g2l | route]`` row gather,
    the local element, the live mask and ``route_decode``."""
    row = g2l[torch.clamp(e_gl, min=0).long()]
    elem = torch.where(e_gl >= 0, row[:, 0], INVALID)
    live = active & (elem >= 0)
    dest, sbar, noncore = route_decode_plain(row[:, 1].to(torch.float32), live, my_rank,
                                             num_ranks)
    g = torch.where(elem >= 0, e_gl, INVALID) if gelem else None
    return Routed(dest, sbar, noncore, live, elem, g)


class BandedParams(NamedTuple):
    """Y1's banded form's constants for one rank: the annulus's sectors
    and the ranks, the rank's window and safe-interval scalars (Python
    floats, exact small integers) and the global sbar map's sector runs
    ((lo, hi, sbar), ...)."""

    me: int
    num_ranks: int
    n_sectors: int
    scalars: tuple            # (a, w, w0, nsa, sa, sl)
    sbar_runs: tuple


def banded_decode_plain(p: BandedParams, ring_f, sec_f, tri_f, valid, active):
    """``banded_decode``'s f32 arithmetic: (lid, dest, sbar, noncore)."""
    a, w, w0, nsa, sa, sl = p.scalars
    Ns = float(p.n_sectors)
    pos = sec_f - a
    pos = torch.where(pos < 0, pos + Ns, pos)
    in_win = pos < w
    gidx = torch.where(pos >= nsa, pos + a - Ns, pos + w0)
    lid_f = ring_f * (2.0 * w) + gidx * 2.0 + tri_f
    ok = active & valid & in_win
    lid = torch.where(ok, lid_f, float(INVALID)).to(I32)
    owner_f = torch.floor(sec_f * float(p.num_ranks) / sec_f.new_full((), Ns))
    d = sec_f - sa
    d = torch.where(d < 0, d + Ns, d)
    safe = d < sl
    me_f = float(p.me)
    dest = torch.where(ok & ~safe, owner_f, sec_f.new_full((), me_f)).to(I32)
    noncore = ok & (owner_f != me_f)
    sbar = torch.full(sec_f.shape, -1, dtype=I32, device=sec_f.device)
    for lo, hi, val in p.sbar_runs:
        sbar = torch.where((sec_f >= float(lo)) & (sec_f < float(hi)),
                           torch.full((), val, dtype=I32, device=sec_f.device), sbar)
    sbar = torch.where(ok, sbar, -1)
    return lid, dest, sbar, noncore


def route_banded_plain(p: BandedParams, e_gl, active, gelem: bool = True) -> Routed:
    """Plain version of Y1's banded form: the global element's (ring,
    sector, triangle) in f32, ``banded_decode``, the live mask."""
    Ns = p.n_sectors
    e = torch.clamp(e_gl, min=0)
    lid, dest, sbar, noncore = banded_decode_plain(
        p, (e // (2 * Ns)).to(torch.float32), ((e // 2) % Ns).to(torch.float32),
        (e % 2).to(torch.float32), e_gl >= 0, active)
    live = active & (lid >= 0)
    g = torch.where(lid >= 0, e_gl, INVALID) if gelem else None
    return Routed(dest, sbar, noncore, live, lid, g)


def _check_elems(name: str, elem, active):
    if elem.dtype != I32 or elem.dim() != 1:
        raise ValueError(f"{name}: (N,) int32 elements expected")
    if active.dtype != torch.bool or active.shape != elem.shape:
        raise ValueError(f"{name}: an (N,) bool mask beside the elements expected")


def _launch_route(name: str, form: int, table, params, elem_in, active, me: int, R: int,
                  two_elems: bool, gelem: bool) -> Routed:
    n = elem_in.shape[0]
    dev = elem_in.device
    dest, sbar = (torch.empty(n, dtype=I32, device=dev) for _ in range(2))
    noncore, live = (torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2))
    elem = torch.empty(n, dtype=I32, device=dev) if two_elems else None
    g = torch.empty(n, dtype=I32, device=dev) if two_elems and gelem else None
    err = _build.lib().pp_route_decode(
        form, _ptr(table), params, _ptr(elem_in), _ptr(active), n, me, R, _ptr(dest),
        _ptr(sbar), _ptr(noncore), _ptr(live), _ptr(elem), _ptr(g), _stream())
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return Routed(dest, sbar, noncore, live, elem, g)


def route_packed(route, elem, active, my_rank: int, num_ranks: int) -> Routed:
    """Y1's packed form: each particle's route from ``pack_route``'s (E,)
    f32 table at its local element ``elem`` (-1: none); ``elem`` and
    ``gelem`` of the result are None.  Kernel Y1 on CUDA tensors
    (``route_packed``), :func:`route_packed_plain` on CPU tensors."""
    _check_elems("route_packed", elem, active)
    if route.dtype != torch.float32 or route.dim() != 1:
        raise ValueError("route_packed: an (E,) f32 route table expected")
    if not kernels.use_kernel("route_packed", route, elem, active):
        return route_packed_plain(route, elem, active, my_rank, num_ranks)
    return _launch_route("route_packed", Y1_PACKED, route, None, elem, active, my_rank,
                         num_ranks, False, False)


def route_g2l(g2l, e_gl, active, my_rank: int, num_ranks: int,
              gelem: bool = True) -> Routed:
    """Y1's g2l form: the route and the local element from the (E_g, 2)
    int32 ``[g2l | route]`` row at the global element ``e_gl`` (-1: none),
    with the global element of each particle found on the picpart
    (``gelem``: else None).  Kernel Y1 on CUDA tensors (``route_g2l``),
    :func:`route_g2l_plain` on CPU tensors."""
    _check_elems("route_g2l", e_gl, active)
    if g2l.dtype != I32 or g2l.dim() != 2 or g2l.shape[1] != 2:
        raise ValueError("route_g2l: an (E_g, 2) int32 [g2l | route] table expected")
    if not kernels.use_kernel("route_g2l", g2l, e_gl, active):
        return route_g2l_plain(g2l, e_gl, active, my_rank, num_ranks, gelem)
    return _launch_route("route_g2l", Y1_G2L, g2l, None, e_gl, active, my_rank, num_ranks,
                         True, gelem)


def banded_params_words(p: BandedParams) -> np.ndarray:
    """``RouteParams`` of ``route.cu`` as int32 words: me, R, sectors and
    runs, the six scalars as f32 bits, then the runs' lows and highs (f32
    bits) and sbars, each padded to ``Y1_MAX_RUNS``."""
    runs = p.sbar_runs
    if len(runs) > Y1_MAX_RUNS:
        raise ValueError(f"route_banded: {len(runs)} sbar runs; kernel Y1 takes at most "
                         f"{Y1_MAX_RUNS}")
    words = np.zeros(10 + 3 * Y1_MAX_RUNS, np.int32)
    words[:4] = [p.me, p.num_ranks, p.n_sectors, len(runs)]
    words[4:10] = np.asarray(p.scalars, np.float32).view(np.int32)
    if runs:
        lo, hi, val = (np.asarray(c) for c in zip(*runs))
        m = Y1_MAX_RUNS
        words[10:10 + len(runs)] = lo.astype(np.float32).view(np.int32)
        words[10 + m:10 + m + len(runs)] = hi.astype(np.float32).view(np.int32)
        words[10 + 2 * m:10 + 2 * m + len(runs)] = val.astype(np.int32)
    return words


def route_banded(p: BandedParams, e_gl, active, gelem: bool = True) -> Routed:
    """Y1's banded form: the route and the local element from the global
    element ``e_gl`` (-1: none) of a sector-band annulus by
    ``banded_decode``'s formulas (no table read).  Kernel Y1 on CUDA
    tensors (``route_banded``), :func:`route_banded_plain` on CPU tensors.
    Raises beyond ``Y1_MAX_RUNS`` sbar runs on every device."""
    _check_elems("route_banded", e_gl, active)
    words = banded_params_words(p)
    if not kernels.use_kernel("route_banded", e_gl, active):
        return route_banded_plain(p, e_gl, active, gelem)
    lib = _build.lib()
    if lib.pp_route_params_bytes() != words.nbytes:
        raise RuntimeError("route_banded: RouteParams' layout differs from route.cu's")
    return _launch_route("route_banded", Y1_BANDED, None,
                         words.ctypes.data_as(ctypes.c_void_p), e_gl, active, p.me,
                         p.num_ranks, True, gelem)


# ---------------------------------------------------------------------------
# Y2: the balancer's keys
# ---------------------------------------------------------------------------

class BalanceKeys(NamedTuple):
    weights: torch.Tensor      # (N,) i32 staying particle's sbar, else S
    forced: torch.Tensor       # (N,) i32 leaving particle's destination, else R
    candidates: torch.Tensor   # (N,) i32 candidate's sbar·2 + !noncore, else 2S
    #                            (sbar, else S, without the non-core flag)
    immovable: torch.Tensor    # () i32 staying particles outside every sbar


def balance_keys_plain(dest, sbar, live, noncore, me: int, num_sbars: int,
                       num_ranks: int) -> BalanceKeys:
    """Plain version of kernel Y2: ``repartition``'s weight keys and
    ``select_particles``' candidate key (the JAX package's arithmetic)."""
    S, R = num_sbars, num_ranks
    staying = live & (dest == me)
    leaving = live & (dest != me)
    cand = staying & (sbar >= 0)
    weights = torch.where(cand, sbar, S)
    forced = torch.where(leaving, dest, R).to(I32)
    if noncore is None:
        candidates = weights.clone()
    else:
        candidates = torch.where(cand, sbar * 2 + (~noncore).to(I32), 2 * S)
    immovable = (staying & (sbar < 0)).sum(dtype=I32)
    return BalanceKeys(weights, forced, candidates, immovable)


def balance_keys(dest, sbar, live, noncore, me: int, num_sbars: int,
                 num_ranks: int) -> BalanceKeys:
    """The balancer's keys of one rank's particles: ``dest`` (N,) i32 the
    routed destinations, ``sbar`` (N,) i32 (-1: none), ``live`` (N,) bool,
    ``noncore`` (N,) bool or None (then the candidates' key is the
    weights').  Kernel Y2 on CUDA tensors (a memset and one launch),
    :func:`balance_keys_plain` on CPU tensors."""
    for t in (dest, sbar):
        if t.dtype != I32 or t.shape != live.shape:
            raise ValueError("balance_keys: (N,) int32 dest and sbar expected")
    if live.dtype != torch.bool or (noncore is not None and noncore.dtype != torch.bool):
        raise ValueError("balance_keys: bool live and noncore expected")
    extra = () if noncore is None else (noncore,)
    if not kernels.use_kernel("balance_keys", dest, sbar, live, *extra):
        return balance_keys_plain(dest, sbar, live, noncore, me, num_sbars, num_ranks)
    n = dest.shape[0]
    dev = dest.device
    w, f, c = (torch.empty(n, dtype=I32, device=dev) for _ in range(3))
    imm = torch.empty((), dtype=I32, device=dev)
    err = _build.lib().pp_balance_keys(_ptr(dest), _ptr(sbar), _ptr(live), _ptr(noncore), n,
                                       me, num_sbars, num_ranks, _ptr(w), _ptr(f), _ptr(c),
                                       _ptr(imm), _stream())
    _build.check(err, "balance_keys")
    kernels.LAUNCHES["balance_keys"] += 1
    return BalanceKeys(w, f, c, imm)


# ---------------------------------------------------------------------------
# Y3: the selection
# ---------------------------------------------------------------------------

def balance_select_plain(key, rank, counts, dest, e_dst, cumsum, sbar_base, sbar_total,
                         num_sbars: int, noncore_form: bool):
    """Plain version of kernel Y3: ``select_particles`` after the ranks
    (the JAX package's arithmetic)."""
    S = num_sbars
    if noncore_form:
        is_cand = key < 2 * S
        sb_c = torch.where(is_cand, key // 2, 0).long()
        core = (key % 2) == 1
        n_noncore = counts[0:2 * S:2]       # key 2s: sbar s's non-core-bound
        rank_in_sbar = torch.where(is_cand & core, rank + n_noncore[sb_c], rank)
    else:
        is_cand = key < S
        sb_c = torch.where(is_cand, key, 0).long()
        rank_in_sbar = rank
    in_plan = is_cand & (rank_in_sbar < sbar_total[sb_c])
    gpos = sbar_base[sb_c] + rank_in_sbar
    edge = torch.searchsorted(cumsum, gpos.to(I32), right=True)
    edge = torch.clamp(edge, max=e_dst.shape[0] - 1)
    chosen = torch.where(in_plan, e_dst[edge], -1)
    return torch.where(chosen >= 0, chosen, dest).to(dest.dtype)


def balance_select(key, rank, counts, dest, e_dst, cumsum, sbar_base, sbar_total,
                   num_sbars: int, noncore_form: bool):
    """The new destination of each particle: a candidate (``key`` below
    2S in the non-core form, else below S: kernel Y2's candidates' key)
    within its sbar's planned flow goes to the edge whose flow interval
    holds its place (X1's ``rank`` within the key, a core candidate's
    after its sbar's non-core ones, ``counts`` X1's key counts), every
    other particle keeps ``dest``.  ``e_dst``, ``cumsum`` (Pmax,) and
    ``sbar_base``, ``sbar_total`` (S,) int32: ``_edge_intervals``'.  Kernel
    Y3 on CUDA tensors, :func:`balance_select_plain` on CPU tensors."""
    if key.dtype != I32 or rank.dtype != I32 or dest.dtype != I32:
        raise ValueError("balance_select: int32 key, rank and dest expected")
    if not kernels.use_kernel("balance_select", key, rank, counts, dest, e_dst, cumsum,
                              sbar_base, sbar_total):
        return balance_select_plain(key, rank, counts, dest, e_dst, cumsum, sbar_base,
                                    sbar_total, num_sbars, noncore_form)
    P = e_dst.shape[0]
    if P > Y3_MAX_EDGES:
        raise ValueError(f"balance_select: {P} edges; kernel Y3 holds at most "
                         f"{Y3_MAX_EDGES}")
    for t in (e_dst, cumsum, sbar_base, sbar_total, counts):
        if t.dtype != I32:
            raise ValueError("balance_select: int32 tables expected")
    n = key.shape[0]
    out = torch.empty_like(dest)
    err = _build.lib().pp_balance_select(
        _ptr(key), _ptr(rank), _ptr(counts), _ptr(dest), n, num_sbars, int(noncore_form), P,
        _ptr(e_dst), _ptr(cumsum), _ptr(sbar_base), _ptr(sbar_total), _ptr(out), _stream())
    _build.check(err, "balance_select")
    kernels.LAUNCHES["balance_select"] += 1
    return out
