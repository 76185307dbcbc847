"""Particle load balancing across picparts by sbar diffusion (port of
``pumipic_tpu.parallel.balancer``; ``ParticleBalancer``,
src/pumipic_lb.hpp:33-114, pumipic_lb.cpp).

Build time (host): the **sbars**, the distinct sets of two or more ranks
whose safe zones share an element, and the directed (sbar, src, dst)
pair edges among each sbar's members.  Run time (:func:`repartition`):
movable weight per (rank, sbar) and immovable weight counted where it
lands travel in ONE ``all_gather``; every rank computes the same plan
(:func:`plan_flows`, a Gauss-Seidel water-fill over the sbars to a
tolerance, on the host in f32 as the JAX package computes it) and
relabels its own candidates, non-core-bound first (``selectParticles``,
lb.hpp:229-287), by an interval lookup at particle rate on the device: the
keys are kernel Y2's, their counts and ranks kernel X1's, the lookup
kernel Y3's (``pumipic_torch.ops.route``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pumipic_torch import native
from pumipic_torch.parallel import group
from pumipic_torch.ops import exchange as ex
from pumipic_torch.ops import route as rt
from pumipic_torch.ops.exchange import key_counts


@dataclass(frozen=True)
class BalancerTables:
    """Host sbar tables (i32): ``sbar_of_elem`` (R, E) per local element
    (-1 immovable), the pair edges (P,), each rank's outgoing edges sorted
    by sbar (R, Pmax, -1 padded)."""

    sbar_of_elem: np.ndarray
    edge_sbar: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    my_edge_idx: np.ndarray
    num_sbars: int = 0
    num_edges: int = 0


def build_balancer(pp, num_ranks: int) -> BalancerTables:
    """Sbars from the picparts' safe zones (buildLocalSbarMap /
    buildNgraph, pumipic_lb.cpp:93-110,434-490)."""
    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    R = num_ranks
    E_g = int(eg.max()) + 1
    safe_by_rank = np.zeros((R, E_g), np.uint8)
    for r in range(R):
        valid = (eg[r] >= 0) & es[r]
        safe_by_rank[r, eg[r][valid]] = 1
    sbar_of_gelem, mem_lists = native.sbar_map(safe_by_rank)
    sbar_of_elem = np.full(eg.shape, -1, np.int64)
    for r in range(R):
        valid = eg[r] >= 0
        sbar_of_elem[r][valid] = sbar_of_gelem[eg[r][valid]]
    edges = [(s, a, b) for s, mem in enumerate(mem_lists)
             for a in mem for b in mem if a != b]
    edges.sort(key=lambda e: (e[1], e[0]))
    e_arr = np.asarray(edges or [(0, 0, 0)], np.int64)
    per_rank = [[i for i, e in enumerate(edges) if e[1] == r] for r in range(R)]
    Pmax = max([1] + [len(p) for p in per_rank])
    my_edge_idx = np.full((R, Pmax), -1, np.int64)
    for r, idx in enumerate(per_rank):
        my_edge_idx[r, :len(idx)] = idx
    i32 = lambda a: np.ascontiguousarray(a, np.int32)   # noqa: E731
    return BalancerTables(i32(sbar_of_elem), i32(e_arr[:, 0]), i32(e_arr[:, 1]),
                          i32(e_arr[:, 2]), i32(my_edge_idx),
                          max(len(mem_lists), 1), max(len(edges), 1))


def plan_flows(bt: BalancerTables, w_sr: torch.Tensor, w_fixed: torch.Tensor,
               tol: float = 1.05, max_iters: int = 8, alpha: float = 0.5
               ) -> torch.Tensor:
    """Integer flow per pair edge from the (R, S) movable and (R,) fixed
    weights (f32): sweeps water-fill each sbar's movable weight over its
    members' base loads until ``max(load)/avg <= tol`` or ``max_iters``
    sweeps; the allocation change becomes edge flows by matching senders'
    and receivers' cumulative intervals within each sbar.  ``alpha`` is
    accepted and unused, as in the JAX package.  Same f32 operations as
    the JAX function (with its water-fill fix: a candidate level is
    consistent when the LAST filled base is under water)."""
    R, S = w_sr.shape
    f32 = torch.float32
    src = torch.as_tensor(bt.edge_src).long()
    dst = torch.as_tensor(bt.edge_dst).long()
    sb = torch.as_tensor(bt.edge_sbar).long()
    w_sr = w_sr.to(f32).cpu()
    w_fixed = w_fixed.to(f32).cpu()
    member = torch.zeros(S, R, dtype=torch.bool)
    ok = sb < S
    member[sb[ok], src[ok]] = True
    total = w_fixed.sum() + w_sr.sum()
    avg = torch.clamp(total / torch.tensor(float(R), dtype=f32), min=1e-30)
    inf = torch.tensor(float("inf"), dtype=f32)
    jf = torch.arange(1, R + 1, dtype=f32)
    ar = torch.arange(R)

    def waterfill(B, T):
        Bs = torch.sort(B).values
        cum = torch.cumsum(torch.where(torch.isfinite(Bs), Bs, 0.0), 0)
        lam_j = (T + cum) / jf
        valid = (lam_j >= Bs - 1e-6) & torch.isfinite(Bs)
        jstar = int(torch.where(valid, ar, -1).max())
        return lam_j[max(jstar, 0)]

    a = w_sr.clone()
    loads = w_fixed + w_sr.sum(dim=1)
    it = 0
    while it < max_iters and bool(loads.max() / avg > tol):
        for s in range(S):
            m = member[s]
            a_s = a[:, s]
            B = torch.where(m, loads - a_s, inf)
            T = torch.where(m, a_s, 0.0).sum()
            lam = waterfill(B, T)
            a_new = torch.where(m, torch.clamp(lam - B, min=0.0), 0.0)
            a_new = a_new * (T / torch.clamp(a_new.sum(), min=1e-30))
            loads = torch.where(m, loads - a_s + a_new, loads)
            a[:, s] = a_new
        it += 1
    send = torch.clamp(w_sr - a, min=0.0)
    recv = torch.clamp(a - w_sr, min=0.0)
    s_hi = torch.cumsum(send, 0)
    s_lo = s_hi - send
    r_hi = torch.cumsum(recv, 0)
    r_lo = r_hi - recv
    sbc = torch.clamp(sb, max=S - 1)
    f = torch.clamp(torch.minimum(s_hi[src, sbc], r_hi[dst, sbc])
                    - torch.maximum(s_lo[src, sbc], r_lo[dst, sbc]), min=0.0)
    return torch.floor(f + 1e-4).to(torch.int32)


def _edge_intervals(bt: BalancerTables, flows: torch.Tensor, me: int, device):
    """This rank's outgoing edges' destinations, their flow prefix, each
    sbar's flow before its first edge and its total outgoing flow."""
    S = bt.num_sbars
    Pmax = bt.my_edge_idx.shape[1]
    mye = torch.as_tensor(bt.my_edge_idx[me]).long()
    valid = mye >= 0
    mye_c = torch.clamp(mye, min=0)
    e_sbar = torch.where(valid, torch.as_tensor(bt.edge_sbar).long()[mye_c], S)
    e_dst = torch.where(valid, torch.as_tensor(bt.edge_dst)[mye_c], -1).to(torch.int32)
    e_flow = torch.where(valid, flows.cpu()[mye_c], 0).to(torch.int32)
    cumsum = torch.cumsum(e_flow, 0, dtype=torch.int32)
    first = torch.full((S + 1,), np.iinfo(np.int32).max, dtype=torch.int32)
    first.scatter_reduce_(0, e_sbar, torch.arange(Pmax, dtype=torch.int32),
                          reduce="amin", include_self=True)
    first = first[:S]
    first_c = torch.clamp(first, max=Pmax - 1)
    sbar_base = torch.where((first < Pmax) & (first > 0),
                            cumsum[torch.clamp(first_c - 1, min=0).long()], 0)
    sbar_total = torch.zeros(S + 1, dtype=torch.int32).index_add_(
        0, torch.clamp(e_sbar, max=S), e_flow)[:S]
    return tuple(t.to(device) for t in (e_dst, cumsum, sbar_base, sbar_total))


def rank_within_key(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Stable rank of each item among the items of its key (key
    ``num_keys``: ignored), kernel X1's."""
    return ex.rank_in_key(key, num_keys)[0]


def _select(bt: BalancerTables, flows: torch.Tensor, key, dest_rank, me: int,
            noncore_form: bool) -> torch.Tensor:
    """Kernel X1's ranks of the candidates' key (kernel Y2's, or
    :func:`select_particles`'), then kernel Y3: the new dest_rank."""
    S = bt.num_sbars
    e_dst, cumsum, sbar_base, sbar_total = _edge_intervals(bt, flows, me, key.device)
    rank, counts = ex.rank_in_key(key, 2 * S if noncore_form else S)
    return rt.balance_select(key, rank, counts, dest_rank.to(torch.int32), e_dst, cumsum,
                             sbar_base, sbar_total, S, noncore_form).to(dest_rank.dtype)


def select_particles(bt: BalancerTables, flows: torch.Tensor, sbar, candidate,
                     dest_rank, me: int, noncore=None) -> torch.Tensor:
    """Relabel up to flow[e] candidates per outgoing edge, non-core-bound
    candidates first (selectParticles, lb.hpp:229-287); returns the new
    dest_rank.  The candidates' key (sbar·2 + !noncore, or sbar) is formed
    here; the step's :func:`repartition` takes kernel Y2's."""
    S = bt.num_sbars
    is_cand = candidate & (sbar >= 0)
    if noncore is None:
        key = torch.where(is_cand, sbar, S)
    else:
        key = torch.where(is_cand, sbar * 2 + (~noncore).to(sbar.dtype), 2 * S)
    return _select(bt, flows, key.to(torch.int32), dest_rank, me, noncore is not None)


def _gathered_weights(w_local, fixed_vec, R: int):
    """One all_gather of [fixed | movable]: (w_fixed (R,) summed over ranks
    in rank order, w_sr (R, S)) on the host."""
    g = group.all_gather(torch.cat([fixed_vec, w_local])).cpu()
    return g[:, R:], g[:, :R].sum(dim=0)


def repartition(bt: BalancerTables, sbar_of_elem_local, new_elem, active,
                dest_rank, me: int, tol: float = 1.05, elem_owner=None,
                sbar_of_ptcl=None, noncore=None, num_ranks: Optional[int] = None
                ) -> torch.Tensor:
    """One balancing pass (repartition, lb.hpp:352-362): weights with the
    forced migrations counted at their destination (addWeights), the
    plan, the selection.  Returns the new dest_rank; the identity on one
    rank.  ``sbar_of_ptcl``/``noncore``: per-particle values already
    decoded from the routing gather (kernel Y1, ``migrate.route_particles``).
    The keys are kernel Y2's (with the immovable count), X1 counts and
    ranks them, Y3 selects."""
    R = group.num_ranks() if num_ranks is None else num_ranks
    if R == 1:
        return dest_rank
    S = bt.num_sbars
    dev = dest_rank.device
    with group.split("glue"):
        sbar = sbar_of_ptcl
        if sbar is None:
            sbar = torch.where(active & (new_elem >= 0),
                               sbar_of_elem_local[torch.clamp(new_elem, min=0).long()], -1)
        if noncore is None and elem_owner is not None:
            noncore = (active & (new_elem >= 0)
                       & (elem_owner[torch.clamp(new_elem, min=0).long()] != me))
        keys = rt.balance_keys(dest_rank.to(torch.int32), sbar.to(torch.int32), active,
                               noncore, me, S, R)
        # counts (exact in f32, as the JAX package's f32 segment sums)
        w_local = key_counts(keys.weights, S).to(torch.float32)
        forced = key_counts(keys.forced, R).to(torch.float32)
        fixed_vec = forced + keys.immovable.to(torch.float32) * (
            torch.arange(R, device=dev) == me).to(torch.float32)
    w_sr, w_fixed = _gathered_weights(w_local, fixed_vec, R)
    with group.split("glue"):
        flows = plan_flows(bt, w_sr, w_fixed, tol)
        return _select(bt, flows, keys.candidates, dest_rank, me, noncore is not None)


def partition(bt: BalancerTables, sbar_of_elem_local, ptcls_per_elem,
              num_ptcls: int, me: int, tol: float = 1.05) -> torch.Tensor:
    """Initial placement from per-element counts (ParticleBalancer::
    partition, lb.hpp:289-350): a (num_ptcls,) destination per particle in
    element-major order (this rank past the true total)."""
    dev = ptcls_per_elem.device
    E = ptcls_per_elem.shape[0]
    R = group.num_ranks()
    ppe = torch.clamp(ptcls_per_elem.to(torch.int32), min=0)
    offsets = torch.cumsum(ppe, 0, dtype=torch.int32)
    total = offsets[E - 1]
    pid = torch.arange(num_ptcls, dtype=torch.int32, device=dev)
    elem = torch.searchsorted(offsets, pid, right=True).to(torch.int32)
    valid = pid < total
    elem = torch.where(valid, torch.clamp(elem, max=E - 1), 0)
    sbar = torch.where(valid, sbar_of_elem_local[elem.long()], -1)
    S = bt.num_sbars
    w_local = key_counts(torch.where(valid & (sbar >= 0), sbar, S), S).to(torch.float32)
    immovable = ((sbar < 0) & valid).sum(dtype=torch.float32)
    fixed_vec = immovable * (torch.arange(R, device=dev) == me).to(torch.float32)
    w_sr, w_fixed = _gathered_weights(w_local, fixed_vec, R)
    flows = plan_flows(bt, w_sr, w_fixed, tol)
    dest0 = torch.full((num_ptcls,), me, dtype=torch.int32, device=dev)
    return select_particles(bt, flows, sbar, valid, dest0, me)


def ptcl_imbalance(num_local: torch.Tensor):
    """printPtclImb: (max, avg, max/avg) of the per-rank counts (f32; 1.0
    where no rank holds a particle)."""
    n = group.all_gather(num_local.to(torch.float32))
    mx, total = n.max(), n.sum()
    avg = total / total.new_full((), float(n.shape[0]))
    return mx, avg, torch.where(avg > 0, mx / avg, total.new_full((), 1.0))
