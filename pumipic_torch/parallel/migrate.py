"""Particle migration over the rank group (port of
``pumipic_tpu.parallel.migrate``; ``SellCSigma::migrate``,
scs/SCS_migrate.h:4-221, and ``migrate_ptcls``/``setUnsafeProcs``,
src/pumipic_ptcl_ops.hpp:17-85).

Particles whose element after the search lies outside the safe zone go to
that element's owner in the JAX package's **bucketed exchange**: leavers
are ranked within their destination's bucket (in slot order), two
(R,)-vector exchanges negotiate admission (each receiver grants senders,
in rank order, up to ``cap`` and its free slots), leavers beyond their
quota stay home (``num_kept_home``) and retry next step, and ``overflow``
is set only where a destination's volume exceeds ``cap`` or arrivals
exceed the free slots.  The admitted leavers travel as one int32 buffer
(gid and every member field; floats bitcast, never ints carried as
floats) in one ``all_to_all_single`` whose split sizes are the quotas,
read on the host: only admitted rows move, not the JAX design's (R, cap,
F), and the arrivals come in the same order (source rank, then slot).
Arrivals translate global to local element ids by binary search over the
picpart's sorted global ids (``num_recv_unresolved`` counts those the
picpart lacks) and fill free slots in arrival order.

With a neighbour plan (the ``Distributor``-scoped exchange,
SCS_migrate.h:41-62) only the plan's peers are destinations: leavers bound
elsewhere stay home and are counted in ``num_illegal_dest``; the results
equal the world exchange's bit for bit otherwise.

The functions take one rank's local tensors and ``my_rank`` (an int);
the collectives run over the default process group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pumipic_torch.parallel import group

INVALID = -1


class MigrateResult(NamedTuple):
    state: Dict[str, torch.Tensor]   # the rank's particle state after
    num_sent: torch.Tensor           # () i32 particles that left this rank
    num_recv: torch.Tensor           # () i32 particles that arrived
    overflow: torch.Tensor           # () bool, see the module docstring
    num_recv_unresolved: torch.Tensor  # () i32 arrivals of unknown element
    num_illegal_dest: torch.Tensor   # () i32 leavers bound outside the plan
    num_kept_home: torch.Tensor      # () i32 leavers kept by the quotas


def set_unsafe_procs(elem_safe, elem_owner, new_elem, active, my_rank: int):
    """setUnsafeProcs: the element's owner where the particle left the safe
    zone, else this rank."""
    e = torch.clamp(new_elem, min=0).long()
    safe = elem_safe[e] & (new_elem >= 0)
    go = active & (new_elem >= 0) & ~safe
    return torch.where(go, elem_owner[e].to(torch.int32),
                       torch.full_like(new_elem, my_rank, dtype=torch.int32))


def pack_route(elem_safe, elem_owner, sbar_of_elem, num_ranks: int) -> torch.Tensor:
    """(safe, owner, sbar) of each element in one f32,
    ``((sbar + 2)·2 + safe)·R + owner``: exact while below 2^24
    (:func:`route_pack_bound_ok`)."""
    sb = (torch.full(elem_safe.shape, -1, dtype=torch.int32, device=elem_safe.device)
          if sbar_of_elem is None else sbar_of_elem.to(torch.int32))
    owner = torch.clamp(elem_owner.to(torch.int32), min=0)
    return (((sb + 2) * 2 + elem_safe.to(torch.int32)) * num_ranks + owner
            ).to(torch.float32)


def route_pack_bound_ok(num_sbars: int, num_ranks: int) -> bool:
    return ((num_sbars + 2) * 2 + 1) * num_ranks + num_ranks < (1 << 24)


def route_particles(route, new_elem, active, my_rank: int, num_ranks: int):
    """(dest, sbar, noncore) of every particle from its element's
    :func:`pack_route` value."""
    v = route[torch.clamp(new_elem, min=0).long()]
    return route_decode(v, active & (new_elem >= 0), my_rank, num_ranks)


def route_decode(v, ok, my_rank: int, num_ranks: int):
    """Decode pre-gathered :func:`pack_route` values in the JAX package's
    f32 arithmetic (divisions by 0-d tensors: IEEE on the card too)."""
    Rf = v.new_full((), float(num_ranks))
    t = torch.floor(v / Rf)
    owner_f = v - t * Rf
    half = torch.floor(t / v.new_full((), 2.0))
    safe = (t - half * 2.0) > 0.5
    sbar = half.to(torch.int32) - 2
    me_f = float(my_rank)
    dest = torch.where(ok & ~safe, owner_f, v.new_full((), me_f)).to(torch.int32)
    sbar = torch.where(ok, sbar, -1)
    noncore = ok & (owner_f != me_f)
    return dest, sbar, noncore


def gid_to_lid(gid_sorted, gid_perm, gids) -> torch.Tensor:
    """Global element ids -> local ids by binary search over the sorted
    gid table; -1 where absent."""
    E = gid_sorted.shape[0]
    pos = torch.searchsorted(gid_sorted, gids.to(gid_sorted.dtype).contiguous())
    pos_c = torch.clamp(pos, max=E - 1)
    found = (gid_sorted[pos_c] == gids) & (gids >= 0)
    return torch.where(found, gid_perm[pos_c], INVALID).to(torch.int32)


# ---------------------------------------------------------------------------
# neighbour plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NeighborPlan:
    """Greedy edge colouring of the buffered-peer digraph (the JAX
    package's ppermute schedule, kept for its tables); the exchange here
    reads only each rank's destinations (:meth:`peers_out`)."""

    round_of_dest: np.ndarray    # (R, R) i32: round r sends to s on; -1 none
    src_of_round: np.ndarray     # (R, rounds) i32: who sends to r on round k
    perms: tuple = ()
    num_rounds: int = 0
    max_out_degree: int = 0
    num_intra_rounds: int = 0

    def peers_out(self, r: int) -> list:
        return [s for s in range(self.round_of_dest.shape[0])
                if self.round_of_dest[r, s] >= 0]


def build_neighbor_plan(distributor, slice_of_rank=None) -> NeighborPlan:
    """Greedy bipartite edge colouring of the directed neighbour graph
    (each colour a partial permutation); ``slice_of_rank`` (the
    multi-slice split) raises."""
    group.check_flat(slices=1 if slice_of_rank is None else 2)
    nb = np.asarray(distributor.is_neighbor)
    R = nb.shape[0]
    edges = sorted((r, s) for r in range(R) for s in range(R) if r != s and nb[r, s])
    colors = {}
    src_used = {r: set() for r in range(R)}
    dst_used = {r: set() for r in range(R)}
    for r, s in edges:
        c = 0
        while c in src_used[r] or c in dst_used[s]:
            c += 1
        colors[(r, s)] = c
        src_used[r].add(c)
        dst_used[s].add(c)
    rounds = max(colors.values(), default=-1) + 1
    round_of_dest = np.full((R, R), -1, np.int32)
    src_of_round = np.full((R, max(rounds, 1)), -1, np.int32)
    perms = [[] for _ in range(rounds)]
    for (r, s), c in colors.items():
        round_of_dest[r, s] = c
        src_of_round[s, c] = r
        perms[c].append((r, s))
    return NeighborPlan(round_of_dest, src_of_round, tuple(tuple(p) for p in perms),
                        rounds, int(max((len(v) for v in src_used.values()), default=0)),
                        rounds)


# ---------------------------------------------------------------------------
# payload packing, bucket slots, arrival placement
# ---------------------------------------------------------------------------

def _to_lanes(arr: torch.Tensor) -> torch.Tensor:
    """(N, lanes) int32 carrier of a member field: f32 bitcast, i32 as is,
    bool as 0/1; tensor-valued fields flatten to lane columns."""
    arr = arr[:, None] if arr.dim() == 1 else arr.reshape(arr.shape[0], -1)
    if arr.dtype == torch.float32:
        return arr.contiguous().view(torch.int32)
    if arr.dtype == torch.int32:
        return arr
    if arr.dtype == torch.bool:
        return arr.to(torch.int32)
    raise TypeError(f"unsupported migrate dtype {arr.dtype}")


def _pack_payload(state, gid):
    """gid and every member field (sorted by name) as one (N, F) int32
    buffer, and each field's (lo, hi, dtype, inner shape)."""
    parts = [gid.to(torch.int32)[:, None]]
    field_slices = {}
    off = 1
    for name in sorted(state):
        if name in ("elem", "active"):
            continue
        lanes = _to_lanes(state[name])
        field_slices[name] = (off, off + lanes.shape[1], state[name].dtype,
                              tuple(state[name].shape[1:]))
        off += lanes.shape[1]
        parts.append(lanes)
    return torch.cat(parts, dim=1), field_slices


def key_starts(sorted_key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(num_keys + 1,) int64: the position of the first key >= k in the
    sorted keys, for k = 0..num_keys.  A binary search per key: counting
    with atomics would put every particle on a handful of addresses."""
    return torch.searchsorted(sorted_key, torch.arange(
        num_keys + 1, dtype=sorted_key.dtype, device=sorted_key.device))


def key_counts(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(num_keys,) int32 count of each key in [0, num_keys) (others
    ignored), from a sort and :func:`key_starts`."""
    starts = key_starts(torch.sort(key).values, num_keys)
    return (starts[1:] - starts[:-1]).to(torch.int32)


def _bucket_ranks(key: torch.Tensor, num_buckets: int):
    """Stable sort of the keys (bucket id, or ``num_buckets`` for
    non-leavers): (order, sorted keys, rank within bucket, counts)."""
    N = key.shape[0]
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    starts = key_starts(sorted_key, num_buckets)
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    rank_in_bucket = (torch.arange(N, dtype=torch.int64, device=key.device)
                      - starts[torch.clamp(sorted_key, max=num_buckets).long()]
                      ).to(torch.int32)
    return order, sorted_key, rank_in_bucket, counts


def _slots_from_ranks(order, sorted_key, rank_in_bucket, counts,
                      num_buckets: int, cap: int, quota, rows_of_bucket):
    """Send-buffer row of each particle, the overflow flag, and the leavers
    beyond their bucket's ``min(cap, quota)`` (kept home), in slot order.
    Buckets fill consecutive rows in bucket order, ``rows_of_bucket[b]``
    (host ints, = the admitted count) each; a particle not sent gets the
    row past the end."""
    N = sorted_key.shape[0]
    dev = counts.device
    if num_buckets == 0:
        none = torch.zeros(N, dtype=torch.int64, device=dev)
        return none, torch.zeros((), dtype=torch.bool, device=dev), none.bool()
    lim_b = torch.clamp(quota.to(torch.int32), max=cap)
    lim = lim_b[torch.clamp(sorted_key, max=num_buckets - 1).long()]
    is_leaver = sorted_key < num_buckets
    admitted = is_leaver & (rank_in_bucket < lim)
    offsets = torch.as_tensor(np.cumsum([0] + list(rows_of_bucket[:-1]), dtype=np.int64),
                              device=dev)
    total = int(sum(rows_of_bucket))
    slot_sorted = torch.where(
        admitted, offsets[torch.clamp(sorted_key, max=num_buckets - 1).long()]
        + rank_in_bucket, total)
    slot = torch.empty(N, dtype=torch.int64, device=dev)
    slot[order] = slot_sorted
    kept = torch.empty(N, dtype=torch.bool, device=dev)
    kept[order] = is_leaver & ~admitted
    # overflow: a destination's volume above the bucket size ``cap`` (the
    # knob too tight); quota parking alone is reported through ``kept``
    return slot, torch.any(counts > cap), kept


def _negotiate_quota(counts_dest, cap: int, n_free_min):
    """Admission: senders announce per-destination counts; each receiver
    grants, in sender-rank order, up to ``cap`` and its free slots
    (capacity less its current actives).  Returns (R,) ``quota[q]``, how
    many of my leavers rank q admits, and ``admit[s]``, how many of rank
    s's I admit."""
    incoming = group.world_all_to_all(counts_dest[:, None])[:, 0]
    with group.split("glue"):
        capped = torch.clamp(incoming, max=cap)
        cum_before = torch.cumsum(capped, 0, dtype=capped.dtype) - capped
        admit = torch.minimum(torch.clamp(n_free_min - cum_before, min=0), capped)
    return group.world_all_to_all(admit[:, None])[:, 0], admit


DROP_ROWS = 1024   # scratch rows that dropped writes spread over


def _set_drop(base, idx, vals):
    """``base.at[idx].set(vals, mode="drop")`` for idx in [0, N]: writes at
    N go to ``DROP_ROWS`` scratch rows past the end, spread by position,
    so that millions of them do not queue on one address."""
    N = base.shape[0]
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device) % DROP_ROWS
    idx = torch.where(idx >= N, N + pos, idx)
    out = torch.cat([base, base.new_zeros((DROP_ROWS,) + tuple(base.shape[1:]))])
    out[idx] = vals
    return out[:N]


def _place_arrivals(state, staying, new_elem, recv, field_slices,
                    gid_sorted, gid_perm):
    """Translate the arrivals' gids and place them into the free slots in
    arrival order (stayers keep theirs)."""
    N = new_elem.shape[0]
    arr_gid = recv[:, 0]
    present = arr_gid >= 0
    arr_lid = gid_to_lid(gid_sorted, gid_perm, arr_gid)
    arr_valid = present & (arr_lid >= 0)
    num_unresolved = (present & (arr_lid < 0)).sum(dtype=torch.int32)
    num_recv = arr_valid.sum(dtype=torch.int32)

    free = torch.argsort(staying.to(torch.uint8), stable=True).to(torch.int32)
    n_free = (~staying).sum(dtype=torch.int32)
    arr_pos = torch.cumsum(arr_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    arr_slot = torch.where(arr_valid & (arr_pos < n_free),
                           free[torch.clamp(arr_pos, 0, N - 1).long()], N)
    recv_overflow = num_recv > n_free

    new_state = {}
    new_state["elem"] = _set_drop(torch.where(staying, new_elem, INVALID), arr_slot,
                                  arr_lid)
    new_state["active"] = _set_drop(staying, arr_slot, arr_valid)
    for name in sorted(state):
        if name in ("elem", "active"):
            continue
        lo, hi, dtype, inner = field_slices[name]
        lanes = recv[:, lo:hi]
        if dtype == torch.int32:
            vals = lanes
        elif dtype == torch.bool:
            vals = lanes != 0
        else:
            vals = lanes.contiguous().view(torch.float32)
        vals = vals.reshape((vals.shape[0],) + inner)
        v = state[name]
        keep = staying.reshape((-1,) + (1,) * (v.dim() - 1))
        new_state[name] = _set_drop(torch.where(keep, v, torch.zeros_like(v)),
                                    arr_slot, vals)
    return new_state, num_recv, num_unresolved, recv_overflow


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def migrate(state: Dict[str, torch.Tensor], new_elem, dest_rank, elem_gid,
            gid_sorted, gid_perm, my_rank: int, num_ranks: int, cap: int,
            plan: Optional[NeighborPlan] = None, hier: bool = False
            ) -> MigrateResult:
    """Bucketed migration of one rank's flat state (with "elem" and
    "active").  With ``plan`` only the plan's peers are destinations
    (leavers bound elsewhere stay home, ``num_illegal_dest``); without
    it, every rank."""
    group.check_flat(hier)
    dev = new_elem.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    if num_ranks == 1:
        # the comm-size-1 path: no exchange, the search's elements applied
        active = state["active"] & (new_elem >= 0)
        new_state = dict(state)
        new_state["elem"] = torch.where(active, new_elem, INVALID)
        new_state["active"] = active
        return MigrateResult(new_state, z, z, torch.zeros((), dtype=torch.bool,
                                                           device=dev), z, z, z)
    R, K = num_ranks, cap
    neighbour = plan is not None and plan.num_rounds > 0
    peers = plan.peers_out(my_rank) if neighbour else list(range(R))
    D = len(peers)
    with group.split("glue"):
        active = state["active"] & (new_elem >= 0)
        wants_leave = active & (dest_rank != my_rank)
        bucket_of = torch.full((R,), -1, dtype=torch.int32, device=dev)
        peer_ids = torch.as_tensor(peers, dtype=torch.int64, device=dev)
        bucket_of[peer_ids] = torch.arange(D, dtype=torch.int32, device=dev)
        bucket = bucket_of[torch.clamp(dest_rank, 0, R - 1).long()]
        illegal = wants_leave & (bucket < 0)
        routed = wants_leave & (bucket >= 0)
        n_free_min = state["active"].shape[0] - state["active"].sum(dtype=torch.int32)
        key = torch.where(routed, bucket, D).to(torch.int32)
        order, sorted_key, rank_in_bucket, counts = _bucket_ranks(key, D)
        counts_dest = torch.zeros(R, dtype=torch.int32, device=dev)
        counts_dest[peer_ids] = counts
    quota, admit = _negotiate_quota(counts_dest, K, n_free_min)
    with group.split("glue"):
        # the split sizes on the host: one sync, which the host-staged
        # exchange needs anyway; only admitted rows travel
        send_rows, recv_rows = torch.stack([quota, admit]).tolist()
        slot, overflow, kept = _slots_from_ranks(
            order, sorted_key, rank_in_bucket, counts, D, K, quota[peer_ids],
            [send_rows[p] for p in peers])
        leaving = routed & ~kept
        staying = active & ~leaving
        gid = torch.where(leaving, elem_gid[torch.clamp(new_elem, min=0).long()],
                          INVALID)
        payload, field_slices = _pack_payload(state, gid)
        send = _set_drop(payload.new_full((sum(send_rows), payload.shape[1]), INVALID),
                         slot, payload)
    recv = group.ragged_all_to_all(send, send_rows, recv_rows)
    with group.split("glue"):
        new_state, num_recv, num_unres, recv_over = _place_arrivals(
            state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm)
    return MigrateResult(new_state, leaving.sum(dtype=torch.int32), num_recv,
                         overflow | recv_over, num_unres,
                         illegal.sum(dtype=torch.int32) if neighbour else z,
                         kept.sum(dtype=torch.int32))


def migrate_structure(ps, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
                      my_rank: int, num_ranks: int, cap: int,
                      plan: Optional[NeighborPlan] = None, hier: bool = False
                      ) -> Tuple[object, MigrateResult]:
    """Migration of a particle structure of any layout (scs, csr, cabm,
    dps): its member fields ride the exchange, arrivals take free slots,
    then ``rebuild`` restores the layout on the merged population.
    Returns (structure, result); the structure's ``overflowed`` covers
    the layout, ``result.overflow`` the exchange."""
    state = dict(ps.fields)
    state["elem"] = ps.elem
    state["active"] = ps.active
    res = migrate(state, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
                  my_rank, num_ranks, cap, plan=plan, hier=hier)
    m = res.state
    ps2 = dataclasses.replace(ps, fields={k: m[k] for k in ps.fields},
                              elem=m["elem"].to(ps.elem.dtype), active=m["active"])
    ps2 = ps2.rebuild(torch.where(m["active"], m["elem"], INVALID))
    return ps2, res
