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
picpart lacks) and fill free slots in arrival order.  On the card the
bookkeeping runs on kernels X1 (ranks within the buckets, the free slots),
X2 (the send buffer) and X3 (the placement), ``pumipic_torch.ops.exchange``;
the route (destination, sbar, non-core flag) on kernel Y1,
``pumipic_torch.ops.route``.

With a neighbour plan (the ``Distributor``-scoped exchange,
SCS_migrate.h:41-62) only the plan's peers are destinations: leavers bound
elsewhere stay home and are counted in ``num_illegal_dest``; the results
equal the world exchange's bit for bit otherwise.

The functions take one rank's local tensors and ``my_rank`` (an int);
the collectives run over the default process group (``hier``: through the
two stages of a ``("slice", "ranks")`` group, equal bit for bit).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pumipic_torch.ops import counts as cnt
from pumipic_torch.ops import exchange as ex
from pumipic_torch.ops import route as rt
from pumipic_torch.ops.exchange import gid_to_lid  # noqa: F401  (the JAX module's)
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
    :func:`pack_route` value: kernel Y1's packed form
    (:func:`pumipic_torch.ops.route.route_packed`), whose live mask the
    steps take too."""
    r = rt.route_packed(route, new_elem, active, my_rank, num_ranks)
    return r.dest, r.sbar, r.noncore


def route_decode(v, ok, my_rank: int, num_ranks: int):
    """Decode pre-gathered :func:`pack_route` values in the JAX package's
    f32 arithmetic (divisions by 0-d tensors: IEEE on the card too): the
    plain versions' decode; on the steps' path kernel Y1 decodes as it
    gathers (:mod:`pumipic_torch.ops.route`)."""
    return rt.route_decode_plain(v, ok, my_rank, num_ranks)


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
    (each colour a partial permutation).  ``slice_of_rank`` (R,) colours
    the edges within a slice into the leading rounds and those across
    slices after them, as the JAX package's multi-slice schedule does."""
    nb = np.asarray(distributor.is_neighbor)
    R = nb.shape[0]
    edges = sorted((r, s) for r in range(R) for s in range(R) if r != s and nb[r, s])
    if slice_of_rank is not None:
        sl = np.asarray(slice_of_rank)
        intra = [e for e in edges if sl[e[0]] == sl[e[1]]]
        inter = [e for e in edges if sl[e[0]] != sl[e[1]]]
    else:
        intra, inter = edges, []
    colors = {}
    src_used = {r: set() for r in range(R)}
    dst_used = {r: set() for r in range(R)}

    def colour(batch, c0):
        for r, s in batch:
            c = c0
            while c in src_used[r] or c in dst_used[s]:
                c += 1
            colors[(r, s)] = c
            src_used[r].add(c)
            dst_used[s].add(c)

    colour(intra, 0)
    num_intra = max(colors.values(), default=-1) + 1
    colour(inter, num_intra)
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
                        num_intra if slice_of_rank is not None else rounds)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

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


def migrate(state: Dict[str, torch.Tensor], new_elem, dest_rank, elem_gid,
            gid_sorted, gid_perm, my_rank: int, num_ranks: int, cap: int,
            plan: Optional[NeighborPlan] = None, hier: bool = False
            ) -> MigrateResult:
    """Bucketed migration of one rank's flat state (with "elem" and
    "active").  With ``plan`` only the plan's peers are destinations
    (leavers bound elsewhere stay home, ``num_illegal_dest``); without
    it, every rank.  ``hier`` routes the payload through the two-stage
    exchange of a ``("slice", "ranks")`` group
    (:func:`~pumipic_torch.parallel.group.hier_ragged_all_to_all`): the
    arrivals and every result are the flat exchange's, bit for bit.  The
    caller gives ``state`` up: on the card the arrivals are written into
    its member field tensors in place (:func:`~pumipic_torch.ops.exchange.
    place_arrivals`); read the result from the returned state."""
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
        routed = wants_leave & (bucket >= 0)
        n_free_min = cnt.slot_counts([[("clear", state["active"])]])[0]     # kernel N
        # bucket ids in [0, D), D for every item that stays (X1)
        key = torch.where(routed, bucket, D).to(torch.int32)
        rank, counts = ex.rank_in_key(key, D)
        counts_dest = torch.zeros(R, dtype=torch.int32, device=dev)
        counts_dest[peer_ids] = counts[:D]
    quota, admit = _negotiate_quota(counts_dest, K, n_free_min)
    with group.split("glue"):
        # the split sizes on the host: one sync, which the host-staged
        # exchange needs anyway; only admitted rows travel (X2)
        send_rows, recv_rows = torch.stack([quota, admit]).tolist()
        send, kept, leaving, overflow, field_slices = ex.pack_send(
            state, key, rank, counts, quota[peer_ids], [send_rows[p] for p in peers], K,
            new_elem, elem_gid)
        staying = active & ~leaving
    exchange = group.hier_ragged_all_to_all if hier else group.ragged_all_to_all
    recv = exchange(send, send_rows, recv_rows)
    with group.split("glue"):
        # the arrivals into the free slots, in place (X3)
        new_state, num_recv, num_unres, recv_over = ex.place_arrivals(
            state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm)
        # kernel N: the sent, kept-home and illegal counts in one launch
        # (illegal: wanting to leave for a rank outside the plan)
        counts = [[("set", leaving)], [("set", kept)]]
        if neighbour:
            counts.append([("set", wants_leave), ("neg", bucket)])
        c = cnt.slot_counts(counts)
    return MigrateResult(new_state, c[0], num_recv, overflow | recv_over, num_unres,
                         c[2] if neighbour else z, c[1])


def migrate_structure(ps, new_elem, dest_rank, elem_gid, gid_sorted, gid_perm,
                      my_rank: int, num_ranks: int, cap: int,
                      plan: Optional[NeighborPlan] = None, hier: bool = False
                      ) -> Tuple[object, MigrateResult]:
    """Migration of a particle structure of any layout (scs, csr, cabm,
    dps): its member fields ride the exchange, arrivals take free slots,
    then ``rebuild`` restores the layout on the merged population.
    Returns (structure, result); the structure's ``overflowed`` covers
    the layout, ``result.overflow`` the exchange.  ``ps`` is given up (its
    member fields may hold the arrivals, see :func:`migrate`)."""
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
