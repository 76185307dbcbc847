"""The distributed step's exchange and owner reduction: kernels X1, X2, X3
and O (``kernels/csrc/exchange.cu``, ``kernels/csrc/owner.cu``).

- :func:`rank_in_key` (X1): each item's stable rank among the items of its
  key (the rank in index order a stable argsort gives) and every key's
  count; the migration's buckets, the balancer's candidates and
  weights.
- :func:`pack_send` (X2): the admitted leavers' rows of the send buffer
  (gid, then every member field as int32 lanes).
- :func:`place_arrivals` (X3): the arrivals' local elements and their
  placement into the free slots, the member fields written in place.
- :func:`owner_gather`, :func:`owner_fan_in`, :func:`owner_fan_out_` (O):
  the owner reduction's three steps around its two collectives (the
  picparts step's SUM takes its send rows from kernel D instead of the
  gather: ``ops/scatter.py``'s ``send_rows``).

Each wrapper runs its plain PyTorch version (``*_plain``: the JAX
package's arithmetic, ``pumipic_tpu/parallel/migrate.py``, ``balancer.py``
and ``reduce.py``) on CPU tensors and launches its kernel on CUDA tensors;
every output is an integer or a moved bit pattern, or a sum in a fixed
order, so the two are equal bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

INVALID = -1
# keys a tile's shared-memory table of kernel X1 holds (48 KB of counters,
# one row for keys out of range): num_keys + 1 must not exceed it
X1_MAX_KEYS = 48 * 1024 // 4 - 1
# keys kernel X1 takes at most: a status word's 30-bit count
X1_MAX_ITEMS = 1 << 30
# member fields one launch of X2 or X3 moves
X_MAX_FIELDS = 16

_P = ctypes.c_void_p


def _ptr(t: Optional[torch.Tensor]):
    return _P(t.data_ptr() if t is not None else 0)


def _stream():
    return _P(kernels.stream_handle())


# ---------------------------------------------------------------------------
# X1: rank within key
# ---------------------------------------------------------------------------

def key_starts(sorted_key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(num_keys + 1,) int64: the position of the first key >= k in the
    sorted keys, for k = 0..num_keys."""
    return torch.searchsorted(sorted_key, torch.arange(
        num_keys + 1, dtype=sorted_key.dtype, device=sorted_key.device))


def rank_in_key_plain(key: torch.Tensor, num_keys: int, ranks: bool = True):
    """Plain version of kernel X1: a stable sort, each key's first position
    and the rank scattered back through the sort order (the JAX package's
    ``rank_within_key``/``_bucket_ranks``)."""
    N = key.shape[0]
    sorted_key, order = torch.sort(key, stable=True)
    starts = key_starts(sorted_key, num_keys)
    counts = torch.diff(starts, append=starts.new_full((1,), N)).to(torch.int32)
    if not ranks:
        return None, counts
    rank_sorted = (torch.arange(N, dtype=torch.int64, device=key.device)
                   - starts[torch.clamp(sorted_key, max=num_keys).long()]).to(torch.int32)
    rank = torch.empty(N, dtype=torch.int32, device=key.device)
    rank[order] = rank_sorted
    return rank, counts


def rank_in_key(key: torch.Tensor, num_keys: int, ranks: bool = True):
    """(rank, counts) of (N,) int32 keys in [0, num_keys]: ``rank[i]`` the
    number of items j < i with ``key[j] == key[i]`` (None with ``ranks``
    False), ``counts`` the (num_keys + 1,) int32 count of each key, key
    ``num_keys`` (the callers' "ignored") included.  Raises on a key
    outside [0, num_keys], where num_keys + 1 exceeds ``X1_MAX_KEYS`` and
    where N reaches ``X1_MAX_ITEMS``, on every device.  Kernel X1 on CUDA
    tensors (one launch counted: a memset of its scratch and one kernel),
    :func:`rank_in_key_plain` on CPU tensors."""
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError("rank_in_key: (N,) int32 keys expected")
    if num_keys < 0 or num_keys + 1 > X1_MAX_KEYS:
        raise ValueError(f"rank_in_key: {num_keys + 1} keys; a tile's table holds "
                         f"at most {X1_MAX_KEYS}")
    if key.shape[0] >= X1_MAX_ITEMS:
        raise ValueError(f"rank_in_key: {key.shape[0]} keys; a status word counts "
                         f"fewer than {X1_MAX_ITEMS}")
    if not kernels.use_kernel("rank_in_key", key):
        if key.numel() and (int(key.min()) < 0 or int(key.max()) > num_keys):
            raise ValueError(f"rank_in_key: a key outside [0, {num_keys}]")
        return rank_in_key_plain(key, num_keys, ranks)
    n = key.shape[0]
    lib = _build.lib()
    counts = torch.empty(num_keys + 2, dtype=torch.int32, device=key.device)
    words = lib.pp_rank_in_key_scratch(n, num_keys + 1, int(ranks))
    if words < 0:
        raise ValueError(f"rank_in_key: {n} keys of {num_keys + 1}: status words "
                         f"beyond an int32 count")
    scratch = torch.empty(words, dtype=torch.int32, device=key.device)
    rank = torch.empty(n, dtype=torch.int32, device=key.device) if ranks else None
    err = lib.pp_rank_in_key(_ptr(key), n, num_keys + 1, _ptr(rank), _ptr(counts),
                             _ptr(scratch), _stream())
    _build.check(err, "rank_in_key")
    kernels.LAUNCHES["rank_in_key"] += 1
    if int(counts[-1]):
        raise ValueError(f"rank_in_key: {int(counts[-1])} keys outside [0, {num_keys}]")
    return rank, counts[:-1]


def key_counts(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(num_keys,) int32 count of each key in [0, num_keys) (key
    ``num_keys`` ignored): :func:`rank_in_key`'s counts."""
    return rank_in_key(key, num_keys, ranks=False)[1][:num_keys]


# ---------------------------------------------------------------------------
# payload lanes
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


def payload_layout(state: Dict[str, torch.Tensor]):
    """Each member field's (lo, hi, dtype, inner shape) in a payload row:
    lane 0 the gid, then the fields sorted by name ("elem" and "active"
    stay home)."""
    field_slices, off = {}, 1
    for name in sorted(state):
        if name in ("elem", "active"):
            continue
        v = state[name]
        if v.dtype not in (torch.float32, torch.int32, torch.bool):
            raise TypeError(f"unsupported migrate dtype {v.dtype}")
        lanes = int(np.prod(v.shape[1:], dtype=np.int64))
        field_slices[name] = (off, off + lanes, v.dtype, tuple(v.shape[1:]))
        off += lanes
    return field_slices, off


def pack_payload(state, gid):
    """gid and every member field (sorted by name) as one (N, F) int32
    buffer, and each field's (lo, hi, dtype, inner shape)."""
    parts = [gid.to(torch.int32)[:, None]]
    field_slices, _ = payload_layout(state)
    for name in field_slices:
        parts.append(_to_lanes(state[name]))
    return torch.cat(parts, dim=1), field_slices


DROP_ROWS = 1024   # scratch rows that dropped writes spread over


def set_drop(base, idx, vals):
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


def _fields(state, field_slices, outs=None):
    """Host arrays of kernel X2/X3's field descriptors."""
    names = list(field_slices)
    m = len(names)
    if m > X_MAX_FIELDS:
        raise ValueError(f"{m} member fields; one launch moves at most {X_MAX_FIELDS}")
    srcs, dsts, lanes, is_bool, offs = [], [], [], [], []
    for name in names:
        lo, hi, dtype, _ = field_slices[name]
        v = state[name]
        if not v.is_contiguous():
            raise ValueError(f"member field {name} is not contiguous")
        srcs.append(v.data_ptr())
        dsts.append(outs[name].data_ptr() if outs is not None else 0)
        lanes.append(hi - lo)
        is_bool.append(int(dtype == torch.bool))
        offs.append(lo)
    k = max(m, 1)
    c_int = ctypes.c_int
    return (m, (_P * k)(*srcs), (_P * k)(*dsts), (c_int * k)(*lanes),
            (c_int * k)(*is_bool), (c_int * k)(*offs))


# ---------------------------------------------------------------------------
# X2: the send buffer
# ---------------------------------------------------------------------------

def pack_send_plain(state, key, rank, counts, quota, rows_of_bucket: Sequence[int],
                    cap: int, new_elem, elem_gid):
    """Plain version of kernel X2: the JAX package's ``_slots_from_ranks``
    (admission by ``min(cap, quota)``), ``_pack_payload`` and
    ``_fill_send`` into consecutive bucket rows."""
    D = len(rows_of_bucket)
    dev = key.device
    total = int(sum(rows_of_bucket))
    if D == 0:
        none = torch.zeros(key.shape[0], dtype=torch.bool, device=dev)
        admitted = kept = none
        slot = torch.zeros(key.shape[0], dtype=torch.int64, device=dev)
    else:
        b = torch.clamp(key, max=D - 1).long()
        is_leaver = key < D
        admitted = is_leaver & (rank < torch.clamp(quota.to(torch.int32), max=cap)[b])
        kept = is_leaver & ~admitted
        offsets = torch.as_tensor(np.cumsum([0] + list(rows_of_bucket[:-1]), dtype=np.int64),
                                  device=dev)
        slot = torch.where(admitted, offsets[b] + rank, total)
    gid = torch.where(admitted, elem_gid[torch.clamp(new_elem, min=0).long()], INVALID)
    payload, field_slices = pack_payload(state, gid)
    send = set_drop(payload.new_full((total, payload.shape[1]), INVALID), slot, payload)
    # overflow: a destination's volume above the bucket size ``cap``
    overflow = torch.any(counts[:D] > cap)
    return send, kept, admitted, overflow, field_slices


def pack_send(state, key, rank, counts, quota, rows_of_bucket: Sequence[int], cap: int,
              new_elem, elem_gid):
    """The send buffer of one rank's admitted leavers.  ``key``/``rank``/
    ``counts``: :func:`rank_in_key` of the bucket keys (bucket id, or D =
    ``len(rows_of_bucket)`` for an item that stays); ``quota`` (D,) the
    receivers' grants; bucket b's first ``min(cap, quota[b])`` items are
    admitted and take rows ``offsets[b] + rank`` (buckets fill consecutive
    rows, ``rows_of_bucket[b]`` each, host ints: the admitted counts).
    Returns (send (Σ rows, F) int32, kept (leavers beyond their quota),
    leaving (the admitted), overflow (a bucket's count above ``cap``),
    the payload layout).  Kernel X2 on CUDA tensors."""
    if not kernels.use_kernel("pack_send", key, rank, counts, quota, new_elem, elem_gid,
                              *(state[k] for k in state)):
        return pack_send_plain(state, key, rank, counts, quota, rows_of_bucket, cap,
                               new_elem, elem_gid)
    n, D = key.shape[0], len(rows_of_bucket)
    dev = key.device
    field_slices, width = payload_layout(state)
    total = int(sum(rows_of_bucket))
    offsets = torch.as_tensor(np.cumsum([0] + list(rows_of_bucket[:-1]), dtype=np.int64)
                              if D else np.zeros(1, np.int64), device=dev)
    send = torch.full((total, width), INVALID, dtype=torch.int32, device=dev)
    kept = torch.empty(n, dtype=torch.bool, device=dev)
    leaving = torch.empty(n, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    quota = quota.to(torch.int32).contiguous()
    m, srcs, _, lanes, is_bool, _ = _fields(state, field_slices)
    err = _build.lib().pp_pack_send(
        _ptr(key), _ptr(rank), n, D, _ptr(quota), cap, _ptr(offsets), _ptr(new_elem),
        _ptr(elem_gid), m, srcs, lanes, is_bool, width, _ptr(send), _ptr(kept),
        _ptr(leaving), _ptr(counts), _ptr(overflow), _stream())
    _build.check(err, "pack_send")
    kernels.LAUNCHES["pack_send"] += 1
    return send, kept, leaving, overflow, field_slices


# ---------------------------------------------------------------------------
# X3: arrivals into the free slots
# ---------------------------------------------------------------------------

def gid_to_lid(gid_sorted, gid_perm, gids) -> torch.Tensor:
    """Global element ids -> local ids by binary search over the sorted
    gid table; -1 where absent."""
    E = gid_sorted.shape[0]
    pos = torch.searchsorted(gid_sorted, gids.to(gid_sorted.dtype).contiguous())
    pos_c = torch.clamp(pos, max=E - 1)
    found = (gid_sorted[pos_c] == gids) & (gids >= 0)
    return torch.where(found, gid_perm[pos_c], INVALID).to(torch.int32)


def place_arrivals_plain(state, staying, new_elem, recv, field_slices, gid_sorted,
                         gid_perm):
    """Plain version of kernel X3: the JAX package's ``_place_arrivals``
    (free slots from a stable argsort of ``staying``, arrivals placed with
    dropped writes)."""
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
    new_state["elem"] = set_drop(torch.where(staying, new_elem, INVALID), arr_slot, arr_lid)
    new_state["active"] = set_drop(staying, arr_slot, arr_valid)
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
        new_state[name] = set_drop(torch.where(keep, v, torch.zeros_like(v)), arr_slot, vals)
    return new_state, num_recv, num_unresolved, recv_overflow


def place_arrivals(state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm):
    """Translate the arrivals' gids (``recv[:, 0]``) to local elements and
    place the arrivals into the free slots (``~staying``) in ascending slot
    order, in arrival order; stayers keep their slots, other free slots
    are cleared (elem -1, active False, fields 0).  Returns (new state,
    num_recv, num_unresolved, recv_overflow).

    The caller gives ``state``'s member fields up, on every device: they
    are written in place and the new state holds those same tensors, with
    a new ``elem`` and ``active``.  On CUDA tensors kernel X3 writes the
    arrivals and the cleared slots alone (the staying slots are neither
    read nor written); on CPU tensors the plain version's fields are
    copied into them (the staying slots keep their values).  A caller
    that still needs the old fields passes copies.  X3 ranks the free
    slots itself (no kernel X1)."""
    if not kernels.use_kernel("place_arrivals", staying, new_elem, recv, gid_sorted,
                              gid_perm, *(state[k] for k in field_slices)):
        new_state, num_recv, num_unres, overflow = place_arrivals_plain(
            state, staying, new_elem, recv, field_slices, gid_sorted, gid_perm)
        for name in field_slices:
            new_state[name] = state[name].copy_(new_state[name])
        return new_state, num_recv, num_unres, overflow
    n, dev = new_elem.shape[0], new_elem.device
    m, width = recv.shape
    if width != 1 + sum(hi - lo for lo, hi, _, _ in field_slices.values()):
        raise ValueError("place_arrivals: payload rows do not match the layout")
    lib = _build.lib()
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    active = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.pp_place_arrivals_scratch(n, m), dtype=torch.int32,
                          device=dev)
    fields = {name: state[name] for name in field_slices}
    k, _, dsts, lanes, is_bool, offs = _fields(state, field_slices, fields)
    err = lib.pp_place_arrivals(
        _ptr(staying), _ptr(new_elem), n, _ptr(recv), m, width, _ptr(gid_sorted),
        _ptr(gid_perm), gid_sorted.shape[0], k, dsts, lanes, is_bool, offs, _ptr(scratch),
        _ptr(stats), _ptr(overflow), _ptr(elem), _ptr(active), _stream())
    _build.check(err, "place_arrivals")
    kernels.LAUNCHES["place_arrivals"] += 1
    new_state = {"elem": elem, "active": active, **fields}
    return new_state, stats[0], stats[1], overflow


# ---------------------------------------------------------------------------
# O: the owner reduction
# ---------------------------------------------------------------------------

OPS = ("sum", "max", "min")


def neutral(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return {"sum": 0.0, "max": float("-inf"), "min": float("inf")}[op]
    info = torch.iinfo(dtype)
    return {"sum": 0, "max": info.min, "min": info.max}[op]


def _bits(value, dtype: torch.dtype) -> int:
    return int(torch.tensor(value, dtype=dtype).view(torch.int32)) & 0xFFFFFFFF


def _words(field: torch.Tensor, what: str) -> int:
    """32-bit words per entity of an f32 or i32 (V[, k]) field."""
    if field.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"{what}: the kernel takes f32 or i32 fields, not {field.dtype}")
    return int(np.prod(field.shape[1:], dtype=np.int64))


def owner_gather_plain(field: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """Plain version of O's gather: field[ids] with ``fill`` where an id is
    -1."""
    vals = field[torch.clamp(ids, min=0).long()]
    mask = ids >= 0
    if vals.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (vals.dim() - mask.dim()))
    return torch.where(mask, vals, torch.full((), fill, dtype=vals.dtype, device=vals.device))


def owner_gather(field: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """(R, K[, k]) rows ``field[ids]``, ``fill`` where an id is -1.  Kernel
    O's gather on CUDA tensors."""
    if not kernels.use_kernel("owner_reduce", field, ids):
        return owner_gather_plain(field, ids, fill)
    w = _words(field, "owner_gather")
    out = torch.empty(tuple(ids.shape) + tuple(field.shape[1:]), dtype=field.dtype,
                      device=field.device)
    err = _build.lib().pp_owner_gather(_ptr(field), w, _ptr(ids), ids.numel(),
                                       _bits(fill, field.dtype), _ptr(out), _stream())
    _build.check(err, "owner_reduce")
    kernels.LAUNCHES["owner_reduce"] += 1
    return out


def owner_fan_in_plain(field: torch.Tensor, recv_vals: torch.Tensor, recv_ids: torch.Tensor,
                       op: str):
    """Plain version of O's fan-in: the received copies folded into each
    owned entity from the neutral value (SUM: one ``index_add_`` per source
    rank, in rank order, then ``field + contrib``; MAX/MIN: ``scatter_reduce``
    then ``maximum``/``minimum``), and the reduced field's rows the fan-out
    sends back (``field[recv_ids]``, 0 where -1)."""
    V = field.shape[0]
    R, K = recv_ids.shape
    keys = torch.where(recv_ids >= 0, recv_ids, V).long()
    contrib = torch.full((V + 1,) + tuple(field.shape[1:]), neutral(op, field.dtype),
                         dtype=field.dtype, device=field.device)
    if op == "sum":
        for s in range(R):
            contrib.index_add_(0, keys[s], recv_vals[s])
        field = field + contrib[:V]
    else:
        flat = recv_vals.reshape((R * K,) + tuple(field.shape[1:]))
        idx = keys.reshape(-1)
        if flat.dim() > 1:
            idx = idx.reshape((-1,) + (1,) * (flat.dim() - 1)).expand_as(flat)
        contrib.scatter_reduce_(0, idx, flat, reduce="amax" if op == "max" else "amin",
                                include_self=True)
        field = (torch.maximum if op == "max" else torch.minimum)(field, contrib[:V])
    return field, owner_gather_plain(field, recv_ids, 0)


# cached per exchange table: the fan-in's CSR and the fan-out's rows
_MAPS: Dict[tuple, tuple] = {}
_MAPS_KEPT = 32


def _cached_map(ids: torch.Tensor, V: int, build):
    key = (build.__name__, id(ids), ids._version, V)
    hit = _MAPS.get(key)
    if hit is None or hit[0] is not ids:
        while len(_MAPS) >= _MAPS_KEPT:
            _MAPS.pop(next(iter(_MAPS)))
        hit = _MAPS[key] = (ids, build(ids.detach().cpu().numpy(), V, ids.device))
    return hit[1]


def fan_in_csr(recv: np.ndarray, V: int, device):
    """Entity -> its received rows (r·K + k), in source-rank order: (V + 1,)
    offsets and the rows, int32 on ``device``."""
    flat = recv.reshape(-1).astype(np.int64)
    rows = np.nonzero(flat >= 0)[0]
    ent = flat[rows]
    if ent.size and ent.max() >= V:
        raise ValueError(f"recv_ids names entity {int(ent.max())} of {V}")
    rows = rows[np.argsort(ent, kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(ent, minlength=V))])
    return (torch.as_tensor(offsets.astype(np.int32), device=device),
            torch.as_tensor(rows.astype(np.int32), device=device))


def fan_out_rows(send: np.ndarray, V: int, device):
    """(V,) int32 on ``device``: the row (o·K + k) the owner sends back to
    each copy, -1 for an entity this rank owns or holds no copy of."""
    flat = send.reshape(-1).astype(np.int64)
    rows = np.nonzero(flat >= 0)[0]
    ent = flat[rows]
    if ent.size and ent.max() >= V:
        raise ValueError(f"send_ids names entity {int(ent.max())} of {V}")
    if np.unique(ent).size != ent.size:
        raise ValueError("send_ids names an entity twice")
    row_of = np.full(V, -1, np.int32)
    row_of[ent] = rows
    return torch.as_tensor(row_of, device=device)


def owner_fan_in(field: torch.Tensor, recv_vals: torch.Tensor, recv_ids: torch.Tensor,
                 op: str):
    """(reduced field, fan-out rows): each owned entity's value combined
    with the copies received from the other ranks (``recv_vals`` (R, K[, k])
    against ``recv_ids`` (R, K)), folded in source-rank order from the
    neutral value; and the reduced value at every (r, k) of ``recv_ids``
    (0 where -1), the rows the fan-out returns.  Kernel O's fan-in on CUDA
    tensors (the CSR built once per ``recv_ids`` tensor)."""
    if op not in OPS:
        raise ValueError(f"unknown reduction {op!r}")
    if not kernels.use_kernel("owner_reduce", field, recv_vals, recv_ids):
        return owner_fan_in_plain(field, recv_vals, recv_ids, op)
    w = _words(field, "owner_fan_in")
    V = field.shape[0]
    offsets, rows = _cached_map(recv_ids, V, fan_in_csr)
    out = torch.empty_like(field)
    back = torch.zeros_like(recv_vals)
    err = _build.lib().pp_owner_fan_in(
        _ptr(field), _ptr(recv_vals), w, V, _ptr(offsets), _ptr(rows), OPS.index(op),
        int(field.dtype == torch.int32), _bits(neutral(op, field.dtype), field.dtype),
        _ptr(out), _ptr(back), _stream())
    _build.check(err, "owner_reduce")
    kernels.LAUNCHES["owner_reduce"] += 1
    return out, back


def owner_fan_out_plain(field: torch.Tensor, back: torch.Tensor, send_ids: torch.Tensor):
    """Plain version of O's fan-out: the returned rows written over the
    copies ``send_ids`` names (dropped writes for -1), in a new field."""
    V = field.shape[0]
    R, K = send_ids.shape
    tgt = torch.where(send_ids >= 0, send_ids, V).reshape(-1)
    return set_drop(field, tgt, back.reshape((R * K,) + tuple(field.shape[1:])))


def owner_fan_out_(field: torch.Tensor, back: torch.Tensor, send_ids: torch.Tensor):
    """In place: each copy named in ``send_ids`` (R, K) takes the row its
    owner returned (``back`` (R, K[, k])), every other entity of ``field``
    keeps its value; returns ``field``.  Give it a field the caller owns
    (the fan-in's output), not one it was handed.  Kernel O's fan-out on
    CUDA tensors: a thread a (row, lane) of the R·K rows (the tables are
    checked once per ``send_ids`` tensor: each copy named once)."""
    V = field.shape[0]
    if not kernels.use_kernel("owner_reduce", field, back, send_ids):
        named = send_ids >= 0
        field[send_ids[named].long()] = back[named]
        return field
    w = _words(field, "owner_fan_out")
    if not field.is_contiguous():
        raise ValueError("owner_fan_out_: the field must be contiguous")
    _cached_map(send_ids, V, fan_out_rows)
    back = back.contiguous()
    err = _build.lib().pp_owner_fan_out(_ptr(back), w, _ptr(send_ids), send_ids.numel(),
                                        _ptr(field), _stream())
    _build.check(err, "owner_reduce")
    kernels.LAUNCHES["owner_reduce"] += 1
    return field


def owner_fan_out(field: torch.Tensor, back: torch.Tensor, send_ids: torch.Tensor):
    """A new field: :func:`owner_fan_out_` on a copy of ``field``."""
    if not kernels.use_kernel("owner_reduce", field, back, send_ids):
        return owner_fan_out_plain(field, back, send_ids)
    return owner_fan_out_(field.clone(), back, send_ids)
