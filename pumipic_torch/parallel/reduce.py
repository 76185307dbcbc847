"""Mesh-field reduction across buffered picpart copies (port of
``pumipic_tpu.parallel.reduce``; ``Mesh::reduceCommArray``,
src/pumipic_comm.cpp:222-440).

Fan-in: each rank sends its copies of entities owned elsewhere to their
owners (one ``all_to_all_single`` of the (R, K) exchange rows), and the
owner reduces them into its value; fan-out: the owner sends the reduced
values back along the same routes.  SUM adds the arrivals in source-rank
order (rank 0's copy first), as the JAX package's ``segment_sum`` over the
R·K rows does: each source's rows name an owned entity at most once, so
one ``index_add_`` per source rank has no colliding keys and the sum is
the same on the CPU and the card, bit for bit.
"""
from __future__ import annotations

from enum import Enum

import torch

from pumipic_torch.parallel import group
from pumipic_torch.parallel.migrate import _set_drop


class Op(Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    BCAST = "bcast"


def _neutral(op: Op, dtype: torch.dtype):
    if dtype.is_floating_point:
        return {Op.SUM: 0.0, Op.MAX: float("-inf"), Op.MIN: float("inf")}[op]
    info = torch.iinfo(dtype)
    return {Op.SUM: 0, Op.MAX: info.min, Op.MIN: info.max}[op]


def _gather_rows(field: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """field[ids] with ``fill`` where an id is -1."""
    vals = field[torch.clamp(ids, min=0).long()]
    mask = ids >= 0
    if vals.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (vals.dim() - mask.dim()))
    return torch.where(mask, vals, torch.full((), fill, dtype=vals.dtype,
                                              device=vals.device))


def reduce_comm_array(send_ids: torch.Tensor, recv_ids: torch.Tensor,
                      field: torch.Tensor, op: Op = Op.SUM,
                      hier: bool = False) -> torch.Tensor:
    """Owner reduction of a per-entity array (V[, k]) over the group: the
    result is the reduced value on every copy of each entity.
    ``send_ids``/``recv_ids``: this rank's (R, K) rows of the picparts'
    exchange tables (:meth:`LocalPicPart.comm_ids`).  ``hier`` (the
    two-stage route) raises."""
    group.check_flat(hier)
    V = field.shape[0]
    R, K = send_ids.shape
    if op is not Op.BCAST:
        with group.split("glue"):
            send_vals = _gather_rows(field, send_ids, _neutral(op, field.dtype))
        recv_vals = group.world_all_to_all(send_vals)
        with group.split("glue"):
            keys = torch.where(recv_ids >= 0, recv_ids, V).long()
            contrib = torch.full((V + 1,) + tuple(field.shape[1:]),
                                 _neutral(op, field.dtype), dtype=field.dtype,
                                 device=field.device)
            if op is Op.SUM:
                for s in range(R):
                    contrib.index_add_(0, keys[s], recv_vals[s])
                field = field + contrib[:V]
            else:
                red = "amax" if op is Op.MAX else "amin"
                flat = recv_vals.reshape((R * K,) + tuple(field.shape[1:]))
                idx = keys.reshape(-1)
                if flat.dim() > 1:
                    idx = idx.reshape((-1,) + (1,) * (flat.dim() - 1)).expand_as(flat)
                contrib.scatter_reduce_(0, idx, flat, reduce=red, include_self=True)
                field = (torch.maximum if op is Op.MAX else torch.minimum)(
                    field, contrib[:V])
    with group.split("glue"):
        out_vals = _gather_rows(field, recv_ids, 0)
    back = group.world_all_to_all(out_vals)
    with group.split("glue"):
        tgt = torch.where(send_ids >= 0, send_ids, V).reshape(-1)
        field = _set_drop(field, tgt, back.reshape((R * K,) + tuple(field.shape[1:])))
    return field
