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
the same on the CPU and the card, bit for bit.  On the card the gathers,
the fan-in and the fan-out are kernel O (``pumipic_torch.ops.exchange``).
"""
from __future__ import annotations

from enum import Enum

import torch

from pumipic_torch.ops import exchange as ex
from pumipic_torch.parallel import group


class Op(Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    BCAST = "bcast"


def reduce_comm_array(send_ids: torch.Tensor, recv_ids: torch.Tensor,
                      field: torch.Tensor, op: Op = Op.SUM,
                      hier: bool = False) -> torch.Tensor:
    """Owner reduction of a per-entity array (V[, k]) over the group: the
    result is the reduced value on every copy of each entity.
    ``send_ids``/``recv_ids``: this rank's (R, K) rows of the picparts'
    exchange tables (:meth:`LocalPicPart.comm_ids`).  ``hier`` routes both
    exchanges through the two stages of a ``("slice", "ranks")`` group,
    equal bit for bit.  On the card: kernel O's gather, fan-in and
    fan-out (SUM/MAX/MIN), its gather and fan-out (BCAST)."""
    exchange = group.hier_all_to_all if hier else group.world_all_to_all
    if op is not Op.BCAST:
        with group.split("glue"):
            send_vals = ex.owner_gather(field, send_ids, ex.neutral(op.value, field.dtype))
        recv_vals = exchange(send_vals)
        with group.split("glue"):
            field, out_vals = ex.owner_fan_in(field, recv_vals, recv_ids, op.value)
    else:
        with group.split("glue"):
            out_vals = ex.owner_gather(field, recv_ids, 0)
    back = exchange(out_vals)
    with group.split("glue"):
        return ex.owner_fan_out(field, back, send_ids)
