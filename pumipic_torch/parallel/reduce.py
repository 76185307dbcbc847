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
the fan-in and the fan-out are kernel O (``pumipic_torch.ops.exchange``);
the picparts step's SUM takes its send rows from kernel D
(:func:`sum_send_rows`), so it launches O twice.
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


def sum_send_rows(send_ids: torch.Tensor, num_entities: int):
    """(row_of (V,) int32, send (R, K) f32 zeros) for SUM's send rows
    written by kernel D (``scatter_to_mapped_verts(..., send_rows=)``): the
    row of each copy owned elsewhere, and a buffer whose rows that name no
    entity hold SUM's neutral value, 0, for good (D writes the named rows
    only).  Built once per picpart; pass ``send`` to :func:`reduce_comm_array`
    as ``send_vals``."""
    row_of = ex.fan_out_rows(send_ids.detach().cpu().numpy(), num_entities, send_ids.device)
    return row_of, torch.zeros(tuple(send_ids.shape), dtype=torch.float32,
                               device=send_ids.device)


def reduce_comm_array(send_ids: torch.Tensor, recv_ids: torch.Tensor,
                      field: torch.Tensor, op: Op = Op.SUM,
                      hier: bool = False, send_vals=None) -> torch.Tensor:
    """Owner reduction of a per-entity array (V[, k]) over the group: the
    result is the reduced value on every copy of each entity, in a new
    tensor (``field`` is not written).  ``send_ids``/``recv_ids``: this
    rank's (R, K) rows of the picparts' exchange tables
    (:meth:`LocalPicPart.comm_ids`).  ``hier`` routes both exchanges
    through the two stages of a ``("slice", "ranks")`` group, equal bit for
    bit.  ``send_vals`` (SUM, MAX, MIN): the (R, K[, k]) rows the fan-in
    sends, ``field[send_ids]`` with the op's neutral value where an id is
    -1, when the caller already holds them (the picparts step: kernel D
    wrote them, :func:`sum_send_rows`); else they are gathered.  On the
    card: kernel O's gather (unless ``send_vals``), fan-in and in-place
    fan-out (SUM/MAX/MIN), its gather and fan-out (BCAST).

    ``send_vals`` may be a buffer the caller writes again for the next
    call: the exchange reads it before it returns on gloo (host-staged),
    and on NCCL the collective is waited on from the current stream
    (``all_to_all_single`` without ``async_op``), so a later kernel on that
    stream writes it only after the collective has read it."""
    exchange = group.hier_all_to_all if hier else group.world_all_to_all
    if op is Op.BCAST:
        if send_vals is not None:
            raise ValueError("BCAST sends the owners' rows; send_vals is for the fan-in")
        with group.split("glue"):
            out_vals = ex.owner_gather(field, recv_ids, 0)
        back = exchange(out_vals)
        with group.split("glue"):
            return ex.owner_fan_out(field, back, send_ids)
    if send_vals is None:
        with group.split("glue"):
            send_vals = ex.owner_gather(field, send_ids, ex.neutral(op.value, field.dtype))
    recv_vals = exchange(send_vals)
    with group.split("glue"):
        field, out_vals = ex.owner_fan_in(field, recv_vals, recv_ids, op.value)
    back = exchange(out_vals)
    with group.split("glue"):
        # in place: the fan-in's own output
        return ex.owner_fan_out_(field, back, send_ids)
