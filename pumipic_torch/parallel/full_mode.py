"""FULL-buffer mode: pure particle data-parallelism (port of
``pumipic_tpu.parallel.full_mode``).

Every rank holds the complete mesh, particles never migrate, and the
per-step vertex fields are summed over ranks (``Input::FULL``,
src/pumipic_comm.cpp:233-247).  The JAX package's ``psum`` inside
``shard_map`` becomes ``torch.distributed.all_reduce``; on one process
(``torch.distributed`` not initialized) the sum is the identity.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from pumipic_torch.parallel import group


def shard_particles(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous share of the flat (N,) particle arrays, padded
    to a multiple of the world size with zeros (inactive slots); the whole
    state on one process."""
    if not group.initialized():
        return state
    ws, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, v in state.items():
        rem = (-v.shape[0]) % ws
        if rem:
            v = torch.cat([v, v.new_zeros(rem)])
        m = v.shape[0] // ws
        out[name] = v[rank * m:(rank + 1) * m].contiguous()
    return out


def reduce_vertex_field(field: torch.Tensor) -> torch.Tensor:
    """reduceCommArray(FULL, SUM): in-place all_reduce over ranks (a
    collective of the group's split), or the field itself on one process."""
    if group.initialized():
        with group.split("collective"):
            dist.all_reduce(field, op=dist.ReduceOp.SUM)
    return field


def reduce_fields(fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Sum every field over ranks; a field that is another's alias (the
    shared forward/backward map) is reduced once."""
    done = {}
    out = {}
    for name, f in fields.items():
        key = id(f)
        if key not in done:
            done[key] = reduce_vertex_field(f)
        out[name] = done[key]
    return out


def make_dp_step(per_rank_step, keep: Sequence[str] = ()):
    """Wrap a one-rank step ``state -> (state, fields)`` into the FULL-mode
    step whose per-vertex ``fields`` are summed over the group (the JAX
    package's ``shard_map`` + ``psum``); the fields named in ``keep`` (a
    rank's own diagnostics) pass unreduced."""

    def step(local_state):
        new_state, fields = per_rank_step(local_state)
        out = reduce_fields({k: v for k, v in fields.items() if k not in keep})
        out.update({k: fields[k] for k in keep})
        return new_state, out

    return step
