"""Framework initialization: the ``pumipic::Library`` analog (port of
``pumipic_tpu.library``; src/pumipic_library.cpp:5-30).

The reference's Library nests MPI/PCU/Kokkos init and finalize with
ownership flags.  Here the object holds the run's choices: the rank
group (joined, or initialised through
:func:`pumipic_torch.parallel.group.init`), the timing registry and the
debug checks, and it is the one context an application holds.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from pumipic_torch.parallel import group
from pumipic_torch.utils import timing


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class NanCheck(TorchFunctionMode):
    """The port's counterpart of ``jax_debug_nans``: every torch function's
    floating-point outputs are read on the host, and one that holds a NaN
    raises ``FloatingPointError`` naming the function.  As with JAX, making
    a tensor from data (``torch.tensor``, ``torch.as_tensor``,
    ``torch.from_numpy``) does not raise.  Unlike JAX, the check sees only
    torch functions: a NaN that a hand-written kernel (launched through its
    C interface) or a write through a host view puts into a tensor raises
    at the first torch function whose output holds it, not where it was
    written."""

    UNCHECKED = (torch.tensor, torch.as_tensor, torch.from_numpy)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in self.UNCHECKED:
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    name = getattr(func, "__qualname__", getattr(func, "__name__", func))
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in the output of {name}")
        return out


@dataclasses.dataclass
class Library:
    """Session context: the rank group and the observability switches.

    ``num_ranks``: the group's size.  Where a group is already initialised
    it is joined (a ``num_ranks`` that differs raises); where none is and
    ``num_ranks`` (or torchrun's ``WORLD_SIZE``) is above 1, one is
    initialised from torchrun's environment over nccl on the cards (a
    group on the CPU is initialised by the caller, ``group.init(...,
    device="cpu")``, and joined) and finalised by :meth:`finalize`;
    otherwise the process is rank 0 of 1.
    ``debug_checks`` turns on :class:`NanCheck` (the counterpart of
    ``jax_debug_nans``, which the JAX package's Library turns on) until
    :meth:`finalize`.
    """

    num_ranks: Optional[int] = None
    enable_timing: bool = True
    debug_checks: bool = False

    def __post_init__(self):
        self._own_group = False
        self._nan_check = None
        if group.initialized():
            if self.num_ranks not in (None, group.num_ranks()):
                raise ValueError(f"num_ranks={self.num_ranks}, but the group has "
                                 f"{group.num_ranks()} ranks")
        else:
            n = self.num_ranks or int(os.environ.get("WORLD_SIZE", 1))
            if n > 1:
                group.init("nccl", world_size=n)
                self._own_group = True
        if self.enable_timing:
            timing.enable_timing()
        else:
            timing.disable_timing()
        if self.debug_checks:
            self._nan_check = NanCheck()
            self._nan_check.__enter__()

    @property
    def world_size(self) -> int:
        return group.num_ranks()

    def summarize(self) -> str:
        return timing.summarize_time()

    def finalize(self) -> None:
        """Print the timing summary, end the debug checks and leave a group
        this Library initialised; the reference's teardown order."""
        if self.enable_timing:
            self.summarize()
        if self._nan_check is not None:
            self._nan_check.__exit__(None, None, None)
            self._nan_check = None
        if self._own_group:
            group.finalize()
            self._own_group = False
