"""Named-operation timing registry (port of ``pumipic_tpu.utils.timing``).

Reference parity: ``support/ppTiming.hpp/.cpp`` — ``RecordTime`` accumulates
per-op total/min/max/sum-of-squares/count (plus optional prebarrier time that
attributes load imbalance ahead of collectives); ``SummarizeTime`` prints a
per-process table (ppTiming.cpp:67-213).

The registry is host-side and wraps steps whose kernels run asynchronously
on the card, so a caller synchronizes before the stop stamp (:func:`timed`
does it).  The prebarrier fence is a timed ``torch.cuda.synchronize`` on
each visible CUDA device: the wait is how long the busiest device's queue
still had to drain.  :class:`DeviceFence` is that fence over a chosen list
of devices, :func:`summarize_across_devices` the cross-device table
(``SummarizeTimeAcrossProcesses``) and :func:`profiling_region` the
``Kokkos::Profiling::pushRegion`` analog.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


@dataclass
class _OpStats:
    count: int = 0
    total: float = 0.0
    tmin: float = math.inf
    tmax: float = 0.0
    sq_total: float = 0.0  # sum of squares, for RMS like reference "sq-avg"
    prebarrier: float = 0.0


@dataclass
class TimingRegistry:
    enabled: bool = True
    verbosity: int = 0
    ops: Dict[str, _OpStats] = field(default_factory=dict)
    _extra_info: list = field(default_factory=list)

    def record(self, name: str, seconds: float, prebarrier: float = 0.0) -> None:
        """RecordTime analog (ppTiming.cpp:67-100)."""
        if not self.enabled:
            return
        s = self.ops.setdefault(name, _OpStats())
        s.count += 1
        s.total += seconds
        s.tmin = min(s.tmin, seconds)
        s.tmax = max(s.tmax, seconds)
        s.sq_total += seconds * seconds
        s.prebarrier += prebarrier
        if self.verbosity >= 1:
            print(f"[timing] {name}: {seconds:.6f}s (pre-barrier {prebarrier:.6f}s)")

    def print_additional_time_info(self, msg: str, level: int = 1) -> None:
        if self.enabled and self.verbosity >= level - 1:
            self._extra_info.append(msg)

    def summarize(self, print_fn: Callable[[str], None] = print) -> str:
        """SummarizeTime analog: per-op table (ppTiming.cpp:168-213)."""
        lines = ["Timing summary (op, count, total, avg, min, max, rms, prebarrier):"]
        for name in sorted(self.ops):
            s = self.ops[name]
            avg = s.total / s.count if s.count else 0.0
            rms = math.sqrt(s.sq_total / s.count) if s.count else 0.0
            lines.append(
                f"  {name:<40s} n={s.count:<6d} tot={s.total:.6f} avg={avg:.6f} "
                f"min={s.tmin if s.count else 0.0:.6f} max={s.tmax:.6f} "
                f"rms={rms:.6f} pre={s.prebarrier:.6f}"
            )
        for msg in self._extra_info:
            lines.append(f"  info: {msg}")
        out = "\n".join(lines)
        if print_fn is not None:
            print_fn(out)
        return out

    def reset(self) -> None:
        self.ops.clear()
        self._extra_info.clear()


# Global registry, mirroring the reference's file-static accumulator.
_REGISTRY = TimingRegistry()


def get_registry() -> TimingRegistry:
    return _REGISTRY


def enable_timing() -> None:
    _REGISTRY.enabled = True


def disable_timing() -> None:
    _REGISTRY.enabled = False


def set_timing_verbosity(v: int) -> None:
    _REGISTRY.verbosity = v


def record_time(name: str, seconds: float, prebarrier: float = 0.0) -> None:
    _REGISTRY.record(name, seconds, prebarrier)


def summarize_time(print_fn: Callable[[str], None] = print) -> str:
    return _REGISTRY.summarize(print_fn)


def print_additional_time_info(msg: str, level: int = 1) -> None:
    _REGISTRY.print_additional_time_info(msg, level)


# ---------------------------------------------------------------------------
# prebarrier fence
# ---------------------------------------------------------------------------

def synchronize_all() -> None:
    """``torch.cuda.synchronize`` on every visible CUDA device (nothing
    without one: CPU work is done when it returns)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class DeviceFence:
    """The reference's ``prebarrier`` (prebarrier.cpp:1-21, an MPI_Barrier
    timed before collectives to separate load imbalance from comm time)
    over ``devices`` (CUDA devices or their indices; every visible CUDA
    device when None): calling it synchronizes each in turn and returns the
    seconds waited, how long the busiest device's queue still had to drain.
    Without a CUDA device it is a no-op that returns 0.0 (CPU work is done
    when it returns)."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            devices = range(torch.cuda.device_count() if torch.cuda.is_available() else 0)
        devs = (torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
                for d in devices)
        self.devices = [d for d in devs if d.type == "cuda"]

    def __call__(self) -> float:
        if not self.devices:
            return 0.0
        t0 = time.perf_counter()
        for d in self.devices:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0


def prebarrier() -> float:
    """Seconds spent waiting for every visible CUDA device to drain its
    queue (:class:`DeviceFence` over all of them)."""
    return DeviceFence()()


@contextmanager
def timed(name: str, block_on=None, with_prebarrier: bool = False):
    """Context manager that records wall time for ``name``.

    ``block_on``: optional tensor (or ``holder["block_on"]`` set inside the
    block) whose readiness gates the stop stamp: every CUDA device is
    synchronized before it.  ``with_prebarrier``: fence first and record
    the wait as the op's prebarrier time.
    """
    pre = prebarrier() if with_prebarrier else 0.0
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        target = holder.get("block_on", block_on)
        if target is not None:
            synchronize_all()
        _REGISTRY.record(name, time.perf_counter() - t0, prebarrier=pre)


def summarize_across_devices(per_device: Dict[str, object],
                             print_fn: Callable[[str], None] = print) -> str:
    """``SummarizeTimeAcrossProcesses`` analog (ppTiming.cpp:220-338): a
    table over per-device values the caller gathered (step times, particle
    counts, ...), one row per name with min, avg, max and the imbalance
    max / avg, in the JAX package's text format."""
    lines = ["Cross-device summary (op, min, avg, max, imb):"]
    for name in sorted(per_device):
        v = per_device[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().double().numpy()
        elif isinstance(v, (list, tuple)):
            v = [float(x) for x in v]
        v = np.asarray(v, dtype=np.float64)
        avg = float(v.mean()) if v.size else 0.0
        imb = float(v.max() / avg) if avg > 0 else 1.0
        lines.append(
            f"  {name:<40s} min={v.min():.6g} avg={avg:.6g} "
            f"max={v.max():.6g} imb={imb:.3f}"
        )
    out = "\n".join(lines)
    if print_fn is not None:
        print_fn(out)
    return out


@contextmanager
def profiling_region(name: str):
    """``Kokkos::Profiling::pushRegion`` analog: a ``torch.profiler``
    record_function range, and on a machine with a CUDA device an NVTX
    range around the block as well."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
