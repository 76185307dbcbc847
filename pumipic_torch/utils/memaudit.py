"""Live-tensor audit, the memcheck analog (port of
``pumipic_tpu.utils.memaudit``).

Reference parity: the reference wires Valgrind memcheck into ctest
(``CMakeLists.txt:105-110``, ``valgrind.supp``) and keeps a dedicated
``destroy_test`` for leak paths.  Under PyTorch the failure mode to catch
is tensor growth across steps (host references pinning old particle
states, a step that keeps its inputs alive).  A snapshot is a census of the
live ``torch.Tensor`` objects the garbage collector tracks, keyed by shape,
dtype and device, beside ``torch.cuda.memory_allocated`` of each CUDA
device; a diff of two snapshots says what a loop left behind.
"""
from __future__ import annotations

import gc
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class BufferSnapshot:
    """Live-tensor census: count and bytes per "(shape)dtype@device" key,
    and the CUDA caching allocator's allocated bytes per device index."""

    count: int
    nbytes: int
    by_key: Dict[str, int]          # "(shape)dtype@device" -> count
    cuda_allocated: Dict[int, int] = field(default_factory=dict)

    def __sub__(self, other: "BufferSnapshot") -> "BufferDiff":
        keys = set(self.by_key) | set(other.by_key)
        delta = {k: self.by_key.get(k, 0) - other.by_key.get(k, 0) for k in keys}
        devs = set(self.cuda_allocated) | set(other.cuda_allocated)
        return BufferDiff(
            count=self.count - other.count,
            nbytes=self.nbytes - other.nbytes,
            by_key={k: v for k, v in delta.items() if v != 0},
            cuda_allocated={d: self.cuda_allocated.get(d, 0) - other.cuda_allocated.get(d, 0)
                            for d in devs},
        )


@dataclass(frozen=True)
class BufferDiff:
    count: int
    nbytes: int
    by_key: Dict[str, int]
    cuda_allocated: Dict[int, int] = field(default_factory=dict)

    def leaked(self, tol_buffers: int = 0) -> bool:
        return self.count > tol_buffers

    def report(self) -> str:
        lines = [f"live-tensor delta: {self.count:+d} tensors, "
                 f"{self.nbytes / 1e6:+.1f} MB"]
        for d, v in sorted(self.cuda_allocated.items()):
            lines.append(f"  cuda:{d} allocated {v / 1e6:+.1f} MB")
        for k, v in sorted(self.by_key.items(), key=lambda kv: -abs(kv[1])):
            lines.append(f"  {v:+d}  {k}")
        return "\n".join(lines)


def _live_tensors():
    # type(), not isinstance(): the latter reads __class__, which some lazy
    # module attributes answer with a deprecation warning
    return (obj for obj in gc.get_objects() if issubclass(type(obj), torch.Tensor))


def snapshot() -> BufferSnapshot:
    """Census of the live tensors (views counted as tensors of their own
    shape) and of each CUDA device's allocated bytes."""
    count = nbytes = 0
    by_key: Counter = Counter()
    for t in _live_tensors():
        count += 1
        nbytes += t.numel() * t.element_size()
        by_key[f"{tuple(t.shape)}{str(t.dtype).replace('torch.', '')}@{t.device}"] += 1
    cuda = {}
    if torch.cuda.is_available():
        cuda = {d: torch.cuda.memory_allocated(d) for d in range(torch.cuda.device_count())}
    return BufferSnapshot(count=count, nbytes=nbytes, by_key=dict(by_key),
                          cuda_allocated=cuda)


class LeakCheck:
    """Context/step helper: assert a step loop leaves the live-tensor
    population flat (the ``destroy_test`` role).

    Usage::

        lc = LeakCheck()
        for _ in range(n):
            state, out = step(state)
        lc.assert_flat(tol_buffers=4)   # raises with a census diff report
    """

    def __init__(self):
        self.base: Optional[BufferSnapshot] = None
        self.reset()

    def reset(self) -> None:
        self.base = snapshot()

    def diff(self) -> BufferDiff:
        return snapshot() - self.base

    def assert_flat(self, tol_buffers: int = 0) -> BufferDiff:
        d = self.diff()
        if d.leaked(tol_buffers):
            raise AssertionError(d.report())
        return d
