"""The picparts step's counts: kernel N (``kernels/csrc/counts.cu``).

- :func:`slot_counts` counts up to ``N_MAX`` predicates over the slots in
  one launch: each predicate is a conjunction of up to ``N_TERMS`` terms,
  ``("set", mask)``, ``("clear", mask)`` (bool) or ``("nonneg", ids)``,
  ``("neg", ids)`` (int32), optionally less an int32 0-d tensor (``sub``).
  It replaces the end-of-step sums of the picparts steps (the alive, exit
  and lost counts) and migrate's free-slot, sent, illegal and kept-home
  sums.
- :func:`rank_stats` is ``step_stats``' reduction of the gathered (R, W)
  counts over the ranks: the column sums (a max for one column) and the
  f32 imbalance of column 0, max / (sum / R).

Each runs its plain PyTorch version (``*_plain``: the same predicates
summed with torch) on CPU tensors and launches its kernel on CUDA tensors
(one launch counted as ``slot_counts``).  Every output is an integer sum,
or the imbalance from an exact sum rounded once, so the two are equal bit
for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

# counts a launch and terms a count, as counts.cu defines them
N_MAX = 4
N_TERMS = 3
# term kinds, as counts.cu numbers them
KINDS = {"set": 1, "clear": 2, "nonneg": 3, "neg": 4}

I32 = torch.int32
_P = ctypes.c_void_p
# the kernel's accumulators and ticket a device: zeroed once, each launch
# leaves them 0 (so two launches must not run at once on two streams; the
# port runs its steps on one stream, and a CUDA graph captured from a call
# reuses them)
_ACC = {}

Term = Tuple[str, torch.Tensor]


def _holds(kind: str, t: torch.Tensor) -> torch.Tensor:
    if kind == "set":
        return t
    if kind == "clear":
        return ~t
    if kind == "nonneg":
        return t >= 0
    if kind == "neg":
        return t < 0
    raise ValueError(f"slot_counts: unknown term kind {kind!r}")


def _check(counts, subs) -> None:
    if not 1 <= len(counts) <= N_MAX or len(subs) != len(counts):
        raise ValueError(f"slot_counts: 1 to {N_MAX} counts, a sub (or None) each")
    for terms in counts:
        if not 1 <= len(terms) <= N_TERMS:
            raise ValueError(f"slot_counts: 1 to {N_TERMS} terms a count")
        n = terms[0][1].shape
        for kind, t in terms:
            want = torch.bool if kind in ("set", "clear") else I32
            if kind not in KINDS or t.dtype != want or t.dim() != 1 or t.shape != n:
                raise ValueError(f"slot_counts: a ({kind!r}) term takes a 1-d {want} "
                                 f"tensor, all of one count the same length")


def slot_counts_plain(counts: Sequence[Sequence[Term]],
                      subs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """Plain PyTorch version of :func:`slot_counts`."""
    _check(counts, subs)
    out = []
    for terms, sub in zip(counts, subs):
        hold = _holds(*terms[0])
        for kind, t in terms[1:]:
            hold = hold & _holds(kind, t)
        c = hold.sum(dtype=I32)
        out.append(c if sub is None else c - sub)
    return torch.stack(out)


def slot_counts(counts: Sequence[Sequence[Term]],
                subs: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """The counts of ``counts`` (each a list of terms whose conjunction is
    counted over its slots), each less its ``subs`` entry (an i32 0-d
    tensor) where given: an (len(counts),) i32 tensor.  Kernel N on CUDA
    tensors (one launch, no memset), :func:`slot_counts_plain` on CPU
    tensors."""
    subs = [None] * len(counts) if subs is None else list(subs)
    tensors = [t for terms in counts for _, t in terms] + [s for s in subs if s is not None]
    if not kernels.use_kernel("slot_counts", *tensors):
        return slot_counts_plain(counts, subs)
    _check(counts, subs)
    for s in subs:
        if s is not None and (s.dtype != I32 or s.numel() != 1):
            raise ValueError("slot_counts: a sub is an i32 0-d tensor")
    dev = tensors[0].device
    out = torch.empty(len(counts), dtype=I32, device=dev)
    acc = _ACC.get(dev.index)
    if acc is None:
        acc = _ACC[dev.index] = torch.zeros(N_MAX + 1, dtype=I32, device=dev)
    k = len(counts)
    terms = (_P * (N_MAX * N_TERMS))()
    kinds = (ctypes.c_int * (N_MAX * N_TERMS))()
    n_slots = (ctypes.c_longlong * N_MAX)()
    outs = (_P * N_MAX)()
    subp = (_P * N_MAX)()
    for c, ts in enumerate(counts):
        for j, (kind, t) in enumerate(ts):
            terms[c * N_TERMS + j] = t.data_ptr()
            kinds[c * N_TERMS + j] = KINDS[kind]
        n_slots[c] = ts[0][1].shape[0]
        outs[c] = out.data_ptr() + 4 * c
        subp[c] = subs[c].data_ptr() if subs[c] is not None else None
    err = _build.lib().pp_slot_counts(*(_P(ctypes.addressof(a)) for a in
                                        (terms, kinds, n_slots, outs, subp)),
                                      k, _P(acc.data_ptr()), _P(kernels.stream_handle()))
    _build.check(err, "slot_counts")
    kernels.LAUNCHES["slot_counts"] += 1
    return out


def rank_stats_plain(g: torch.Tensor, max_col: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`rank_stats`."""
    W = g.shape[1]
    cols = [g[:, i].max() if i == max_col else g[:, i].sum(dtype=I32) for i in range(W)]
    n = g[:, 0].to(torch.float32)
    mx = n.max()
    total = g[:, 0].sum(dtype=torch.int64).to(torch.float32)
    avg = total / total.new_full((), float(g.shape[0]))
    imb = torch.where(avg > 0, mx / avg, total.new_full((), 1.0))
    return torch.cat([torch.stack(cols), imb.reshape(1).view(I32)])


def rank_stats(g: torch.Tensor, max_col: int) -> torch.Tensor:
    """``step_stats``' reduction of the gathered (R, W) i32 counts ``g``:
    a (W + 1,) i32 tensor, column w's sum over the ranks (its max where w
    is ``max_col``) and last the bits of the f32 imbalance of column 0,
    max / (sum / R) (1 where the sum is 0), the sum exact and rounded to
    f32 once.  Kernel N's second launcher on CUDA tensors (one launch),
    :func:`rank_stats_plain` on CPU tensors."""
    if g.dtype != I32 or g.dim() != 2 or not 1 <= g.shape[1] <= 32 or g.shape[0] < 1:
        raise ValueError("rank_stats: an (R, W) i32 tensor with 1 <= W <= 32 expected")
    if not kernels.use_kernel("slot_counts", g):
        return rank_stats_plain(g, max_col)
    out = torch.empty(g.shape[1] + 1, dtype=I32, device=g.device)
    err = _build.lib().pp_rank_stats(_P(g.data_ptr()), g.shape[0], g.shape[1], max_col,
                                     _P(out.data_ptr()), _P(kernels.stream_handle()))
    _build.check(err, "slot_counts")
    kernels.LAUNCHES["slot_counts"] += 1
    return out
