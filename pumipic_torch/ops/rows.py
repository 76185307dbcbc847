"""Row moves of the particle-structure rebuild: kernels G and S.

- :func:`row_gather` is the wrapper of kernel G (``kernels/csrc/gather.cu``),
  the port of the TPU's row gather (``perf/pallas_gather_ab.py``,
  ``row_dma_gather``): ``out[i, :] = table[idx[i], :]`` over 4-byte lanes,
  bit for bit.  Form (a) takes one (M, W) table; form (b) a list of arrays
  with M rows each that share the index (the rebuild's fields in place,
  plus its key lane).
- :func:`slot_map` is the wrapper of kernel S (``kernels/csrc/slotmap.cu``),
  the per-slot arithmetic of the sorted SCS/CabM rebuild: for each slot the
  sorted particle it takes, its element and whether it may hold one.

Each runs its plain PyTorch version on CPU tensors and launches its kernel
on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

# arrays one launch of kernel G takes (more go in further launches)
MAX_GATHER_ARRAYS = 16

Arrays = Union[torch.Tensor, Sequence[torch.Tensor]]


# ---------------------------------------------------------------------------
# kernel G: row gather
# ---------------------------------------------------------------------------

def lanes_of(a: torch.Tensor) -> int:
    """4-byte lanes per row of ``a`` (rows on dim 0), or 0 where its rows
    are not made of whole 4-byte words (1- and 2-byte dtypes)."""
    if a.dim() < 1 or a.element_size() not in (4, 8):
        return 0
    return math.prod(a.shape[1:]) * a.element_size() // 4


def row_gather_plain(src: Arrays, idx: torch.Tensor):
    """Plain version of kernel G: ``table[idx]`` (form (a)) or
    ``[c[idx] for c in cols]`` (form (b))."""
    i = idx.long()
    if isinstance(src, torch.Tensor):
        return src[i]
    return [c[i] for c in src]


def row_gather(src: Arrays, idx: torch.Tensor):
    """``out[i] = src[idx[i]]`` for one (M, ...) table (form (a), returns a
    tensor) or for each array of a list sharing the index (form (b),
    returns a list).  Arrays are moved as 4-byte words (f32, i32, and
    8-byte types as two words), at any 4-byte alignment; ``idx`` is i32
    with values in [0, M).  Kernel G on CUDA tensors,
    :func:`row_gather_plain` on CPU tensors."""
    single = isinstance(src, torch.Tensor)
    cols: List[torch.Tensor] = [src] if single else list(src)
    if not kernels.use_kernel("row_gather", idx, *cols):
        return row_gather_plain(src, idx)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("row_gather: (N,) i32 index expected")
    n = idx.shape[0]
    outs, srcs, dsts, widths = [], [], [], []
    for c in cols:
        w = lanes_of(c)
        if w == 0:
            raise ValueError(f"row_gather: rows of {c.dtype} {tuple(c.shape)} "
                             f"are not whole 4-byte words")
        out = torch.empty((n,) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
        outs.append(out)
        srcs.append(c.data_ptr())
        dsts.append(out.data_ptr())
        widths.append(w)
    if n > 0:
        for j0 in range(0, len(cols), MAX_GATHER_ARRAYS):
            m = min(MAX_GATHER_ARRAYS, len(cols) - j0)
            P = ctypes.c_void_p
            err = _build.lib().pp_row_gather(
                P(idx.data_ptr()), n, m,
                (P * m)(*srcs[j0:j0 + m]), (P * m)(*dsts[j0:j0 + m]),
                (ctypes.c_int * m)(*widths[j0:j0 + m]),
                P(kernels.stream_handle()))
            _build.check(err, "row_gather")
            kernels.LAUNCHES["row_gather"] += 1
    return outs[0] if single else outs


# ---------------------------------------------------------------------------
# kernel S: the sorted rebuild's slot map
# ---------------------------------------------------------------------------

def scatter_add_drop(size: int, pos: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
    """``zeros(size).at[pos].add(vals, mode="drop")``: adds at positions
    outside [0, size) are dropped."""
    buf = torch.zeros(size + 1, dtype=vals.dtype, device=vals.device)
    p = pos.long()
    p = torch.where((p >= 0) & (p < size), p, size)
    buf.index_add_(0, p, vals)
    return buf[:size]


def _segment_offsets_of_slot(offsets: torch.Tensor, C: int):
    """(segment id, segment start) of every slot by the JAX package's
    scatter-add + cumsum (``_rebuild_sorted.segment_offsets_of_slot``)."""
    pos = offsets[1:-1]
    jump = torch.diff(offsets)[:-1]
    ind = scatter_add_drop(C, pos, torch.ones_like(pos))
    gj = scatter_add_drop(C, pos, jump)
    return (torch.cumsum(ind, 0, dtype=torch.int32),
            torch.cumsum(gj, 0, dtype=torch.int32))


def slot_map_plain(layout: str, order: torch.Tensor, start: torch.Tensor,
                   offsets: torch.Tensor, row_to_elem: Optional[torch.Tensor],
                   chunk: int, C: int, M: int):
    """Plain version of kernel S: the JAX package's slot arithmetic
    (``_rebuild_sorted``, structure.py:555-654) in torch."""
    E = start.shape[0] - 1
    dev = order.device
    i32 = torch.int32
    j = torch.arange(C, dtype=i32, device=dev)
    seg, seg_start = _segment_offsets_of_slot(offsets, C)
    needed = offsets[-1]
    if layout == "cabm":
        elem_j = seg
        elem_c = torch.clamp(elem_j, 0, E - 1)
        rank_j = j - seg_start
        # gather-free source: slots of segment e map to sorted positions
        # shifted by the cumulative padding offsets[e] - start[e]
        pad = (torch.diff(offsets) - torch.diff(start)).to(i32)
        pj = scatter_add_drop(C, offsets[1:-1], pad[:-1])
        src_pos0 = j - torch.cumsum(pj, 0, dtype=i32)
    elif layout == "scs":
        nchunks = offsets.shape[0] - 1
        o = j - seg_start
        if chunk & (chunk - 1) == 0:
            sh = chunk.bit_length() - 1
            rank_j = o >> sh
            local_row = o & (chunk - 1)
        else:
            rank_j = torch.div(o, chunk, rounding_mode="floor")
            local_row = o - rank_j * chunk
        row = torch.clamp(seg, 0, nchunks - 1) * chunk + local_row
        R = row_to_elem.shape[0]
        elem_j = row_to_elem[torch.clamp(row, max=R - 1).long()]
        elem_c = torch.clamp(elem_j, 0, E - 1)
        src_pos0 = start[elem_c.long()] + rank_j
    else:
        raise ValueError(f"slot_map: unknown layout {layout!r}")
    guard = (elem_j >= 0) & (elem_j < E) & (rank_j >= 0) & (j < needed)
    src_pos = torch.clamp(src_pos0, max=M - 1)
    src = order[src_pos.long()].to(i32)
    return src, elem_c.to(i32), guard & (src_pos0 <= M - 1)


def slot_map(layout: str, order: torch.Tensor, start: torch.Tensor,
             offsets: torch.Tensor, row_to_elem: Optional[torch.Tensor],
             chunk: int, C: int, M: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Slot map of the sorted rebuild: ``(src, elem_c, pre_valid)``, each
    (C,), for ``layout`` "scs" (``offsets`` the chunk offsets,
    ``row_to_elem`` the row order, ``chunk`` rows per chunk) or "cabm"
    (``offsets`` the element offsets).  ``order`` (M,) i32 is the stable
    element sort, ``start`` (E+1,) i32 the sorted element starts.  Slot j
    takes sorted particle ``src[j]`` of element ``elem_c[j]`` and holds it
    iff ``pre_valid[j]`` and the particle's key equals ``elem_c[j]``.
    Kernel S on CUDA tensors, :func:`slot_map_plain` on CPU tensors."""
    tensors = [order, start, offsets] + ([] if layout == "cabm" else [row_to_elem])
    if not kernels.use_kernel("slot_map", *tensors):
        return slot_map_plain(layout, order, start, offsets, row_to_elem,
                              chunk, C, M)
    if layout not in ("scs", "cabm"):
        raise ValueError(f"slot_map: unknown layout {layout!r}")
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("slot_map: i32 order, start, offsets and row order expected")
    E = start.shape[0] - 1
    if E < 1 or M < 1 or offsets.shape[0] < 2:
        raise ValueError("slot_map: needs E >= 1, M >= 1 and one segment")
    dev = order.device
    src = torch.empty(C, dtype=torch.int32, device=dev)
    elem_c = torch.empty(C, dtype=torch.int32, device=dev)
    pre_valid = torch.empty(C, dtype=torch.bool, device=dev)
    if C == 0:
        return src, elem_c, pre_valid
    cabm = layout == "cabm"
    P = ctypes.c_void_p
    err = _build.lib().pp_slot_map(
        int(cabm), P(order.data_ptr()), P(start.data_ptr()),
        P(offsets.data_ptr()), offsets.shape[0] - 1,
        P(None if cabm else row_to_elem.data_ptr()),
        0 if cabm else row_to_elem.shape[0], 1 if cabm else chunk, E, C, M,
        P(src.data_ptr()), P(elem_c.data_ptr()), P(pre_valid.data_ptr()),
        P(kernels.stream_handle()))
    _build.check(err, "slot_map")
    kernels.LAUNCHES["slot_map"] += 1
    return src, elem_c, pre_valid
