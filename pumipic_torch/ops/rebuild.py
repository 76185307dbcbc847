"""The particle structures' rebuild around the slot map and the field
gather: kernels Q and C (``kernels/csrc/rebuild.cu``), U1, U2, U3 and Z
(``kernels/csrc/reshuffle.cu``).

- :func:`rebuild_mask_dps`, :func:`rebuild_mask_epilogue` and
  :func:`rebuild_mask_prefix` are the three modes of kernel Q, one pass
  that rewrites a rebuild's element ids and mask and counts the particles
  held: the destinations' check of every rebuild (the whole DPS rebuild),
  the sorted SCS/CabM rebuild's epilogue, and the CSR and DPS-add
  rebuilds' "first ``needed`` slots" form.
- :func:`key_sort` is the wrapper of kernel C, the stable sort of the
  rebuilds' element keys: the int32 order that ``torch.sort(key,
  stable=True)`` gives, for every int32 key (or a payload in that order);
  :func:`masked_key_sort` is its fused mode, which forms the key
  ``where(active, elem, fill)`` itself.
- :func:`reshuffle_count` and :func:`reshuffle_place` are kernels U1 and
  U2 (``kernels/csrc/reshuffle.cu``), the reshuffle of ``rebuild(mode=
  "auto")``: the stayers' and movers' split, counts, fits check and mover
  list; the movers' placement into their segments' holes;
  :func:`reshuffle_order` is kernel U3, the movers in destination order.
- :func:`scs_row_order` is kernel Z, the Sell-C-σ row order and its maps.

Each runs its plain PyTorch version (``*_plain``: the JAX package's
arithmetic, ``pumipic_tpu/particles/structure.py``) on CPU tensors and
launches its kernel on CUDA tensors (one launch counted, under its
name).  Every output is an integer, a mask or a moved row, so the two
are equal bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

_P = ctypes.c_void_p
I32 = torch.int32

# kernel C's widest digit, as rebuild.cu defines it
KS_MAX_BITS = 9

# kernel Q's modes, as rebuild.cu numbers them
Q_DPS, Q_EPILOGUE, Q_PREFIX = 0, 1, 2

# fields one launch of kernel U2 moves, as reshuffle.cu defines it
MAX_PLACE_FIELDS = 16


def _ptr(t: Optional[torch.Tensor]):
    return _P(t.data_ptr() if t is not None else 0)


# ---------------------------------------------------------------------------
# Q: rebuild_mask
# ---------------------------------------------------------------------------

def _count(keep: torch.Tensor) -> torch.Tensor:
    return torch.sum(keep, dtype=I32)


def rebuild_mask_dps_plain(new_elem: torch.Tensor, active: torch.Tensor, num_elems: int):
    """Plain version of Q's DPS mode (``_rebuild``'s destination check)."""
    elem = torch.where(active & (new_elem >= 0) & (new_elem < num_elems), new_elem, -1)
    keep = elem >= 0
    return elem, keep, _count(keep)


def rebuild_mask_epilogue_plain(pre_valid: torch.Tensor, key_src: torch.Tensor,
                                elem_c: torch.Tensor):
    """Plain version of Q's epilogue mode (``_rebuild_sorted``'s tail)."""
    valid = pre_valid & (key_src == elem_c)
    return torch.where(valid, elem_c, -1).to(I32), valid, _count(valid)


def rebuild_mask_prefix_plain(sk: torch.Tensor, needed: torch.Tensor):
    """Plain version of Q's prefix mode (the CSR / DPS-add rebuild's
    output mask)."""
    j = torch.arange(sk.shape[0], dtype=I32, device=sk.device)
    keep = j < needed
    return torch.where(keep, sk, -1), keep, _count(keep)


def _rebuild_mask(mode: int, a: torch.Tensor, m: Optional[torch.Tensor],
                  b: Optional[torch.Tensor], num_elems: int,
                  needed: Optional[torch.Tensor]):
    """Launch kernel Q (the caller has checked the device)."""
    n = a.shape[0]
    if (a.dtype != I32 or a.dim() != 1 or (m is not None and (
            m.dtype != torch.bool or m.shape != (n,))) or (b is not None and (
            b.dtype != I32 or b.shape != (n,))) or (needed is not None and (
            needed.dtype != I32 or needed.numel() != 1))):
        raise ValueError("rebuild_mask: (N,) i32 ids, (N,) bool masks and a 0-d i32 "
                         "count expected")
    elem = torch.empty(n, dtype=I32, device=a.device)
    keep = torch.empty(n, dtype=torch.bool, device=a.device)
    if n == 0:
        return elem, keep, torch.zeros((), dtype=I32, device=a.device)
    num = torch.empty((), dtype=I32, device=a.device)
    err = _build.lib().pp_rebuild_mask(mode, _ptr(a), _ptr(m), _ptr(b), num_elems,
                                       _ptr(needed), _ptr(elem), _ptr(keep), _ptr(num), n,
                                       _P(kernels.stream_handle()))
    _build.check(err, "rebuild_mask")
    kernels.LAUNCHES["rebuild_mask"] += 1
    return elem, keep, num


def rebuild_mask_dps(new_elem: torch.Tensor, active: torch.Tensor, num_elems: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(elem, active, num_ptcls) of a rebuild's destinations: ``new_elem``
    (N,) i32 where ``active`` and in [0, num_elems), else -1; the mask of
    those kept; their count (0-d i32).  Kernel Q's DPS mode on CUDA
    tensors, :func:`rebuild_mask_dps_plain` on CPU tensors."""
    if not kernels.use_kernel("rebuild_mask", new_elem, active):
        return rebuild_mask_dps_plain(new_elem, active, num_elems)
    return _rebuild_mask(Q_DPS, new_elem, active, None, num_elems, None)


def rebuild_mask_epilogue(pre_valid: torch.Tensor, key_src: torch.Tensor,
                          elem_c: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(elem, valid, num_ptcls) of the sorted rebuild's slots: a slot holds
    its particle iff ``pre_valid`` and the gathered key ``key_src`` equals
    the slot's element ``elem_c`` ((C,) each); its element, -1 where not.
    Kernel Q's epilogue mode on CUDA tensors,
    :func:`rebuild_mask_epilogue_plain` on CPU tensors."""
    if not kernels.use_kernel("rebuild_mask", pre_valid, key_src, elem_c):
        return rebuild_mask_epilogue_plain(pre_valid, key_src, elem_c)
    return _rebuild_mask(Q_EPILOGUE, elem_c, pre_valid, key_src, 0, None)


def rebuild_mask_prefix(sk: torch.Tensor, needed: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(elem, active, num_ptcls) of a gathered layout whose first
    ``needed`` (0-d i32 tensor) slots hold particles: ``sk`` (C,) i32 there,
    -1 beyond.  Kernel Q's prefix mode on CUDA tensors,
    :func:`rebuild_mask_prefix_plain` on CPU tensors."""
    if not kernels.use_kernel("rebuild_mask", sk, needed):
        return rebuild_mask_prefix_plain(sk, needed)
    return _rebuild_mask(Q_PREFIX, sk, None, None, 0, needed)


# ---------------------------------------------------------------------------
# C: key_sort
# ---------------------------------------------------------------------------

def key_sort_passes(max_key: int) -> List[Tuple[int, int]]:
    """Kernel C's digit passes for keys in [0, max_key]: (shift, width) of
    each, least significant first: ceil(bits / 9) passes of equal width
    (the last narrower where bits do not divide), bits the bit length of
    ``max_key`` (at least 1).  Keys outside [0, 2^bits) take
    :func:`key_sort_high_passes` after them."""
    bits = max(int(max_key).bit_length(), 1)
    passes = -(-bits // KS_MAX_BITS)
    width = -(-bits // passes)
    return [(s, min(width, bits - s)) for s in range(0, bits, width)]


def key_sort_high_passes(max_key: int) -> List[Tuple[int, int]]:
    """The passes over bits [bits, 32) of the keys' order-preserving
    unsigned image (the sign bit flipped) that kernel C runs only when a
    key lies outside [0, 2^bits)."""
    bits = max(int(max_key).bit_length(), 1)
    passes = -(-(32 - bits) // KS_MAX_BITS)
    width = -(-(32 - bits) // passes)
    return [(s, min(width, 32 - s)) for s in range(bits, 32, width)]


def key_sort_plain(key: torch.Tensor, max_key: int,
                   values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel C: torch's stable sort, its indices as
    int32 (any int32 keys; ``max_key`` only picks the kernel's passes), or
    ``values`` in that order."""
    order = torch.sort(key, stable=True).indices
    return order.to(I32) if values is None else values[order]


def masked_key_sort_plain(elem: Optional[torch.Tensor], active: torch.Tensor, fill: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel C's fused mode: the rebuilds' element key
    (``elem``, 0 where None, where ``active``; ``fill`` elsewhere; int32)
    and its stable order."""
    key = torch.where(active, elem if elem is not None else 0, fill).to(I32)
    return key_sort_plain(key, fill), key


def _key_sort(n: int, dev, max_key: int, key=None, elem=None, active=None, fill: int = 0,
              keep_key: bool = False, values=None):
    """Launch kernel C (the caller has checked the device): the order and,
    with ``keep_key``, the keys as the histogram read or formed them."""
    if not 0 <= max_key < 2**31:
        raise ValueError(f"key_sort: max_key {max_key} outside [0, 2^31)")
    if n >= 1 << 30:
        raise ValueError("key_sort: the kernel sorts fewer than 2^30 keys")
    order = torch.empty(n, dtype=I32, device=dev)
    key_out = torch.empty(n, dtype=I32, device=dev) if keep_key else None
    if n == 0:
        return order, key_out
    lib = _build.lib()
    scratch = torch.empty(lib.pp_key_sort_scratch(n), dtype=I32, device=dev)
    n_low = len(key_sort_passes(max_key))
    bufs = [torch.empty(n, dtype=I32, device=dev) for _ in range(2 * min(n_low - 1, 2))]
    bufs += [None] * (4 - len(bufs))
    spare = torch.empty(n, dtype=I32, device=dev)
    bits = max(int(max_key).bit_length(), 1)
    err = lib.pp_key_sort(_ptr(key), _ptr(elem), _ptr(active), int(fill), n, bits,
                          _ptr(key_out), _ptr(order), _ptr(scratch),
                          *(_ptr(b) for b in bufs), _ptr(spare), _ptr(values),
                          _P(kernels.stream_handle()))
    _build.check(err, "key_sort")
    kernels.LAUNCHES["key_sort"] += 1
    return order, key_out


def key_sort(key: torch.Tensor, max_key: int,
             values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (N,) int32 order of (N,) int32 ``key`` that a stable argsort
    gives: ``key[order]`` ascending, equal keys in index order, for every
    int32 key; with ``values`` ((N,) int32), ``values[order]`` in its place
    (the sort's last pass writes it).  ``max_key`` is the largest key the
    caller expects: kernel C (on CUDA tensors) sorts keys in [0, max_key]
    in its low passes and takes passes over the high bits only when a key
    lies outside [0, 2^bits).  :func:`key_sort_plain` on CPU tensors."""
    if key.dtype != I32 or key.dim() != 1:
        raise ValueError("key_sort: (N,) int32 keys expected")
    if values is not None and (values.dtype != I32 or values.shape != key.shape):
        raise ValueError("key_sort: (N,) int32 values expected")
    if not 0 <= max_key < 2**31:
        raise ValueError(f"key_sort: max_key {max_key} outside [0, 2^31)")
    tensors = [key] if values is None else [key, values]
    if not kernels.use_kernel("key_sort", *tensors):
        return key_sort_plain(key, max_key, values)
    return _key_sort(key.shape[0], key.device, max_key, key=key, values=values)[0]


def masked_key_sort(elem: Optional[torch.Tensor], active: torch.Tensor, fill: int,
                    keep_key: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`key_sort` of the rebuilds' element key (``elem`` where
    ``active``, ``fill`` elsewhere; 0 for ``elem`` None) with ``max_key =
    fill``, the
    key formed inside kernel C's histogram and first pass (no separate
    pass).  Returns (order, the key where ``keep_key``, else None).  The
    plain version on CPU tensors."""
    if (active.dtype != torch.bool or active.dim() != 1 or (elem is not None and (
            elem.dtype != I32 or elem.shape != active.shape))):
        raise ValueError("masked_key_sort: (N,) int32 elements and an (N,) bool mask "
                         "expected")
    tensors = [t for t in (elem, active) if t is not None]
    if not kernels.use_kernel("key_sort", *tensors):
        order, key = masked_key_sort_plain(elem, active, fill)
        return order, key if keep_key else None
    return _key_sort(active.shape[0], active.device, fill, elem=elem, active=active,
                     fill=fill, keep_key=keep_key)


# ---------------------------------------------------------------------------
# U1, U2, U3: the reshuffle; Z: the Sell-C-σ row order (kernels/csrc/reshuffle.cu)
# ---------------------------------------------------------------------------

class ReshuffleCount(NamedTuple):
    """Kernel U1's outputs over a rebuild's C slots and E elements."""

    info: torch.Tensor        # (2,) i32: fits, n_mov (the host's one read)
    stay_cnt: torch.Tensor    # (E,) i32 stayers per element (where n_mov <= MB)
    mov_cnt: torch.Tensor     # (E,) i32 movers per destination (where n_mov <= MB)
    mov_start: torch.Tensor   # (E,) i32 exclusive cumsum of mov_cnt (where n_mov <= MB)
    msrc: torch.Tensor        # (MB,) i32 the movers' slots in slot order
    mkey: torch.Tensor        # (MB,) i32 their destinations
    num: torch.Tensor         # () i32 stayers + movers


def reshuffle_count_plain(elem: torch.Tensor, old_elem: torch.Tensor,
                          seg_cap: torch.Tensor, mover_budget: int) -> ReshuffleCount:
    """Plain version of kernel U1 (``_rebuild_auto``'s split, counts and
    fits check; ``_reshuffle``'s mover list in slot order)."""
    E, MB = seg_cap.shape[0], mover_budget
    dev = elem.device
    stay = (elem >= 0) & (elem == old_elem)
    mover = (elem >= 0) & ~stay
    stay_cnt = torch.bincount(elem[stay].long(), minlength=E).to(I32)
    mov_cnt = torch.bincount(elem[mover].long(), minlength=E).to(I32)
    n_mov = _count(mover)
    fits = torch.all(mov_cnt <= seg_cap - stay_cnt) & (n_mov <= MB)
    slots = torch.nonzero(mover).reshape(-1)[:MB].to(I32)
    msrc = torch.zeros(MB, dtype=I32, device=dev)
    mkey = torch.zeros(MB, dtype=I32, device=dev)
    msrc[:slots.shape[0]] = slots
    mkey[:slots.shape[0]] = elem[slots.long()]
    mov_start = (torch.cumsum(mov_cnt, 0, dtype=I32) - mov_cnt).to(I32)
    return ReshuffleCount(torch.stack([fits.to(I32), n_mov]), stay_cnt, mov_cnt,
                          mov_start, msrc, mkey, _count(stay) + n_mov)


def reshuffle_count(elem: torch.Tensor, old_elem: torch.Tensor, seg_cap: torch.Tensor,
                    mover_budget: int) -> ReshuffleCount:
    """Split a rebuild's destinations ``elem`` ((C,) i32, -1 where none:
    kernel Q's DPS output) against the slots' current elements
    ``old_elem``: stayers (same element) and movers; their counts per
    element; n_mov; ``fits`` = every destination's movers fit the holes of
    its segment (``seg_cap`` (E,)) and n_mov <= ``mover_budget`` (MB); the
    first min(n_mov, MB) movers' slots in slot order and their
    destinations; the movers' first places in the destination-sorted list.
    Kernel U1 on CUDA tensors (a memset and one launch), where the
    stayers' and movers' counts and the movers' first places are computed
    only while n_mov <= MB (past it the reshuffle does not run: a tile that
    starts after the movers passed MB counts its particles alone, and the
    last block does not scan); :func:`reshuffle_count_plain` on CPU
    tensors."""
    if (elem.dtype != I32 or old_elem.dtype != I32 or seg_cap.dtype != I32
            or elem.dim() != 1 or old_elem.shape != elem.shape or seg_cap.dim() != 1):
        raise ValueError("reshuffle_count: (C,) i32 ids and (E,) i32 caps expected")
    if not kernels.use_kernel("reshuffle_count", elem, old_elem, seg_cap):
        return reshuffle_count_plain(elem, old_elem, seg_cap, mover_budget)
    C, E, MB = elem.shape[0], seg_cap.shape[0], mover_budget
    if C == 0 or E == 0 or C >= 1 << 30:
        raise ValueError("reshuffle_count: the kernel takes 0 < C < 2^30 slots and "
                         "E > 0 elements")
    dev = elem.device
    lib = _build.lib()
    cnt = torch.empty(lib.pp_reshuffle_count_words(C, E), dtype=I32, device=dev)
    mov_start = torch.empty(E, dtype=I32, device=dev)
    msrc = torch.empty(MB, dtype=I32, device=dev)
    mkey = torch.empty(MB, dtype=I32, device=dev)
    info = torch.empty(2, dtype=I32, device=dev)
    num = torch.empty((), dtype=I32, device=dev)
    err = lib.pp_reshuffle_count(_ptr(elem), _ptr(old_elem), _ptr(seg_cap), E, C, MB,
                                 _ptr(cnt), _ptr(mov_start), _ptr(msrc), _ptr(mkey),
                                 _ptr(info), _ptr(num), _P(kernels.stream_handle()))
    _build.check(err, "reshuffle_count")
    kernels.LAUNCHES["reshuffle_count"] += 1
    return ReshuffleCount(info, cnt[:E], cnt[E:2 * E], mov_start, msrc, mkey, num)


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def reshuffle_place_plain(elem: torch.Tensor, old_elem: torch.Tensor,
                          elem_offsets: torch.Tensor, seg_cap: torch.Tensor,
                          mov_cnt: torch.Tensor, mov_start: torch.Tensor,
                          fields: Dict[str, torch.Tensor], staged: Dict[str, torch.Tensor],
                          stride: int, overflowed: torch.Tensor,
                          row_to_elem: Optional[torch.Tensor] = None):
    """Plain version of kernel U2 (``_reshuffle``'s placement): every
    segment's slots in q order, its holes ranked, the hole of rank r <
    mov_cnt[e] given staged row mov_start[e] + r, written into ``fields``
    in place (``row_to_elem``, the kernel's chunk walk, is not read)."""
    C, E = elem.shape[0], seg_cap.shape[0]
    dev = elem.device
    cap = seg_cap.long()
    seg = torch.repeat_interleave(torch.arange(E, device=dev), cap)
    first = torch.cumsum(cap, 0) - cap
    q = torch.arange(seg.shape[0], device=dev) - first[seg]
    slot = elem_offsets[:E].long()[seg] + q * stride
    inside = slot < C
    sc = torch.where(inside, slot, 0)
    stay = inside & (elem[sc] >= 0) & (elem[sc] == old_elem[sc])
    hole = inside & ~stay
    holes_e = torch.bincount(seg[hole], minlength=E)
    hole_first = torch.cumsum(holes_e, 0) - holes_e
    rank = torch.cumsum(hole.long(), 0) - hole.long() - hole_first[seg]
    fill = hole & (rank < mov_cnt.long()[seg])
    dst, src = slot[fill], mov_start.long()[seg[fill]] + rank[fill]
    kept = slot[stay]
    out_elem = torch.full((C,), -1, dtype=I32, device=dev)
    out_active = torch.zeros(C, dtype=torch.bool, device=dev)
    out_elem[kept] = elem[kept]
    out_elem[dst] = seg[fill].to(I32)
    out_active[kept] = True
    out_active[dst] = True
    for k, v in fields.items():
        v[dst] = staged[k][src]
    placed = torch.minimum(holes_e, mov_cnt.long())
    num = (_count(stay) + torch.sum(placed)).to(I32)
    return out_elem, out_active, dict(fields), num, overflowed | torch.any(holes_e < mov_cnt)


def reshuffle_place(elem: torch.Tensor, old_elem: torch.Tensor, elem_offsets: torch.Tensor,
                    seg_cap: torch.Tensor, mov_cnt: torch.Tensor, mov_start: torch.Tensor,
                    fields: Dict[str, torch.Tensor], staged: Dict[str, torch.Tensor],
                    stride: int, overflowed: torch.Tensor,
                    row_to_elem: Optional[torch.Tensor] = None):
    """The reshuffle's new slots: (elem, active, fields, num_ptcls,
    overflowed), the fields written IN PLACE.  Stayers (``elem`` ==
    ``old_elem`` >= 0) keep their slots; element e's holes (its segment's
    slots ``elem_offsets[e] + q·stride``, q < ``seg_cap[e]``, below C,
    without a stayer) in q order take the staged rows ``mov_start[e] + r``
    (r < ``mov_cnt[e]``) of every field (``staged``: the movers' rows in
    destination order), written into the tensors of ``fields`` themselves,
    which are returned (a new dict of the same tensors); every other slot
    is empty (-1, inactive) with its fields as they were; num_ptcls counts
    the output mask; a segment short of holes raises the sticky
    ``overflowed``.  Element and mask are fresh tensors.  A repeated call
    on the same arguments writes the same rows again, so it gives the same
    result.  ``row_to_elem`` is the Sell-C-σ row order (``stride`` its
    chunk), which the kernel walks chunk by chunk; None for CabM (stride
    1, ``elem_offsets`` (E + 1,)).  Kernel U2 on CUDA tensors (a memset of
    the count and the flag, one launch; contiguous fields), the plain
    version on CPU tensors."""
    names = list(fields)
    if list(staged) != names:
        raise ValueError("reshuffle_place: staged rows of every field expected")
    ints = (elem, old_elem, elem_offsets, seg_cap, mov_cnt, mov_start)
    if any(t.dtype != I32 or t.dim() != 1 for t in ints) or old_elem.shape != elem.shape \
            or overflowed.dtype != torch.bool or overflowed.numel() != 1:
        raise ValueError("reshuffle_place: (C,) and (E,) i32 arrays and a 0-d bool flag "
                         "expected")
    C, E = elem.shape[0], seg_cap.shape[0]
    if row_to_elem is not None and (row_to_elem.dtype != I32 or row_to_elem.dim() != 1
                                    or row_to_elem.shape[0] < E
                                    or row_to_elem.shape[0] % stride):
        raise ValueError("reshuffle_place: (R,) i32 row order, R >= E a multiple of the "
                         "chunk, expected")
    if row_to_elem is None and (stride != 1 or elem_offsets.shape[0] != E + 1):
        raise ValueError("reshuffle_place: without a row order, stride 1 and (E + 1,) "
                         "offsets (CabM) expected")
    for k in names:
        if fields[k].shape[1:] != staged[k].shape[1:] or fields[k].dtype != staged[k].dtype \
                or fields[k].shape[0] != C:
            raise ValueError(f"reshuffle_place: field {k!r} and its staged rows differ")
    tensors = [*ints, overflowed, *fields.values(), *staged.values()]
    tensors += [] if row_to_elem is None else [row_to_elem]
    if not kernels.use_kernel("reshuffle_place", *tensors):
        return reshuffle_place_plain(elem, old_elem, elem_offsets, seg_cap, mov_cnt,
                                     mov_start, fields, staged, stride, overflowed,
                                     row_to_elem)
    if len(names) > MAX_PLACE_FIELDS:
        raise ValueError(f"reshuffle_place: at most {MAX_PLACE_FIELDS} fields")
    dev = elem.device
    out_elem = torch.empty(C, dtype=I32, device=dev)
    out_active = torch.empty(C, dtype=torch.bool, device=dev)
    num_ovf = torch.empty(2, dtype=I32, device=dev)    # the count; the flag word
    m = len(names)
    err = _build.lib().pp_reshuffle_place(
        _ptr(elem), _ptr(old_elem), _ptr(elem_offsets), _ptr(seg_cap), _ptr(mov_cnt),
        _ptr(mov_start), _ptr(row_to_elem),
        0 if row_to_elem is None else row_to_elem.shape[0], E, C, int(stride),
        _ptr(overflowed), m,
        (_P * m)(*(staged[k].data_ptr() for k in names)),
        (_P * m)(*(fields[k].data_ptr() for k in names)),
        (ctypes.c_int * m)(*(_row_bytes(fields[k]) for k in names)),
        _ptr(out_elem), _ptr(out_active), _ptr(num_ovf), _P(kernels.stream_handle()))
    _build.check(err, "reshuffle_place")
    kernels.LAUNCHES["reshuffle_place"] += 1
    ovf = num_ovf[1:].view(torch.uint8)[0].view(torch.bool)
    return out_elem, out_active, dict(fields), num_ovf[0], ovf


def scs_row_keys_plain(counts: torch.Tensor, num_rows: int, sigma: int, bits: int
                       ) -> torch.Tensor:
    """The key of kernel Z's plain version: row i's (i // sigma)·2^(bits+1) +
    (2^bits - 1 - count), the count -1 for the padding rows i >= E, as
    int32 (wrapping where a count exceeds 2^bits - 1)."""
    E, R = counts.shape[0], num_rows
    c = torch.full((R,), -1, dtype=torch.int64, device=counts.device)
    c[:E] = counts
    i = torch.arange(R, dtype=torch.int64, device=counts.device)
    key = (i // sigma) * (2 << bits) + ((1 << bits) - 1 - c)
    return ((key + 2**31) % 2**32 - 2**31).to(I32)


def scs_row_maps_plain(order: torch.Tensor, counts: torch.Tensor, chunk: int):
    """The maps of kernel Z's plain version: elem_to_row[order[r]] = r for the
    real rows; chunk widths the largest count of each chunk's rows (0 for
    the padding rows)."""
    E, R = counts.shape[0], order.shape[0]
    dev = order.device
    o = order.long()
    e2r = torch.zeros(R, dtype=I32, device=dev)
    e2r[o] = torch.arange(R, dtype=I32, device=dev)
    cpad = torch.zeros(R, dtype=I32, device=dev)
    cpad[:E] = torch.clamp(counts, min=0)
    width = torch.amax(cpad[o].reshape(R // chunk, chunk), dim=1)
    return e2r[:E], width


def scs_row_order_plain(counts: torch.Tensor, num_rows: int, sigma: int, chunk: int,
                        bits: int):
    """Plain version of kernel Z: Z's key (:func:`scs_row_keys_plain`), the
    stable sort (:func:`key_sort_plain`) and Z's maps
    (:func:`scs_row_maps_plain`); where the windows' keys would pass 2^31,
    the counts' key sorts first and the windows' second."""
    R = num_rows
    sigma = min(sigma, R)
    nwin = -(-R // sigma)
    if nwin << (bits + 1) <= 2**31:
        key = scs_row_keys_plain(counts, R, sigma, bits)
        order = key_sort_plain(key, (nwin << (bits + 1)) - 1)
    else:
        by_count = key_sort_plain(scs_row_keys_plain(counts, R, R, bits), 1 << bits)
        window = torch.div(by_count, sigma, rounding_mode="floor").to(I32)
        order = key_sort_plain(window, nwin - 1, values=by_count)
    return (order,) + tuple(scs_row_maps_plain(order, counts, chunk))


def scs_row_order(counts: torch.Tensor, num_rows: int, sigma: int, chunk: int, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Sell-C-σ row order of the padded counts (``counts`` (E,) i32, E
    <= ``num_rows`` = R, a multiple of ``chunk``): (row_to_elem (R,) i32,
    the rows sorted by descending count, stable, within windows of
    ``sigma`` rows, the padding rows (>= E, count -1) last in theirs;
    elem_to_row (E,); chunk_width (R / chunk,), the largest count of each
    chunk's rows, 0 for padding).  Kernel Z on CUDA tensors: one launch of
    one thread block cluster, no memset, for any counts and any R (one
    window: one pass of at most 11-bit digits, counts far above the rest
    ranked by a second stage in the launch; σ windows or many such counts:
    more passes, their number set by the counts' min and max on the card;
    the rows stream through the L2, so R has no shared-memory limit);
    :func:`scs_row_order_plain` on CPU tensors, whose key holds counts
    below 2^``bits`` (one window: any count)."""
    R = num_rows
    if (counts.dtype != I32 or counts.dim() != 1 or counts.shape[0] > R or chunk < 1
            or R % chunk or sigma < 1):
        raise ValueError("scs_row_order: (E,) i32 counts, E <= rows, rows a multiple of "
                         "the chunk, expected")
    if not 1 <= bits <= 30:
        raise ValueError(f"scs_row_order: bits {bits} outside [1, 30]")
    if not kernels.use_kernel("scs_row_order", counts):
        return scs_row_order_plain(counts, R, sigma, chunk, bits)
    if R >= 1 << 30:
        raise ValueError("scs_row_order: the kernel takes fewer than 2^30 rows")
    E, dev = counts.shape[0], counts.device
    r2e = torch.empty(R, dtype=I32, device=dev)
    e2r = torch.empty(E, dtype=I32, device=dev)
    width = torch.empty(R // chunk, dtype=I32, device=dev)
    lib = _build.lib()
    scratch = torch.empty(lib.pp_scs_row_order_scratch_words() + 2 * R, dtype=I32, device=dev)
    err = lib.pp_scs_row_order(_ptr(counts), E, R, min(sigma, R), chunk, _ptr(r2e), _ptr(e2r),
                               _ptr(width), _ptr(scratch), _P(kernels.stream_handle()))
    _build.check(err, "scs_row_order")
    kernels.LAUNCHES["scs_row_order"] += 1
    return r2e, e2r, width


def reshuffle_order_plain(mkey: torch.Tensor, msrc: torch.Tensor,
                          mov_start: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel U3: kernel C's plain version, the movers'
    slots ``msrc`` in the stable order of their destinations ``mkey``."""
    return key_sort_plain(mkey, max(mov_start.shape[0] - 1, 0), values=msrc)


def reshuffle_order_turns(num_elems: int) -> int:
    """The key turns each bucket of kernel U3 takes over ``num_elems``
    destinations: 1 up to 524,288 (a bucket's keys fit its warps' tables),
    more in the turns form."""
    return _build.lib().pp_reshuffle_order_turns(num_elems)


def reshuffle_order(mkey: torch.Tensor, msrc: torch.Tensor, mov_start: torch.Tensor
                    ) -> torch.Tensor:
    """The reshuffle's movers in destination order: ``take`` (n,) i32 with
    take[mov_start[mkey[i]] + r_i] = msrc[i], r_i the movers before i with
    destination mkey[i] (``mkey``, ``msrc``: kernel U1's first n movers, in
    slot order; ``mov_start`` (E,): the exclusive cumsum of the movers'
    counts, destinations in [0, E)): ``msrc`` in the stable order of
    ``mkey``, as ``argsort(dest, stable=True)`` groups them.  Kernel U3 on
    CUDA tensors: one cooperative launch over the card, no memset and no
    histogram (U1 counted the movers: a bucket of consecutive destinations
    starts at mov_start of its first): the movers grouped by bucket in
    order, then each bucket ranked by key; a bucket of more keys than its
    warps' tables hold takes them in turns (:func:`reshuffle_order_turns`).
    :func:`reshuffle_order_plain` on CPU tensors."""
    if (mkey.dtype != I32 or msrc.dtype != I32 or mov_start.dtype != I32 or mkey.dim() != 1
            or msrc.shape != mkey.shape or mov_start.dim() != 1):
        raise ValueError("reshuffle_order: (n,) i32 keys and slots and (E,) i32 starts "
                         "expected")
    if not kernels.use_kernel("reshuffle_order", mkey, msrc, mov_start):
        return reshuffle_order_plain(mkey, msrc, mov_start)
    n, E = mkey.shape[0], mov_start.shape[0]
    if E == 0 or n >= 1 << 28:
        raise ValueError("reshuffle_order: the kernel takes E > 0 destinations and fewer "
                         "than 2^28 movers")
    take = torch.empty(n, dtype=I32, device=mkey.device)
    if n == 0:
        return take
    lib = _build.lib()
    scratch = torch.empty(lib.pp_reshuffle_order_scratch(E, n), dtype=I32, device=mkey.device)
    err = lib.pp_reshuffle_order(_ptr(mkey), _ptr(msrc), _ptr(mov_start), E, n, _ptr(take),
                                 _ptr(scratch), _P(kernels.stream_handle()))
    _build.check(err, "reshuffle_order")
    kernels.LAUNCHES["reshuffle_order"] += 1
    return take
