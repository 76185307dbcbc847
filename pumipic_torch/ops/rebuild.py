"""The particle structures' rebuild around the slot map and the field
gather: kernels Q and C (``kernels/csrc/rebuild.cu``).

- :func:`rebuild_mask_dps`, :func:`rebuild_mask_epilogue` and
  :func:`rebuild_mask_prefix` are the three modes of kernel Q, one pass
  that rewrites a rebuild's element ids and mask and counts the particles
  held: the destinations' check of every rebuild (the whole DPS rebuild),
  the sorted SCS/CabM rebuild's epilogue, and the CSR and DPS-add
  rebuilds' "first ``needed`` slots" form.
- :func:`key_sort` is the wrapper of kernel C, the stable sort of the
  rebuilds' element keys: the int32 order that ``torch.sort(key,
  stable=True)`` gives, for every int32 key; :func:`masked_key_sort` is its
  fused mode, which forms the key ``where(active, elem, fill)`` itself.

Each runs its plain PyTorch version (``*_plain``: the JAX package's
arithmetic, ``pumipic_tpu/particles/structure.py``) on CPU tensors and
launches its kernel on CUDA tensors (one launch counted, under
``rebuild_mask`` or ``key_sort``).  Every output is an integer or a mask,
so the two are equal bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build

_P = ctypes.c_void_p
I32 = torch.int32

# kernel C's widest digit, as rebuild.cu defines it
KS_MAX_BITS = 9

# kernel Q's modes, as rebuild.cu numbers them
Q_DPS, Q_EPILOGUE, Q_PREFIX = 0, 1, 2


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


def key_sort_plain(key: torch.Tensor, max_key: int) -> torch.Tensor:
    """Plain version of kernel C: torch's stable sort, its indices as
    int32 (any int32 keys; ``max_key`` only picks the kernel's passes)."""
    return torch.sort(key, stable=True).indices.to(I32)


def masked_key_sort_plain(elem: Optional[torch.Tensor], active: torch.Tensor, fill: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel C's fused mode: the rebuilds' element key
    (``elem``, 0 where None, where ``active``; ``fill`` elsewhere; int32)
    and its stable order."""
    key = torch.where(active, elem if elem is not None else 0, fill).to(I32)
    return key_sort_plain(key, fill), key


def _key_sort(n: int, dev, max_key: int, key=None, elem=None, active=None, fill: int = 0,
              keep_key: bool = False):
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
                          *(_ptr(b) for b in bufs), _ptr(spare),
                          _P(kernels.stream_handle()))
    _build.check(err, "key_sort")
    kernels.LAUNCHES["key_sort"] += 1
    return order, key_out


def key_sort(key: torch.Tensor, max_key: int) -> torch.Tensor:
    """The (N,) int32 order of (N,) int32 ``key`` that a stable argsort
    gives: ``key[order]`` ascending, equal keys in index order, for every
    int32 key.  ``max_key`` is the largest key the caller expects: kernel C
    (on CUDA tensors) sorts keys in [0, max_key] in its low passes and takes
    passes over the high bits only when a key lies outside [0, 2^bits).
    :func:`key_sort_plain` on CPU tensors."""
    if key.dtype != I32 or key.dim() != 1:
        raise ValueError("key_sort: (N,) int32 keys expected")
    if not 0 <= max_key < 2**31:
        raise ValueError(f"key_sort: max_key {max_key} outside [0, 2^31)")
    if not kernels.use_kernel("key_sort", key):
        return key_sort_plain(key, max_key)
    return _key_sort(key.shape[0], key.device, max_key, key=key)[0]


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
