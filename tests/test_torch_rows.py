"""Kernels G (row gather) and S (the sorted rebuild's slot map) on the CPU:
their wrappers dispatch to the plain versions, which hold against the JAX
package's ``_gather_fields`` and the slot arithmetic of its
``_rebuild_sorted``.

Tolerance: none.  G moves 32-bit words and S is integer arithmetic, so
every output is compared bit for bit, on every slot (valid or not).  How
kernel S splits the slots among its threads is modelled in numpy
(tests/slotmap_tiles.py) and held to the plain version here.  The
card-side comparisons of each kernel with its plain version are in
tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu import particles as J
from pumipic_tpu.particles import structure as JS
from pumipic_torch import kernels
from pumipic_torch.ops import rows
from pumipic_torch.particles import structure as TS

import slotmap_tiles


def _bits(rng, shape):
    """f32 array of random 32-bit patterns (NaNs, infinities, denormals)."""
    return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32).view(np.float32)


@pytest.mark.parametrize("n", [0, 1, 31, 1000])
@pytest.mark.parametrize("w", [1, 8, 14])
def test_row_gather_rows_form_moves_bits(n, w):
    rng = np.random.default_rng(w + n)
    table = _bits(rng, (257, w))
    idx = rng.integers(0, 257, n).astype(np.int32)
    n0 = kernels.LAUNCHES["row_gather"]
    got = rows.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert kernels.LAUNCHES["row_gather"] == n0          # plain version: no launch
    np.testing.assert_array_equal(got.numpy().view(np.int32), table[idx].view(np.int32))


def test_row_gather_columns_form_and_lanes():
    rng = np.random.default_rng(3)
    M = 100
    cols = [torch.from_numpy(_bits(rng, (M, 2))), torch.from_numpy(_bits(rng, (M,))),
            torch.arange(M, dtype=torch.int32), torch.arange(M, dtype=torch.int64),
            torch.from_numpy(_bits(rng, (M, 3, 2)))]
    assert [rows.lanes_of(c) for c in cols] == [2, 1, 1, 2, 6]
    assert rows.lanes_of(torch.zeros(M, dtype=torch.bool)) == 0
    assert rows.lanes_of(torch.zeros(M, dtype=torch.float16)) == 0
    idx = torch.from_numpy(rng.integers(0, M, 77).astype(np.int32))
    got = rows.row_gather(cols, idx)
    assert isinstance(got, list) and len(got) == len(cols)
    for g, c in zip(got, cols):
        assert g.dtype == c.dtype
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           (c[idx.long()].view(torch.int32) if c.dtype == torch.float32
                            else c[idx.long()]))


def test_wrappers_refuse_other_devices():
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        rows.row_gather(torch.zeros(4, 2, device="meta"), idx)
    with pytest.raises(ValueError, match="several devices"):
        rows.row_gather(torch.zeros(4, 2), idx)
    with pytest.raises(ValueError, match="device"):
        rows.slot_map("scs", idx, idx, idx, idx, 8, 4, 4)


def _jax_gather(fields, take, extra):
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    return JS._gather_fields(jf, jnp.asarray(take), extra=tuple(jnp.asarray(e) for e in extra))


@pytest.mark.parametrize("packed", [True, False])
def test_gather_fields_equals_reference(packed, monkeypatch):
    """The port's field move (kernel G, columns form; torch indexing for a
    1-byte field) equals the JAX package's packed and per-field gathers."""
    monkeypatch.setattr(JS, "PACKED_REBUILD_GATHER", packed)
    rng = np.random.default_rng(5)
    M = 300
    fields = {"x": _bits(rng, (M, 2)), "pid": np.arange(M, dtype=np.int32),
              "phi": _bits(rng, (M,)), "w": rng.normal(size=(M, 3)).astype(np.float32)}
    key = rng.integers(-1, 40, M).astype(np.int32)
    take = rng.integers(0, M, 250).astype(np.int32)
    jf, (jk,) = _jax_gather(fields, take, (key,))
    tf, (tk,) = TS._gather_fields({k: torch.from_numpy(v) for k, v in fields.items()},
                                  torch.from_numpy(take), extra=(torch.from_numpy(key),))
    for k in fields:
        np.testing.assert_array_equal(tf[k].numpy().view(np.int32),
                                      np.asarray(jf[k]).view(np.int32), err_msg=k)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # a bool field is not made of 4-byte words: it moves by indexing
    flag = rng.uniform(size=M) < 0.5
    tf2, _ = TS._gather_fields({"flag": torch.from_numpy(flag)}, torch.from_numpy(take))
    np.testing.assert_array_equal(tf2["flag"].numpy(), flag[take])


def _slot_case(layout, E, n, chunk, sigma, extra_padding, seed, cap_scale):
    """A JAX structure and the inputs of its sorted rebuild."""
    rng = np.random.default_rng(seed)
    elems = rng.integers(0, E, n)
    elems[rng.uniform(size=n) < 0.3] = int(rng.integers(0, E))   # a crowded element
    fields = {"pid": jnp.arange(n, dtype=jnp.int32)}
    if layout == "scs":
        ps = J.SellCSigma(E, elems, fields=fields, scs_input=J.SCSInput(
            chunk_size=chunk, sigma=sigma, extra_padding=extra_padding,
            pad_strategy="inversely"))
    else:
        ps = J.CabM(E, elems, fields=fields, soa_width=chunk,
                    extra_padding=extra_padding)
    ps = dataclasses.replace(ps, capacity=int(ps.capacity * cap_scale) // 8 * 8)
    M = ps.capacity + 37
    new_elem = rng.integers(-2, E + 2, M).astype(np.int32)
    new_elem[rng.uniform(size=M) < 0.4] = int(rng.integers(0, E))
    return ps, new_elem


@pytest.mark.parametrize("layout,chunk,sigma,extra_padding,cap_scale", [
    ("scs", 8, 2**30, 0.0, 1.0), ("scs", 4, 8, 0.3, 1.0), ("scs", 3, 5, 0.0, 0.5),
    ("scs", 8, 2**30, 0.3, 0.5), ("cabm", 8, 0, 0.0, 1.0), ("cabm", 16, 0, 0.3, 1.0),
    ("cabm", 8, 0, 0.3, 0.5)])
def test_slot_map_equals_reference_on_every_slot(layout, chunk, sigma,
                                                 extra_padding, cap_scale):
    """Slot j's source: the JAX package's ``_rebuild_sorted`` run on a
    structure whose only field is each row's own index gives, at EVERY
    slot, the row the slot took (its fields at invalid slots are whatever
    src points to), and its output mask is ``pre_valid & key == elem_c``.
    ``cap_scale`` 0.5 makes the layout overflow the capacity."""
    E = 23
    jps, new_elem = _slot_case(layout, E, 400, chunk, sigma, extra_padding, 11,
                               cap_scale)
    M, C = new_elem.shape[0], jps.capacity
    ne = jnp.asarray(new_elem)
    active = (ne >= 0) & (ne < E)
    elem = jnp.where(active, ne, -1)
    out = JS._rebuild_sorted(jps, elem, active,
                             {"row": jnp.arange(M, dtype=jnp.int32)})
    # the port's inputs to S, as its _rebuild_sorted computes them
    te = torch.as_tensor(np.array(elem))
    key = torch.where(te >= 0, te, E)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.bincount(te[te >= 0].long(), minlength=E).to(torch.int32)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    if layout == "cabm":
        ce = TS._scs_pad_counts(counts, extra_padding, "proportionally")
        seg = ((ce + chunk - 1) // chunk) * chunk
        offsets = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0, dtype=torch.int32)])
        r2e = None
    else:
        r2e, _, cw = TS._scs_row_order(counts, sigma, chunk, E, extra_padding,
                                       "inversely")
        offsets = torch.cat([cw.new_zeros(1), torch.cumsum(chunk * cw, 0, dtype=torch.int32)])
    src, elem_c, pre_valid = rows.slot_map(layout, order, start, offsets, r2e,
                                           chunk, C, M)
    np.testing.assert_array_equal(src.numpy(), np.asarray(out.fields["row"]))
    valid = pre_valid & (key[src.long()] == elem_c)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(out.active))
    np.testing.assert_array_equal(torch.where(valid, elem_c, -1).numpy(),
                                  np.asarray(out.elem))
    assert bool(out.overflowed) == (int(offsets[-1]) > C)
    # a brute-force reading of the map: slot j lies in segment s with
    # offsets[s] <= j < offsets[s+1] (empty segments skipped)
    off = offsets.numpy()
    s = np.searchsorted(off[1:-1], np.arange(C), side="right")
    if layout == "cabm":
        np.testing.assert_array_equal(elem_c.numpy(), np.minimum(s, E - 1))


@pytest.mark.parametrize("layout,chunk", [("scs", 8), ("scs", 3), ("cabm", 8)])
@pytest.mark.parametrize("case", slotmap_tiles.SLOT_CASES)
@pytest.mark.parametrize("fill", slotmap_tiles.SLOT_FILLS)
def test_slot_map_tiles_cover_every_slot_as_plain(layout, chunk, case, fill):
    """Kernel S's partition (a tile of slots per block, the tile's segment
    window searched once, each thread's slots stepped through it; numpy
    model in tests/slotmap_tiles.py) writes every slot exactly once, with
    the plain version's src, elem_c and pre_valid: segments wider than a
    tile, empty segments and width-0 chunks, SCS pad rows, a window larger
    than the kernel's shared-memory cap, C not a multiple of the tile, and
    needed below, equal to and above C."""
    order, start, offsets, r2e, C, M = slotmap_tiles.slot_inputs(layout, case, fill, chunk)
    args = (layout, order, start, offsets, r2e, chunk if layout == "scs" else 1, C, M)
    *got, stats = slotmap_tiles.slot_map_tiles(*args)
    for g, w in zip(got, rows.slot_map_plain(*args)):
        np.testing.assert_array_equal(g, w.numpy())
    consts = slotmap_tiles.kernel_constants()
    assert C % (consts["SLOT_THREADS"] * consts["SLOTS_PER_THREAD"]) != 0
    if case == "wide segment":
        assert stats["longest_segment_tiles"] >= 3
    if case == "sparse window" and (layout == "cabm" or fill == "tail"):
        assert stats["windows_over_cap"] >= 1
    if case == "empty segments":
        assert (torch.diff(offsets) == 0).any()
