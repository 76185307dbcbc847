"""The rebuild's kernels Q (``rebuild_mask``) and C (``key_sort``): their
plain versions against the JAX package, kernel C's design in numpy, and the
four structure layouts' rebuilds through the wrappers.

Inputs come from numpy seeds.  Tolerance: none.  Ids, masks, counts and
orders are integers: every one must equal the JAX package's
(``pumipic_tpu/particles/structure.py``: ``_rebuild``'s DPS branch,
``_rebuild_sorted``'s tail, the CSR / DPS-add output mask, and
``jnp.argsort(key, stable=True)``).
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu import particles as J
from pumipic_torch import interop, kernels
from pumipic_torch import particles as T
from pumipic_torch.ops import rebuild as rb

CSRC = Path(rb.__file__).resolve().parents[1] / "kernels" / "csrc" / "rebuild.cu"


def _defines():
    """rebuild.cu's integer #defines, by name."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^#define (\w+) (\d+)\s*$", CSRC.read_text(), re.M)}


# ---------------------------------------------------------------------------
# Q: the three modes against the JAX expressions
# ---------------------------------------------------------------------------

def _dests(rng, n, E):
    """Destinations: in range, negative, out of range (>= E)."""
    ne = rng.integers(0, E, n)
    pick = rng.random(n)
    ne = np.where(pick < 0.1, -1 - rng.integers(0, 3, n), ne)
    ne = np.where((pick >= 0.1) & (pick < 0.2), E + rng.integers(0, 3, n), ne)
    return ne.astype(np.int32)


@pytest.mark.parametrize("n", [0, 1, 257, 5000])
def test_rebuild_mask_dps_equals_reference(n):
    """Q's DPS mode against the JAX package's DPS rebuild: a DPS structure
    of n slots, some inactive, rebuilt to negative, out-of-range and
    in-range destinations."""
    E = 37
    rng = np.random.default_rng(n + 1)
    elems = np.where(rng.random(n) < 0.7, rng.integers(0, E, n), -1).astype(np.int32)
    fields = {"pid": np.arange(n, dtype=np.int32)}
    cap = max(n, 8) + 8
    j = J.DPS(E, elems, fields={k: jnp.asarray(v) for k, v in fields.items()},
              capacity=cap)
    ne = _dests(rng, j.capacity, E)
    jr = j.rebuild(jnp.asarray(ne))
    active = torch.as_tensor(np.array(j.active))
    elem, keep, num = rb.rebuild_mask_dps(torch.as_tensor(ne), active, E)
    assert elem.dtype == torch.int32 and keep.dtype == torch.bool
    assert num.dtype == torch.int32 and num.dim() == 0
    np.testing.assert_array_equal(elem.numpy(), np.asarray(jr.elem))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jr.active))
    assert int(num) == int(jr.num_ptcls)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_rebuild_mask_epilogue_and_prefix_equal_jax_expressions(n):
    """Q's epilogue mode against ``_rebuild_sorted``'s tail and its prefix
    mode against the CSR / DPS-add output mask (structure.py:473-490 and
    :664-681), in jnp, on random slots: pre-valid or not, gathered keys
    equal to the slot's element or not, ``needed`` below, inside and
    beyond the slots (the overflow case)."""
    rng = np.random.default_rng(7 + n)
    E = 11
    elem_c = rng.integers(0, E, n).astype(np.int32)
    key_src = np.where(rng.random(n) < 0.6, elem_c, rng.integers(0, E + 1, n)).astype(np.int32)
    pre_valid = rng.random(n) < 0.8
    elem, valid, num = rb.rebuild_mask_epilogue(
        torch.as_tensor(pre_valid), torch.as_tensor(key_src), torch.as_tensor(elem_c))
    jv = jnp.asarray(pre_valid) & (jnp.asarray(key_src) == jnp.asarray(elem_c))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        elem.numpy(), np.asarray(jnp.where(jv, jnp.asarray(elem_c), -1).astype(jnp.int32)))
    assert int(num) == int(jnp.sum(jv.astype(jnp.int32)))
    for needed in (0, n // 3, n, n + 5):
        nd = torch.tensor(needed, dtype=torch.int32)
        elem, act, num = rb.rebuild_mask_prefix(torch.as_tensor(key_src), nd)
        ja = jnp.arange(n, dtype=jnp.int32) < needed
        np.testing.assert_array_equal(act.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(
            elem.numpy(), np.asarray(jnp.where(ja, jnp.asarray(key_src), -1)))
        assert elem.dtype == torch.int32 and int(num) == int(jnp.sum(ja.astype(jnp.int32)))


def test_rebuild_mask_and_key_sort_refuse_other_devices_and_inputs():
    """On the CPU the wrappers run their plain versions and count no
    launch; on a device that is neither CPU nor CUDA they raise (no
    fallback); key_sort takes (N,) int32 keys in [0, max_key]."""
    kernels.reset_launches()
    e = torch.zeros(4, dtype=torch.int32)
    a = torch.ones(4, dtype=torch.bool)
    rb.rebuild_mask_dps(e, a, 3)
    rb.rebuild_mask_epilogue(a, e, e)
    rb.rebuild_mask_prefix(e, torch.tensor(2, dtype=torch.int32))
    rb.key_sort(e, 3)
    assert not any(kernels.LAUNCHES.values())
    m = torch.device("meta")
    for call in (lambda: rb.rebuild_mask_dps(e.to(m), a.to(m), 3),
                 lambda: rb.rebuild_mask_epilogue(a.to(m), e.to(m), e.to(m)),
                 lambda: rb.rebuild_mask_prefix(e.to(m), torch.tensor(2).to(m)),
                 lambda: rb.key_sort(e.to(m), 3)):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()
    with pytest.raises(ValueError, match="int32"):
        rb.key_sort(e.to(torch.int64), 3)
    with pytest.raises(ValueError, match="outside"):
        rb.key_sort(torch.tensor([0, 4], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="outside"):
        rb.key_sort(torch.tensor([-1], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="max_key"):
        rb.key_sort(e, 2**31)


# ---------------------------------------------------------------------------
# C: the stable order against jnp.argsort, and its design in numpy
# ---------------------------------------------------------------------------

def _keys(case, rng):
    """(keys, max_key) of a named case."""
    if case.startswith("K="):
        K = int(case[2:])
        return rng.integers(0, K + 1, 3000), K
    if case == "all keys equal":
        return np.full(2000, 5), 9
    if case == "all sentinel":
        return np.full(2000, 122_603), 122_603
    if case == "M = 0":
        return np.zeros(0), 4
    if case == "app keys, nearly sorted":
        k = np.sort(rng.integers(0, 122_603, 20_000))
        swap = rng.integers(0, 20_000, 400)
        k[swap] = k[swap[::-1]]
        return np.where(rng.random(20_000) < 0.05, 122_603, k), 122_603
    if case == "0/1 partition":
        return (rng.random(5000) < 0.3).astype(np.int64), 1
    raise ValueError(case)


K_CASES = ["K=1", "K=2", "K=3", "K=255", "K=256", "K=257", "K=511", "K=512", "K=513",
           "K=131071", "K=131072", "K=131073", "K=2147483647", "all keys equal",
           "all sentinel", "M = 0", "app keys, nearly sorted", "0/1 partition"]


@pytest.mark.parametrize("case", K_CASES)
def test_key_sort_equals_jax_argsort(case):
    key, K = _keys(case, np.random.default_rng(len(case)))
    key = key.astype(np.int32)
    got = rb.key_sort(torch.as_tensor(key), K)
    assert got.dtype == torch.int32 and got.shape == key.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.argsort(jnp.asarray(key), stable=True)).astype(np.int32))


@pytest.mark.parametrize("bits", range(1, 32))
def test_key_sort_passes_cover_the_bits(bits):
    """ceil(bits / 9) passes of at most 9 bits, least significant first,
    covering the key's bits once (rebuild.cu computes them the same way)."""
    passes = rb.key_sort_passes((1 << bits) - 1)
    assert len(passes) == -(-bits // rb.KS_MAX_BITS)
    assert passes[0][0] == 0 and all(0 < w <= rb.KS_MAX_BITS for _, w in passes)
    assert all(s1 == s0 + w0 for (s0, w0), (s1, _) in zip(passes, passes[1:]))
    assert passes[-1][0] + passes[-1][1] == bits
    width0 = passes[0][1]
    assert width0 == -(-bits // len(passes))
    assert rb.key_sort_passes(0) == [(0, 1)]


def test_kernel_constants_match_the_source():
    d = _defines()
    assert d["KS_MAX_BITS"] == rb.KS_MAX_BITS
    assert (d["KS_WARPS"], d["KS_CHUNKS"]) == (KS_WARPS, KS_CHUNKS)
    src = CSRC.read_text()
    assert "enum { Q_DPS = 0, Q_EPILOGUE = 1, Q_PREFIX = 2 };" in src
    assert (rb.Q_DPS, rb.Q_EPILOGUE, rb.Q_PREFIX) == (0, 1, 2)


KS_WARPS, KS_CHUNKS = 8, 16
KS_WARP_KEYS = 32 * KS_CHUNKS
KS_TILE = KS_WARPS * KS_WARP_KEYS


def key_sort_emulated(key: np.ndarray, max_key: int) -> np.ndarray:
    """Kernel C's algorithm in numpy, step for step: the digit passes; per
    tile the digit counts (digit-major rows); the rows' exclusive scans and
    the digits' first positions; each warp's ranks chunk after chunk (the
    lower lanes of the chunk with its digit plus the warp's counter); the
    per-warp bases (digit start + tile prefix + the lower warps' counts);
    the scatter of keys and source indices."""
    key = np.asarray(key, np.int32)
    n = key.shape[0]
    n_tiles = -(-n // KS_TILE)
    passes = rb.key_sort_passes(max_key)
    kin, iin = key, np.arange(n, dtype=np.int32)
    for p, (shift, width) in enumerate(passes):
        top, D = p == len(passes) - 1, 1 << width
        d_all = kin.astype(np.uint32) >> np.uint32(shift)
        d_all = (np.minimum(d_all, D - 1) if top else d_all & (D - 1)).astype(np.int64)
        counts = np.zeros((D, n_tiles), np.int64)                       # ks_count
        np.add.at(counts, (d_all, np.arange(n) // KS_TILE), 1)
        prefix = np.cumsum(counts, axis=1) - counts                     # ks_scan_rows
        totals = counts.sum(axis=1)
        start = np.cumsum(totals) - totals                              # ks_scan_digits
        kout, iout = np.empty_like(kin), np.empty_like(iin)            # ks_scatter
        for t in range(n_tiles):
            wcnt = np.zeros((KS_WARPS, D), np.int64)
            rank = {}
            for w in range(KS_WARPS):
                for c in range(KS_CHUNKS):
                    lo = t * KS_TILE + w * KS_WARP_KEYS + c * 32
                    d = d_all[lo:min(lo + 32, n)]
                    for lane, dl in enumerate(d):       # popc(group & lower lanes)
                        rank[lo + lane] = wcnt[w, dl] + int((d[:lane] == dl).sum())
                    np.add.at(wcnt[w], d, 1)            # the group's highest lane
            base = start + prefix[:, t]
            for w in range(KS_WARPS):
                wcnt[w], base = base, base + wcnt[w]
            for i, r in rank.items():
                pos = wcnt[(i - t * KS_TILE) // KS_WARP_KEYS, d_all[i]] + r
                kout[pos], iout[pos] = kin[i], iin[i]
        kin, iin = kout, iout
    return iin


@pytest.mark.parametrize("case", ["K=1", "K=2", "K=257", "K=131073", "K=2147483647",
                                  "all keys equal", "all sentinel", "M = 0",
                                  "app keys, nearly sorted", "0/1 partition"])
def test_key_sort_design_equals_stable_argsort(case):
    """Kernel C's passes, tile ranks and scatter (numpy) give the stable
    argsort: over ragged and whole tiles, 1 to 4 passes."""
    key, K = _keys(case, np.random.default_rng(3 + len(case)))
    key = key.astype(np.int32)
    np.testing.assert_array_equal(key_sort_emulated(key, K),
                                  np.argsort(key, kind="stable").astype(np.int32))


def test_key_sort_design_keeps_keys_outside_the_range_distinct():
    """Keys outside [0, K] (which the wrapper refuses on the CPU) still
    land on distinct positions: the output is a permutation."""
    rng = np.random.default_rng(5)
    key = rng.integers(-5, 1000, 9000).astype(np.int32)
    got = key_sort_emulated(key, 300)
    np.testing.assert_array_equal(np.sort(got), np.arange(9000))


# ---------------------------------------------------------------------------
# the four layouts' rebuilds through the wrappers, several steps
# ---------------------------------------------------------------------------

E = 23


def _builders(m, kw):
    return {
        "scs": lambda e, f, **k: m.SellCSigma(
            E, e, fields=f, scs_input=m.SCSInput(chunk_size=4, sigma=8), **kw, **k),
        "csr": lambda e, f, **k: m.CSR(E, e, fields=f, **kw, **k),
        "cabm": lambda e, f, **k: m.CabM(E, e, fields=f, soa_width=4, **kw, **k),
        "dps": lambda e, f, **k: m.DPS(E, e, fields=f, **kw, **k),
    }


def _same(j, t, tag):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "fields":
            assert sorted(a) == sorted(b), tag
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                              err_msg=f"{tag} {k}")
        elif f.name in interop.STRUCTURE_STATIC:
            assert a == b, (tag, f.name)
        elif a is None or b is None:
            assert a is None and b is None, (tag, f.name)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{tag} {f.name}")


@pytest.mark.parametrize("layout", ["scs", "csr", "cabm", "dps"])
def test_layout_rebuilds_equal_reference_through_the_wrappers(layout, monkeypatch):
    """Five rebuilds of each layout (moves, removals, out-of-range
    destinations, a batch of additions, an overflow) equal the JAX
    package's; each goes through key_sort and rebuild_mask as the card's
    path does (counted by a spy)."""
    calls = {"key_sort": 0, "rebuild_mask": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("rebuild_mask_dps", "rebuild_mask_epilogue", "rebuild_mask_prefix"):
        monkeypatch.setattr(rb, name, spy("rebuild_mask", getattr(rb, name)))
    monkeypatch.setattr(rb, "key_sort", spy("key_sort", rb.key_sort))
    rng = np.random.default_rng(17)
    n = 300
    elems = rng.integers(0, E, n).astype(np.int32)
    fields = {"x": rng.normal(size=(n, 3)).astype(np.float32),
              "pid": np.arange(n, dtype=np.int32)}
    kw = {"capacity": 400} if layout in ("csr", "dps") else {}
    j = _builders(J, {})[layout](elems, {k: jnp.asarray(v) for k, v in fields.items()}, **kw)
    t = _builders(T, {"device": "cpu"})[layout](
        elems, {k: torch.as_tensor(v) for k, v in fields.items()}, **kw)
    _same(j, t, f"{layout} build")
    for step in range(5):
        cur = np.where(np.asarray(j.active), np.asarray(j.elem), -1)
        ne = np.where(rng.random(cur.shape) < 0.3, _dests(rng, cur.shape[0], E), cur)
        ne = np.where(cur >= 0, ne, -1).astype(np.int32)
        add = None
        if step == 2:
            add = np.concatenate([rng.integers(0, E, 40), [E + 1, -1]]).astype(np.int32)
        if step == 4:       # more than the capacity holds
            add = rng.integers(0, E, 600).astype(np.int32)
        if add is None:
            j, t = j.rebuild(jnp.asarray(ne)), t.rebuild(torch.as_tensor(ne))
        else:
            af = {"x": np.full((add.shape[0], 3), step, np.float32),
                  "pid": np.arange(add.shape[0], dtype=np.int32) + 1000 * step}
            j = j.rebuild(jnp.asarray(ne), jnp.asarray(add),
                          {k: jnp.asarray(v) for k, v in af.items()})
            t = t.rebuild(torch.as_tensor(ne), torch.as_tensor(add),
                          {k: torch.as_tensor(v) for k, v in af.items()})
        _same(j, t, f"{layout} step {step}")
        assert int(t.num_ptcls) == int(t.active.sum())
        oj, offj = j.get_pids()
        ot, offt = t.get_pids()
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(offt.numpy(), np.asarray(offj))
    assert bool(t.overflowed)
    # every rebuild checks its destinations (Q), and the sorted ones and
    # get_pids sort (C); DPS sorts only when it takes additions
    assert calls["rebuild_mask"] >= 5
    assert calls["key_sort"] >= (7 if layout == "dps" else 10)
