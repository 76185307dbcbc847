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
    fallback); key_sort takes (N,) int32 keys, any int32 key sorted as
    torch.sort sorts it, and masked_key_sort an (N,) int32 element array
    (or none) with an (N,) bool mask."""
    kernels.reset_launches()
    e = torch.zeros(4, dtype=torch.int32)
    a = torch.ones(4, dtype=torch.bool)
    rb.rebuild_mask_dps(e, a, 3)
    rb.rebuild_mask_epilogue(a, e, e)
    rb.rebuild_mask_prefix(e, torch.tensor(2, dtype=torch.int32))
    rb.key_sort(e, 3)
    rb.masked_key_sort(e, a, 3)
    assert not any(kernels.LAUNCHES.values())
    m = torch.device("meta")
    for call in (lambda: rb.rebuild_mask_dps(e.to(m), a.to(m), 3),
                 lambda: rb.rebuild_mask_epilogue(a.to(m), e.to(m), e.to(m)),
                 lambda: rb.rebuild_mask_prefix(e.to(m), torch.tensor(2).to(m)),
                 lambda: rb.key_sort(e.to(m), 3),
                 lambda: rb.masked_key_sort(e.to(m), a.to(m), 3)):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()
    with pytest.raises(ValueError, match="int32"):
        rb.key_sort(e.to(torch.int64), 3)
    with pytest.raises(ValueError, match="int32"):
        rb.masked_key_sort(e.to(torch.int64), a, 3)
    with pytest.raises(ValueError, match="bool"):
        rb.masked_key_sort(e, a.to(torch.int32), 3)
    for key in ([0, 4, 3, -1], [-1], [2**31 - 1, -(2**31), 0]):
        k = torch.tensor(key, dtype=torch.int32)
        assert torch.equal(rb.key_sort(k, 3), torch.sort(k, stable=True).indices.int())
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
    if case == "negative keys":
        return rng.integers(-300, 300, 9000), 300
    if case == "keys above max_key":
        return rng.integers(0, 5000, 9000), 300
    if case == "every int32":
        return rng.integers(-(2**31), 2**31, 9000), 122_603
    if case == "a few outside, ragged tiles":
        k = rng.integers(0, 122_604, 3 * 4096 + 77)
        pick = rng.integers(0, k.shape[0], 5)
        k[pick] = [-1, -(2**31), 2**31 - 1, 122_604, 1 << 20]
        return k, 122_603
    raise ValueError(case)


K_CASES = ["K=1", "K=2", "K=3", "K=255", "K=256", "K=257", "K=511", "K=512", "K=513",
           "K=131071", "K=131072", "K=131073", "K=2147483647", "all keys equal",
           "all sentinel", "M = 0", "app keys, nearly sorted", "0/1 partition"]
OUTSIDE_CASES = ["negative keys", "keys above max_key", "every int32",
                 "a few outside, ragged tiles"]


@pytest.mark.parametrize("case", K_CASES + OUTSIDE_CASES)
def test_key_sort_equals_jax_argsort(case):
    key, K = _keys(case, np.random.default_rng(len(case)))
    key = key.astype(np.int32)
    got = rb.key_sort(torch.as_tensor(key), K)
    assert got.dtype == torch.int32 and got.shape == key.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.argsort(jnp.asarray(key), stable=True)).astype(np.int32))


def _masked(case, rng):
    """(elem or None, active, fill) of a fused-mode case: the sorted
    rebuilds' (elem, active, E) and the DPS add path's (None, active, 1)."""
    n = 3 * 4096 + 77
    if case == "0/1 partition":
        return None, rng.random(n) < 0.7, 1
    E = 122_603
    elem = np.sort(rng.integers(0, E, n)).astype(np.int32)
    active = rng.random(n) < 0.9
    if case == "inactive slots hold -1":
        elem = np.where(active, elem, -1).astype(np.int32)
    if case == "active elements outside [0, E]":
        elem[rng.integers(0, n, 20)] = rng.integers(-5, 3 * E, 20)
        active[:] = True
    if case == "none active":
        active[:] = False
    return elem, active, E


MASKED_CASES = ["app's rebuild", "inactive slots hold -1", "0/1 partition",
                "active elements outside [0, E]", "none active"]


@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_key_sort_equals_jax_argsort(case):
    """The fused mode (the key formed from (elem, active, fill)) equals
    ``jnp.argsort(jnp.where(active, elem, fill), stable=True)``, and the
    key it keeps equals the where's."""
    elem, active, fill = _masked(case, np.random.default_rng(len(case)))
    order, key = rb.masked_key_sort(None if elem is None else torch.as_tensor(elem),
                                    torch.as_tensor(active), fill, keep_key=True)
    jkey = jnp.where(jnp.asarray(active), 0 if elem is None else jnp.asarray(elem), fill)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey).astype(np.int32))
    np.testing.assert_array_equal(order.numpy(), np.asarray(
        jnp.argsort(jkey, stable=True)).astype(np.int32))
    emu, emu_key = key_sort_emulated(None, fill, elem=elem, active=active, fill=fill,
                                     keep_key=True)
    np.testing.assert_array_equal(emu, order.numpy())
    np.testing.assert_array_equal(emu_key, key.numpy())
    assert rb.masked_key_sort(None, torch.as_tensor(active), fill)[1] is None


@pytest.mark.parametrize("bits", range(1, 32))
def test_key_sort_passes_cover_the_bits(bits):
    """ceil(bits / 9) passes of at most 9 bits, least significant first,
    covering the key's bits once, then ceil((32 - bits) / 9) high passes
    covering the rest of the 32 (rebuild.cu computes them the same way)."""
    passes = rb.key_sort_passes((1 << bits) - 1)
    assert len(passes) == -(-bits // rb.KS_MAX_BITS)
    assert passes[0][0] == 0 and all(0 < w <= rb.KS_MAX_BITS for _, w in passes)
    assert all(s1 == s0 + w0 for (s0, w0), (s1, _) in zip(passes, passes[1:]))
    assert passes[-1][0] + passes[-1][1] == bits
    width0 = passes[0][1]
    assert width0 == -(-bits // len(passes))
    assert rb.key_sort_passes(0) == [(0, 1)]
    high = rb.key_sort_high_passes((1 << bits) - 1)
    assert len(high) == -(-(32 - bits) // rb.KS_MAX_BITS)
    both = passes + high
    assert all(s1 == s0 + w0 for (s0, w0), (s1, _) in zip(both, both[1:]))
    assert high[-1][0] + high[-1][1] == 32 and all(0 < w <= rb.KS_MAX_BITS for _, w in high)
    assert len(both) <= _defines()["KS_MAX_PASSES"]


def test_kernel_constants_match_the_source():
    d = _defines()
    assert d["KS_MAX_BITS"] == rb.KS_MAX_BITS
    assert (d["KS_WARPS"], d["KS_CHUNKS"]) == (KS_WARPS, KS_CHUNKS)
    src = CSRC.read_text()
    assert "enum { Q_DPS = 0, Q_EPILOGUE = 1, Q_PREFIX = 2 };" in src
    assert (rb.Q_DPS, rb.Q_EPILOGUE, rb.Q_PREFIX) == (0, 1, 2)
    assert "enum { KS_LOW = 0, KS_TOP = 1, KS_HI = 2, KS_HI_LAST = 3 };" in src


KS_WARPS, KS_CHUNKS = 16, 8
KS_WARP_KEYS = 32 * KS_CHUNKS
KS_TILE = KS_WARPS * KS_WARP_KEYS
KS_LOW, KS_TOP, KS_HI, KS_HI_LAST = range(4)
AGGREGATE, INCLUSIVE = 1, 2


def _digit(key, shift, width):
    """Bits [shift, shift + width) of the keys' order-preserving image."""
    u = (np.asarray(key, np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return ((u >> shift) & ((1 << width) - 1)).astype(np.int64)


def key_sort_emulated(key, max_key: int, elem=None, active=None, fill=0,
                      keep_key=False, resident=3, seed=0):
    """Kernel C's algorithm in numpy, step for step (``pp_key_sort``):
    the plan of low and high passes; the histogram (every pass's digit
    counts, the keys outside [0, 2^bits) counted in the high passes, the
    in-range keys added to the high passes' digit of 0, the flag, the
    digits' first positions); then each pass over tiles taken in index
    order by ``resident`` blocks at a time: each warp's ranks chunk after
    chunk (the lower lanes of the chunk with its digit plus the warp's
    counter), the tile's counts published as aggregates, the tile staged
    in digit order, the look-back over the status words, KS_LOOKBACK at a
    time (in a random order of the resident tiles, so it walks
    aggregates), the staged tile written
    out; the passes' modes and buffers as the launcher gives them (a buffer
    a pass reads is never one it writes).  Returns the order (and the key
    where ``keep_key``)."""
    rng = np.random.default_rng(seed)
    window = _defines()["KS_LOOKBACK"]
    if active is not None:
        key = np.where(active, 0 if elem is None else elem, fill)
    key = np.asarray(key, np.int64).astype(np.int32)
    n = key.shape[0]
    bits = max(int(max_key).bit_length(), 1)
    plan = rb.key_sort_passes(max_key) + rb.key_sort_high_passes(max_key)
    n_low, n_pass = len(rb.key_sort_passes(max_key)), len(plan)
    # the histogram
    out = (key.astype(np.int64) & 0xFFFFFFFF) >= (1 << bits)
    starts = []
    for p, (shift, width) in enumerate(plan):
        d = _digit(key if p < n_low else key[out], shift, width)
        counts = np.bincount(d, minlength=1 << width)
        if p >= n_low:
            counts[_digit(0, shift, width)] += n - int(out.sum())
        starts.append(np.cumsum(counts) - counts)
    flag = bool(out.any())
    bufs = {"order": np.full(n, -7, np.int32)}
    n_tiles = -(-n // KS_TILE)
    for p, (shift, width) in enumerate(plan):
        mode = (KS_LOW if p < n_low - 1 else KS_TOP if p == n_low - 1
                else KS_HI_LAST if p == n_pass - 1 else KS_HI)
        if mode >= KS_HI and not flag:
            continue
        last = mode == KS_HI_LAST or (mode == KS_TOP and not flag)
        kin = None if p == 0 or p >= n_low else f"k{(p - 1) % 2}"
        iin = (None if p == 0 else f"i{(p - 1) % 2}" if p <= n_low - 1
               else ("order" if (n_pass - p) % 2 == 0 else "spare"))
        iout = (f"i{p % 2}" if mode == KS_LOW
                else ("order" if (n_pass - 1 - p) % 2 == 0 else "spare"))
        kout = f"k{p % 2}" if mode == KS_LOW else None
        if last:
            iout = "order"
        assert ({kin, iin} - {None}).isdisjoint({kout, iout} - {None})
        k_all = (key if p == 0 else key[bufs[iin]] if mode >= KS_HI else bufs[kin])
        i_all = np.arange(n, dtype=np.int32) if iin is None else bufs[iin]
        d_all = _digit(k_all, shift, width)
        D = 1 << width
        status = np.zeros((n_tiles, D), np.int64)     # (flag, value) as flag·2^30 + value
        new = {iout: np.full(n, -9, np.int32)}
        if kout:
            new[kout] = np.full(n, -9, np.int32)
        for w0 in range(0, n_tiles, resident):
            wave = list(range(w0, min(w0 + resident, n_tiles)))
            staged = {}
            for t in wave:                            # rank, publish, stage
                lo, hi = t * KS_TILE, min((t + 1) * KS_TILE, n)
                wcnt = np.zeros((KS_WARPS, D), np.int64)
                r = np.zeros(hi - lo, np.int64)
                for w in range(KS_WARPS):
                    for c in range(KS_CHUNKS):
                        a = lo + w * KS_WARP_KEYS + c * 32
                        if a >= hi:
                            continue
                        dl = d_all[a:min(a + 32, hi)]
                        same = (dl[:, None] == dl[None, :]) & np.tri(len(dl), k=-1,
                                                                      dtype=bool)
                        r[a - lo:a - lo + len(dl)] = wcnt[w, dl] + same.sum(axis=1)
                        np.add.at(wcnt[w], dl, 1)
                cnt = wcnt.sum(axis=0)
                wpre = np.cumsum(wcnt, axis=0) - wcnt
                status[t] = (INCLUSIVE if t == 0 else AGGREGATE) * 2**30 + cnt
                loc = np.cumsum(cnt) - cnt
                warp = (np.arange(lo, hi) - lo) // KS_WARP_KEYS
                d = d_all[lo:hi]
                pos = loc[d] + wpre[warp, d] + r
                assert np.array_equal(np.sort(pos), np.arange(hi - lo))
                sk, si = np.empty(hi - lo, np.int64), np.empty(hi - lo, np.int64)
                sk[pos], si[pos] = k_all[lo:hi], i_all[lo:hi]
                staged[t] = (lo, hi, loc, cnt, sk, si)
            for t in rng.permutation(wave):           # look back, write out
                lo, hi, loc, cnt, sk, si = staged[t]
                excl = np.zeros(D, np.int64)
                for dd in range(D):                   # KS_LOOKBACK words at a time
                    j, done = t - 1, False
                    while j >= 0 and not done:
                        used = 0
                        for k in range(window):
                            word = int(status[j - k, dd]) if j - k >= 0 else INCLUSIVE * 2**30
                            f, v = divmod(word, 2**30)
                            assert f != 0, "a tile waited on one not yet published"
                            excl[dd] += v
                            used, done = k + 1, f == INCLUSIVE
                            if done:
                                break
                        j -= used
                if t > 0:
                    status[t] = INCLUSIVE * 2**30 + excl + cnt
                gofs = starts[p] + excl - loc
                out_pos = gofs[_digit(sk, shift, width)] + np.arange(hi - lo)
                new[iout][out_pos] = si
                if kout:
                    new[kout][out_pos] = sk
        bufs.update(new)
    order = bufs["order"]
    return (order, key) if keep_key else order


DESIGN_CASES = ["K=1", "K=2", "K=257", "K=131073", "K=2147483647", "all keys equal",
                "all sentinel", "M = 0", "app keys, nearly sorted", "0/1 partition"]


@pytest.mark.parametrize("case", DESIGN_CASES + OUTSIDE_CASES)
def test_key_sort_design_equals_stable_argsort(case):
    """Kernel C's histogram, passes, tile ranks, look-back and staged
    write-out (numpy) give the stable argsort: over ragged and whole tiles,
    1 to 5 passes, keys outside [0, 2^bits) included."""
    key, K = _keys(case, np.random.default_rng(3 + len(case)))
    key = key.astype(np.int32)
    np.testing.assert_array_equal(key_sort_emulated(key, K, seed=len(case)),
                                  np.argsort(key, kind="stable").astype(np.int32))


def test_key_sort_design_sorts_keys_outside_the_range():
    """Keys outside [0, K] (negative ones, ones above K, the int32 limits)
    are sorted by value among themselves and against the keys in range,
    stably, through the high passes (here 2 low and 2 high, as the app's
    K = 122,603 takes), and only when the flag is raised: in range, the
    same keys take the low passes alone."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 122_604, 9000).astype(np.int32)
    key[::97] = rng.integers(-(2**31), 2**31, key[::97].shape[0])
    key[5], key[6000] = -(2**31), 2**31 - 1
    want = np.argsort(key, kind="stable").astype(np.int32)
    np.testing.assert_array_equal(key_sort_emulated(key, 122_603), want)
    np.testing.assert_array_equal(key_sort_emulated(key, 122_603, resident=1), want)
    assert (np.diff(key[want].astype(np.int64)) >= 0).all()
    ok = np.clip(key, 0, 122_603)
    np.testing.assert_array_equal(key_sort_emulated(ok, 122_603),
                                  np.argsort(ok, kind="stable").astype(np.int32))


def key_sort_schedule(n_tiles: int, passes: int, resident: int, seed: int) -> list:
    """Kernel C's one launch of every pass (``ks_passes``), as a schedule:
    ``resident`` blocks take (pass, tile) tickets in order (pass p's tiles
    are tickets [p·n_tiles, (p+1)·n_tiles)); a block waits before a tile of
    a pass later than the last it worked on until every tile of the pass
    before is written; a tile publishes its count as it starts and looks
    back until every earlier tile of its pass has published; then it is
    written.  Blocks move in a random order.  Returns the (pass, tile)
    order in which tiles were written; fails if every block waits."""
    rng = np.random.default_rng(seed)
    ticket, done, published = 0, [0] * passes, [set() for _ in range(passes)]
    blocks = [{"ready": 0, "work": None} for _ in range(resident)]
    written = []
    while len(written) < passes * n_tiles:
        moves = []
        for b in blocks:
            if b["work"] is None:
                moves.append((b, "take"))
                continue
            p, t, started = b["work"]
            if not started:
                if p <= b["ready"] or done[p - 1] == n_tiles:
                    moves.append((b, "start"))
            elif all(u in published[p] for u in range(t)):
                moves.append((b, "write"))
        assert moves, "every block waits"
        b, what = moves[rng.integers(len(moves))]
        if what == "take":
            if ticket < passes * n_tiles:
                b["work"] = (ticket // n_tiles, ticket % n_tiles, False)
                ticket += 1
            else:
                blocks.remove(b)             # the tickets are spent: the block ends
        elif what == "start":
            p, t, _ = b["work"]
            assert p == 0 or done[p - 1] == n_tiles, "a pass read before it was written"
            b["ready"], b["work"] = p, (p, t, True)
            published[p].add(t)
        else:
            p, t, _ = b["work"]
            done[p] += 1
            written.append((p, t))
            b["work"] = None
    return written


@pytest.mark.parametrize("n_tiles,passes,resident", [
    (1, 1, 1), (1, 5, 3), (7, 2, 1), (7, 2, 3), (7, 5, 2), (20, 4, 6), (3, 5, 8), (64, 2, 9)])
def test_key_sort_one_launch_schedule_ends(n_tiles, passes, resident):
    """Every pass in one launch: whatever order the resident blocks move
    in, every (pass, tile) ticket is served, a pass's tiles start only
    after every tile of the pass before is written, and the blocks never
    all wait (every ticket before a waiting one is held by a running
    block)."""
    for seed in range(20):
        written = key_sort_schedule(n_tiles, passes, resident, seed)
        assert sorted(written) == [(p, t) for p in range(passes) for t in range(n_tiles)]
        last_of = [max(i for i, (q, _) in enumerate(written) if q == p) for p in range(passes)]
        first_of = [min(i for i, (q, _) in enumerate(written) if q == p) for p in range(passes)]
        assert all(first_of[p + 1] > last_of[p] for p in range(passes - 1))


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
    package's; each goes through the fused key sort and rebuild_mask as the
    card's path does (counted by a spy)."""
    calls = {"key_sort": 0, "rebuild_mask": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("rebuild_mask_dps", "rebuild_mask_epilogue", "rebuild_mask_prefix"):
        monkeypatch.setattr(rb, name, spy("rebuild_mask", getattr(rb, name)))
    monkeypatch.setattr(rb, "key_sort", spy("key_sort", rb.key_sort))
    monkeypatch.setattr(rb, "masked_key_sort", spy("key_sort", rb.masked_key_sort))
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
