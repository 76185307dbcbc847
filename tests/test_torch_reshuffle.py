"""Parity of the port's reshuffle-or-rebuild (``rebuild(mode="auto")``:
kernels U1, U3, G and U2 on the card) and of its Sell-C-σ row order (kernel
Z) with the JAX reference, on the CPU, where every wrapper runs its plain
version.

- ``rebuild(mode="auto")`` of the port against the JAX package's, every
  member of the structure equal, for Sell-C-σ under the three pad
  strategies and σ in {8, 16, all rows} and for CabM, with f32 (N, 3),
  int32 and bool fields: a swap churn (each mover's source slot is another
  mover's destination), a random churn, a concentrated churn that cannot
  fit, and n_mov equal to the mover budget and one above it.
- ``_scs_row_order`` (kernel Z's wrapper, whose plain version chains the
  key, the plain sort and the maps) against the JAX ``_scs_row_order`` on
  counts with ties, zeros and counts above the key's bits, E not a
  multiple of the chunk; the same through ``scs_row_order`` and its plain
  version directly; Z's cluster design (the min and max, the clamped pass
  and its big rows' stage, the LSD passes, each warp's digit table, the
  blocks' counts exchanged, the widths from the rows that start a chunk or
  a window) emulated in numpy against the reference, also where the counts
  need several passes, all counts are equal or zero, E = 1.
- ``reshuffle_order_plain`` (kernel U3's) on U1's plain outputs against a
  stable argsort of the movers' keys and against where the JAX
  ``_rebuild_auto`` puts the movers; U3's design (tiles counted by key
  bucket, the buckets' columns scanned from U1's starts, the movers
  grouped by bucket, each bucket ranked by key in turns of a warp table's
  keys) emulated in numpy against the plain version.
- CPU emulations of U1's and U2's schedules (U1: tiles in launch
  order, the flag past the budget and the tiles that then count alone;
  U2: units in any order, rounds of 32 consecutive slots, a row's holes
  ranked by its lanes' ballot, every slot written once, the fields in
  place) equal to their plain versions; ``rebuild(mode="auto")`` writes
  the fields in place.

Tolerance: none.  Structures are integer and bit moves."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu import particles as J
from pumipic_tpu.particles import structure as JS
from pumipic_torch import interop
from pumipic_torch import particles as T
from pumipic_torch.ops import rebuild as rb
from pumipic_torch.particles import structure as TS

E = 40
N = 1200

SCS_CASES = [(s, g) for s in ("evenly", "proportionally", "inversely")
             for g in (8, 16, None)]
CONFIGS = [f"scs-{s}-{g or 'all'}" for s, g in SCS_CASES] + ["cabm"]
CHURNS = ["swap", "random", "concentrated", "budget", "budget+1"]


def _fields(rng):
    return {"x": rng.normal(size=(N, 3)).astype(np.float32),
            "pid": np.arange(N, dtype=np.int32),
            "flag": rng.uniform(size=N) < 0.5}


def _build(m, config, elems, fields, device_kw):
    if config == "cabm":
        return m.CabM(E, elems, fields=fields, soa_width=8, extra_padding=0.3,
                      **device_kw)
    _, strategy, sigma = config.split("-")
    scs = dict(chunk_size=8, sigma=None if sigma == "all" else int(sigma),
               extra_padding=0.3, pad_strategy=strategy)
    return m.SellCSigma(E, elems, fields=fields, scs_input=m.SCSInput(**scs), **device_kw)


def _pair(config, seed=7):
    rng = np.random.default_rng(seed)
    elems = np.sort(rng.integers(0, E, N))
    f = _fields(rng)
    j = _build(J, config, elems, {k: jnp.asarray(v) for k, v in f.items()}, {})
    t = _build(T, config, elems, {k: torch.as_tensor(v) for k, v in f.items()},
               {"device": "cpu"})
    return j, t


def assert_same(j, t, tag=""):
    """Every member of the JAX structure equals the port's."""
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "fields":
            assert sorted(a) == sorted(b), tag
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                              err_msg=f"{tag} field {k}")
        elif f.name in interop.STRUCTURE_STATIC:
            assert a == b, (tag, f.name)
        elif a is None or b is None:
            assert a is None and b is None, (tag, f.name)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{tag} {f.name}")


def _cur(j):
    return np.where(np.asarray(j.active), np.asarray(j.elem), -1).astype(np.int32)


def _churn(j, kind, rng):
    cur = _cur(j)
    new = cur.copy()
    live = np.flatnonzero(cur >= 0)
    if kind in ("swap", "budget", "budget+1"):
        # count-preserving: pairs of particles of different elements swap
        # elements, so a mover's source is another mover's destination
        k = len(live) // 8 * 2
        sel = rng.choice(live, size=k, replace=False)
        a, b = sel[:k // 2], sel[k // 2:]
        new[a], new[b] = cur[b], cur[a]
    elif kind == "random":
        mv = rng.uniform(size=len(live)) < 0.04
        new[live[mv]] = rng.integers(-1, E + 2, int(mv.sum()))
    else:  # concentrated: far more movers into one element than it holds
        mv = rng.uniform(size=len(live)) < 0.3
        new[live[mv]] = 3
    return new


def _n_mov(j, new):
    cur = _cur(j)
    keep = (new >= 0) & (new < E)
    return int((keep & (new != cur)).sum())


@pytest.mark.parametrize("churn", CHURNS)
@pytest.mark.parametrize("config", CONFIGS)
def test_auto_rebuild_equals_reference(config, churn, monkeypatch, request):
    """Two auto rebuilds (a random churn, then the case's), every member of
    the port's structure equal to the JAX package's after each; the branch
    each took is the one the case names."""
    calls = []
    real = TS._reshuffle
    monkeypatch.setattr(TS, "_reshuffle", lambda *a: calls.append(a[-1]) or real(*a))
    rng = np.random.default_rng(CONFIGS.index(config) * 10 + CHURNS.index(churn))
    j, t = _pair(config)
    assert_same(j, t, "build")
    if churn.startswith("budget"):
        request.addfinalizer(JS._rebuild.clear_cache)   # drop the traces of the patched MB
    for i, kind in enumerate(("random", churn)):
        new = _churn(j, kind, rng)
        n_mov = _n_mov(j, new)
        if kind.startswith("budget"):
            mb = n_mov - (kind == "budget+1")
            monkeypatch.setattr(JS, "_reshuffle_mover_budget", lambda cap: mb)
            monkeypatch.setattr(TS, "_reshuffle_mover_budget", lambda cap: mb)
            JS._rebuild.clear_cache()      # the jitted reference reads MB when traced
        calls.clear()
        j = j.rebuild(jnp.asarray(new), mode="auto")
        t = t.rebuild(torch.as_tensor(new), mode="auto")
        assert_same(j, t, f"{config} {kind} step {i}")
        assert int(t.num_ptcls) == int(t.active.sum())
        reshuffled = kind not in ("concentrated", "budget+1")
        assert calls == ([n_mov] if reshuffled else []), (kind, calls)
        assert not (reshuffled and bool(t.overflowed))


@pytest.mark.parametrize("chunk", [3, 4, 8])
@pytest.mark.parametrize("sigma", [8, 16, None])
@pytest.mark.parametrize("bound", ["tight", "none"])
def test_scs_row_order_equals_reference(chunk, sigma, bound):
    """The row order through Z's key, the plain stable sort and Z's maps
    equals the JAX ``_scs_row_order``: ties, zeros, a count above the one-
    window key's bits (a negative key), E = 37 (not a multiple of 3, 4 or
    8); with the counts' bound given (the composite key over windows) and
    without (one window: the mean's bits; windows: two sorts)."""
    rng = np.random.default_rng(chunk * 100 + (sigma or 0))
    En = 37
    counts = rng.integers(0, 6, En).astype(np.int32)
    counts[rng.choice(En, 5, replace=False)] = 0
    counts[rng.choice(En, 4, replace=False)] = 3
    counts[11] = 900
    num = int(counts.sum()) if bound == "tight" else None
    s = sigma or 2**30
    for extra, strat in ((0.0, "proportionally"), (0.25, "inversely"), (0.5, "evenly")):
        want = JS._scs_row_order(jnp.asarray(counts), s, chunk, En, extra, strat)
        got = TS._scs_row_order(torch.as_tensor(counts), s, chunk, En, extra, strat,
                                num_ptcls=num)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_scs_row_keys_put_padding_last_and_windows_apart():
    """The key of Z's plain version: descending counts ascend, the padding rows' key 2^b follows
    every count of their window, and each window's keys lie below the
    next's."""
    counts = torch.tensor([0, 5, 2, 5, 7, 1, 0], dtype=torch.int32)
    key = rb.scs_row_keys_plain(counts, 8, 4, 3)
    assert key.tolist() == [7, 2, 5, 2, 16, 22, 23, 24]
    assert rb.key_sort(key, 31).tolist() == [1, 3, 2, 0, 4, 5, 6, 7]
    one = rb.scs_row_keys_plain(counts, 8, 8, 2)    # 5 and 7 exceed 2^2 - 1
    assert one.tolist() == [3, -2, 1, -2, -4, 2, 3, 4]


def test_count_bits_hold_every_padded_count():
    """_scs_count_bits covers the largest padded count of each strategy
    when every particle sits in one element."""
    for n in (1, 7, 1000, 123457):
        for extra in (0.0, 0.15, 0.5, 1.0):
            bits = TS._scs_count_bits(n, extra)
            for strat in ("evenly", "proportionally", "inversely"):
                c = np.zeros(5, np.int64)
                c[2] = n
                padded = TS._scs_pad_counts(torch.as_tensor(c, dtype=torch.int32), extra,
                                            strat)
                assert int(padded.max()) < 2**bits, (n, extra, strat)


def _row_counts(chunk, sigma, seed=0):
    """test_scs_row_order_equals_reference's counts: ties, zeros, one count
    (900) above the one-window key's bits, 37 elements."""
    rng = np.random.default_rng(chunk * 100 + (sigma or 0) + seed)
    En = 37
    counts = rng.integers(0, 6, En).astype(np.int32)
    counts[rng.choice(En, 5, replace=False)] = 0
    counts[rng.choice(En, 4, replace=False)] = 3
    counts[11] = 900
    return counts


@pytest.mark.parametrize("chunk", [3, 4, 8])
@pytest.mark.parametrize("sigma", [8, 16, None])
@pytest.mark.parametrize("bound", ["tight", "none"])
def test_scs_row_order_wrapper_and_plain_equal_reference(chunk, sigma, bound):
    """``scs_row_order`` (the wrapper: its plain version on the CPU) and
    ``scs_row_order_plain`` on the padded counts, with the key bits the
    structure gives them, equal the JAX ``_scs_row_order`` on the cases of
    test_scs_row_order_equals_reference."""
    counts = _row_counts(chunk, sigma)
    En = counts.shape[0]
    num = int(counts.sum()) if bound == "tight" else None
    s = sigma or 2**30
    R = -(-En // chunk) * chunk
    nwin = -(-R // min(s, R))
    for extra, strat in ((0.0, "proportionally"), (0.25, "inversely"), (0.5, "evenly")):
        want = JS._scs_row_order(jnp.asarray(counts), s, chunk, En, extra, strat)
        padded = TS._scs_pad_counts(torch.as_tensor(counts), extra, strat).to(torch.int32)
        bits = TS._scs_key_bits(nwin, En, num if num is not None else 2**29, extra)
        for got in (rb.scs_row_order(padded, R, s, chunk, bits),
                    rb.scs_row_order_plain(padded, R, s, chunk, bits)):
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


Z_DMAX, Z_BIG = 11, 1024


def _z_bases(digit, units, nb, bins, rng):
    """One pass of Z's tables: each unit's (block, warp, lo, hi) digit
    counts; each digit's total scanned over the digits and the earlier
    blocks' counts added: each unit's first place of each digit (the
    block's plus its earlier warps').
    Returns (those places, the cluster's count of digit 0)."""
    tab = {u[:2]: np.bincount(digit[u[2]:u[3]], minlength=bins) for u in units}
    warps = max(w for _, w, _, _ in units) + 1
    blk = np.array([sum(tab[b, w] for w in range(warps)) for b in range(nb)])
    tot = blk.sum(axis=0)
    start = np.cumsum(tot) - tot
    base = {}
    for b in range(nb):
        s = start + blk[:b].sum(axis=0)
        for w in range(warps):
            base[b, w] = s.copy()
            s = s + tab[b, w]
    return base, int(tot[0])


def _z_walk(seq, digit, units, base, R, rng):
    nxt = np.full(R, -1, np.int64)
    for i in rng.permutation(len(units)):
        b, w, lo, hi = units[i]
        t = base[b, w].copy()
        for j in range(lo, hi):
            nxt[t[digit[j]]] = seq[j]
            t[digit[j]] += 1
    assert (nxt >= 0).all()
    return nxt


def emulate_scs_row_order(counts, R, sigma, chunk, nb, warps=16, dmax=Z_DMAX, big=Z_BIG,
                          rng=None):
    """Kernel Z's design: the cluster's min and max count (padding rows -1)
    give the key max - count and its range.  One window: one clamped pass
    of width = min(dmax, bits of range + 1) (keys more than 2^width - 2
    below the largest to bin 0, the rest key - k0 + 1) and, where bin 0
    holds at most ``big`` rows, a second stage that ranks those rows (at
    places [0, n_big)) by descending count, equal counts in row order;
    else (or with σ windows) LSD passes of equal digits of at most dmax
    bits over the key, then over the row's window.  A pass: block b (of the
    cluster's ``nb``) takes positions [b·S, b·S + S) of the current order
    (S = ceil(R / nb) up to a multiple of 32), warp w of it Sw = ceil(S /
    warps) (the same) from b·S + w·Sw; each warp counts its digits; the
    blocks' counts are exchanged and scanned over the digits and the
    blocks (:func:`_z_bases`); each warp (in any order, ``rng``) places
    its positions in order.  A chunk's width is the count
    of its first row and of each window's first row in it.  Returns
    (row_to_elem, elem_to_row, chunk_width, passes, n_big or None)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    E = counts.shape[0]
    sigma = min(sigma, R)
    nwin = -(-R // sigma)
    bw = (nwin - 1).bit_length()
    c_all = np.full(R, -1, np.int64)
    c_all[:E] = counts
    mn, mx = int(c_all.min()), int(c_all.max())
    rng_ = (mx - mn) & 0xFFFFFFFF
    S = (-(-R // nb) + 31) & ~31
    Sw = (-(-S // warps) + 31) & ~31
    units = []
    for b in range(nb):
        lo_b, hi_b = min(b * S, R), min(min(b * S, R) + S, R)
        for w in range(warps):
            lo = min(lo_b + w * Sw, hi_b)
            units.append((b, w, lo, min(lo + Sw, hi_b)))
    seq = np.arange(R)
    key = (mx - c_all) & 0xFFFFFFFF
    out, passes, n_big = None, 0, None
    if bw == 0:
        width = dmax if rng_ + 1 == 2**32 else min(dmax, (rng_ + 1).bit_length())
        top = (1 << width) - 2
        k0 = rng_ - top if rng_ > top else 0
        digit = np.where(key < k0, 0, key - k0 + 1)
        base, n_big = _z_bases(digit, units, nb, 1 << width, rng)
        passes = 1
        if n_big <= big:
            out = _z_walk(seq, digit, units, base, R, rng)
            head = out[:n_big].copy()
            c = c_all[head]
            out[:n_big] = head[np.lexsort((np.arange(n_big), -c))]
    if out is None:
        bk = rng_.bit_length()
        pk, pw = -(-bk // dmax), -(-bw // dmax)
        wk = -(-bk // pk) if pk else 0
        ww = -(-bw // pw) if pw else 0
        passes = max(pk + pw, 1)
        for p in range(passes):
            win = p >= pk and pw > 0
            shift = (p - pk) * ww if win else p * wk
            width = min(ww, bw - shift) if win else (min(wk, bk - shift) if pk else 0)
            v = seq // sigma if win else (mx - c_all[seq]) & 0xFFFFFFFF
            digit = (v >> shift) & ((1 << width) - 1)
            base, _ = _z_bases(digit, units, nb, 1 << width, rng)
            seq = _z_walk(seq, digit, units, base, R, rng)
        out = seq
    r2e = out.astype(np.int32)
    e2r = np.zeros(R, np.int32)
    e2r[r2e] = np.arange(R)
    width = np.zeros(R // chunk, np.int64)
    for k in range(R // chunk):
        r = k * chunk
        while r < (k + 1) * chunk:
            width[k] = max(width[k], c_all[r2e[r]])
            r = (r // sigma + 1) * sigma
    return r2e, e2r[:E], width.astype(np.int32), passes, n_big


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("sigma", [8, 16, None])
def test_scs_row_order_design_equals_reference(sigma, chunk, nb):
    """Kernel Z's design, emulated (clusters of 8 and 16 blocks), equals the
    JAX ``_scs_row_order`` on the reference cases (a count of 900 among
    counts below 6: in one window, the clamped pass with 3-bit digits puts
    it in the big rows' bin, ranked by the second stage), on counts up to
    2^31 - 1 (one window: most rows big, so more than ``big`` of them take
    the LSD passes), all equal, all zero, E = 1 and 300 counts below 3;
    with 11- and 3-bit digits, and a second stage of 1,024 rows and of 2
    (its fallback to the passes)."""
    rng = np.random.default_rng(nb + chunk + (sigma or 0))
    s = sigma or 2**30
    cases = [_row_counts(chunk, sigma), np.full(37, 4, np.int32), np.zeros(37, np.int32),
             np.array([5], np.int32),
             rng.integers(0, 2**31 - 1, 70, dtype=np.int64).astype(np.int32),
             rng.integers(0, 3, 300).astype(np.int32)]
    for i, counts in enumerate(cases):
        En = counts.shape[0]
        R = -(-En // chunk) * chunk
        want = JS._scs_row_order(jnp.asarray(counts), s, chunk, En)
        for dmax, big in ((Z_DMAX, Z_BIG), (3, Z_BIG), (3, 2)):
            got = emulate_scs_row_order(counts, R, s, chunk, nb, dmax=dmax, big=big, rng=rng)
            for a, b in zip(want, got[:3]):
                np.testing.assert_array_equal(b, np.asarray(a),
                                              err_msg=f"case {i} dmax {dmax} big {big}")
            if i == 0 and sigma is None:          # 900 and counts below 6: one big row
                assert got[4] == (1 if dmax == 3 else 0) and got[3] == 1


def test_reshuffle_order_plain_is_the_stable_destination_order():
    """``reshuffle_order_plain`` on U1's plain outputs (every reference
    churn of a Sell-C-σ and a CabM structure) gives the movers' slots in
    the order of a stable argsort of their destinations, and the wrapper
    (its plain version on the CPU) the same."""
    for config in ("scs-proportionally-8", "cabm"):
        for kind in ("swap", "random", "concentrated"):
            t, elem = _count_inputs(config, kind, 11)
            c = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, t.capacity)
            n_mov = int(c.info[1])
            mkey, msrc = c.mkey[:n_mov], c.msrc[:n_mov]
            want = msrc.numpy()[np.argsort(mkey.numpy(), kind="stable")]
            for got in (rb.reshuffle_order_plain(mkey, msrc, c.mov_start),
                        rb.reshuffle_order(mkey, msrc, c.mov_start)):
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config", ["scs-proportionally-8", "scs-evenly-all", "cabm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reshuffle_order_equals_the_reference_placement(config, seed):
    """Where the JAX ``_rebuild_auto`` puts the movers (E = 40, 1,200
    particles, a random churn from numpy): each element's movers, by source
    slot, in the order of the holes they fill (their new slots ascend
    within a segment: CabM's slots, a Sell-C-σ row's q order), are
    ``reshuffle_order_plain``'s segment of that element, and U3's design
    (emulated) gives the same."""
    rng = np.random.default_rng(seed + 40)
    j, t = _pair(config, seed + 3)
    new = _churn(j, "random", rng)
    want = j.rebuild(jnp.asarray(new), mode="auto")
    elem, _, _ = rb.rebuild_mask_dps(torch.as_tensor(new), t.active, E)
    c = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, t.capacity)
    fits, n_mov = c.info.tolist()
    assert fits and n_mov > 0
    mkey, msrc = c.mkey[:n_mov], c.msrc[:n_mov]
    take = rb.reshuffle_order_plain(mkey, msrc, c.mov_start).numpy()
    # the reference: a mover's pid (its old slot's) and its new slot
    pid_old = np.asarray(j.fields["pid"])
    pid_new = np.asarray(want.fields["pid"])
    act = np.asarray(want.active)
    slot_of = np.full(N, -1)
    slot_of[pid_new[act]] = np.flatnonzero(act)
    src, key = msrc.numpy(), mkey.numpy()
    placed = slot_of[pid_old[src]]
    order = np.lexsort((placed, key))
    np.testing.assert_array_equal(take, src[order])
    starts = c.mov_start.numpy()
    for G in (4, 132):
        got = emulate_reshuffle_order(key, src, starts, E, G, rng)
        np.testing.assert_array_equal(got, take)


U3_WARPS, U3_BUCKET_BITS, U3_TABLE_KEYS = 16, 8, 2048


def _u3_parts(lo, hi):
    """A range's split over U3's warps: ceil(len / warps) up to a multiple
    of 32 each."""
    per = (-(-(hi - lo) // U3_WARPS) + 31) & ~31
    out = []
    for w in range(U3_WARPS):
        a = min(lo + w * per, hi)
        out.append((a, min(a + per, hi)))
    return out


def emulate_reshuffle_order(mkey, msrc, mov_start, En, G, rng, table_keys=U3_TABLE_KEYS):
    """Kernel U3's design: buckets of 2^bs consecutive keys (at most 256);
    G tiles of ceil(n / G) consecutive movers.  (1) Each tile's warps count
    their parts by bucket; (2) each bucket's column of tile counts is
    scanned into each tile's first place, from mov_start of the bucket's
    first key; (3) each tile (in any order) places its warps' parts in
    order into a copy grouped by bucket; (4) each bucket (in any order),
    its keys in turns of ``table_keys``, is ranked by key: its movers'
    counts per warp part, each key's first place mov_start[k] plus the
    earlier warps', the warps (in any order) placing their parts in
    order."""
    n = mkey.shape[0]
    bs = max((En - 1).bit_length() - U3_BUCKET_BITS, 0)
    nbk = ((En - 1) >> bs) + 1
    kt = min(1 << bs, table_keys)
    T = -(-n // G)
    key = mkey.astype(np.int64)
    tcount = np.zeros((nbk, G), np.int64)
    wpre = {}
    for t in range(G):
        lo, hi = min(t * T, n), min(min(t * T, n) + T, n)
        s = np.zeros(nbk, np.int64)
        for w, (a, b) in enumerate(_u3_parts(lo, hi)):
            wpre[t, w] = s.copy()
            s += np.bincount(key[a:b] >> bs, minlength=nbk)
        tcount[:, t] = s
    start = mov_start[np.arange(nbk) << bs][:, None] + np.cumsum(tcount, axis=1) - tcount
    tkey = np.full(n, -1, np.int64)
    tslot = np.full(n, -1, np.int64)
    for t in rng.permutation(G):
        lo, hi = min(t * T, n), min(min(t * T, n) + T, n)
        for w, (a, b) in enumerate(_u3_parts(lo, hi)):
            pos = start[:, t] + wpre[t, w]
            for j in range(a, b):
                bk = key[j] >> bs
                tkey[pos[bk]], tslot[pos[bk]] = key[j], msrc[j]
                pos[bk] += 1
    assert (tkey >= 0).all()
    take = np.full(n, -7, np.int64)
    for bk in rng.permutation(nbk):
        kb, ke = bk << bs, min((bk << bs) + (1 << bs), En)
        s0, s1 = int(mov_start[kb]), int(mov_start[ke]) if ke < En else n
        for k0 in range(kb, ke, kt):
            nk = min(kt, ke - k0)
            parts = _u3_parts(s0, s1)
            pos = {}
            s = mov_start[k0:k0 + nk].astype(np.int64).copy()
            for w, (a, b) in enumerate(parts):
                pos[w] = s.copy()
                k = tkey[a:b] - k0
                s += np.bincount(k[(k >= 0) & (k < nk)], minlength=nk)
            for w in rng.permutation(U3_WARPS):
                a, b = parts[w]
                for j in range(a, b):
                    k = tkey[j] - k0
                    if 0 <= k < nk:
                        take[pos[w][k]] = tslot[j]
                        pos[w][k] += 1
    return take


@pytest.mark.parametrize("kind", ["random", "one key", "runs", "one mover"])
def test_reshuffle_order_design_equals_plain(kind):
    """U3's design, emulated, equals ``reshuffle_order_plain`` on movers in
    slot order (ascending slots) with destinations at random, all to one
    destination (a whole round of one key: fields of 32), in runs of equal
    keys (a key in several warps of a round and across blocks) and one
    mover; grids of 1, 13 and 132 tiles; buckets of 2 keys (E = 300) in
    one turn and in turns of 1 key."""
    rng = np.random.default_rng(["random", "one key", "runs", "one mover"].index(kind))
    En = 300
    n = {"random": 5000, "one key": 3000, "runs": 4000, "one mover": 1}[kind]
    src = np.sort(rng.choice(10 * n + 10, n, replace=False)).astype(np.int32)
    if kind == "one key":
        key = np.full(n, 123, np.int32)
    elif kind == "runs":
        key = np.repeat(rng.integers(0, En, n // 40 + 1), 40)[:n].astype(np.int32)
    else:
        key = rng.integers(0, En, n).astype(np.int32)
    cnt = np.bincount(key, minlength=En)
    starts = (np.cumsum(cnt) - cnt).astype(np.int32)
    want = rb.reshuffle_order_plain(torch.as_tensor(key), torch.as_tensor(src),
                                    torch.as_tensor(starts)).numpy()
    for G in (1, 13, 132):
        for kt in (U3_TABLE_KEYS, 1, 3):
            got = emulate_reshuffle_order(key, src, starts, En, G, rng, kt)
            np.testing.assert_array_equal(got, want, err_msg=f"G {G} table {kt}")


# ---------------------------------------------------------------------------
# the kernels' schedules, emulated on the CPU
# ---------------------------------------------------------------------------

U_THREADS, U_J = 1024, 16


def _count_inputs(config, kind, seed):
    rng = np.random.default_rng(seed)
    j, t = _pair(config, seed)
    new = torch.as_tensor(_churn(j, kind, rng))
    elem, _, _ = rb.rebuild_mask_dps(new, t.active, E)
    return t, elem


def emulate_reshuffle_count(elem, old_elem, seg_cap, mb, wave, threads=U_THREADS):
    """U1's schedule: a block a tile of ``threads`` · 16 slots (16,384), in
    launch order, ``wave`` tiles in flight at once (a tile sees the flag
    of the tiles that finished before it started: those ``wave`` or more
    tiles earlier), thread t taking slots tile + 16t .. tile + 16t + 15.  A
    tile that sees the flag (an earlier tile's movers passed MB) counts its
    stayers and movers alone; any other adds its stayers, places its
    movers after the movers of the tiles before it (the look-back, its sum
    saturated at MB + 1) in the threads' order, writes those below MB,
    adds its movers while the movers so far fit the budget and raises the
    flag when they do not.  The last block scans the elements only while
    n_mov <= MB.  Returns (fits, n_mov, num, stay_cnt, mov_cnt, mov_start,
    msrc, mkey, the tiles that counted alone)."""
    C, En = elem.shape[0], seg_cap.shape[0]
    e, o = elem.numpy(), old_elem.numpy()
    stay = (e >= 0) & (e == o)
    mover = (e >= 0) & ~stay
    tile = threads * U_J
    n_tiles = -(-C // tile)
    cap = mb + 1
    cnt = np.zeros(2 * En, np.int64)
    msrc, mkey = np.full(mb, -7, np.int32), np.full(mb, -7, np.int32)
    prefix = 0                                     # saturated at cap
    flag_at = n_tiles                              # the first tile to raise the flag
    n_mov = n_stay = alone = 0
    for tl in range(n_tiles):
        s = tl * tile + np.arange(tile).reshape(threads, U_J)     # (thread, j)
        s = s[s < C]
        moving = s[mover[s]]                                     # the threads' order
        n_mov += len(moving)
        n_stay += int(stay[s].sum())
        if tl - flag_at >= wave:                   # the flag set before this tile started
            prefix = cap
            alone += 1
            continue
        np.add.at(cnt, e[s[stay[s]]], 1)
        base = prefix
        prefix = min(base + len(moving), cap)
        if base + len(moving) > mb:
            flag_at = min(flag_at, tl)
        pos = base + np.arange(len(moving))
        ok = pos < mb
        msrc[pos[ok]], mkey[pos[ok]] = moving[ok], e[moving[ok]]
        if base + len(moving) <= mb:
            np.add.at(cnt, En + e[moving], 1)
    stay_cnt, mov_cnt = cnt[:En], cnt[En:]
    fits = n_mov <= mb and bool(np.all(mov_cnt <= seg_cap.numpy() - stay_cnt))
    start = np.cumsum(mov_cnt) - mov_cnt if n_mov <= mb else None
    return fits, n_mov, n_stay + n_mov, stay_cnt, mov_cnt, start, msrc, mkey, alone


@pytest.mark.parametrize("kind", ["swap", "random", "concentrated"])
@pytest.mark.parametrize("config", ["scs-proportionally-8", "scs-evenly-all", "cabm"])
def test_reshuffle_count_schedule_equals_plain(config, kind):
    """U1's schedule, emulated, equals ``reshuffle_count_plain``: fits,
    n_mov, the count and the list's first min(n_mov, MB) always; the
    stayers' and movers' counts and first places where n_mov <= MB (past
    it tiles that see the flag count alone, the fallback's skip).  With
    MB = 64 and tiles of 1,024 slots in flight one at a time, every tile
    after the first whose movers pass the budget counts alone."""
    t, elem = _count_inputs(config, kind, 3)
    for mb, threads, wave in ((4096, 1024, 1), (64, 1024, 1), (64, 64, 1), (64, 64, 3)):
        want = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, mb)
        (fits, n_mov, num, stay_cnt, mov_cnt, start, msrc, mkey,
         alone) = emulate_reshuffle_count(elem, t.elem, t.seg_cap, mb, wave, threads)
        assert [fits, n_mov] == want.info.tolist() and num == int(want.num)
        k = min(n_mov, mb)
        np.testing.assert_array_equal(msrc[:k], want.msrc[:k].numpy())
        np.testing.assert_array_equal(mkey[:k], want.mkey[:k].numpy())
        if n_mov <= mb:
            assert alone == 0
            np.testing.assert_array_equal(stay_cnt, want.stay_cnt.numpy())
            np.testing.assert_array_equal(mov_cnt, want.mov_cnt.numpy())
            np.testing.assert_array_equal(start, want.mov_start.numpy())
        elif threads == 64 and wave == 1:          # the first tile passes MB
            assert alone > 0 and stay_cnt.sum() < int(want.stay_cnt.sum())


LANES = np.arange(32)


def _unit_slots(row_to_elem, offsets, seg_cap, u, chunk, En):
    """U2's unit layout: the first real row among the unit's first 32 gives
    the chunk's first slot (its offset less its row) and width."""
    rows = np.arange(min(chunk, 32))
    e = row_to_elem[u * chunk + rows] if row_to_elem is not None else np.array([u])
    real = np.flatnonzero((e >= 0) & (e < En))
    if len(real) == 0:
        return None
    r = real[0]
    return int(offsets[e[r]]) - int(r), int(seg_cap[e[r]])


def emulate_reshuffle_place(elem, old_elem, offsets, seg_cap, mov_cnt, mov_start, fields,
                            staged, chunk, overflowed, row_to_elem, rng):
    """U2's schedule: a warp a unit (a Sell-C-σ chunk of the row order, or
    a CabM segment: chunk 1, no row order), units in any order; a round is
    RG·QR consecutive slots (RG = min(chunk, 32) rows, QR = 32 // RG q's),
    lane l serving row g0 + l % RG of each group of 32 rows; a row's holes
    ranked in q order by the round's ballot masked to the row's lanes, its
    running hole count held by each of them; the tail blocks write the
    slots from the last unit's end to C.  The fields are written in place
    (``fields``' tensors); every slot's element and mask must be written
    exactly once."""
    C, En = elem.shape[0], seg_cap.shape[0]
    e_, o_ = elem.numpy(), old_elem.numpy()
    offs, cap = offsets.numpy(), seg_cap.numpy()
    mc, mst = mov_cnt.numpy(), mov_start.numpy()
    r2e = row_to_elem.numpy() if row_to_elem is not None else None
    out = {k: v.numpy() for k, v in fields.items()}        # the tensors' memory
    rows_of = {k: v.numpy() for k, v in staged.items()}
    out_elem = np.full(C, -777, np.int32)
    out_active = np.zeros(C, bool)
    writes = np.zeros(C, np.int64)
    num, ovf = 0, bool(overflowed)
    RG = min(chunk, 32)
    QR = 32 // RG
    row_l, qoff, used = LANES % RG, LANES // RG, LANES < RG * QR
    same = ((row_l[:, None] == row_l[None, :]) & used[:, None] & used[None, :]).astype(
        np.int64)
    before = same * (LANES[None, :] < LANES[:, None])      # lanes of the row below l
    n_units = En if r2e is None else r2e.shape[0] // chunk
    for u in rng.permutation(n_units):
        lay = _unit_slots(r2e, offs, cap, u, chunk, En)
        if lay is None:
            continue
        base, w = lay
        for g0 in range(0, chunk, 32):
            row = g0 + row_l
            ok_row = used & (row < chunk)
            e = np.where(ok_row, (r2e[u * chunk + np.minimum(row, chunk - 1)]
                                  if r2e is not None else u), -1)
            real = (e >= 0) & (e < En)
            ec = np.where(real, e, 0)
            k, ms = np.where(real, mc[ec], 0), np.where(real, mst[ec], 0)
            holes = np.zeros(32, np.int64)
            for q0 in range(0, w, QR):
                q = q0 + qoff
                slot = base + q * chunk + row
                inn = ok_row & (q < w) & (slot < C)
                rd = inn & real
                sc = np.where(rd, slot, 0)
                en, eo = np.where(rd, e_[sc], -1), np.where(rd, o_[sc], -1)
                st = (en >= 0) & (en == eo)
                hole = inn & real & ~st
                r = holes + before @ hole
                fill = hole & (r < k)
                s_in = slot[inn]
                writes[s_in] += 1
                out_elem[s_in] = np.where(st, en, np.where(fill, e, -1))[inn]
                out_active[s_in] = (st | fill)[inn]
                for name in out:
                    out[name][slot[fill]] = rows_of[name][(ms + r)[fill]]
                num += int(st.sum())
                holes += same @ hole
            lead = ok_row & real & (qoff == 0)
            num += int(np.minimum(holes, k)[lead].sum())
            ovf |= bool((holes < k)[lead].any())
    last = _unit_slots(r2e, offs, cap, n_units - 1, chunk, En)
    end = last[0] + chunk * last[1] if last is not None else C
    writes[end:] += 1
    out_elem[end:], out_active[end:] = -1, False
    assert (writes == 1).all(), np.flatnonzero(writes != 1)[:10]
    return out_elem, out_active, num, ovf


def _place_case(config, kind, seed, En=37):
    """A structure of ``config`` over ``En`` elements (37: padding rows at
    chunks of 8; ``scs-chunk-c``: chunks of c, extra padding 0.3) and the
    rebuild's inputs for churn ``kind``: U1's counts (the budget the
    capacity, so a concentrated churn overflows its segment), C's order and
    G's staged rows."""
    rng = np.random.default_rng(seed)
    elems = np.sort(rng.integers(0, En, N))
    f = {k: torch.as_tensor(v) for k, v in _fields(rng).items()}
    if config == "cabm":
        t = T.CabM(En, elems, fields=f, soa_width=8, extra_padding=0.3, device="cpu")
    else:
        _, a, b = config.split("-")
        chunk = int(b) if a == "chunk" else 8
        sigma = None if a == "chunk" or b == "all" else int(b)
        t = T.SellCSigma(En, elems, fields=f, device="cpu", scs_input=T.SCSInput(
            chunk_size=chunk, sigma=sigma, extra_padding=0.3,
            pad_strategy="proportionally" if a == "chunk" else a))
    cur = np.where(t.active.numpy(), t.elem.numpy(), -1).astype(np.int32)
    new = cur.copy()
    live = np.flatnonzero(cur >= 0)
    if kind in ("swap", "budget", "budget+1"):
        k = len(live) // 8 * 2
        sel = rng.choice(live, size=k, replace=False)
        a_, b_ = sel[:k // 2], sel[k // 2:]
        new[a_], new[b_] = cur[b_], cur[a_]
    elif kind == "random":
        mv = rng.uniform(size=len(live)) < 0.04
        new[live[mv]] = rng.integers(-1, En + 2, int(mv.sum()))
    else:
        mv = rng.uniform(size=len(live)) < 0.3
        new[live[mv]] = 3
    elem, _, _ = rb.rebuild_mask_dps(torch.as_tensor(new), t.active, En)
    c = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, t.capacity)
    n_mov = int(c.info[1])
    take = rb.key_sort_plain(c.mkey[:n_mov], En - 1, c.msrc[:n_mov])
    staged = {k: v[take.long()] for k, v in t.fields.items()}
    return t, elem, c, staged


PLACE_CONFIGS = CONFIGS + ["scs-chunk-3", "scs-chunk-40"]


@pytest.mark.parametrize("kind", CHURNS)
@pytest.mark.parametrize("config", PLACE_CONFIGS)
def test_reshuffle_place_schedule_equals_plain(config, kind):
    """U2's schedule, emulated, equals ``reshuffle_place_plain`` on the
    rebuild's own inputs (U1's counts, C's order, G's staged rows), each
    writing into its own copy of the fields: every slot's element and mask
    (padding rows, the slots past the layout's end), every field, the count
    and the flag; every slot written once; a swap churn (each mover's
    source slot another mover's destination), a random one with removals,
    a concentrated one (a short segment: the flag set, only the placed
    counted); chunks of 3, 8 and 40 rows (a round of 30, 32 and 32 slots,
    40: two row groups), 37 elements (padding rows at chunks of 8 and 40)."""
    t, elem, c, staged = _place_case(config, kind, PLACE_CONFIGS.index(config) * 10
                                     + CHURNS.index(kind))
    stride = t.chunk_size if t.layout == "scs" else 1
    fp = {k: v.clone() for k, v in t.fields.items()}
    fe = {k: v.clone() for k, v in t.fields.items()}
    want = rb.reshuffle_place_plain(elem, t.elem, t.elem_offsets, t.seg_cap, c.mov_cnt,
                                    c.mov_start, fp, staged, stride, t.overflowed,
                                    t.row_to_elem)
    got = emulate_reshuffle_place(elem, t.elem, t.elem_offsets, t.seg_cap, c.mov_cnt,
                                  c.mov_start, fe, staged, stride, t.overflowed,
                                  t.row_to_elem, np.random.default_rng(2))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    for k in want[2]:
        assert want[2][k] is fp[k]
        np.testing.assert_array_equal(fe[k].numpy(), fp[k].numpy())
    assert got[2] == int(want[3]) and got[3] == bool(want[4])
    assert got[3] == (kind == "concentrated")


@pytest.mark.parametrize("config", CONFIGS)
def test_auto_rebuild_writes_the_fields_in_place(config):
    """A reshuffle (``rebuild(mode="auto")``) returns the input structure's
    own field tensors (the same tensors, the same data_ptr), holding what
    the JAX package's out-of-place ``_rebuild_auto`` computes; the input's
    element ids and mask stay as they were (fresh outputs)."""
    rng = np.random.default_rng(CONFIGS.index(config) + 50)
    j, t = _pair(config)
    new = _churn(j, "swap", rng)
    fields, ptrs = dict(t.fields), {k: v.data_ptr() for k, v in t.fields.items()}
    elem0, active0 = t.elem.clone(), t.active.clone()
    out = t.rebuild(torch.as_tensor(new), mode="auto")
    want = j.rebuild(jnp.asarray(new), mode="auto")
    for k in fields:
        assert out.fields[k] is fields[k] and out.fields[k].data_ptr() == ptrs[k]
        np.testing.assert_array_equal(out.fields[k].numpy(), np.asarray(want.fields[k]))
    assert torch.equal(t.elem, elem0) and torch.equal(t.active, active0)
    assert out.elem is not t.elem and out.active is not t.active
    assert_same(want, out, f"{config} in place")


def test_reshuffle_place_short_segment_sets_overflow():
    """A segment whose holes lie past the capacity places the movers it
    can, counts only them and raises the sticky overflow flag."""
    elem = torch.tensor([0, 1, 1, -1, -1, -1], dtype=torch.int32)
    old = torch.tensor([0, 0, 1, -1, -1, -1], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 6], dtype=torch.int32)
    seg_cap = torch.tensor([2, 5], dtype=torch.int32)   # element 1: slots 2..6, 6 past C
    mov_cnt = torch.tensor([0, 5], dtype=torch.int32)
    mov_start = torch.tensor([0, 0], dtype=torch.int32)
    fields = {"v": torch.arange(6, dtype=torch.float32)}
    staged = {"v": torch.tensor([10.0, 11, 12, 13, 14])}
    ovf0 = torch.zeros((), dtype=torch.bool)
    e, a, f, n, ovf = rb.reshuffle_place_plain(elem, old, offsets, seg_cap, mov_cnt,
                                               mov_start, fields, staged, 1, ovf0)
    assert e.tolist() == [0, -1, 1, 1, 1, 1] and a.tolist() == [True, False] + [True] * 4
    assert f["v"].tolist() == [0.0, 1, 2, 10, 11, 12] and int(n) == 5 and bool(ovf)
    assert f["v"] is fields["v"]                       # in place
    fe = {"v": torch.arange(6, dtype=torch.float32)}
    got = emulate_reshuffle_place(elem, old, offsets, seg_cap, mov_cnt, mov_start, fe,
                                  staged, 1, ovf0, None, np.random.default_rng(0))
    assert got[0].tolist() == e.tolist() and got[2] == 5 and got[3]
    assert fe["v"].tolist() == f["v"].tolist()
