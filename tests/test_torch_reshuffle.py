"""Parity of the port's reshuffle-or-rebuild (``rebuild(mode="auto")``:
kernels U1, C, G and U2 on the card) and of its Sell-C-σ row order (kernel
C over kernel Z's row key, then Z's maps) with the JAX reference, on the
CPU, where every wrapper runs its plain version.

- ``rebuild(mode="auto")`` of the port against the JAX package's, every
  member of the structure equal, for Sell-C-σ under the three pad
  strategies and σ in {8, 16, all rows} and for CabM, with f32 (N, 3),
  int32 and bool fields: a swap churn (each mover's source slot is another
  mover's destination), a random churn, a concentrated churn that cannot
  fit, and n_mov equal to the mover budget and one above it.
- ``_scs_row_order`` (Z's key, the plain sort, Z's maps) against the JAX
  ``_scs_row_order`` on counts with ties, zeros and counts above the key's
  bits, E not a multiple of the chunk.
- CPU emulations of U1's and U2's schedules (tiles ranked in any order;
  segments in any order, holes by q in 32-slot ballots) equal to their
  plain versions.

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
    """Z's key: descending counts ascend, the padding rows' key 2^b follows
    every count of their window, and each window's keys lie below the
    next's."""
    counts = torch.tensor([0, 5, 2, 5, 7, 1, 0], dtype=torch.int32)
    key = rb.scs_row_keys(counts, 8, 4, 3)
    assert key.tolist() == [7, 2, 5, 2, 16, 22, 23, 24]
    assert rb.key_sort(key, 31).tolist() == [1, 3, 2, 0, 4, 5, 6, 7]
    one = rb.scs_row_keys(counts, 8, 8, 2)          # 5 and 7 exceed 2^2 - 1
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


# ---------------------------------------------------------------------------
# the kernels' schedules, emulated on the CPU
# ---------------------------------------------------------------------------

U_THREADS, U_J = 512, 16


def _count_inputs(config, kind, seed):
    rng = np.random.default_rng(seed)
    j, t = _pair(config, seed)
    new = torch.as_tensor(_churn(j, kind, rng))
    elem, _, _ = rb.rebuild_mask_dps(new, t.active, E)
    return t, elem


def emulate_reshuffle_count(elem, old_elem, seg_cap, mb, rng):
    """U1's tile schedule: tiles of 8192 slots ranked in any order, thread
    t taking slots tile + 16t .. tile + 16t + 15; a tile's movers placed
    after the movers of the tiles before it (the look-back) in the threads'
    order; stayers and, while the movers so far fit the budget, movers
    counted; the last tile's checks."""
    C, En = elem.shape[0], seg_cap.shape[0]
    e, o = elem.numpy(), old_elem.numpy()
    stay = (e >= 0) & (e == o)
    mover = (e >= 0) & ~stay
    tile = U_THREADS * U_J
    n_tiles = -(-C // tile)
    cnt = np.zeros(2 * En, np.int64)
    msrc, mkey = np.full(mb, -7, np.int32), np.full(mb, -7, np.int32)
    before = np.concatenate([[0], np.cumsum([mover[i * tile:(i + 1) * tile].sum()
                                             for i in range(n_tiles)])])
    for tl in rng.permutation(n_tiles):
        s = tl * tile + np.arange(tile).reshape(U_THREADS, U_J)   # (thread, j)
        s = s[s < C]
        np.add.at(cnt, e[s[stay[s]]], 1)
        moving = s[mover[s]]                                     # the threads' order
        pos = before[tl] + np.arange(len(moving))
        if before[tl + 1] <= mb:
            np.add.at(cnt, En + e[moving], 1)
        ok = pos < mb
        msrc[pos[ok]], mkey[pos[ok]] = moving[ok], e[moving[ok]]
    n_mov = int(mover.sum())
    stay_cnt, mov_cnt = cnt[:En], cnt[En:]
    fits = bool(np.all(mov_cnt <= seg_cap.numpy() - stay_cnt)) and n_mov <= mb
    return fits, n_mov, stay_cnt, mov_cnt, np.cumsum(mov_cnt) - mov_cnt, msrc, mkey


@pytest.mark.parametrize("kind", ["swap", "random", "concentrated"])
@pytest.mark.parametrize("config", ["scs-proportionally-8", "scs-evenly-all", "cabm"])
def test_reshuffle_count_schedule_equals_plain(config, kind):
    """U1's schedule, emulated, equals ``reshuffle_count_plain``: fits,
    n_mov and the stayers' counts always; the movers' counts, first places
    and list where n_mov fits the budget (and the list's first MB where it
    does not)."""
    t, elem = _count_inputs(config, kind, 3)
    rng = np.random.default_rng(5)
    for mb in (4096, 64):
        want = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, mb)
        fits, n_mov, stay_cnt, mov_cnt, start, msrc, mkey = emulate_reshuffle_count(
            elem, t.elem, t.seg_cap, mb, rng)
        assert [fits, n_mov] == want.info.tolist()
        assert int(want.num) == int(stay_cnt.sum()) + n_mov
        np.testing.assert_array_equal(stay_cnt, want.stay_cnt.numpy())
        k = min(n_mov, mb)
        np.testing.assert_array_equal(msrc[:k], want.msrc[:k].numpy())
        np.testing.assert_array_equal(mkey[:k], want.mkey[:k].numpy())
        if n_mov <= mb:
            np.testing.assert_array_equal(mov_cnt, want.mov_cnt.numpy())
            np.testing.assert_array_equal(start, want.mov_start.numpy())


def emulate_reshuffle_place(elem, old_elem, offsets, seg_cap, mov_cnt, mov_start, fields,
                            staged, stride, overflowed, rng):
    """U2's schedule: a warp an element, elements in any order; 32 q's at
    a time, the holes' ballot ranking them in q order; outputs fresh."""
    C, En = elem.shape[0], seg_cap.shape[0]
    out_elem = np.full(C, -1, np.int32)
    out_active = np.zeros(C, bool)
    out = {k: v.numpy().copy() for k, v in fields.items()}
    num, ovf = 0, bool(overflowed)
    e_, o_ = elem.numpy(), old_elem.numpy()
    for e in rng.permutation(En):
        base, cap = int(offsets[e]), int(seg_cap[e])
        k, ms = int(mov_cnt[e]), int(mov_start[e])
        holes = 0
        for q0 in range(0, cap, 32):
            q = q0 + np.arange(32)
            s = base + q * stride
            inside = (q < cap) & (s < C)
            sc = np.where(inside, s, 0)
            st = inside & (e_[sc] >= 0) & (e_[sc] == o_[sc])
            hole = inside & ~st
            r = holes + np.cumsum(hole) - hole
            out_elem[s[st]] = e_[s[st]]
            out_active[s[st]] = True
            fill = hole & (r < k)
            out_elem[s[fill]] = e
            out_active[s[fill]] = True
            for name in out:
                out[name][s[fill]] = staged[name].numpy()[ms + r[fill]]
            num += int(st.sum())
            holes += int(hole.sum())
        num += min(holes, k)
        ovf |= holes < k
    return out_elem, out_active, out, num, ovf


@pytest.mark.parametrize("kind", ["swap", "random"])
@pytest.mark.parametrize("config", ["scs-inversely-16", "scs-proportionally-all", "cabm"])
def test_reshuffle_place_schedule_equals_plain(config, kind):
    """U2's schedule, emulated, equals ``reshuffle_place_plain`` on the
    rebuild's own inputs (U1's counts, C's order, G's staged rows), and the
    structure the port's auto rebuild returns."""
    t, elem = _count_inputs(config, kind, 11)
    c = rb.reshuffle_count_plain(elem, t.elem, t.seg_cap, t.capacity)
    fits, n_mov = c.info.tolist()
    assert fits and n_mov > 0
    take = rb.key_sort_plain(c.mkey[:n_mov], E - 1, c.msrc[:n_mov])
    staged = {k: v[take.long()] for k, v in t.fields.items()}
    stride = t.chunk_size if t.layout == "scs" else 1
    want = rb.reshuffle_place_plain(elem, t.elem, t.elem_offsets, t.seg_cap, c.mov_cnt,
                                    c.mov_start, t.fields, staged, stride, t.overflowed,
                                    t.row_to_elem)
    got = emulate_reshuffle_place(elem, t.elem, t.elem_offsets, t.seg_cap, c.mov_cnt,
                                  c.mov_start, t.fields, staged, stride, t.overflowed,
                                  np.random.default_rng(2))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k].numpy())
    assert got[3] == int(want[3])
    assert got[4] is False and not bool(want[4])


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
    got = emulate_reshuffle_place(elem, old, offsets, seg_cap, mov_cnt, mov_start, fields,
                                  staged, 1, ovf0, np.random.default_rng(0))
    assert got[0].tolist() == e.tolist() and got[3] == 5 and got[4]
