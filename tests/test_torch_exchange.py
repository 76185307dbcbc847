"""Parity of the plain versions of the exchange kernels X1, X2, X3 and the
owner reduction O (``pumipic_torch.ops.exchange``) with the JAX package's
functions, on seeded numpy inputs (tests/torch_ranks.py) that include the
adversarial cases the card checks run: one key, no leaver, every slot
leaving, a ragged last tile, arrivals beyond the free slots, NaN (a
signalling payload among them), -0.0 and subnormal payloads.

X1 against ``balancer.rank_within_key`` and ``migrate._bucket_ranks``, X2
against ``_slots_from_ranks`` + ``_pack_payload`` + ``_fill_send`` (the
admitted rows of each bucket), X3 against ``_place_arrivals``, and O's
gather, fan-in and fan-out chained over 8 ranks' picpart tables against
``reduce_comm_array`` under ``shard_map``.  Integers and moved bits are
compared equal; the reduction's sums are exact (small halves); NaN
results are compared by position."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pumipic_tpu.parallel import balancer as jlb
from pumipic_tpu.parallel import migrate as jmig
from pumipic_tpu.parallel import reduce as jred
from pumipic_tpu.parallel.mesh_axis import RANK_AXIS, make_device_mesh
from pumipic_torch.mesh.generate import annulus_mesh
from pumipic_torch.ops import exchange as tex
from pumipic_torch.parallel import picparts as tpp

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks as tr  # noqa: E402


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _bits_equal(got: torch.Tensor, want, what: str, nan_positions: bool = False):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype == np.float32:
        if nan_positions:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
            got, want = got[~np.isnan(got)], want[~np.isnan(want)]
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# X1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", tr.RANK_CASES)
def test_rank_in_key_matches_jax(case):
    key, K = tr.rank_case(case)
    rank, counts = tex.rank_in_key(T(key), K)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jlb.rank_within_key(
        jnp.asarray(key), K)))
    order, _, rank_in_bucket, jcounts = jmig._bucket_ranks(jnp.asarray(key), K)
    np.testing.assert_array_equal(rank.numpy()[np.asarray(order)], np.asarray(rank_in_bucket))
    np.testing.assert_array_equal(counts.numpy()[:K], np.asarray(jcounts))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(key, minlength=K + 1))
    _, only = tex.rank_in_key(T(key), K, ranks=False)
    np.testing.assert_array_equal(only.numpy(), counts.numpy())
    np.testing.assert_array_equal(tex.key_counts(T(key), K).numpy(), counts.numpy()[:K])


def test_rank_in_key_ranks_the_ignored_key_and_refuses_others():
    """Key ``num_keys`` (the callers' "stays" / "not a candidate") is
    ranked and counted like any other; a key outside [0, num_keys] is
    refused, as is a key count beyond a tile's table."""
    key = np.asarray([3, 0, 3, 3, 1, 0], np.int32)
    rank, counts = tex.rank_in_key(T(key), 3)
    np.testing.assert_array_equal(rank.numpy(), [0, 0, 1, 2, 0, 1])
    np.testing.assert_array_equal(counts.numpy(), [2, 1, 0, 3])
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jlb.rank_within_key(
        jnp.asarray(key), 3)))
    for bad in ([4, 0], [0, -1]):
        with pytest.raises(ValueError, match="outside"):
            tex.rank_in_key(T(np.asarray(bad, np.int32)), 3)
    with pytest.raises(ValueError, match="table holds"):
        tex.rank_in_key(T(key), tex.X1_MAX_KEYS)
    rank, counts = tex.rank_in_key(T(key), tex.X1_MAX_KEYS - 1)
    assert counts.shape == (tex.X1_MAX_KEYS,) and int(counts.sum()) == len(key)
    with pytest.raises(ValueError, match="int32"):
        tex.rank_in_key(T(key.astype(np.int64)), 3)


# kernel X1's constants (kernels/csrc/exchange.cu)
X1_WARPS, X1_ITEMS, X1_PRIVATE_ROWS, X1_STAGE_TILES, X1_GROUP = 8, 8, 64, 8, 32
X1_CHUNKS, X1_SMEM, X1_LOOKBACK, X1_COUNT_UNROLL = 8, 224 * 1024, 8, 4
X1_THREADS = 32 * X1_WARPS
X1_AGGREGATE, X1_INCLUSIVE = 1 << 30, 2 << 30
X1_VALUE = X1_AGGREGATE - 1
LANE = np.arange(32)


def _warp_groups(kc):
    """``__match_any_sync`` over one chunk of 32 keys: each lane's count of
    the lanes below it with its key, and each key's group size."""
    eq = kc[None, :] == kc[:, None]
    return (eq & (LANE[None, :] < LANE[:, None])).sum(axis=1), eq.sum(axis=1)


def _x1_window(status, rows, j, excl, live, width):
    """One read of the wide mode's look-back for the keys ``live``, a
    thread's ``width`` words of the tiles j, j - 1, ... at once: the words before the first one not yet published are summed,
    up to the nearest inclusive prefix; returns the keys that are done."""
    keys = np.arange(rows)
    s = np.stack([np.where(j - q >= 0, status[np.maximum(j - q, 0), keys], X1_INCLUSIVE)
                  for q in range(width)])
    waiting, incl = s < X1_AGGREGATE, s >= X1_INCLUSIVE
    wait_at = np.where(waiting.any(axis=0), waiting.argmax(axis=0), width)
    incl_at = np.where(incl.any(axis=0), incl.argmax(axis=0), width)
    at = np.arange(width)[:, None]
    done = live & (incl_at < wait_at)
    to_incl = np.where(at <= incl_at, s & X1_VALUE, 0).sum(axis=0)
    to_wait = np.where(at < wait_at, s & X1_VALUE, 0).sum(axis=0)
    excl += np.where(live, np.where(done, to_incl, to_wait), 0)
    j -= np.where(live & ~done, wait_at, 0)
    return done


def _x1_keys(k_all, n, first, count):
    """``count`` keys from ``first``, -1 past the end."""
    i = first + np.arange(count)
    return i, np.where(i < n, k_all[np.minimum(i, max(n - 1, 0))] if n else -1, -1)


def _x1_tile_private(k_all, n, t):
    """A tile of the private mode: thread u's X1_ITEMS consecutive keys, its
    count of each before each key, the exclusive prefixes over the threads
    and the tile's count of each key."""
    i, kt = _x1_keys(k_all, n, t * X1_THREADS * X1_ITEMS, X1_THREADS * X1_ITEMS)
    kt = kt.reshape(X1_THREADS, X1_ITEMS)
    r = np.zeros_like(kt)
    for q in range(1, X1_ITEMS):
        r[:, q] = (kt[:, :q] == kt[:, q:q + 1]).sum(axis=1)
    return i.reshape(kt.shape), kt, r


def _x1_tile_wide(k_all, n, t, n_warps, rows):
    """A tile of the wide mode: each warp's chunks ranked by its groups
    (the count before the group from the warp's table), the warps' tables."""
    i = np.zeros((n_warps, X1_CHUNKS, 32), np.int64)
    kt = np.zeros_like(i)
    r = np.zeros_like(i)
    tab = np.zeros((n_warps, rows), np.int64)
    for w in range(n_warps):
        for c in range(X1_CHUNKS):
            i[w, c], kt[w, c] = _x1_keys(k_all, n, (t * n_warps + w) * 32 * X1_CHUNKS + c * 32, 32)
            below, size = _warp_groups(kt[w, c])
            r[w, c] = np.where(kt[w, c] >= 0, tab[w, np.maximum(kt[w, c], 0)], 0) + below
            lead = (kt[w, c] >= 0) & (below == size - 1)          # the group's highest lane
            tab[w, kt[w, c][lead]] += size[lead]
    return i, kt, r, tab


def _x1_columns(kt, rows):
    """Each thread's (or warp's) count of each key: a (rows, threads) table."""
    cols = np.zeros((rows, kt.shape[0]), np.int64)
    for u in range(kt.shape[0]):
        ok = kt[u] >= 0
        np.add.at(cols[:, u], kt[u][ok], 1)
    return cols


def _x1_chunk_private(k_all, n, tiles, rows):
    """A chunk of the private mode: its tiles ranked in turn (a thread's
    count before each of its keys, a key's row scanned over the threads on
    top of the key's items in the chunk's earlier tiles), staged as (items,
    keys, rank in the chunk); and the chunk's count of each key."""
    staged, base = [], np.zeros(rows, np.int64)
    for t in tiles:
        i, kt, r = _x1_tile_private(k_all, n, t)
        cols = _x1_columns(kt, rows)
        before = np.cumsum(cols, axis=1) - cols + base[:, None]
        staged.append((i, kt, r + before[np.maximum(kt, 0), np.arange(X1_THREADS)[:, None]]))
        base += cols.sum(axis=1)
    return staged, base


def rank_in_key_emulated(key, num_keys, ranks=True, blocks=3, seed=0):
    """Kernel X1's design in numpy, step for step, on ``blocks`` resident
    blocks.  rows = num_keys + 2 (the last: keys out of range).

    The private mode (rows <= X1_PRIVATE_ROWS), ranked: the blocks take
    chunks of ``per`` (<= X1_STAGE_TILES) tiles by tickets in index order.
    A block's turn (picked at random, so chunks complete in a shuffled
    order) either ranks its chunk and publishes the
    chunk's count of each key, the last chunk of a group of X1_GROUP to
    publish (a ticket a group) publishing the group's; or reads the words
    before its chunk (the earlier groups' counts, the earlier chunks' of
    its group), and finds one of them not yet published (it reads them
    again on its next turn); or, all published, writes its ranks (the key's
    items before the chunk added) and, the last chunk, the counts.  Counts
    only: each block's counts over a grid stride, added into the copies of
    the counts in any order; the last block sums the copies.

    The wide mode, ranked: tiles by tickets in order, each warp's chunks
    ranked by their groups into the warp's table (fewer warps where eight
    tables do not fit), a thread a key looking back X1_LOOKBACK status
    words at a time; counts only: each block's counts over a grid stride
    added into the counts in a shuffled order.  Returns (rank or None,
    counts) as ``rank_in_key_plain``."""
    rng = np.random.default_rng(seed)
    n, n_keys = key.shape[0], num_keys + 1
    rows = n_keys + 1
    private = rows <= X1_PRIVATE_ROWS
    k_all = np.where((key < 0) | (key >= n_keys), n_keys, key).astype(np.int64)
    if not ranks:
        per_block = X1_THREADS * (X1_ITEMS if private else X1_COUNT_UNROLL)
        grid = max(min(-(-n // per_block), blocks), 1)
        tables = []
        for b in range(grid):
            cnt = np.zeros(rows, np.int64)
            for first in range(b * per_block, n, grid * per_block):
                _, kc = _x1_keys(k_all, n, first, per_block)
                np.add.at(cnt, kc[kc >= 0], 1)
            tables.append(cnt)
        counts = np.zeros(rows, np.int64)
        for b in rng.permutation(grid):            # the atomics, in any order
            counts += tables[b]
        return None, torch.as_tensor(counts[:-1].astype(np.int32))
    n_warps = min(X1_WARPS, X1_SMEM // (rows * 4))
    tile_n = X1_THREADS * X1_ITEMS if private else n_warps * 32 * X1_CHUNKS
    n_tiles = -(-n // tile_n)
    per = min(-(-n_tiles // blocks), X1_STAGE_TILES) if private and n_tiles else 1
    n_chunks = -(-n_tiles // per) if n_tiles else 0
    n_groups = -(-n_chunks // X1_GROUP)
    agg = np.full((max(n_chunks, 1), rows), -1, np.int64)     # -1: not published
    gtot = np.full((max(n_groups, 1), rows), -1, np.int64)
    gdone = np.zeros(max(n_groups, 1), np.int64)
    status = np.zeros((max(n_chunks, 1), rows), np.int64)     # the wide mode's
    rank = np.full(n, -7, np.int64)
    counts = np.zeros(rows, np.int64) if n == 0 else np.full(rows, -7, np.int64)
    tickets = iter(range(1 << 62))
    held = {b: {"chunk": next(tickets), "phase": "rank"} for b in range(blocks)}
    while True:
        live_blocks = [b for b in held if held[b]["chunk"] < n_chunks]
        if not live_blocks:
            break
        b = int(rng.choice(live_blocks))
        st = held[b]
        c = st["chunk"]
        g = c // X1_GROUP
        if st["phase"] == "rank" and private:
            tiles = range(c * per, min((c + 1) * per, n_tiles))
            st["staged"], st["total"] = _x1_chunk_private(k_all, n, tiles, rows)
            agg[c] = st["total"]
            gdone[g] += 1
            if gdone[g] == min(X1_GROUP, n_chunks - g * X1_GROUP):   # the group's last
                gtot[g] = agg[g * X1_GROUP:(g + 1) * X1_GROUP].sum(axis=0)
            st["phase"] = "prefix"
        elif st["phase"] == "prefix":
            words = np.concatenate([gtot[:g], agg[g * X1_GROUP:c]])
            if (words < 0).any():
                continue                            # a word not yet published: spin
            st["excl"], st["phase"] = words.sum(axis=0), "write"
        elif st["phase"] == "rank":                 # the wide mode: a tile
            i, kt, r, tab = _x1_tile_wide(k_all, n, c, n_warps, rows)
            before = (np.cumsum(tab, axis=0) - tab).T                # (rows, warps)
            st.update(staged=[(i, kt, r + before[np.maximum(kt, 0),
                                                 np.arange(n_warps)[:, None, None]])],
                      total=tab.sum(axis=0), excl=np.zeros(rows, np.int64),
                      j=np.full(rows, c - 1, np.int64), live=np.full(rows, c > 0),
                      phase="look")
            status[c] = (X1_INCLUSIVE if c == 0 else X1_AGGREGATE) | st["total"]
        elif st["phase"] == "look":
            st["live"] &= ~_x1_window(status, rows, st["j"], st["excl"], st["live"],
                                      X1_LOOKBACK)
            if not st["live"].any():
                status[c] = X1_INCLUSIVE | (st["excl"] + st["total"])
                st["phase"] = "write"
        if st["phase"] == "write":
            excl = st["excl"]
            if c == n_chunks - 1:
                counts = excl + st["total"]
            for i, kt, in_chunk in st["staged"]:
                val = np.where(kt < n_keys, in_chunk + excl[np.maximum(kt, 0)], -1)
                ok = (i < n) & (kt >= 0)
                rank[i[ok]] = val[ok]
            st["phase"] = "done"
        if st["phase"] == "done":
            held[b] = {"chunk": next(tickets), "phase": "rank"}
    if private:
        assert (agg[:n_chunks] >= 0).all() and (gtot[:n_groups] >= 0).all()
    else:
        assert (status[:n_chunks] >= X1_INCLUSIVE).all()
    return (torch.as_tensor(rank.astype(np.int32)),
            torch.as_tensor(counts[:-1].astype(np.int32)))


X1_DESIGN_CASES = ("N = 0", "N = 1", "N = 1023", "one key", "33 keys, many tiles",
                   "ignored only", "buckets, many tiles", "63 keys, 40 chunks",
                   "buckets, chunks of tiles",
                   "100 keys (wide mode)", "K + 1 = X1_MAX_KEYS")


def _x1_design_case(case):
    rng = np.random.default_rng(4)
    if case == "N = 0":
        return np.zeros(0, np.int32), 3
    if case == "N = 1":
        return np.asarray([2], np.int32), 3
    if case == "N = 1023":
        return rng.integers(0, 3, 1023).astype(np.int32), 2
    if case == "one key":
        return np.zeros(5000, np.int32), 3
    if case == "33 keys, many tiles":
        return rng.integers(0, 34, 20_000).astype(np.int32), 33
    if case == "ignored only":
        return np.full(7000, 3, np.int32), 3
    if case == "buckets, many tiles":          # 1% leavers for 3 buckets, 3 the stayers
        return np.where(rng.random(30_000) < 0.01, rng.integers(0, 3, 30_000),
                        3).astype(np.int32), 3
    if case == "63 keys, 40 chunks":          # two groups of chunks
        return rng.integers(0, 63, 40 * 2048 - 5).astype(np.int32), 62
    if case == "buckets, chunks of tiles":    # chunks of 8 tiles, more than the blocks
        return np.where(rng.random(70_000) < 0.01, rng.integers(0, 3, 70_000),
                        3).astype(np.int32), 3
    if case == "100 keys (wide mode)":
        return rng.integers(0, 101, 12_000).astype(np.int32), 100
    K = tex.X1_MAX_KEYS - 1
    return rng.integers(0, K + 1, 5000).astype(np.int32), K


@pytest.mark.parametrize("ranks", [True, False], ids=["ranked", "counts only"])
@pytest.mark.parametrize("case", X1_DESIGN_CASES)
def test_rank_in_key_design_equals_plain_and_jax(case, ranks):
    """Kernel X1's design (numpy, tiles completing in a shuffled order
    behind tickets in order) equals ``rank_in_key_plain`` and the JAX
    ``rank_within_key`` / ``_bucket_ranks`` bit for bit, ranked and counts
    only, at the keys' edges: no key, one, a ragged tile, one key, every
    item the ignored key, chunks in two groups, chunks of several tiles, 100
    keys (the wide mode) and a key count whose eight warp tables do not fit
    (four warps a tile)."""
    key, K = _x1_design_case(case)
    want = tex.rank_in_key_plain(T(key), K, ranks)
    blocks = 40 if "chunks" in case else 3
    for seed in range(3):
        got = rank_in_key_emulated(key, K, ranks, blocks=blocks, seed=seed)
        _bits_equal(got[1], want[1].numpy(), f"counts, seed {seed}")
        if ranks:
            _bits_equal(got[0], want[0].numpy(), f"ranks, seed {seed}")
    np.testing.assert_array_equal(want[1].numpy(), np.bincount(key, minlength=K + 1))
    if ranks and len(key):
        np.testing.assert_array_equal(want[0].numpy(), np.asarray(jlb.rank_within_key(
            jnp.asarray(key), K)))
        order, _, rank_in_bucket, jcounts = jmig._bucket_ranks(jnp.asarray(key), K)
        np.testing.assert_array_equal(want[0].numpy()[np.asarray(order)],
                                      np.asarray(rank_in_bucket))
        np.testing.assert_array_equal(want[1].numpy()[:K], np.asarray(jcounts))


def test_rank_in_key_refuses_more_items_than_a_status_word_counts():
    """X1's status word holds a 30-bit count: 2^30 keys are refused on
    every device (a view of one key, nothing allocated)."""
    key = torch.zeros(1, dtype=torch.int32).expand(tex.X1_MAX_ITEMS)
    with pytest.raises(ValueError, match="status word"):
        tex.rank_in_key(key, 3)


# ---------------------------------------------------------------------------
# X2
# ---------------------------------------------------------------------------

def _jax_state(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("case", tr.SEND_CASES)
def test_pack_send_matches_jax_fill_send(case):
    st, key, quota, rows, cap, ne, eg = tr.send_case(case)
    D = len(rows)
    k = T(key)
    rank, counts = tex.rank_in_key(k, D)
    send, kept, leaving, overflow, fs = tex.pack_send(
        {n: T(v) for n, v in st.items()}, k, rank, counts, T(quota), rows, cap, T(ne), T(eg))
    order, sorted_key, rib, jcounts = jmig._bucket_ranks(jnp.asarray(key), D)
    slot, jover, jkept = jmig._slots_from_ranks(order, sorted_key, rib, jcounts, D, cap,
                                                 jnp.asarray(quota))
    jleave = (jnp.asarray(key) < D) & ~jkept
    gid = jnp.where(jleave, jnp.asarray(eg)[jnp.maximum(jnp.asarray(ne), 0)], -1)
    payload, jfs = jmig._pack_payload(_jax_state(st), jleave, gid)
    jsend = np.asarray(jmig._fill_send(payload, slot, D, cap))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(leaving.numpy(), np.asarray(jleave))
    assert bool(overflow) == bool(jover) == (case == "over cap")
    assert {n: v[:2] for n, v in fs.items()} == {n: v[:2] for n, v in jfs.items()}
    assert send.shape == (sum(rows), 1 + sum(hi - lo for lo, hi, _, _ in fs.values()))
    off = np.cumsum([0] + rows)
    for b in range(D):
        np.testing.assert_array_equal(send.numpy()[off[b]:off[b + 1]],
                                      jsend[b * cap:b * cap + rows[b]], err_msg=f"bucket {b}")
    assert int(leaving.sum()) == sum(rows)


# kernel X2's block size (kernels/csrc/exchange.cu: X_THREADS)
X2_THREADS = 256


def pack_send_emulated(state, key, rank, counts, quota, rows, cap, new_elem, elem_gid,
                       reverse=False):
    """Kernel X2's design in numpy, step for step: a thread an item, in
    blocks of X2_THREADS (run in reverse block order with ``reverse``: no
    block depends on another); the item's bucket key, its rank against
    min(quota, cap), and, for an admitted leaver, its row written word by
    word (the gid, then each field's lanes in the layout's order); every
    item writes kept and leaving; the grid's first thread sets the overflow
    flag.  Returns (send, kept, leaving, overflow, layout) as
    ``pack_send_plain``."""
    n, D = key.shape[0], len(rows)
    fs, width = tex.payload_layout({k: T(v) for k, v in state.items()})
    lanes = {name: tex._to_lanes(T(state[name])).numpy() for name in fs}
    offsets = np.cumsum([0] + list(rows[:-1]), dtype=np.int64) if D else np.zeros(1, np.int64)
    send = np.full((sum(rows), width), tex.INVALID, np.int32)
    kept = np.full(n, 7, np.uint8)
    leaving = np.full(n, 7, np.uint8)
    overflow = None
    blocks = range(max(-(-n // X2_THREADS), 1))
    for blk in reversed(blocks) if reverse else blocks:
        for i in range(blk * X2_THREADS, (blk + 1) * X2_THREADS):
            if i == 0:
                overflow = any(int(counts[b]) > cap for b in range(D))
            if i >= n:
                continue
            k = int(key[i])
            go = stay = False
            if k < D:
                r = int(rank[i])
                go = r < min(int(quota[k]), cap)
                stay = not go
                if go:
                    row = send[offsets[k] + r]
                    row[0] = elem_gid[max(int(new_elem[i]), 0)]
                    col = 1
                    for name in fs:
                        for lane in range(lanes[name].shape[1]):
                            row[col] = lanes[name][i, lane]
                            col += 1
            kept[i], leaving[i] = stay, go
    return (T(send), T(kept.astype(bool)), T(leaving.astype(bool)), torch.tensor(overflow),
            fs)


@pytest.mark.parametrize("reverse", [False, True], ids=["blocks in order", "blocks reversed"])
@pytest.mark.parametrize("case", tr.SEND_CASES + ("wide rows", "clustered runs"))
def test_pack_send_design_equals_plain_and_jax(case, reverse):
    """Kernel X2's design (numpy: a thread an item, each admitted leaver
    writing its own row, blocks in either order) equals ``pack_send_plain``
    and the JAX ``_fill_send`` bit for bit, a bool field and NaN, -0.0 and
    subnormal lanes among the payloads; "wide rows" adds a (5, 8) f32
    field, 40 lanes more than a warp; "clustered runs" puts the leavers in
    runs of slots across block edges; "step layout" is the picparts step's
    (a slot prefix in element order, leavers in runs by element)."""
    base = case if case in tr.SEND_CASES else "random"
    st, key, quota, rows, cap, ne, eg = tr.send_case(base)
    if case == "wide rows":
        st["W"] = tr.odd_floats(np.random.default_rng(9), 40 * len(key)).reshape(-1, 5, 8)
    if case == "clustered runs":                  # 3 runs of 300 slots, all leaving
        rng = np.random.default_rng(10)
        key = np.full(len(key), len(rows), np.int32)
        for start in (100, 1500, 3000):
            key[start:start + 300] = rng.integers(0, len(rows), 300)
        counts = np.bincount(key, minlength=len(rows) + 1)[:len(rows)]
        quota = np.minimum(counts, cap).astype(np.int32)
        rows = [int(q) for q in quota]
    D = len(rows)
    rank, counts = tex.rank_in_key_plain(T(key), D)
    args = ({n: T(v) for n, v in st.items()}, T(key), rank, counts, T(quota), rows, cap,
            T(ne), T(eg))
    want = tex.pack_send_plain(*args)
    got = pack_send_emulated(st, key, rank.numpy(), counts.numpy(), quota, rows, cap, ne, eg,
                             reverse)
    for x, y, what in zip(got[:4], want[:4], ("send", "kept", "leaving", "overflow")):
        _bits_equal(x, y.numpy(), what)
    assert got[4] == want[4]
    order, sorted_key, rib, jcounts = jmig._bucket_ranks(jnp.asarray(key), D)
    slot, _, jkept = jmig._slots_from_ranks(order, sorted_key, rib, jcounts, D, cap,
                                            jnp.asarray(quota))
    jleave = (jnp.asarray(key) < D) & ~jkept
    gid = jnp.where(jleave, jnp.asarray(eg)[jnp.maximum(jnp.asarray(ne), 0)], -1)
    payload, _ = jmig._pack_payload(_jax_state(st), jleave, gid)
    jsend = np.asarray(jmig._fill_send(payload, slot, D, cap))
    off = np.cumsum([0] + rows)
    for b in range(D):
        np.testing.assert_array_equal(got[0].numpy()[off[b]:off[b + 1]],
                                      jsend[b * cap:b * cap + rows[b]], err_msg=f"bucket {b}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jleave))


# ---------------------------------------------------------------------------
# X3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", tr.PLACE_CASES)
def test_place_arrivals_matches_jax(case):
    st, staying, ne, recv, gs, gp = tr.place_case(case)
    tst = {n: T(v) for n, v in st.items()}
    fs, _ = tex.payload_layout(tst)
    state, n_recv, n_unres, over = tex.place_arrivals(tst, T(staying), T(ne), T(recv), fs,
                                                     T(gs), T(gp))
    _, jfs = jmig._pack_payload(_jax_state(st), jnp.zeros(len(staying), bool),
                                jnp.zeros(len(staying), jnp.int32))
    jstate, jn, ju, jo = jmig._place_arrivals(_jax_state(st), jnp.asarray(staying),
                                              jnp.asarray(ne), jnp.asarray(recv), jfs,
                                              jnp.asarray(gs), jnp.asarray(gp))
    assert set(state) == set(jstate)
    for name in state:
        _bits_equal(state[name], jstate[name], name)
    assert (int(n_recv), int(n_unres), bool(over)) == (int(jn), int(ju), bool(jo))
    if case == "beyond the free slots":
        assert bool(over) and int(state["active"].sum()) == len(staying)
    if case == "all unresolved":
        assert int(n_recv) == 0 and int(n_unres) == recv.shape[0]


X_THREADS, X3_CHUNKS = 256, 8
X3_TILE = X3_CHUNKS * X_THREADS


def place_arrivals_emulated(state, staying, new_elem, recv, fs, gs, gp):
    """Kernel X3's design in numpy, step for step: launch 1 takes a tile a
    block (X_THREADS arrivals: binary search, the tile's scan compacting
    its valid arrivals' rows and elements at its own X_THREADS entries, its
    valid and unresolved counts; X3_TILE slots: the count of the free
    ones); launch 2 scans the tiles' counts into exclusive prefixes and
    writes the counts and the overflow; launch 3 takes X3_TILE slots a
    block (a ballot a warp and chunk, the scan of the 64 counts on the
    tile's prefix: each free slot's rank r; the r-th valid arrival's tile
    by a binary search over the prefixes) and writes the member fields IN
    PLACE, only at the free slots, and elem and active anew.  Returns (new
    state, num_recv, num_unresolved, overflow); ``state``'s member arrays
    are the new state's."""
    m, n, E = recv.shape[0], staying.shape[0], gs.shape[0]
    tiles_a = -(-m // X_THREADS) + (m == 0)
    tiles_p = -(-n // X3_TILE) + (n == 0)
    arr_row = np.full(tiles_a * X_THREADS, -5, np.int64)
    arr_lid = np.full(tiles_a * X_THREADS, -5, np.int64)
    tile_valid, tile_unres = np.zeros(tiles_a, np.int64), np.zeros(tiles_a, np.int64)
    tile_free = np.zeros(tiles_p, np.int64)
    for b in range(max(tiles_a, tiles_p)):                  # launch 1
        if b < tiles_p:
            i = np.arange(b * X3_TILE, (b + 1) * X3_TILE)
            tile_free[b] = int(((i < n) & ~staying[np.minimum(i, max(n - 1, 0))]).sum()) \
                if n else 0
        if b < tiles_a:
            j = np.arange(b * X_THREADS, (b + 1) * X_THREADS)
            g = np.where(j < m, recv[np.minimum(j, max(m - 1, 0)), 0] if m else -1, -1)
            pos = np.clip(np.searchsorted(gs, g), 0, E - 1)
            lid = np.where((g >= 0) & (gs[pos] == g), gp[pos], -1)
            valid, unres = (g >= 0) & (lid >= 0), (g >= 0) & (lid < 0)
            k = np.cumsum(valid) - valid
            arr_row[b * X_THREADS + k[valid]] = j[valid]
            arr_lid[b * X_THREADS + k[valid]] = lid[valid]
            tile_valid[b], tile_unres[b] = valid.sum(), unres.sum()
    valid_pre = np.cumsum(tile_valid) - tile_valid              # launch 2
    free_pre = np.cumsum(tile_free) - tile_free
    num_recv, num_unres = int(tile_valid.sum()), int(tile_unres.sum())
    overflow = num_recv > int(tile_free.sum())
    elem = np.full(n, -7, np.int32)
    active = np.zeros(n, bool)
    lane = np.arange(32)
    for b in range(tiles_p):                                    # launch 3
        i = b * X3_TILE + np.arange(X3_TILE).reshape(X3_CHUNKS, X_THREADS // 32, 32)
        free = ((i < n) & ~staying[np.minimum(i, max(n - 1, 0))]) if n else i < 0
        cnt = free.sum(axis=2).reshape(-1)                      # (chunk, warp) in slot order
        pre = (np.cumsum(cnt) - cnt).reshape(X3_CHUNKS, -1)
        lower = (free[:, :, None, :] & (lane[None, None, None, :] < lane[None, None, :, None])
                 ).sum(axis=3)
        r = free_pre[b] + pre[:, :, None] + lower
        for s_, f, rank in zip(i.reshape(-1), free.reshape(-1), r.reshape(-1)):
            if s_ >= n:
                continue
            if not f:
                elem[s_], active[s_] = new_elem[s_], True
                continue
            row, lid = -1, -1
            if rank < num_recv:
                a = int(np.searchsorted(valid_pre, rank, side="right")) - 1
                row = arr_row[a * X_THREADS + rank - valid_pre[a]]
                lid = arr_lid[a * X_THREADS + rank - valid_pre[a]]
            elem[s_], active[s_] = lid, row >= 0
            for name, (lo, hi, dtype, inner) in fs.items():
                vals = recv[row, lo:hi] if row >= 0 else np.zeros(hi - lo, np.int32)
                tgt = state[name].reshape(n, -1)
                tgt[s_] = (vals != 0) if dtype == torch.bool else vals.view(
                    np.float32 if dtype == torch.float32 else np.int32)
    new = {"elem": elem, "active": active, **{k: state[k] for k in fs}}
    return new, num_recv, num_unres, overflow


@pytest.mark.parametrize("case", tr.PLACE_CASES)
def test_place_arrivals_design_equals_plain_in_place(case):
    """Kernel X3's tile counts, scan and in-place placement (numpy) equal the plain
    version (which equals ``_place_arrivals``): the member fields are
    written into the state's own arrays at the free slots alone (the
    staying slots keep their bits), elem and active are new.  The CPU
    wrapper keeps the same contract: the new state's member fields are
    the state's own tensors, holding the result, and elem and active are
    not written."""
    st, staying, ne, recv, gs, gp = tr.place_case(case)
    tst = {n: T(v.copy()) for n, v in st.items()}
    fs, _ = tex.payload_layout(tst)
    before = {k: v.clone() for k, v in tst.items()}
    want = tex.place_arrivals(tst, T(staying), T(ne), T(recv), fs, T(gs), T(gp))
    for k in fs:
        assert want[0][k] is tst[k], f"{k} not written in place by the CPU wrapper"
    for k in ("elem", "active"):
        _bits_equal(tst[k], before[k].numpy(), f"{k} written by the CPU wrapper")
    arrays = {k: v.copy() for k, v in st.items()}
    got = place_arrivals_emulated(arrays, staying, ne, recv, fs, gs, gp)
    for name in want[0]:
        _bits_equal(want[0][name], got[0][name], name)
    assert (int(want[1]), int(want[2]), bool(want[3])) == (int(got[1]), int(got[2]),
                                                          bool(got[3]))
    for name in fs:        # in place: the same arrays, stayers untouched
        assert got[0][name] is arrays[name]
        keep = staying.reshape((-1,) + (1,) * (st[name].ndim - 1))
        _bits_equal(T(np.where(keep, arrays[name], st[name])), st[name], name)


# ---------------------------------------------------------------------------
# O
# ---------------------------------------------------------------------------

R_O = 8


@pytest.fixture(scope="module")
def owner_tables():
    coords, tris, cls = annulus_mesh(4, 48, 0.3, 1.0)
    owners = tpp.partition_rcb(coords, tris, R_O)
    pp = tpp.build_picparts(coords, tris, owners, R_O, tpp.PicPartsInput(), cls)
    return pp.vert_send_ids, pp.vert_recv_ids, pp.nverts


def _fields(case, V, rng):
    inner = (3,) if "vec" in case else ()
    shape = (R_O, V) + inner
    if "i32" in case:
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    f = (rng.integers(-40, 40, shape) / 2.0).astype(np.float32)
    if case.startswith("sum"):
        f[rng.random(shape) < 0.1] = -0.0
    if "nan" in case:
        f[rng.random(shape) < 0.03] = np.nan
    return f


def _port_reduce(send, recv, f, op, rows_from_d=False):
    """The owner reduction of every rank in one process: O's gather (or,
    with ``rows_from_d``, the send rows kernel D's epilogue writes beside
    the field, as the picparts step's SUM takes them), the all_to_all as a
    transpose, O's fan-in, the transpose back, O's fan-out (in place on the
    fan-in's output, as ``reduce_comm_array``)."""
    from pumipic_torch.ops import scatter as tsc
    from pumipic_torch.parallel import reduce as tred

    f = [T(x) for x in f]
    if op != "bcast":
        if rows_from_d:
            sv = []
            for r in range(R_O):
                rows = tred.sum_send_rows(T(send[r]), f[r].shape[0])
                tsc.write_send_rows(f[r], rows)
                sv.append(rows[1])
        else:
            sv = [tex.owner_gather(f[r], T(send[r]), tex.neutral(op, f[r].dtype))
                  for r in range(R_O)]
        red = [tex.owner_fan_in(f[r], torch.stack([sv[q][r] for q in range(R_O)]),
                                T(recv[r]), op) for r in range(R_O)]
        f, ov = [x[0] for x in red], [x[1] for x in red]
        return [tex.owner_fan_out_(f[r], torch.stack([ov[q][r] for q in range(R_O)]),
                                   T(send[r])) for r in range(R_O)]
    ov = [tex.owner_gather(f[r], T(recv[r]), 0) for r in range(R_O)]
    return [tex.owner_fan_out(f[r], torch.stack([ov[q][r] for q in range(R_O)]),
                              T(send[r])) for r in range(R_O)]


@pytest.mark.parametrize("case", ["sum f32", "sum f32 vec", "sum i32", "sum f32 nan",
                                  "max f32", "max f32 nan", "min f32", "max i32",
                                  "min i32", "bcast f32", "bcast i32", "sum f32 rows from D"])
def test_owner_reduction_matches_jax(owner_tables, case):
    send, recv, V = owner_tables
    op = case.split()[0]
    f = _fields(case, V, np.random.default_rng(5))
    got = _port_reduce(send, recv, f, op, rows_from_d=case.endswith("from D"))
    run = jax.jit(jax.shard_map(
        lambda a, b, c: jred.reduce_comm_array(a[0], b[0], c[0], jred.Op[op.upper()])[None],
        mesh=make_device_mesh(R_O), in_specs=(P(RANK_AXIS),) * 3, out_specs=P(RANK_AXIS),
        check_vma=False))
    want = np.asarray(run(jnp.asarray(send), jnp.asarray(recv), jnp.asarray(f)))
    for r in range(R_O):
        _bits_equal(got[r], want[r], f"{case} rank {r}", nan_positions="nan" in case)
    # every copy of a vertex holds its owner's value
    changed = sum(int((got[r].numpy() != f[r]).sum()) for r in range(R_O))
    assert changed > 0


@pytest.mark.parametrize("case", tr.OWNER_CASES)
def test_owner_fan_out_writes_in_place_and_its_copy_does_not(case):
    """``owner_fan_out_`` writes the returned rows into the field it is
    given and returns it; ``owner_fan_out`` leaves its input as it was;
    both equal the plain version bit for bit."""
    f, rid, rv, sid, back, op = (T(a) if isinstance(a, np.ndarray) else a
                                 for a in tr.owner_case(case))
    want = tex.owner_fan_out_plain(f, back, sid)
    before = f.clone()
    _bits_equal(tex.owner_fan_out(f, back, sid), want.numpy(), case,
                nan_positions="nan" in case)
    _bits_equal(f, before.numpy(), case + ": input untouched", nan_positions="nan" in case)
    mine = f.clone()
    assert tex.owner_fan_out_(mine, back, sid) is mine
    _bits_equal(mine, want.numpy(), case + ": in place", nan_positions="nan" in case)


def test_owner_maps_refuse_inconsistent_tables():
    """The kernel's maps (built once per table) name each copy once and
    every entity within the field."""
    with pytest.raises(ValueError, match="twice"):
        tex.fan_out_rows(np.asarray([[1, 2], [2, -1]]), 4, "cpu")
    with pytest.raises(ValueError, match="entity 7"):
        tex.fan_in_csr(np.asarray([[7, -1]]), 4, "cpu")
    off, rows = tex.fan_in_csr(np.asarray([[2, 0], [-1, 2]]), 3, "cpu")
    np.testing.assert_array_equal(off.numpy(), [0, 1, 1, 3])
    np.testing.assert_array_equal(rows.numpy(), [1, 0, 3])
