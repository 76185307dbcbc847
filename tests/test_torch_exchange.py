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


def _port_reduce(send, recv, f, op):
    """The owner reduction of every rank in one process: O's gather, the
    all_to_all as a transpose, O's fan-in, the transpose back, O's fan-out."""
    f = [T(x) for x in f]
    if op != "bcast":
        sv = [tex.owner_gather(f[r], T(send[r]), tex.neutral(op, f[r].dtype))
              for r in range(R_O)]
        red = [tex.owner_fan_in(f[r], torch.stack([sv[q][r] for q in range(R_O)]),
                                T(recv[r]), op) for r in range(R_O)]
        f, ov = [x[0] for x in red], [x[1] for x in red]
    else:
        ov = [tex.owner_gather(f[r], T(recv[r]), 0) for r in range(R_O)]
    return [tex.owner_fan_out(f[r], torch.stack([ov[q][r] for q in range(R_O)]),
                              T(send[r])) for r in range(R_O)]


@pytest.mark.parametrize("case", ["sum f32", "sum f32 vec", "sum i32", "sum f32 nan",
                                  "max f32", "max f32 nan", "min f32", "max i32",
                                  "min i32", "bcast f32", "bcast i32"])
def test_owner_reduction_matches_jax(owner_tables, case):
    send, recv, V = owner_tables
    op = case.split()[0]
    f = _fields(case, V, np.random.default_rng(5))
    got = _port_reduce(send, recv, f, op)
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
