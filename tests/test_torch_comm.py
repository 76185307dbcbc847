"""Parity of the port's rank group and comm helpers
(pumipic_torch.parallel.group, reduce, migrate's pieces) with the JAX
package's collectives and comm code, on 8 gloo CPU ranks against
conftest's 8 virtual devices: ``world_all_to_all`` against
``lax.all_to_all``, ``all_gather``, ``all_sum`` against ``psum``, the
ragged ``all_to_all_single`` against a ``ppermute`` ring,
``reduce_comm_array`` on the JAX test's synthetic tables (also fed the
send rows kernel D writes, flat and over slices), ``gid_to_lid``,
the payload lanes, the neighbour plan; the same ranks split into 2 slices
of 4 (the JAX package's ``("slice", "ranks")`` mesh): the two-stage
exchanges, reduction and migration against the flat ones and the JAX
package's; the launcher's failure and deadline; and the dry run at CPU
scale, its mode 4 included, against ``__graft_entry__.dryrun_multichip(8)``.
Every value is an integer, an exact small float or moved bits: all
compared equal."""
import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pumipic_tpu.parallel import distributor as jdst
from pumipic_tpu.parallel import migrate as jmig
from pumipic_tpu.parallel import reduce as jred
from pumipic_tpu.parallel.mesh_axis import RANK_AXIS, make_device_mesh
from pumipic_torch.parallel import distributor as tdst
from pumipic_torch.parallel import group
from pumipic_torch.ops import exchange as tex
from pumipic_torch.parallel import migrate as tmig

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks as tr  # noqa: E402

R = 8
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ranks():
    return group.launch("torch_ranks:comm_rank", R, {}, timeout=240,
                        backend="gloo", device="cpu", extra_paths=[HERE])


def _smap(f, out_specs=P(RANK_AXIS)):
    mesh = make_device_mesh(R)
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(RANK_AXIS),
                                 out_specs=out_specs, check_vma=False))


def test_world_all_to_all_matches_jax(ranks):
    rows = np.stack([np.arange(R * 3, dtype=np.int32).reshape(R, 3) + 100 * me
                     for me in range(R)])
    want = np.asarray(_smap(lambda x: jax.lax.all_to_all(
        x[0], RANK_AXIS, 0, 0, tiled=False)[None])(jnp.asarray(rows)))
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out["a2a"].numpy(), want[me])


def test_all_gather_and_sum_match_jax(ranks):
    g = np.stack([[me, 2 * me] for me in range(R)]).astype(np.int32)
    want = np.asarray(_smap(lambda x: jax.lax.all_gather(x[0], RANK_AXIS)[None])(
        jnp.asarray(g)))
    s = np.stack([[float(me), 1.0] for me in range(R)]).astype(np.float32)
    want_s = np.asarray(_smap(lambda x: jax.lax.psum(x[0], RANK_AXIS)[None])(
        jnp.asarray(s)))
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out["gather"].numpy(), want[me])
        np.testing.assert_array_equal(out["sum"].numpy(), want_s[me])


def test_ragged_all_to_all_matches_ppermute_ring(ranks):
    x = np.stack([[[me, (me + 1) % R]] for me in range(R)]).astype(np.int32)
    perm = [(r, (r + 1) % R) for r in range(R)]
    want = np.asarray(_smap(lambda a: jax.lax.ppermute(a[0], RANK_AXIS, perm)[None])(
        jnp.asarray(x)))
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ragged"].numpy(), want[me])


@pytest.mark.parametrize("op", tr.REDUCE_OPS)
def test_reduce_comm_array_synthetic_matches_jax(ranks, op):
    s, r, f = tr.synthetic_tables(R)
    mesh = make_device_mesh(R)
    run = jax.jit(jax.shard_map(
        lambda a, b, c: jred.reduce_comm_array(a[0], b[0], c[0], jred.Op[op])[None],
        mesh=mesh, in_specs=(P(RANK_AXIS),) * 3, out_specs=P(RANK_AXIS),
        check_vma=False))
    want = np.asarray(run(*(jnp.asarray(a) for a in (s, r, f))))
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out[op].numpy(), want[me])
    if op == "SUM":
        np.testing.assert_array_equal(want[0], [15.0, 22.0])


def test_reduce_comm_array_with_send_rows_matches_jax(ranks):
    """SUM fed the send rows kernel D writes beside the field (the picparts
    step's path: ``send_vals``, no gather) equals the JAX package's
    ``reduce_comm_array``; no op writes into the field it is given."""
    s, r, f = tr.synthetic_tables(R)
    run = jax.jit(jax.shard_map(
        lambda a, b, c: jred.reduce_comm_array(a[0], b[0], c[0], jred.Op.SUM)[None],
        mesh=make_device_mesh(R), in_specs=(P(RANK_AXIS),) * 3, out_specs=P(RANK_AXIS),
        check_vma=False))
    want = np.asarray(run(*(jnp.asarray(a) for a in (s, r, f))))
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out["SUM_send_vals"].numpy(), want[me])
        _same(out["SUM_send_vals"], out["SUM"], f"rank {me}")
        assert all(out["untouched"].values()), (me, out["untouched"])
    np.testing.assert_array_equal(want[0], [15.0, 22.0])


def _same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif a.dtype == torch.float32:
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    else:
        assert torch.equal(a, b), what


def test_hier_all_to_all_matches_jax(ranks):
    """The two-stage exchange over 2 slices of 4 ranks equals the JAX
    package's flat all_to_all over its ("slice", "ranks") mesh
    (tests/test_comm.py's hier test), and the port's flat exchange."""
    mesh2 = make_device_mesh(R, slices=2)
    AX = ("slice", "ranks")
    flat = jax.jit(jax.shard_map(
        lambda x: jax.lax.all_to_all(x, AX, split_axis=0, concat_axis=0, tiled=False),
        mesh=mesh2, in_specs=P(AX), out_specs=P(AX)))
    want = np.asarray(flat(jnp.asarray(tr.hier_rows(R)))).reshape(R, R, 5)
    for me, out in enumerate(ranks):
        np.testing.assert_array_equal(out["hier"]["sliced"]["a2a"].numpy(), want[me])
        np.testing.assert_array_equal(out["hier"]["flat"]["a2a"].numpy(), want[me])


def test_hier_ragged_all_to_all_equals_flat(ranks):
    """Random row counts (empty blocks among them): the rows arrive in
    flat source order, as from the flat exchange."""
    rows = 0
    for me, out in enumerate(ranks):
        got, flat = out["hier"]["sliced"]["ragged"], out["hier"]["flat"]["ragged"]
        _same(got, flat, f"rank {me}")
        rows += got.shape[0]
    assert rows > 0


@pytest.mark.parametrize("op", tr.REDUCE_OPS)
def test_reduce_comm_array_hier_equals_flat_and_jax(ranks, op):
    s, r, f = tr.hier_tables(R)
    mesh2 = make_device_mesh(R, slices=2)
    AX = ("slice", "ranks")
    run = jax.jit(jax.shard_map(
        lambda a, b, c: jred.reduce_comm_array(a[0], b[0], c[0], jred.Op[op],
                                               axis_name=AX, hier=True)[None],
        mesh=mesh2, in_specs=(P(AX),) * 3, out_specs=P(AX), check_vma=False))
    want = np.asarray(run(*(jnp.asarray(a) for a in (s, r, f))))
    for me, out in enumerate(ranks):
        _same(out["hier"]["sliced"][op], out["hier"]["flat"][op], f"{op} rank {me}")
        np.testing.assert_array_equal(out["hier"]["sliced"][op].numpy(), want[me])


def test_reduce_comm_array_hier_with_send_rows_equals_flat_and_jax(ranks):
    """SUM fed D's send rows over 2 slices of 4 ranks (the two-stage route
    takes the same rows) equals the flat reduction and the JAX package's
    hier SUM."""
    s, r, f = tr.hier_tables(R)
    AX = ("slice", "ranks")
    run = jax.jit(jax.shard_map(
        lambda a, b, c: jred.reduce_comm_array(a[0], b[0], c[0], jred.Op.SUM,
                                               axis_name=AX, hier=True)[None],
        mesh=make_device_mesh(R, slices=2), in_specs=(P(AX),) * 3, out_specs=P(AX),
        check_vma=False))
    want = np.asarray(run(*(jnp.asarray(a) for a in (s, r, f))))
    for me, out in enumerate(ranks):
        got = out["hier"]["sliced"]["SUM_send_vals"]
        _same(got, out["hier"]["flat"]["SUM_send_vals"], f"rank {me}")
        _same(got, out["hier"]["sliced"]["SUM"], f"rank {me}")
        np.testing.assert_array_equal(got.numpy(), want[me])


@pytest.mark.parametrize("plan", ["world", "neighbor"])
def test_migrate_hier_equals_flat(ranks, plan):
    sent = 0
    for me, out in enumerate(ranks):
        got, flat = (out["hier"][k][f"migrate-{plan}"] for k in ("sliced", "flat"))
        _same(got, flat, f"{plan} rank {me}")
        sent += int(flat["num_sent"])
    assert sent > 0


def test_gid_to_lid_matches_jax():
    gids = np.asarray([40, 10, 30, 20], np.int32)
    perm = np.argsort(gids).astype(np.int32)
    q = np.asarray([10, 20, 25, 40, -1, 99], np.int32)
    got = tmig.gid_to_lid(torch.as_tensor(gids[perm]), torch.as_tensor(perm),
                          torch.as_tensor(q))
    want = jmig.gid_to_lid(jnp.asarray(gids[perm]), jnp.asarray(perm), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 3, -1, 0, -1, -1])


def test_payload_lanes_match_jax():
    """One int32 buffer: floats bitcast, bools 0/1, tensor fields flattened,
    in the JAX package's lane order, restored exactly by the placement."""
    st = {"elem": np.zeros(4, np.int32), "active": np.ones(4, bool),
          "x": np.asarray([1.5, -2.5, 3.25, 1e-40], np.float32),
          "pid": np.asarray([7, -8, 2**30, 0], np.int32),
          "flag": np.asarray([True, False, True, False]),
          "vec": np.arange(8, dtype=np.float32).reshape(4, 2),
          "J": np.arange(16, dtype=np.float32).reshape(4, 2, 2)}
    gid = np.asarray([3, 1, 0, 2], np.int32)
    tp, ts = tex.pack_payload({k: torch.as_tensor(v) for k, v in st.items()},
                                torch.as_tensor(gid))
    jp, js = jmig._pack_payload({k: jnp.asarray(v) for k, v in st.items()},
                                jnp.ones(4, bool), jnp.asarray(gid))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.int32
    assert {k: v[:2] + (v[3],) for k, v in ts.items()} == \
        {k: v[:2] + (tuple(v[3]),) for k, v in js.items()}
    staying = torch.zeros(4, dtype=torch.bool)
    state, n, unres, over = tex.place_arrivals(
        {k: torch.tensor(v) for k, v in st.items()}, staying,
        torch.zeros(4, dtype=torch.int32), tp, ts, torch.arange(4, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32))
    assert int(n) == 4 and int(unres) == 0 and not bool(over)
    for k in ("x", "pid", "flag", "vec", "J"):
        np.testing.assert_array_equal(state[k].numpy(), st[k], err_msg=k)


def test_neighbor_plan_ring_matches_jax():
    nb = np.zeros((R, R), bool)
    for r in range(R):
        nb[r, [r, (r + 1) % R, (r - 1) % R]] = True
    tp = tmig.build_neighbor_plan(tdst.Distributor(nb, R))
    jp = jmig.build_neighbor_plan(jdst.Distributor(is_neighbor=jnp.asarray(nb), num_ranks=R))
    np.testing.assert_array_equal(tp.round_of_dest, np.asarray(jp.round_of_dest))
    np.testing.assert_array_equal(tp.src_of_round, np.asarray(jp.src_of_round))
    assert tp.num_rounds == jp.num_rounds <= 3
    for r in range(R):
        assert tp.peers_out(r) == sorted({(r + 1) % R, (r - 1) % R})


def test_launch_fails_with_the_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        group.launch("torch_ranks:fail_rank", 2, {}, backend="gloo", device="cpu",
                     timeout=120, extra_paths=[HERE])


def test_launch_deadline_kills_a_hung_collective():
    with pytest.raises(RuntimeError, match="no result after 20 s"):
        group.launch("torch_ranks:hang_rank", 2, {}, backend="gloo", device="cpu",
                     timeout=20, extra_paths=[HERE])


def test_without_a_group_collectives_are_the_identity():
    assert not group.initialized() and group.rank() == 0 and group.num_ranks() == 1
    x = torch.arange(3)
    assert torch.equal(group.world_all_to_all(x[None])[0], x)
    assert torch.equal(group.all_gather(x), x[None])
    assert torch.equal(group.all_sum(x), x)
    with pytest.raises(ValueError):
        group.init("mpi")


def _parse(text):
    nums = {}
    for mode, body in re.findall(r"\(8\) (\S+): (.*) OK", text):
        nums[mode] = {k: float(v) for k, v in re.findall(r"(\w+)=([\d.]+)", body)}
    return nums


def test_dryrun_matches_jax():
    """dryrun_multirank(8, cpu, gloo) prints the counts of a fresh JAX
    dryrun_multichip(8), its multi-slice mode 4 (2 x 4 ranks) included."""
    import __graft_entry__
    from pumipic_torch.parallel.dryrun import dryrun_multirank

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        __graft_entry__.dryrun_multichip(8)
    want = _parse(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counts = dryrun_multirank(8, "cpu", "gloo", timeout=300)
    got = _parse(buf.getvalue())
    assert set(want) == set(got)
    for mode, vals in got.items():
        assert vals == want[mode], mode
    # the removals the port splits into boundary exits and particles lost
    # off the picparts are the JAX run's: 64 particles a rank less its
    # alive; the dry run's 40° push outruns its 3-layer buffer
    removed = re.search(r"lost off the picparts\) per step: (.*)", buf.getvalue())
    pairs = [tuple(map(int, p)) for p in re.findall(r"\((\d+), (\d+)\)", removed.group(1))]
    assert sum(e + lo for e, lo in pairs) == 64 * 8 - want["picparts"]["alive"]
    assert sum(lo for _, lo in pairs) > 0
    assert counts["picparts"]["migrated"] > 0 and counts["picparts-3d"]["migrated"] > 0
