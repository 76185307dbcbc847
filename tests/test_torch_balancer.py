"""Parity of the port's balancer (pumipic_torch.parallel.balancer) with the
JAX package's: the sbar tables, ``plan_flows`` (tolerance, fixed weight,
the heterogeneous water-fill of ``16df6b3``), ``rank_within_key``,
``select_particles``, and on 4 gloo CPU ranks against 4 virtual devices
``repartition`` (with and without the non-core priority), ``partition``
and ``ptcl_imbalance``.  Integer outputs (tables, flows, ranks,
destinations) equal; the imbalance triple f32 equal."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pumipic_tpu.mesh import generate as jgen
from pumipic_tpu.parallel import balancer as jlb
from pumipic_tpu.parallel import picparts as jpp
from pumipic_tpu.parallel.mesh_axis import RANK_AXIS, make_device_mesh
from pumipic_torch.parallel import balancer as tlb
from pumipic_torch.parallel import group
from pumipic_torch.parallel import picparts as tpp


R = 4
HERE = os.path.dirname(os.path.abspath(__file__))


def _mesh():
    return jgen.annulus_mesh(6, 32, 0.3, 1.0)


@pytest.fixture(scope="module")
def tables():
    coords, tris, cls = _mesh()
    owners = jpp.partition_rcb(coords, tris, R)
    jp = jpp.build_picparts(coords, tris, owners, R, jpp.PicPartsInput(), cls)
    tp = tpp.build_picparts(coords, tris, owners, R, tpp.PicPartsInput(), cls)
    return jp, tp, jlb.build_balancer(jp, R), tlb.build_balancer(tp, R)


def _one_sbar(mod, R):
    edges = sorted([(0, a, b) for a in range(R) for b in range(R) if a != b],
                   key=lambda e: (e[1], e[0]))
    my = np.full((R, R - 1), -1, np.int64)
    for r in range(R):
        idx = [i for i, e in enumerate(edges) if e[1] == r]
        my[r, :len(idx)] = idx
    e = np.asarray(edges, np.int64)
    conv = (lambda a: jnp.asarray(a, jnp.int32)) if mod is jlb else (
        lambda a: np.asarray(a, np.int32))
    return mod.BalancerTables(conv(np.zeros((R, 4))), conv(e[:, 0]), conv(e[:, 1]),
                              conv(e[:, 2]), conv(my), 1, len(edges))


def test_sbar_tables_match_jax(tables):
    jp, tp, jb, tb = tables
    for k in ("sbar_of_elem", "edge_sbar", "edge_src", "edge_dst", "my_edge_idx"):
        np.testing.assert_array_equal(getattr(tb, k), np.asarray(getattr(jb, k)), err_msg=k)
    assert (tb.num_sbars, tb.num_edges) == (jb.num_sbars, jb.num_edges)
    assert tb.num_sbars > 1 and (tb.edge_src != tb.edge_dst).all()
    for r in range(R):
        assert tp.elem_safe[r][tb.sbar_of_elem[r] >= 0].all()


PLAN_CASES = {
    # (R, w_sr, w_fixed, tol)
    "tolerance": (4, [[400.0], [0.0], [0.0], [0.0]], [0, 0, 0, 0], 1.05),
    "within-tolerance": (4, [[400.0], [0.0], [0.0], [0.0]], [0, 0, 0, 0], 4.5),
    "fixed-weight": (4, [[100.0], [0.0], [0.0], [0.0]], [0, 100, 0, 0], 1.05),
    "waterfill-no-move": (3, [[3.0], [0.0], [0.0]], [5, 10, 100], 1.001),
    "waterfill-partial": (3, [[5.0], [0.0], [0.0]], [0, 2, 10], 1.001),
    "uneven": (4, [[37.0], [5.0], [0.0], [11.0]], [3, 0, 9, 1], 1.01),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_flows_matches_jax(name):
    n, w, fx, tol = PLAN_CASES[name]
    w, fx = np.asarray(w, np.float32), np.asarray(fx, np.float32)
    got = tlb.plan_flows(_one_sbar(tlb, n), torch.as_tensor(w), torch.as_tensor(fx), tol)
    want = jlb.plan_flows(_one_sbar(jlb, n), jnp.asarray(w), jnp.asarray(fx), tol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "waterfill-no-move":
        assert got.sum() == 0


def test_plan_flows_on_picparts_matches_jax(tables):
    jp, tp, jb, tb = tables
    rng = np.random.default_rng(5)
    for trial in range(4):
        w = (rng.integers(0, 50, (R, tb.num_sbars)) * (rng.random((R, tb.num_sbars)) < 0.6)
             ).astype(np.float32)
        fx = rng.integers(0, 100, R).astype(np.float32)
        got = tlb.plan_flows(tb, torch.as_tensor(w), torch.as_tensor(fx), 1.02)
        want = jlb.plan_flows(jb, jnp.asarray(w), jnp.asarray(fx), 1.02)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(trial))


def test_rank_within_key_matches_jax():
    key = np.random.default_rng(2).integers(0, 9, 500).astype(np.int32)
    np.testing.assert_array_equal(tlb.rank_within_key(torch.as_tensor(key), 8).numpy(),
                                  np.asarray(jlb.rank_within_key(jnp.asarray(key), 8)))


@pytest.mark.parametrize("noncore", [False, True])
def test_select_particles_matches_jax(noncore):
    rng = np.random.default_rng(4)
    n = 60
    flows = np.zeros(12, np.int32)
    flows[[0, 1, 2, 4, 7]] = [5, 3, 0, 2, 4]
    sbar = np.where(rng.random(n) < 0.8, 0, -1).astype(np.int32)
    cand = rng.random(n) < 0.9
    dest = np.zeros(n, np.int32)
    nc = rng.random(n) < 0.3 if noncore else None
    for me in range(R):
        got = tlb.select_particles(_one_sbar(tlb, R), torch.as_tensor(flows),
                                   torch.as_tensor(sbar), torch.as_tensor(cand),
                                   torch.as_tensor(dest + me), me,
                                   None if nc is None else torch.as_tensor(nc))
        want = jlb.select_particles(_one_sbar(jlb, R), jnp.asarray(flows),
                                    jnp.asarray(sbar), jnp.asarray(cand),
                                    jnp.asarray(dest + me), jnp.int32(me),
                                    None if nc is None else jnp.asarray(nc))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def scenario(tables):
    jp, tp, jb, tb = tables
    rng = np.random.default_rng(9)
    n = 400
    eg, es, eo = tp.elem_gid, tp.elem_safe, tp.elem_owner
    new_elem = np.full((R, n), -1, np.int32)
    dest = np.zeros((R, n), np.int32)
    ppe = np.zeros((R, tp.nelems), np.int32)
    for r in range(R):
        E = tp.local_nelems(r)
        k = n if r == 0 else n // 4          # rank 0 overloaded
        e = rng.integers(0, E, k)
        new_elem[r, :k] = e
        go = ~es[r][e]
        dest[r] = r
        dest[r, :k] = np.where(go, eo[r][e], r)
        ppe[r, :E] = rng.integers(0, 6 if r == 0 else 2, E)
    num_ptcls = int(ppe.sum(1).max()) + 8
    coords, tris, cls = _mesh()
    return dict(coords=coords, tris=tris, cls=cls, new_elem=new_elem, dest=dest,
                ppe=ppe, num_ptcls=num_ptcls)


@pytest.fixture(scope="module")
def ranks(scenario):
    return group.launch("torch_ranks:balancer_rank", R, scenario, timeout=300,
                        backend="gloo", device="cpu", extra_paths=[HERE])


@pytest.fixture(scope="module")
def jranks(tables, scenario):
    jp, tp, jb, tb = tables
    mesh = make_device_mesh(R)
    sh = NamedSharding(mesh, P(RANK_AXIS))

    def f(pp_l, ne, de, ppe):
        lpp = jpp.local_view(pp_l)
        ne, de, ppe = ne[0], de[0], ppe[0]
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        act = ne >= 0
        sb = jb.sbar_of_elem[me]
        out = {"repart": jlb.repartition(jb, sb, ne, act, de, me),
               "repart_nc": jlb.repartition(jb, sb, ne, act, de, me,
                                            elem_owner=lpp.elem_owner),
               "partition": jlb.partition(jb, sb, ppe, scenario["num_ptcls"], me),
               "imb": jnp.stack(jlb.ptcl_imbalance(jnp.sum(act.astype(jnp.int32))))}
        return {k: v[None] for k, v in out.items()}

    run = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(RANK_AXIS),) * 4,
                                out_specs=P(RANK_AXIS), check_vma=False))
    out = run(jax.device_put(jp, sh),
              *(jax.device_put(jnp.asarray(scenario[k]), sh)
                for k in ("new_elem", "dest", "ppe")))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("key", ["repart", "repart_nc", "partition"])
def test_distributed_balancer_matches_jax(ranks, jranks, scenario, key):
    moved = 0
    for r, out in enumerate(ranks):
        got = out[key].numpy()
        np.testing.assert_array_equal(got, jranks[key][r], err_msg=f"rank {r}")
        if key != "partition":
            moved += int((got != scenario["dest"][r]).sum())
    if key != "partition":
        assert moved > 0


def test_ptcl_imbalance_matches_jax(ranks, jranks):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(torch.stack(out["imb"]).numpy(), jranks["imb"][r])
    assert float(ranks[0]["imb"][2]) > 1.0
