"""Parity of the port's distributed runtime (pumipic_torch.parallel,
``make_picparts_setup``, ``make_picparts_setup_3d``) with the JAX package,
on 4 gloo CPU ranks against 4 of conftest's virtual devices.

One module-scoped launch runs every rank-side case (tests/torch_ranks.py);
the JAX side runs the same numpy-seeded inputs under ``shard_map``.
Equal: every host table, id, slot, mask, count and ``stats`` key (the
picparts tables bit for bit), the gyro fields (multiples of 1/8) and the
reduced fields (exact small values).  Floats that a push produced: within
atol 2e-6 (XLA contracts the rotation's products into FMAs where torch
rounds each; the JAX package's walk arm pushes through its f64-rounded
table, the port's through the f32 band rotation, as its FULL mode does)."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pumipic_tpu.mesh import generate as jgen
from pumipic_tpu.models import pseudo_push_and_search as jpps
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.parallel import banded_route as jbr
from pumipic_tpu.parallel import capacity as jcap
from pumipic_tpu.parallel import distributor as jdst
from pumipic_tpu.parallel import migrate as jmig
from pumipic_tpu.parallel import picparts as jpp
from pumipic_tpu.parallel import reduce as jred
from pumipic_tpu.parallel.mesh_axis import RANK_AXIS, make_device_mesh
from pumipic_torch import native
from pumipic_torch.mesh.locator import detect_annulus_structured
from pumipic_torch.parallel import banded_route as tbr
from pumipic_torch.parallel import capacity as tcap
from pumipic_torch.parallel import distributor as tdst
from pumipic_torch.parallel import group
from pumipic_torch.parallel import migrate as tmig
from pumipic_torch.parallel import picparts as tpp

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks as tr  # noqa: E402

R = 4
HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = 2e-6
STEP_ARMS = {
    "analytic": ({}, {"use_lb": True}, {}),
    "walk": ({"analytic_locate": "off"}, {"use_lb": True}, {}),
    "walk-world": ({"analytic_locate": "off"},
                   {"use_lb": True, "neighbor_migration": False}, {}),
    "analytic-pprad-gather": ({}, {"use_lb": True, "banded_route": "off"},
                              {"per_particle_radius": True}),
}
STEP3D_ARMS = {"csr-walk": {"structure": "csr", "kuhn": "off"},
               "scs-kuhn": {"structure": "scs", "kuhn": "auto"}}
MIG_CASES = {"world": (32, False, False), "neighbor": (32, True, False),
             "world-cap1": (1, False, False), "neighbor-cap1": (1, True, False),
             "neighbor-illegal": (32, True, True)}


def _mesh():
    return jgen.annulus_mesh(6, 32, 0.3, 1.0)


def _smap(mesh, f, n_in, out_specs):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(RANK_AXIS),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def _step_cfg(name):
    cfg, setup, gyro = STEP_ARMS[name]
    return dict(cfg=dict(num_ptcls=512, mdl_face=4, deg_per_push=40.0, **cfg),
                gyro=dict(rmax=0.05, num_rings=2, points_per_ring=4, **gyro),
                setup=setup)


def _cfg3(name):
    return dict(cfg=dict(num_ptcls=32 * R, distance=0.15, push_dir=(1.0, 0.7, 0.4),
                         use_locator=False, **STEP3D_ARMS[name]),
                setup=dict(use_lb=True))


@pytest.fixture(scope="module")
def jpp_mesh():
    coords, tris, cls = _mesh()
    owners = jpp.partition_rcb(coords, tris, R)
    pp = jpp.build_picparts(coords, tris, owners, R, jpp.PicPartsInput(), cls)
    return coords, tris, cls, owners, pp


@pytest.fixture(scope="module")
def inputs(jpp_mesh):
    coords, tris, cls, owners, pp = jpp_mesh
    counts = {0: (np.asarray(pp.vert_gid) >= 0).sum(1),
              1: (np.asarray(pp.side_gid) >= 0).sum(1),
              2: (np.asarray(pp.elem_gid) >= 0).sum(1)}
    fields = tr.reduce_fields(counts)
    eg, es, eo = (np.asarray(pp.elem_gid), np.asarray(pp.elem_safe),
                  np.asarray(pp.elem_owner))
    mig_cases = {}
    for name, (cap, nb, illegal) in MIG_CASES.items():
        st, ne, de = tr.migrate_inputs(eg, es, eo, illegal=illegal)
        mig_cases[name] = (st, ne, de, cap, nb)
    return dict(coords=coords, tris=tris, cls=cls, fields=fields,
                mig_cases=mig_cases, struct_layouts=tr.LAYOUTS, shrink_cap=56,
                step_cfgs=[_step_cfg(n) for n in STEP_ARMS],
                coords3=np.asarray(jgen.box_tet_mesh(4, 4, 4)[0]),
                tets=np.asarray(jgen.box_tet_mesh(4, 4, 4)[1]),
                cfg3s=[_cfg3(n) for n in STEP3D_ARMS])


@pytest.fixture(scope="module")
def ranks(inputs):
    return group.launch("torch_ranks:picparts_rank", R, inputs, timeout=420,
                        backend="gloo", device="cpu", extra_paths=[HERE])


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

BUILDS = {
    "bfs": (jpp.BufferMethod.BFS, 3, 1, 0, 2),
    "full": (jpp.BufferMethod.FULL, 3, 1, 0, 2),
    "minimum": (jpp.BufferMethod.MINIMUM, 3, 1, 0, 2),
    "none": (jpp.BufferMethod.NONE, 3, 1, 0, 2),
    "bfs-2-0": (jpp.BufferMethod.BFS, 2, 0, 0, 2),
    "edge-bridge": (jpp.BufferMethod.BFS, 3, 1, 1, 2),
    "3d": (jpp.BufferMethod.BFS, 2, 1, 0, 3),
    "3d-face-bridge": (jpp.BufferMethod.BFS, 2, 1, 2, 3),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_tables_match_jax(name):
    method, layers, safe, bridge, dim = BUILDS[name]
    if dim == 2:
        coords, tris, cls = _mesh()
        mesh_cls = jpp.Mesh2D
    else:
        coords, tris = jgen.box_tet_mesh(3, 3, 3)
        cls = None
        mesh_cls = jpp.Mesh3D
    owners = jpp.partition_rcb(coords, tris, R)
    np.testing.assert_array_equal(tpp.partition_rcb(coords, tris, R), owners)
    jinp = jpp.PicPartsInput(method, layers, safe, bridge)
    tinp = tpp.PicPartsInput(tpp.BufferMethod(method.value), layers, safe, bridge)
    j = jpp.build_picparts(coords, tris, owners, R, jinp, cls, mesh_cls=mesh_cls)
    t = tpp.build_picparts(coords, tris, owners, R, tinp, cls)
    names = tpp.TABLES + (tpp.TABLES_3D if dim == 3 else ())
    assert set(t.tables) == set(names)
    for k in names:
        np.testing.assert_array_equal(t.tables[k], np.asarray(getattr(j, k)), err_msg=k)
    np.testing.assert_array_equal(t.elem_safe, np.asarray(j.elem_safe))
    assert (t.nelems, t.nverts, t.num_core_elems) == (j.mesh.nelems, j.mesh.nverts,
                                                      j.num_core_elems)
    for r in range(R):
        lm = t.local_mesh(r, "cpu")
        E, V = t.local_nelems(r), t.local_nverts(r)
        for f in ("coords", "elem2verts", "walk_geom", "class_id", "elem_inv_basis"):
            np.testing.assert_array_equal(getattr(lm, f).numpy(),
                                          np.asarray(getattr(j.mesh, f)[r])[:E if f != "coords" else V],
                                          err_msg=f"{f} rank {r}")
        lv = t.local_view(r, "cpu")
        for d, gid in ((0, j.vert_gid), (dim, j.elem_gid), (dim - 1, j.side_gid)):
            assert lv.comm_array_size(d) == int((np.asarray(gid)[r] >= 0).sum())
            for a, b in zip(lv.comm_ids(d), j.comm_ids(d)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b)[r])


def test_partition_files_and_classification(tmp_path):
    coords, tris, cls = _mesh()
    owners = tpp.partition_rcb(coords, tris, R)
    tpp.write_ptn(str(tmp_path / "p.ptn"), owners)
    np.testing.assert_array_equal(tpp.read_ptn(str(tmp_path / "p.ptn")),
                                  jpp.read_ptn(str(tmp_path / "p.ptn")))
    c2r = {int(c): int(c) % R for c in np.unique(cls)}
    tpp.write_cpn(str(tmp_path / "p.cpn"), c2r)
    assert tpp.read_cpn(str(tmp_path / "p.cpn")) == jpp.read_cpn(str(tmp_path / "p.cpn")) == c2r
    np.testing.assert_array_equal(tpp.partition_from_classification(cls, c2r),
                                  jpp.partition_from_classification(cls, c2r))


def test_distributor_and_neighbor_plan_match_jax(jpp_mesh):
    coords, tris, cls, owners, pp = jpp_mesh
    tp = tpp.build_picparts(coords, tris, owners, R, tpp.PicPartsInput(), cls)
    jd, td = jdst.from_picparts(pp), tdst.from_picparts(tp)
    np.testing.assert_array_equal(td.is_neighbor, np.asarray(jd.is_neighbor))
    np.testing.assert_array_equal(tdst.world_distributor(R).is_neighbor,
                                  np.asarray(jdst.world_distributor(R).is_neighbor))
    jp, tpl = jmig.build_neighbor_plan(jd), tmig.build_neighbor_plan(td)
    np.testing.assert_array_equal(tpl.round_of_dest, np.asarray(jp.round_of_dest))
    np.testing.assert_array_equal(tpl.src_of_round, np.asarray(jp.src_of_round))
    assert (tpl.perms, tpl.num_rounds, tpl.max_out_degree) == (
        jp.perms, jp.num_rounds, jp.max_out_degree)


@pytest.mark.parametrize("which", ["annulus", "box"])
def test_native_matches_numpy(which):
    """The g++ library and its numpy counterparts: BFS layers, sbar maps,
    exchange lists and side dedup, equal."""
    assert native.path().startswith("g++"), native.path()
    if which == "annulus":
        coords, tris, cls = _mesh()
    else:
        coords, tris = jgen.box_tet_mesh(3, 3, 3)
        cls = None
    owners = tpp.partition_rcb(coords, tris, R)
    for layers in (1, 3):
        for r in range(R):
            a = native.bfs_layers_native(tris, coords.shape[0], owners == r, layers)
            b = native.bfs_layers_numpy(tris, coords.shape[0], owners == r, layers)
            np.testing.assert_array_equal(a, b)
    pp = tpp.build_picparts(coords, tris, owners, R, tpp.PicPartsInput(), cls)
    E_g = tris.shape[0]
    safe = np.zeros((R, E_g), np.uint8)
    for r in range(R):
        v = (pp.elem_gid[r] >= 0) & pp.elem_safe[r]
        safe[r, pp.elem_gid[r][v]] = 1
    (sa, ma), (sb, mb) = native.sbar_map_native(safe), native.sbar_map_numpy(safe)
    np.testing.assert_array_equal(sa, sb)
    assert len(ma) == len(mb) > 0 and all(np.array_equal(x, y) for x, y in zip(ma, mb))
    for gid, own, n in ((pp.vert_gid, pp.vert_owner, coords.shape[0]),
                        (pp.elem_gid, pp.elem_owner, E_g)):
        np.testing.assert_array_equal(native.exchange_lists_native(gid, own, n),
                                      native.exchange_lists_numpy(gid, own, n))
    sides = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]]), axis=1)
    for x, y in zip(native.unique_sides_native(sides), native.unique_sides_numpy(sides)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jreduce(jpp_mesh, inputs):
    coords, tris, cls, owners, pp = jpp_mesh
    mesh = make_device_mesh(R)
    sh = NamedSharding(mesh, P(RANK_AXIS))
    out = {}
    for d in (0, 1, 2):
        s, r = (jax.device_put(jnp.asarray(np.asarray(a)), sh) for a in pp.comm_ids(d))
        f, i = inputs["fields"][d]
        cases = [(op, f, jred.Op[op]) for op in tr.REDUCE_OPS] + [("MAXint", i, jred.Op.MAX)]
        if d == 0:
            cases.append(("SUMvec", inputs["fields"]["vec"], jred.Op.SUM))
        for name, fld, op in cases:
            run = _smap(mesh, lambda s_, r_, x_, op=op: jred.reduce_comm_array(
                s_[0], r_[0], x_[0], op)[None], 3, P(RANK_AXIS))
            out[(d, name)] = np.asarray(run(s, r, jax.device_put(jnp.asarray(fld), sh)))
    return out


REDUCE_CASES = [(d, op) for d in (0, 1, 2) for op in tr.REDUCE_OPS + ("MAXint",)] + [(0, "SUMvec")]


@pytest.mark.parametrize("d,op", REDUCE_CASES)
def test_reduce_comm_array_matches_jax(ranks, jreduce, d, op):
    want = jreduce[(d, op)]
    for r, out in enumerate(ranks):
        got = out["reduce"][(d, op)].numpy()
        np.testing.assert_array_equal(got, want[r][:len(got)], err_msg=f"rank {r}")


def test_reduce_sum_is_copy_count(ranks, jpp_mesh):
    """SUM of the float field equals the owner's value plus every copy's:
    every copy of a vertex holds the same value."""
    coords, tris, cls, owners, pp = jpp_mesh
    vg = np.asarray(pp.vert_gid)
    seen = {}
    for r, out in enumerate(ranks):
        for g, v in zip(vg[r][vg[r] >= 0], out["reduce"][(0, "SUM")].numpy()):
            assert seen.setdefault(g, v) == v


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def _jax_migrate(pp, case):
    st, ne, de, cap, nb = case
    mesh = make_device_mesh(R)
    sh = NamedSharding(mesh, P(RANK_AXIS))
    plan = jmig.build_neighbor_plan(jdst.from_picparts(pp)) if nb else None
    pp_d = jax.device_put(pp, sh)

    def f(pp_l, s, ne_, de_):
        lpp = jpp.local_view(pp_l)
        s = jpp.local_view(s)
        me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
        res = jmig.migrate(s, ne_[0], de_[0], lpp.elem_gid, lpp.elem_gid_sorted,
                           lpp.elem_gid_perm, me, R, cap, plan=plan)
        out = {k: jnp.asarray(getattr(res, k))[None] for k in res._fields if k != "state"}
        return jax.tree_util.tree_map(lambda a: a[None], res.state), out

    run = _smap(mesh, f, 4, (P(RANK_AXIS), P(RANK_AXIS)))
    args = [jax.device_put(jax.tree_util.tree_map(jnp.asarray, a), sh)
            for a in (st, ne, de)]
    state, stats = run(pp_d, *args)
    return ({k: np.asarray(v) for k, v in state.items()},
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.fixture(scope="module")
def jmigrate(jpp_mesh, inputs):
    pp = jpp_mesh[4]
    return {name: _jax_migrate(pp, case) for name, case in inputs["mig_cases"].items()}


@pytest.mark.parametrize("name", list(MIG_CASES))
def test_migrate_matches_jax(ranks, jmigrate, name):
    jstate, jstats = jmigrate[name]
    for r, out in enumerate(ranks):
        got = out["migrate"][name]
        assert set(got["state"]) == set(jstate)
        for k, v in got["state"].items():
            np.testing.assert_array_equal(v.numpy(), jstate[k][r], err_msg=f"{k} rank {r}")
        for k in jstats:
            assert int(got[k]) == int(jstats[k][r]), (k, r)
    cap, nb, illegal = MIG_CASES[name]
    if cap == 1:
        assert jstats["overflow"].any() and jstats["num_kept_home"].sum() > 0
    if illegal:
        assert jstats["num_illegal_dest"].sum() > 0


def test_neighbor_migrate_matches_world(ranks):
    for out in ranks:
        for a, b in (("world", "neighbor"), ("world-cap1", "neighbor-cap1")):
            x, y = out["migrate"][a], out["migrate"][b]
            for k in x["state"]:
                assert torch.equal(x["state"][k], y["state"][k]), k
            for k in ("num_sent", "num_recv", "overflow", "num_recv_unresolved",
                      "num_kept_home"):
                assert torch.equal(x[k], y[k]), k


def test_migrate_lossless_under_cap1(ranks, inputs):
    st = inputs["mig_cases"]["world-cap1"][0]
    before = sum(int((np.asarray(ne) >= 0).sum()) for ne in [inputs["mig_cases"]["world-cap1"][1]])
    after = sum(int(o["migrate"]["world-cap1"]["state"]["active"].sum()) for o in ranks)
    assert after == before
    pids = np.concatenate([o["migrate"]["world-cap1"]["state"]["pid"].numpy()[
        o["migrate"]["world-cap1"]["state"]["active"].numpy()] for o in ranks])
    assert len(np.unique(pids)) == len(pids) and st["pid"].size >= len(pids)


def test_single_rank_early_out():
    st, ne, de = tr.migrate_inputs(np.arange(40, dtype=np.int32)[None],
                                   np.zeros((1, 40), bool), np.zeros((1, 40), np.int32))
    s1 = {k: v[0] for k, v in st.items()}
    g = np.arange(40, dtype=np.int32)
    j = jmig.migrate({k: jnp.asarray(v) for k, v in s1.items()}, jnp.asarray(ne[0]),
                     jnp.asarray(de[0]), jnp.asarray(g), jnp.asarray(g), jnp.asarray(g),
                     jnp.int32(0), 1, 8)
    t = tmig.migrate({k: torch.as_tensor(v) for k, v in s1.items()}, torch.as_tensor(ne[0]),
                     torch.as_tensor(de[0]), torch.as_tensor(g), torch.as_tensor(g),
                     torch.as_tensor(g), 0, 1, 8)
    for k in s1:
        np.testing.assert_array_equal(t.state[k].numpy(), np.asarray(j.state[k]), err_msg=k)
    for k in t._fields[1:]:
        assert int(getattr(t, k)) == int(getattr(j, k)) == 0


@pytest.fixture(scope="module")
def jstruct(jpp_mesh):
    from pumipic_tpu.particles import CSR, DPS, CabM, SCSInput, SellCSigma

    coords, tris, cls, owners, pp = jpp_mesh
    mesh = make_device_mesh(R)
    sh = NamedSharding(mesh, P(RANK_AXIS))
    pp_d = jax.device_put(pp, sh)
    E_l = pp.mesh.nelems
    builders = {
        "dps": lambda e, f, c: DPS(E_l, e, fields=f, capacity=c),
        "csr": lambda e, f, c: CSR(E_l, e, fields=f, capacity=c),
        "cabm": lambda e, f, c: CabM(E_l, e, fields=f, capacity=c, soa_width=8),
        "scs": lambda e, f, c: SellCSigma(E_l, e, fields=f, capacity=c,
                                          scs_input=SCSInput(chunk_size=4, sigma=8)),
    }
    ins = tr.structure_inputs(np.asarray(pp.elem_gid), np.asarray(pp.elem_safe), R)
    out = {}
    for layout in tr.LAYOUTS:
        for nb in (False, True):
            plan = jmig.build_neighbor_plan(jdst.from_picparts(pp)) if nb else None
            ps = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
                builders[layout](sl, {"pos": jnp.asarray(pos), "pid": jnp.asarray(pids)},
                                 tr.STRUCT_CAP[layout]) for sl, pos, pids in ins])

            def f(pp_l, ps_s, plan=plan):
                lpp = jpp.local_view(pp_l)
                p = jpp.local_view(ps_s)
                me = jax.lax.axis_index(RANK_AXIS).astype(jnp.int32)
                dest = jmig.set_unsafe_procs(lpp.elem_safe, lpp.elem_owner, p.elem,
                                             p.active, me)
                p2, res = jmig.migrate_structure(p, p.elem, dest, lpp.elem_gid,
                                                 lpp.elem_gid_sorted, lpp.elem_gid_perm,
                                                 me, R, 32, plan=plan)
                st = {k: jnp.asarray(getattr(res, k))[None] for k in res._fields
                      if k != "state"}
                return jax.tree_util.tree_map(lambda a: a[None], p2), st

            p2, st = _smap(mesh, f, 2, (P(RANK_AXIS), P(RANK_AXIS)))(
                pp_d, jax.device_put(ps, sh))
            out[(layout, nb)] = (p2, {k: np.asarray(v) for k, v in st.items()})
    return out


@pytest.mark.parametrize("layout", tr.LAYOUTS)
@pytest.mark.parametrize("neighbor", [False, True])
def test_migrate_structure_matches_jax(ranks, jstruct, layout, neighbor):
    p2, jst = jstruct[(layout, neighbor)]
    for r, out in enumerate(ranks):
        h, st = out["struct"][(layout, neighbor)]
        jr = jax.tree_util.tree_map(lambda a, _r=r: a[_r], p2)
        jh = jr.copy_to_host()
        for k in ("elem", "active", "pid", "pos"):
            np.testing.assert_array_equal(h[k], jh[k], err_msg=f"{k} rank {r}")
        for k in ("elem_offsets", "row_to_elem"):
            a, b = h[k], getattr(jr, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
        assert bool(h["overflowed"]) == bool(jr.overflowed) is False
        for k in jst:
            assert int(st[k]) == int(jst[k][r]), (k, r)
    assert sum(int(jst["num_sent"][r]) for r in range(R)) > 0


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

def test_shrink_and_grow_capacity_match_jax(ranks, inputs):
    st = {k: v for k, v in inputs["mig_cases"]["world"][0].items() if v.ndim == 2}
    for key, cap in (("shrink", inputs["shrink_cap"]), ("grow", st["x"].shape[1] + 8)):
        j = jx.shrink_picparts_capacity({k: jnp.asarray(v) for k, v in st.items()}, cap)
        for r, out in enumerate(ranks):
            for k, v in out[key].items():
                np.testing.assert_array_equal(v.numpy(), np.asarray(j[k])[r],
                                              err_msg=f"{key} {k} rank {r}")
    with pytest.raises(ValueError):
        tcap.resize_capacity({k: torch.as_tensor(v[0]) for k, v in st.items()}, 4)


def test_capacity_monitor_recommendations_match_jax():
    for stats in ([(900, 10, 0)], [(100, 5, 0)] * 3, [(500, 40, 3)], [(950, 100, 0)]):
        jm, tm = jcap.CapacityMonitor(), tcap.CapacityMonitor()
        for alive, sent, kept in stats:
            s = {"alive_per_rank": np.array([alive, alive // 2]),
                 "sent_per_rank": np.array([sent, 0]), "kept_home": kept}
            jm.observe(s)
            tm.observe({k: torch.as_tensor(v) for k, v in s.items()})
        for cap in (64, 1000, 5000):
            assert tm.recommend(cap) == jm.recommend(cap)
    assert tcap.CapacityMonitor().recommend(10) is None


# ---------------------------------------------------------------------------
# banded route
# ---------------------------------------------------------------------------

def test_banded_route_matches_jax():
    from pumipic_tpu.mesh.locator import detect_annulus_structured as jdetect
    from pumipic_tpu.parallel import balancer as jlb
    from pumipic_torch.parallel import balancer as tlb

    coords, tris, cls = jgen.annulus_mesh(6, 48, 0.3, 1.0)
    ja = jdetect(coords, tris, cls=cls)
    ta = detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    owners = jbr.sector_band_owners(6, 48, R)
    np.testing.assert_array_equal(tbr.sector_band_owners(6, 48, R), owners)
    jp = jpp.build_picparts(coords, tris, owners, R, jpp.PicPartsInput(), cls)
    tp = tpp.build_picparts(coords, tris, owners, R, tpp.PicPartsInput(), cls)
    jb, tb = jbr.derive_banded_route(jp, owners, ja, jlb.build_balancer(jp, R), R), \
        tbr.derive_banded_route(tp, owners, ta, tlb.build_balancer(tp, R), R)
    assert jb is not None and tb is not None
    for f in ("win_a", "win_w", "win_w0", "win_nsa", "safe_a", "safe_len"):
        np.testing.assert_array_equal(getattr(tb, f), np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.sbar_runs, tb.n_sectors, tb.n_rings) == (jb.sbar_runs, jb.n_sectors, jb.n_rings)
    rng = np.random.default_rng(3)
    n = 4000
    ring = rng.integers(0, 6, n).astype(np.float32)
    sec = rng.integers(0, 48, n).astype(np.float32)
    tri = rng.integers(0, 2, n).astype(np.float32)
    valid, active = rng.random(n) < 0.95, rng.random(n) < 0.9
    for me in range(R):
        sc = tb.scalars(me)
        got = tbr.banded_decode(tb, *map(torch.as_tensor, (ring, sec, tri, valid, active)),
                                me, *sc)
        want = jbr.banded_decode(jb, *map(jnp.asarray, (ring, sec, tri, valid, active)),
                                 jnp.int32(me), *(jnp.float32(v) for v in sc))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # negatives: an RCB partition and a ragged window are not banded
    rcb = tpp.partition_rcb(coords, tris, R)
    tp2 = tpp.build_picparts(coords, tris, rcb, R, tpp.PicPartsInput(), cls)
    assert tbr.derive_banded_route(tp2, rcb, ta, None, R) is None
    assert tbr.derive_banded_route(tp, owners[:-2], ta, None, R) is None


# ---------------------------------------------------------------------------
# the steps end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jsteps(inputs):
    out = {}
    for name in STEP_ARMS:
        kw = _step_cfg(name)
        cfg = jx.XGCmConfig(**kw["cfg"], gyro=jx.GyroConfig(**kw["gyro"]))
        pp, s, _, step = jx.make_picparts_setup(inputs["coords"], inputs["tris"],
                                                inputs["cls"], cfg, make_device_mesh(R),
                                                **kw["setup"])
        hist = []
        for _ in range(3):
            s, fwd, st = step(s)
            hist.append(({k: np.asarray(v) for k, v in st.items()}, np.asarray(fwd)))
        out[name] = (hist, {k: np.asarray(v) for k, v in s.items()})
    return out


INT_FIELDS = ("elem", "active", "pid", "gelem")


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_step_2d_matches_jax(ranks, jsteps, arm):
    i = list(STEP_ARMS).index(arm)
    jhist, jstate = jsteps[arm]
    sent = 0
    for t in range(3):
        jst, jfwd = jhist[t]
        for r, out in enumerate(ranks):
            st, fwd = out["step"][i]["hist"][t]
            for k in jst:
                np.testing.assert_array_equal(st[k].numpy(), jst[k], err_msg=f"{k} step {t}")
            f = fwd.numpy()
            np.testing.assert_array_equal(f, jfwd[r][:len(f)], err_msg=f"fwd rank {r} step {t}")
            assert not jfwd[r][len(f):].any()
        sent += int(jst["sent"])
        for k in ("overflow", "unresolved", "illegal_dest"):
            assert int(jst[k]) == 0
    assert sent > 0
    for r, out in enumerate(ranks):
        s = out["step"][i]["state"]
        assert set(s) == set(jstate)
        for k, v in s.items():
            if k in INT_FIELDS:
                np.testing.assert_array_equal(v.numpy(), jstate[k][r], err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), jstate[k][r], rtol=0, atol=ATOL,
                                           err_msg=k)


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_step_2d_last_deposit_is_the_field_before_the_reduction(ranks, arm):
    """``step.last_deposit`` is the deposit as it was before the owner SUM
    (whose fan-out writes in place into its own output, never into the
    deposit): a tensor apart from the reduced field, and the ranks'
    deposits add up to the reduced field's owned vertices, exactly (every
    value a multiple of 1/P)."""
    i = list(STEP_ARMS).index(arm)
    for t in range(3):
        deposited = owned = 0.0
        for r, out in enumerate(ranks):
            dep, apart = out["step"][i]["deposits"][t]
            fwd = out["step"][i]["hist"][t][1]
            assert apart, (r, t)
            deposited += float(dep.double().sum())
            owned += float(fwd[out["step"][i]["vert_owner"][:len(fwd)] == r].double().sum())
        assert deposited == owned > 0, (t, deposited, owned)


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_step_2d_gives_up_the_input_states_member_fields(ranks, arm):
    """The 2D step's migration writes the arrivals into the input state's
    member field tensors on the CPU as kernel X3 does on the card: after a
    step the input state's ``b``, ``pid`` (and ``rg``) are the new state's
    tensors, so a caller reads the result only from the new state."""
    i = list(STEP_ARMS).index(arm)
    for r, out in enumerate(ranks):
        for t, fields in enumerate(out["step"][i]["given_up"]):
            assert fields and all(same and equal for same, equal in fields.values()), \
                (r, t, fields)


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_step_2d_exits_and_lost_add_up_to_the_jax_removals(ranks, jsteps, arm):
    """The port's own stats keys split each step's removals (the JAX step's
    alive counts give them) into boundary exits and particles lost off the
    picparts; the walk arms split them as the analytic arm, whose global
    locate is exact, does."""
    i, a = list(STEP_ARMS).index(arm), list(STEP_ARMS).index("analytic")
    jhist, _ = jsteps[arm]
    prev = _step_cfg(arm)["cfg"]["num_ptcls"]
    for t in range(3):
        st, sa = ranks[0]["step"][i]["hist"][t][0], ranks[0]["step"][a]["hist"][t][0]
        alive = int(jhist[t][0]["alive"])
        assert int(st["exits"]) + int(st["lost"]) == prev - alive, t
        assert (int(st["exits"]), int(st["lost"])) == (int(sa["exits"]), int(sa["lost"])), t
        prev = alive


def test_step_capacity_monitor(ranks):
    """The telemetry the steps report drives the monitor the same on every
    rank."""
    recs = {tuple(o["step"][i]["recommend"] for i in range(len(STEP_ARMS))) for o in ranks}
    assert len(recs) == 1


@pytest.fixture(scope="module")
def jsteps3d(inputs):
    out = {}
    for name in STEP3D_ARMS:
        kw = _cfg3(name)
        pp, ps, step = jpps.make_picparts_setup_3d(
            inputs["coords3"], inputs["tets"], jpps.PushSearchConfig(**kw["cfg"]),
            make_device_mesh(R), **kw["setup"])
        hist = []
        for _ in range(3):
            ps, st = step(ps)
            hist.append({k: np.asarray(v) for k, v in st.items()})
        out[name] = (hist, [jax.tree_util.tree_map(lambda a, _r=r: a[_r], ps).copy_to_host()
                            for r in range(R)])
    return out


@pytest.mark.parametrize("arm", list(STEP3D_ARMS))
def test_step_3d_matches_jax(ranks, jsteps3d, arm):
    i = list(STEP3D_ARMS).index(arm)
    jhist, jh = jsteps3d[arm]
    for t in range(3):
        for r, out in enumerate(ranks):
            st = out["step3d"][i]["hist"][t]
            for k in jhist[t]:
                np.testing.assert_array_equal(st[k].numpy(), jhist[t][k], err_msg=f"{k} {t}")
    assert sum(int(h["sent"]) for h in jhist) > 0
    for r, out in enumerate(ranks):
        h = out["step3d"][i]["h"]
        for k in ("elem", "active", "pid", "x"):
            np.testing.assert_array_equal(h[k], jh[r][k], err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("arm", list(STEP3D_ARMS))
def test_step_3d_loses_no_particle_off_the_picparts(ranks, jsteps3d, arm):
    """The 3D steps' removals (the JAX step's alive counts give them) are
    all boundary exits."""
    i = list(STEP3D_ARMS).index(arm)
    jhist, _ = jsteps3d[arm]
    prev = _cfg3(arm)["cfg"]["num_ptcls"]
    for t in range(3):
        st = ranks[0]["step3d"][i]["hist"][t]
        alive = int(jhist[t]["alive"])
        assert (int(st["exits"]), int(st["lost"])) == (prev - alive, 0), t
        prev = alive


def _equal_tree(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        x, y = (a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 \
            else (a, b)
        assert torch.equal(x, y), what
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_step_2d_over_slices_equals_flat(ranks, arm):
    """The 2D step over 2 slices of 2 ranks (the two-stage route for the
    migration's payload and the field's reduction) equals the flat step
    bit for bit: every step's stats and field, and the final state."""
    i = list(STEP_ARMS).index(arm)
    for r, out in enumerate(ranks):
        got, want = out["step_sliced"][i], out["step"][i]
        _equal_tree(got["hist"], want["hist"], f"{arm} rank {r}")
        _equal_tree(got["state"], want["state"], f"{arm} rank {r} state")
    assert sum(int(h[0]["sent"]) for h in ranks[0]["step"][i]["hist"]) > 0


@pytest.mark.parametrize("arm", list(STEP3D_ARMS))
def test_step_3d_over_slices_equals_flat(ranks, arm):
    i = list(STEP3D_ARMS).index(arm)
    for r, out in enumerate(ranks):
        got, want = out["step3d_sliced"][i], out["step3d"][i]
        _equal_tree(got["hist"], want["hist"], f"{arm} rank {r}")
        _equal_tree(got["h"], want["h"], f"{arm} rank {r} state")


def test_neighbor_plan_slice_split_matches_jax():
    """The multi-slice schedule colours the edges within a slice first, as
    the JAX package's does."""
    nb = np.zeros((8, 8), bool)
    for r in range(8):
        nb[r, [r, (r + 1) % 8, (r - 1) % 8, (r + 4) % 8]] = True
    sl = np.repeat(np.arange(2), 4)
    tp = tmig.build_neighbor_plan(tdst.Distributor(nb, 8), slice_of_rank=sl)
    jp = jmig.build_neighbor_plan(jdst.Distributor(is_neighbor=jnp.asarray(nb),
                                                   num_ranks=8), slice_of_rank=sl)
    np.testing.assert_array_equal(tp.round_of_dest, np.asarray(jp.round_of_dest))
    np.testing.assert_array_equal(tp.src_of_round, np.asarray(jp.src_of_round))
    assert (tp.num_rounds, tp.num_intra_rounds, tp.perms) == \
        (jp.num_rounds, jp.num_intra_rounds, jp.perms)
    assert tp.num_intra_rounds < tp.num_rounds
