"""Parity of the port's 3D search (kernel L3's plain version behind
``search_mesh_3d`` and ``search_mesh_3d_accel``) and of its
pseudoPushAndSearch app with the JAX reference, the refused options, the
locator policy and the bench entry point's pps3d arms on the CPU.

Tolerances: none.  Element ids, ``iters``, ``all_found``, alive counts,
pids and structure arrays are equal, and so are the pushed positions: the
port repeats the reference's f32 operations in its order.  The Kuhn and
walk arms are compared with each other on one step: their ids are equal
except at points that both tets contain within the walk's tolerance
(counted)."""
import dataclasses as dc
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh3D as JMesh3D
from pumipic_tpu.models import pseudo_push_and_search as jp
from pumipic_tpu.ops import search as j_se
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.models import pseudo_push_and_search as tp
from pumipic_torch.ops import search as t_se

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STRUCT_ARRAYS = ("elem", "active", "num_ptcls", "overflowed", "elem_offsets",
                 "row_to_elem", "elem_to_row", "seg_cap")


@pytest.fixture(scope="module")
def box():
    """box_tet_mesh(4, 4, 4) in both packages, the reference's cpe-16 grid
    (its "rows" peel) carried across, and 20k walkers: random previous
    tets, destinations scattered around them (some leave the box)."""
    coords, tets = j_gen.box_tet_mesh(4, 4, 4)
    jm = JMesh3D.from_arrays(coords, tets)
    jg = j_loc.build_locator_grid_3d(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     cells_per_elem=16.0, walk_geom=jm.walk_geom,
                                     peel="rows")
    tm = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm, f))
                                    for f in interop.MESH3D_FIELDS}, device="cpu")
    tg = interop.locator3d_from_numpy({f: np.asarray(getattr(jg, f))
                                       for f in interop.LOCATOR3D_FIELDS}, device="cpu")
    rng = np.random.default_rng(11)
    n = 20_000
    e0 = rng.integers(-1, jm.nelems + 3, n).astype(np.int32)    # some garbage
    act = rng.uniform(size=n) < 0.9
    cent = np.asarray(jm.elem_centroids)[np.clip(e0, 0, jm.nelems - 1)]
    xt = (cent + rng.normal(0, 0.25, (n, 3))).astype(np.float32)
    xt[:500] = np.round(xt[:500] * 4) / 4              # exact lattice points
    return dict(jm=jm, jg=jg, tm=tm, tg=tg, e0=e0, act=act, x0=cent.astype(np.float32),
                xt=xt)


@pytest.mark.parametrize("max_iters", [100, 8, 2, 1])
@pytest.mark.parametrize("accel", [True, False])
def test_search_mesh_3d_matches_reference(box, accel, max_iters):
    j_args = (jnp.asarray(box["x0"]), jnp.asarray(box["xt"]), jnp.asarray(box["e0"]),
              jnp.asarray(box["act"]), max_iters)
    t_args = (torch.from_numpy(box["x0"]), torch.from_numpy(box["xt"]),
              torch.from_numpy(box["e0"]), torch.from_numpy(box["act"]), max_iters)
    if accel:
        jr = j_se.search_mesh_3d_accel(box["jm"], box["jg"], *j_args, widths=None)
        tr = t_se.search_mesh_3d_accel(box["tm"], box["tg"], *t_args)
    else:
        jr = j_se.search_mesh_3d(box["jm"], *j_args, widths=None)
        tr = t_se.search_mesh_3d(box["tm"], *t_args)
    np.testing.assert_array_equal(tr.elem_ids.numpy(), np.asarray(jr.elem_ids))
    assert int(tr.iters) == int(jr.iters)
    assert bool(tr.all_found) == bool(jr.all_found)
    np.testing.assert_array_equal(tr.dest.numpy(), np.asarray(jr.dest))
    assert torch.equal(tr.active, tr.elem_ids >= 0)
    # the walkers deleted at the limit, counted by kernel L3's plain version
    unf = t_se.walk_locate_3d(box["tm"].walk_geom, tr.dest, t_args[2], t_args[3],
                              max_iters, grid=box["tg"] if accel else None)[4]
    assert (int(unf) == 0) == bool(tr.all_found)
    if max_iters == 100:
        assert bool(tr.all_found)
    elif max_iters == 1 and accel:
        assert not bool(tr.all_found) and int(unf) > 0       # the peel misses some


def test_search_accepts_component_tuples_and_widths(box):
    t = torch.from_numpy(box["xt"])
    args = (torch.from_numpy(box["e0"]), torch.from_numpy(box["act"]), 64)
    a = t_se.search_mesh_3d_accel(box["tm"], box["tg"], None, t, *args)
    b = t_se.search_mesh_3d_accel(box["tm"], box["tg"], None, tuple(t.unbind(1)),
                                  *args, widths=(4096, 256))
    assert torch.equal(a.elem_ids, b.elem_ids) and int(a.iters) == int(b.iters)


@pytest.mark.parametrize("what", ["hybrid", "intersection", "reflect", "record_exit",
                                  "recover", "check_initial_parents", "trace",
                                  "no rows", "wall reflect"])
def test_refused_options_raise_not_implemented(box, what):
    """What the port still refuses raises NotImplementedError: the 3D peel
    without cell rows ("no rows").  The options this test once refused run
    now, in 3D (their parity with the reference is in
    tests/test_torch_trace3d.py and tests/test_torch_gitr.py) and in 2D
    (the reflect, record_exit, recovery and the unified driver with them:
    tests/test_torch_trace2d.py): each returns a valid result here."""
    t = torch.from_numpy(box["xt"][:10])
    e = torch.zeros(10, dtype=torch.int32)
    a = torch.ones(10, dtype=torch.bool)
    args = (t, t, e, a)
    m2 = Mesh2D.from_arrays(*j_gen.disk_mesh(2, 8), device="cpu")
    x2 = torch.full((10, 2), 0.1)
    args2 = (x2, x2, e, a)
    runs = {
        "hybrid": lambda: t_se.search_mesh_3d(box["tm"], *args, method="hybrid"),
        "intersection": lambda: t_se.search_mesh_3d_accel(
            box["tm"], box["tg"], *args, method="intersection"),
        "reflect": lambda: t_se.search_mesh_3d(
            box["tm"], *args, boundary_handler=t_se.reflect_on_exit_3d),
        "record_exit": lambda: t_se.search_mesh_3d(box["tm"], *args, record_exit=True),
        "recover": lambda: t_se.search_mesh_3d_accel(box["tm"], box["tg"], *args,
                                                     recover="project"),
        "check_initial_parents": lambda: t_se.check_initial_parents(box["tm"], t, e, a),
        "trace": lambda: t_se.trace_particle_through_mesh(box["tm"], *args),
        "wall reflect": lambda: tp.PseudoPushAndSearch(
            box["tm"], tp.PushSearchConfig(num_ptcls=10, wall="reflect"), device="cpu"),
    }
    runs_2d = {
        "reflect": lambda: t_se.search_mesh_2d(
            m2, *args2, boundary_handler=t_se.reflect_on_exit_2d),
        "record_exit": lambda: t_se.search_mesh_2d(m2, *args2, record_exit=True),
        "recover": lambda: t_se.search_mesh_2d(m2, *args2, recover="project"),
        "trace": lambda: t_se.trace_particle_through_mesh(m2, *args2, record_exit=True),
    }
    still_refused = {
        "no rows": lambda: t_se.search_mesh_3d_accel(
            box["tm"], dc.replace(box["tg"], cell_rows=None), *args),
    }
    if what in runs:
        out = runs[what]()
        if isinstance(out, t_se.SearchResult):
            assert out.elem_ids.shape == (10,) and bool(out.all_found)
    if what in runs_2d:
        out = runs_2d[what]()
        assert out.elem_ids.shape == (10,) and bool(out.all_found)
        assert bool((out.elem_ids >= 0).all())          # (0.1, 0.1) is in the disk
        assert out.dest.shape == (10, 2)
        if what in ("record_exit", "trace"):
            assert int(out.num_hits.sum()) == 0 and bool((out.exit_side == -1).all())
    if what in still_refused:
        with pytest.raises(NotImplementedError):
            still_refused[what]()


def test_config_fields_and_policy_match_reference():
    def fields(cls):
        return {f.name: f.default for f in dc.fields(cls)}
    assert fields(tp.PushSearchConfig) == fields(jp.PushSearchConfig)
    for nelems, n in ((384, 5000), (24_576, 10_000_000), (200_000, 10_000_000)):
        for kw in ({}, {"cells_per_elem": 2.0, "peel": "rows_ab"}, {"widths": (64,)}):
            assert tp.resolve_locator_policy_3d(tp.PushSearchConfig(**kw), nelems, n) \
                == jp.resolve_locator_policy_3d(jp.PushSearchConfig(**kw), nelems, n)


def test_config_checks():
    m = Mesh3D.from_arrays(*j_gen.box_tet_mesh(2, 2, 2), device="cpu")
    for kw in (dict(structure="aos"), dict(wall="bounce"), dict(peel="bogus"),
               dict(kuhn="force", wall="reflect")):
        with pytest.raises(ValueError):
            tp.PseudoPushAndSearch(m, tp.PushSearchConfig(num_ptcls=10, **kw), device="cpu")
    jel = j_gen.box_tet_mesh(2, 2, 2)
    coords = jel[0].copy()
    coords[13] += 0.01                     # the centre vertex: not a Kuhn box
    with pytest.raises(ValueError, match="Kuhn"):
        tp.PseudoPushAndSearch(Mesh3D.from_arrays(coords, jel[1], device="cpu"),
                               tp.PushSearchConfig(num_ptcls=10, kuhn="force"),
                               device="cpu")


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

def _pair(raw, **kw):
    jm = JMesh3D.from_arrays(*raw)
    japp = jp.PseudoPushAndSearch(jm, jp.PushSearchConfig(**kw))
    tapp = tp.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device="cpu"),
                                  tp.PushSearchConfig(**kw), device="cpu")
    return japp, tapp


def _assert_same(jps, tps, where):
    for k in STRUCT_ARRAYS:
        a, b = getattr(jps, k), getattr(tps, k)
        assert (a is None) == (b is None), (where, k)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{where} {k}")
    assert sorted(tps.fields) == sorted(jps.fields)
    for k in tps.fields:
        np.testing.assert_array_equal(tps.fields[k].numpy(), np.asarray(jps.fields[k]),
                                      err_msg=f"{where} {k}")
    assert tps.capacity == jps.capacity, where


@pytest.mark.parametrize("kuhn", ["auto", "off"])
@pytest.mark.parametrize("wall", ["remove", "periodic"])
@pytest.mark.parametrize("structure", ["scs", "csr", "cabm", "dps"])
def test_app_matches_reference(structure, wall, kuhn):
    """Three steps of the reference's app and the port's, each from its own
    seeding: every structure array, x and pid equal after each step."""
    kw = dict(num_ptcls=4000, structure=structure, wall=wall, kuhn=kuhn,
              max_search_iters=64)
    japp, tapp = _pair(j_gen.box_tet_mesh(4, 4, 4), **kw)
    assert (tapp.kuhn is None) == (kuhn == "off")
    assert (tapp.locator is None) == (kuhn != "off")
    _assert_same(japp.ptcls, tapp.ptcls, "setup")
    jps, tps = japp.ptcls, tapp.ptcls
    for i in range(3):
        jps, jit = japp._step(jps)
        tps, tit = tapp.step_fn(tps)
        _assert_same(jps, tps, f"step {i}")
        assert int(tit) == int(jit)
        assert int(tps.num_ptcls) == int(tps.active.sum()) and not bool(tps.overflowed)
    alive = int(tps.num_ptcls)
    assert alive == 4000 if wall == "periodic" else 0 < alive < 4000


@pytest.mark.parametrize("structure", ["scs", "cabm"])
def test_app_reshuffle_rebuild_matches_reference(structure):
    kw = dict(num_ptcls=4000, structure=structure, wall="periodic",
              rebuild_mode="auto", max_search_iters=64)
    japp, tapp = _pair(j_gen.box_tet_mesh(3, 3, 3), **kw)
    _assert_same(japp.ptcls, tapp.ptcls, "setup")
    jps, tps = japp.ptcls, tapp.ptcls
    for i in range(3):
        jps, _ = japp._step(jps)
        tps, _ = tapp.step_fn(tps)
        _assert_same(jps, tps, f"step {i}")


def test_app_without_locator_and_on_an_unstructured_mesh_matches_reference():
    raw = j_gen.box_tet_mesh(3, 3, 3)
    coords = raw[0].copy()
    inner = np.all((coords > 1e-9) & (coords < 1 - 1e-9), axis=1)
    coords[inner] += np.random.default_rng(2).uniform(-0.03, 0.03, (inner.sum(), 3))
    for raw_, kw in (((coords, raw[1]), {}), (raw, dict(kuhn="off", use_locator=False))):
        japp, tapp = _pair(raw_, num_ptcls=3000, structure="csr", max_search_iters=64,
                           **kw)
        assert tapp.kuhn is None
        jps, tps = japp.ptcls, tapp.ptcls
        for i in range(3):
            jps, jit = japp._step(jps)
            tps, tit = tapp.step_fn(tps)
            _assert_same(jps, tps, f"step {i}")
            assert int(tit) == int(jit)


def test_app_run_history():
    m = Mesh3D.from_arrays(*j_gen.box_tet_mesh(2, 2, 2), device="cpu")
    app = tp.PseudoPushAndSearch(m, tp.PushSearchConfig(num_ptcls=500, distance=0.4),
                                 device="cpu")
    hist = app.run(10, verbose=True)
    assert hist == sorted(hist, reverse=True) and len(hist) <= 10
    assert hist[-1] == 0 or len(hist) == 10


def test_kuhn_and_walk_arms_agree_except_at_shared_faces():
    """One step from the same structure: the walk's ids equal the analytic
    locate's, except where the destination lies within the walk's
    containment tolerance of both tets (a shared face); those are counted."""
    m = Mesh3D.from_arrays(*j_gen.box_tet_mesh(4, 4, 4), device="cpu")
    kw = dict(num_ptcls=20_000, wall="periodic", structure="dps", max_search_iters=64)
    ka = tp.PseudoPushAndSearch(m, tp.PushSearchConfig(**kw), device="cpu")
    wa = tp.PseudoPushAndSearch(m, tp.PushSearchConfig(kuhn="off", **kw), device="cpu")
    pk, _ = ka.step_fn(ka.ptcls)
    pw, _ = wa.step_fn(ka.ptcls)
    ek, ew = pk.elem.numpy(), pw.elem.numpy()
    assert torch.equal(pk.fields["x"], pw.fields["x"])
    bad = np.nonzero(ek != ew)[0]
    geom = m.walk_geom.numpy().astype(np.float64)
    x = pk.fields["x"].numpy().astype(np.float64)
    for p in bad:
        for e in (ek[p], ew[p]):
            g = geom[e]
            l = [g[4 * k:4 * k + 3] @ x[p] + g[4 * k + 3] for k in range(3)]
            assert min(*l, 1.0 - sum(l)) >= -1e-5, (p, e)
    assert len(bad) <= 0.001 * ek.size
    assert int(pw.num_ptcls) == 20_000


def test_bench_torch_pps3d_runs_on_cpu(capsys):
    """bench_torch's pps3d mode, Kuhn and walk arms, at a small size on the
    CPU: bench.py's keys and tags, all particles alive (periodic wall)."""
    sys.path.insert(0, REPO)
    import bench_torch

    before = set(os.listdir(REPO))
    for kuhn, tag in (("auto", "pps3d-dps"), ("off", "pps3d-dps-walk")):
        rec, state, fields = bench_torch.main(
            device="cpu", num_ptcls=3000, iters=2, mode="pps3d", mesh_elems=200,
            kuhn=kuhn)
        d = rec["detail"]
        assert rec["metric"].startswith("pseudoPushAndSearch")
        assert d["tag"] == tag + "-0M" and d["impl"] == "torch"
        assert d["mesh_elems"] == 6 * 3 ** 3 and d["alive"] == 3000
        assert (d["iters"] == 0) == (kuhn == "auto")
        assert int(state.num_ptcls) == 3000
    assert bench_torch.pps3d_tag(10_000_000, "scs", "auto", "off") == "pps3d-scs-auto-walk"
    assert set(os.listdir(REPO)) == before


def _entry_points_3d():
    from pumipic_torch.mesh import locator as t_loc
    from pumipic_torch.ops import push as t_push

    coords, tets = j_gen.box_tet_mesh(2, 2, 2)
    cls = np.ones(tets.shape[0], np.int64)
    return {
        "Mesh3D.from_arrays": lambda m: Mesh3D.from_arrays(coords, tets),
        "PseudoPushAndSearch": lambda m: tp.PseudoPushAndSearch(
            m, tp.PushSearchConfig(num_ptcls=10)),
        "build_locator_grid_3d": lambda m: t_loc.build_locator_grid_3d(coords, tets),
        "detect_box_kuhn": lambda m: t_loc.detect_box_kuhn(coords, tets),
        "RotTable.build": lambda m: t_push.RotTable.build(cls, 15.0),
        "mesh3d_from_numpy": lambda m: interop.mesh3d_from_numpy(
            {f: getattr(m, f).numpy() for f in interop.MESH3D_FIELDS}),
    }


@pytest.mark.parametrize("entry", list(_entry_points_3d()))
def test_entry_points_raise_without_a_device_and_cuda(entry, monkeypatch):
    """With no device named and no CUDA device, the new entry points raise
    (telling the caller to pass device="cpu") rather than run on the CPU."""
    mesh = Mesh3D.from_arrays(*j_gen.box_tet_mesh(2, 2, 2), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points_3d()[entry](mesh)


# ---------------------------------------------------------------------------
# what kernel L3's design relies on: order independence and the id pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_iters", [64, 3, 1])
@pytest.mark.parametrize("accel", [True, False])
def test_walk_plain_is_independent_of_particle_order(box, accel, max_iters):
    """Kernel L3 walks a block's walkers in the order they fall into its
    pool: the plain version on a permuted particle order returns the
    permuted results with the same iters and num_unfinished."""
    wg = box["tm"].walk_geom
    args = (torch.from_numpy(box["xt"]), torch.from_numpy(box["e0"]),
            torch.from_numpy(box["act"]))
    grid = box["tg"] if accel else None
    want = t_se.walk_locate_3d_plain(wg, *args, max_iters, grid)
    perm = torch.from_numpy(np.random.default_rng(max_iters).permutation(len(box["e0"])))
    got = t_se.walk_locate_3d_plain(wg, *(a[perm] for a in args), max_iters, grid)
    assert torch.equal(got[0], want[0][perm]) and torch.equal(got[1], want[1][perm])
    for k in (2, 3, 4):
        assert int(got[k]) == int(want[k])
    if max_iters == 1:
        assert int(want[4]) > 0                      # walkers deleted at the limit


def _assert_pair_matches_rows(grid, walk_geom):
    rows = grid.cell_rows.numpy()
    pair = grid.candidate_ids(torch.from_numpy(np.array(walk_geom, np.float32)))
    ids = pair.numpy()
    assert pair.dtype == torch.int32 and ids.shape == (rows.shape[0], 2)
    np.testing.assert_array_equal(ids[:, 0], rows[:, 12].astype(np.int32))
    np.testing.assert_array_equal(ids[:, 1], rows[:, 25].astype(np.int32))
    geom = np.asarray(walk_geom, np.float32)
    for c, (lo, hi) in enumerate(((0, 12), (13, 25))):
        np.testing.assert_array_equal(geom[ids[:, c], 0:12].view(np.int32),
                                      rows[:, lo:hi].view(np.int32))


@pytest.mark.parametrize("source", ["port pps3d grid", "reference grid via interop"])
def test_cell_id_pair_equals_rows_bit_for_bit(box, source):
    """The (n_cells, 2) pair that kernel L3 reads equals the rows' id
    columns 12 and 25, and walk_geom at those ids equals the rows' affine
    columns bit for bit: for the port's own pps3d grid (the app's policy)
    and for the JAX package's attach_cell_rows_3d grid carried across."""
    if source == "port pps3d grid":
        m = Mesh3D.from_arrays(*j_gen.box_tet_mesh(4, 4, 4), device="cpu")
        app = tp.PseudoPushAndSearch(m, tp.PushSearchConfig(num_ptcls=1000, kuhn="off"),
                                     device="cpu")
        grid, wg = app.locator, m.walk_geom.numpy()
    else:
        wg = np.asarray(box["jm"].walk_geom)
        grid = interop.locator3d_from_numpy(
            {f: np.asarray(getattr(box["jg"], f)) for f in interop.LOCATOR3D_FIELDS},
            device="cpu")
        assert torch.equal(grid.cell_rows, box["tg"].cell_rows)
    _assert_pair_matches_rows(grid, wg)


def _tampered_rows(box, tamper):
    rows = box["tg"].cell_rows.clone()
    c = rows.shape[0] // 2
    if tamper == "affine A":
        rows[c, 5] = torch.nextafter(rows[c, 5], torch.tensor(np.inf))
    elif tamper == "affine B":
        rows[c, 20] = -rows[c, 20] if rows[c, 20] != 0 else 1.0
    elif tamper == "id A":
        rows[c, 12] = (rows[c, 12] + 1) % box["tm"].nelems
    else:
        rows[c, 25] = float(box["tm"].nelems)
    return rows


@pytest.mark.parametrize("tamper", ["affine A", "affine B", "id A", "id B out of range"])
def test_cell_id_pair_check_raises_on_a_tampered_row(box, tamper):
    rows = _tampered_rows(box, tamper)
    box["tg"].candidate_ids(box["tm"].walk_geom)          # the untampered grid
    with pytest.raises(ValueError, match="bit for bit"):
        dc.replace(box["tg"], cell_rows=rows).candidate_ids(box["tm"].walk_geom)


@pytest.mark.parametrize("change", ["same tensors", "rows replaced", "rows written",
                                    "another walk_geom", "walk_geom written",
                                    "an equal walk_geom"])
def test_cell_id_pair_is_kept_only_for_the_tensors_it_was_checked_against(box, change):
    """The checked pair is kept on the grid for its cell_rows and walk_geom
    tensors as they were: a grid from dataclasses.replace, another
    walk_geom, or either tensor written in place since, is checked again
    (and raises where the candidates no longer match)."""
    grid = dc.replace(box["tg"], cell_rows=box["tg"].cell_rows.clone())
    wg = box["tm"].walk_geom.clone()
    ids = grid.candidate_ids(wg)
    c = int(ids[ids.shape[0] // 2, 0])
    other = wg.clone()
    other[c, 5] = torch.nextafter(other[c, 5], torch.tensor(np.inf))
    if change == "same tensors":
        assert grid.candidate_ids(wg) is ids
    elif change == "an equal walk_geom":
        got = grid.candidate_ids(wg.clone())
        assert got is not ids and torch.equal(got, ids)
    else:
        if change == "rows replaced":
            grid = dc.replace(grid, cell_rows=_tampered_rows(box, "affine A"))
        elif change == "rows written":
            grid.cell_rows[ids.shape[0] // 2, 5] += 1.0
        elif change == "another walk_geom":
            wg = other
        else:
            wg.copy_(other)
        with pytest.raises(ValueError, match="bit for bit"):
            grid.candidate_ids(wg)
