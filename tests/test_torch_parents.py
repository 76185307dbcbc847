"""Parity of the port's parent check (kernel J's plain version,
``check_parents_plain``, behind ``check_initial_parents`` and
``trace_particle_through_mesh(validate_parents=...)``) and of the plain
walks in their sparse and in-place forms (kernel L's ``walk_locate`` on
column views and ``walk_locate_into``, kernel L3's ``walk_locate_3d_into``)
with the JAX reference; and of J's 2D table, ``parent_rows``, with the
``walk_geom`` rows it is cut from.

Inputs are made from a seed with numpy and handed to both packages: a disk
mesh (2D) and ``box_tet_mesh(4, 4, 4)`` (3D); claimed parents right, a
neighbour's, random, below 0 and at E or above; inactive particles; NaN and
±inf origins and points off the mesh; N = 0; int32 and int64 ids.
Tolerance: none.  Element ids, both counts, ``iters`` and ``all_found`` are
equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.mesh.core import Mesh3D as JMesh3D
from pumipic_tpu.ops import search as j_se
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.ops import search as t_se


@pytest.fixture(scope="module")
def meshes():
    coords, tris, cls = j_gen.disk_mesh(6, 24)
    jm2 = JMesh2D.from_arrays(coords, tris, cls)
    tm2 = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    jg2 = j_loc.build_locator_grid(np.asarray(jm2.coords), np.asarray(jm2.elem2verts),
                                   cells_per_elem=4.0, walk_geom=jm2.walk_geom)
    tg2 = interop.locator_from_numpy({f: np.asarray(getattr(jg2, f))
                                      for f in interop.LOCATOR_FIELDS}, device="cpu")
    jm3 = JMesh3D.from_arrays(*j_gen.box_tet_mesh(4, 4, 4))
    tm3 = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm3, f))
                                     for f in interop.MESH3D_FIELDS}, device="cpu")
    jg3 = j_loc.build_locator_grid_3d(np.asarray(jm3.coords), np.asarray(jm3.elem2verts),
                                      cells_per_elem=16.0, walk_geom=jm3.walk_geom,
                                      peel="rows")
    tg3 = interop.locator3d_from_numpy({f: np.asarray(getattr(jg3, f))
                                        for f in interop.LOCATOR3D_FIELDS}, device="cpu")
    return {2: (jm2, tm2, jg2, tg2), 3: (jm3, tm3, jg3, tg3)}


def _claims(jm, dim, n, seed):
    """Origins in random elements with claimed parents: right, a
    neighbour's index, random, below 0, at E or above; about a tenth
    inactive; NaN, +inf and -inf components and points off the mesh."""
    rng = np.random.default_rng(seed)
    ev, cz = np.asarray(jm.elem2verts), np.asarray(jm.coords)
    e = rng.integers(0, jm.nelems, n)
    w = rng.dirichlet(np.ones(dim + 1), n)
    pts = np.einsum("nk,nkd->nd", w, cz[ev[e]]).astype(np.float32)
    claim = e.copy()
    if n >= 400:
        claim[50:100] = np.maximum(e[50:100] - 1, 0)
        claim[100:150] = rng.integers(0, jm.nelems, 50)
        claim[150:170] = rng.integers(-5, 0, 20)
        claim[170:190] = jm.nelems + rng.integers(0, 5, 20)
        pts[190:200] = 3.0                                   # off the mesh
        pts[200:205] = np.nan
        pts[205:210, 0] = np.inf
        pts[210:215, dim - 1] = -np.inf
        pts[215, :] = np.inf
    act = rng.uniform(size=n) < 0.9
    return pts, claim, act


def _both(meshes, dim, pts, claim, act, mode, locator, dtype=np.int32, columns=False):
    jm, tm, jg, tg = meshes[dim]
    jr = j_se.check_initial_parents(jm, jnp.asarray(pts), jnp.asarray(claim.astype(np.int32)),
                                    jnp.asarray(act), mode=mode,
                                    locator=jg if locator else None)
    x = torch.from_numpy(pts)
    if columns:
        x = tuple(x.unbind(1))
    args = (tm, x, torch.from_numpy(claim.astype(dtype)), torch.from_numpy(act))
    kw = dict(mode=mode, locator=tg if locator else None)
    return jr, t_se.check_initial_parents(*args, **kw), t_se.check_parents_plain(*args, **kw)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("locator", [False, True])
@pytest.mark.parametrize("mode", ["delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_check_parents_plain_matches_reference(meshes, dim, mode, locator, dtype):
    pts, claim, act = _claims(meshes[dim][0], dim, 1200, 31 + dim)
    jr, tr, pr = _both(meshes, dim, pts, claim, act, mode, locator, dtype,
                       columns=dtype == np.int64)
    want = np.asarray(jr[0])
    for got in (tr, pr):
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert got[0].dtype == torch.int32
        assert int(got[1]) == int(jr[1]) and int(got[2]) == int(jr[2])
        assert got[1].dim() == 0 and got[2].dim() == 0
    # the cases reach every branch: bad parents, repairs and deletions
    assert int(tr[1]) > 100
    assert (want[~act] == -1).all()
    if mode == "repair":
        assert 0 < int(tr[2]) < int(tr[1])
    else:
        assert int(tr[2]) == 0
    # a NaN origin is always bad, and no repair walk finds it (an infinite
    # one can pass the test: its tolerance is infinite too)
    nan_pts = np.isnan(pts).any(1) & act
    assert nan_pts.any() and (want[nan_pts] == -1).all()


@pytest.mark.parametrize("mode", ["delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_check_parents_no_particles(meshes, dim, mode):
    _, tm, _, _ = meshes[dim]
    elem, nb, nr = t_se.check_initial_parents(
        tm, torch.zeros(0, dim), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool), mode=mode)
    assert elem.shape == (0,) and elem.dtype == torch.int32
    assert int(nb) == 0 and int(nr) == 0


@pytest.mark.parametrize("share", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("dim", [2, 3])
def test_check_parents_bad_shares_match_reference(meshes, dim, share):
    """Every particle good, 1% bad, every one bad: ids and counts equal."""
    jm = meshes[dim][0]
    pts, claim, act = _claims(jm, dim, 3000, 50 + dim)
    act[:] = True
    rng = np.random.default_rng(7)
    pick = rng.uniform(size=claim.size) < share
    claim[pick] = (claim[pick] + 1 + rng.integers(0, jm.nelems - 1, int(pick.sum()))) \
        % jm.nelems
    jr, tr, _ = _both(meshes, dim, pts, claim, act, "repair", False)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    assert int(tr[1]) == int(jr[1]) and int(tr[2]) == int(jr[2])


@pytest.mark.parametrize("validate", ["delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_trace_with_parent_check_matches_reference(meshes, dim, validate):
    jm, tm, _, _ = meshes[dim]
    pts, claim, act = _claims(jm, dim, 1200, 70 + dim)
    rng = np.random.default_rng(dim)
    tgt = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    jr = j_se.trace_particle_through_mesh(jm, jnp.asarray(pts), jnp.asarray(tgt),
                                          jnp.asarray(claim.astype(np.int32)),
                                          jnp.asarray(act), 100, validate_parents=validate)
    tr = t_se.trace_particle_through_mesh(tm, torch.from_numpy(pts), torch.from_numpy(tgt),
                                          torch.from_numpy(claim.astype(np.int32)),
                                          torch.from_numpy(act), 100,
                                          validate_parents=validate)
    np.testing.assert_array_equal(tr.elem_ids.numpy(), np.asarray(jr.elem_ids))
    assert int(tr.iters) == int(jr.iters) and bool(tr.all_found) == bool(jr.all_found)


def _sparse_walkers(jm, n, walkers, seed):
    """``walkers`` walkers among ``n`` slots: destinations in random
    triangles (some off the mesh, some NaN), starts random (some out of
    range, which the walk clamps)."""
    rng = np.random.default_rng(seed)
    ev, cz = np.asarray(jm.elem2verts), np.asarray(jm.coords)
    e = rng.integers(0, jm.nelems, n)
    w = rng.dirichlet(np.ones(3), n)
    dest = np.einsum("nk,nkd->nd", w, cz[ev[e]]).astype(np.float32)
    idx = rng.choice(n, walkers, replace=False)
    act = np.zeros(n, bool)
    act[idx] = True
    dest[idx[:20]] = rng.uniform(1.2, 2.0, (20, 2))        # off the mesh
    dest[idx[20:25]] = np.nan
    start = rng.integers(0, jm.nelems, n).astype(np.int32)
    start[idx[25:35]] = rng.integers(-4, 0, 10)
    start[idx[35:45]] = jm.nelems + 2
    return dest, start, act


@pytest.mark.parametrize("max_iters", [200, 6, 1, 0])
def test_sparse_plain_walk_matches_reference(meshes, max_iters):
    """A few hundred walkers among 10^5 slots: the plain walk on column
    views and in place against JAX ``search_mesh_2d`` on the same walkers;
    with a short budget some stop at the limit and are deleted."""
    jm, tm, _, _ = meshes[2]
    n = 100_000
    dest, start, act = _sparse_walkers(jm, n, 300, 11)
    jr = j_se.search_mesh_2d(jm, jnp.asarray(dest), jnp.asarray(dest), jnp.asarray(start),
                             jnp.asarray(act), max_iters)
    want = np.asarray(jr.elem_ids)
    x = torch.from_numpy(dest)
    e, a, iters, all_found = t_se.walk_locate(tm.walk_geom, *x.unbind(1),
                                              torch.from_numpy(start), torch.from_numpy(act),
                                              max_iters)
    np.testing.assert_array_equal(e.numpy(), want)
    assert torch.equal(a, e >= 0)
    assert int(iters) == int(jr.iters) and bool(all_found) == bool(jr.all_found)
    res = t_se.search_mesh_2d(tm, x, x, torch.from_numpy(start), torch.from_numpy(act),
                              max_iters)
    np.testing.assert_array_equal(res.elem_ids.numpy(), want)
    # the counts alone, as the picparts step's lost check takes them
    found, all_found2 = t_se.walk_locate_count(tm.walk_geom, *x.unbind(1),
                                               torch.from_numpy(start),
                                               torch.from_numpy(act), max_iters)
    assert int(found) == int((want >= 0).sum()) and found.dtype == torch.int32
    assert bool(all_found2) == bool(jr.all_found)
    # in place: the walkers' slots only, and the counts
    rng = np.random.default_rng(3)
    before = torch.from_numpy(rng.integers(-1, jm.nelems, n).astype(np.int32))
    elem, stats = before.clone(), torch.zeros(4, dtype=torch.int32)
    walkers = torch.from_numpy(act)
    t_se.walk_locate_into(tm.walk_geom, *x.unbind(1), torch.from_numpy(start), walkers,
                          max_iters, elem, stats)
    np.testing.assert_array_equal(elem.numpy()[act], want[act])
    assert torch.equal(elem[~walkers], before[~walkers])
    found = int((want[act] >= 0).sum())
    assert int(stats[2]) == found and int(stats[3]) == 0
    assert int(stats[0]) == int(jr.iters)
    assert (int(stats[1]) == 0) == bool(jr.all_found)
    if max_iters == 0:
        assert found == 0 and int(stats[1]) == 300
    if max_iters == 200:
        assert 0 < found < 300 and bool(jr.all_found) is False      # the NaN walkers


def test_walk_locate_refuses_other_devices():
    """The wrappers' device rule: CPU runs the plain versions, a device
    that is neither CPU nor CUDA raises."""
    geom = torch.zeros(1, 12, device="meta")
    f = torch.zeros(4, device="meta")
    e = torch.zeros(4, dtype=torch.int32, device="meta")
    a = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        t_se.walk_locate_into(geom, f, f, e, a, 4, e, torch.zeros(4, dtype=torch.int32,
                                                                   device="meta"))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("form", ["rows", "columns"])
@pytest.mark.parametrize("share", [0.0, 0.01, 1.0])
def test_check_parents_3d_repair_in_place_matches_reference(meshes, share, form, dtype):
    """The 3D repair as J's plain version and the plain walk in place
    (``walk_locate_3d_into_plain``), origins as (N, 3) rows or as column
    views: every particle good, 1% bad, every one bad; ids and counts equal
    the JAX function's, and a good particle keeps its parent."""
    jm = meshes[3][0]
    pts, claim, act = _claims(jm, 3, 3000, 90)
    act[:] = True
    pts[190:216] = pts[300:326]                   # no NaN, inf or off-mesh origin
    claim[:190] = np.arange(190) % jm.nelems      # every claim in range, ...
    jr0 = np.asarray(j_se.check_initial_parents(jm, jnp.asarray(pts),
                                                jnp.asarray(claim.astype(np.int32)),
                                                jnp.asarray(act), mode="delete")[0])
    claim[jr0 < 0] = np.asarray(j_se.search_mesh_3d(
        jm, jnp.asarray(pts), jnp.asarray(pts), jnp.zeros(claim.size, jnp.int32),
        jnp.asarray(jr0 < 0), 200).elem_ids)[jr0 < 0]          # ... and right
    rng = np.random.default_rng(11)
    pick = rng.uniform(size=claim.size) < share
    claim[pick] = (claim[pick] + 1 + rng.integers(0, jm.nelems - 1, int(pick.sum()))) \
        % jm.nelems
    jr, tr, pr = _both(meshes, 3, pts, claim, act, "repair", False, dtype,
                       columns=form == "columns")
    want = np.asarray(jr[0])
    for got in (tr, pr):
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert int(got[1]) == int(jr[1]) and int(got[2]) == int(jr[2])
    if share == 0.0:
        assert int(jr[1]) == 0 and (want == claim).all()
    else:
        assert int(jr[1]) >= int(pick.sum()) * 9 // 10 and int(jr[2]) > 0
    if share == 1.0:
        assert int(jr[1]) > 2900


def test_check_parents_3d_repair_no_particles(meshes):
    """N = 0 with the origin given as columns: no walk, no count."""
    _, tm, _, _ = meshes[3]
    for x in (torch.zeros(0, 3), tuple(torch.zeros(0, 3).unbind(1))):
        for fn in (t_se.check_initial_parents, t_se.check_parents_plain):
            elem, nb, nr = fn(tm, x, torch.zeros(0, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.bool), "repair")
            assert elem.shape == (0,) and elem.dtype == torch.int32
            assert int(nb) == 0 and int(nr) == 0


@pytest.mark.parametrize("max_iters", [200, 6, 1, 0])
def test_sparse_plain_walk_3d_in_place_matches_reference(meshes, max_iters):
    """Kernel L3's plain walk in place (``walk_locate_3d_into``, its plain
    version on the CPU) on column views: 300 walkers among 10^5 slots, some
    destinations off the mesh or NaN, some starts out of range; the
    walkers' slots equal JAX ``search_mesh_3d``'s ids on the same walkers,
    the other slots keep their values, and the counts add to what the
    stats held."""
    jm, tm, _, _ = meshes[3]
    n, w = 100_000, 300
    rng = np.random.default_rng(13)
    ev, cz = np.asarray(jm.elem2verts), np.asarray(jm.coords)
    e = rng.integers(0, jm.nelems, n)
    dest = np.einsum("nk,nkd->nd", rng.dirichlet(np.ones(4), n), cz[ev[e]]).astype(np.float32)
    idx = rng.choice(n, w, replace=False)
    act = np.zeros(n, bool)
    act[idx] = True
    dest[idx[:20]] = rng.uniform(1.2, 2.0, (20, 3))          # off the box
    dest[idx[20:25]] = np.nan
    start = rng.integers(0, jm.nelems, n).astype(np.int32)
    start[idx[25:35]] = rng.integers(-4, 0, 10)
    start[idx[35:45]] = jm.nelems + 2
    jr = j_se.search_mesh_3d(jm, jnp.asarray(dest), jnp.asarray(dest), jnp.asarray(start),
                             jnp.asarray(act), max_iters)
    want = np.asarray(jr.elem_ids)
    before = torch.from_numpy(rng.integers(-1, jm.nelems, n).astype(np.int32))
    elem = before.clone()
    stats = torch.tensor([0, 0, 0, 7], dtype=torch.int32)
    walkers = torch.from_numpy(act)
    t_se.walk_locate_3d_into(tm.walk_geom, *torch.from_numpy(dest).unbind(1),
                             torch.from_numpy(start), walkers, max_iters, elem, stats)
    np.testing.assert_array_equal(elem.numpy()[act], want[act])
    assert torch.equal(elem[~walkers], before[~walkers])
    found = int((want[act] >= 0).sum())
    assert int(stats[2]) == found and int(stats[3]) == 7
    assert int(stats[0]) == int(jr.iters)
    assert (int(stats[1]) == 0) == bool(jr.all_found)
    if max_iters == 0:
        assert found == 0 and int(stats[1]) == w
    if max_iters == 200:            # the off-box and NaN walkers are deleted
        assert 0 < found <= w - 25 and (want[idx[:25]] == -1).all()


def test_parent_rows_are_walk_geom_affine_rows(meshes):
    """J's 2D table: (E, 8) f32, ``walk_geom[:, :6]`` bit for bit and two
    zero pads; kept while ``walk_geom`` is unchanged, built again after an
    in-place write and for another ``walk_geom`` tensor."""
    import dataclasses

    tm = meshes[2][1]
    m = dataclasses.replace(tm, walk_geom=tm.walk_geom.clone())
    rows = t_se.parent_rows(m)
    assert rows.shape == (m.nelems, 8) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    assert torch.equal(rows[:, :6].view(torch.int32), m.walk_geom[:, :6].view(torch.int32))
    assert torch.equal(rows[:, 6:], torch.zeros(m.nelems, 2))
    assert t_se.parent_rows(m) is rows
    m.walk_geom[3, 4] = -2.5                     # written in place
    again = t_se.parent_rows(m)
    assert again is not rows and float(again[3, 4]) == -2.5
    assert torch.equal(again[:, :6], m.walk_geom[:, :6])
    other = dataclasses.replace(m, walk_geom=m.walk_geom.clone())   # another tensor
    assert t_se.parent_rows(other) is not again
    assert torch.equal(t_se.parent_rows(other), again)
