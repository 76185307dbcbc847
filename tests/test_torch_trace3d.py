"""Parity of the port's 3D walk modes (kernel M's plain version behind
``search_mesh_3d``, ``search_mesh_3d_accel``, ``check_initial_parents`` and
``trace_particle_through_mesh``) with the JAX reference.

Inputs are made from a seed with numpy and handed to both packages.  Two
meshes: ``box_tet_mesh(4, 4, 4)`` and the same box with its interior
vertices jittered into slivers (9 tets of quality below 0.05, the worst 0.004; none inverted).

Tolerances.  Element ids, ``iters``, ``all_found``, exit sides, hit counts
and recovered counts are equal; element ids may differ only where both tets
contain the destination within the walk's BCC tolerance (a shared-face tie:
counted, and at most 0.5% of the walkers).  Destinations (the mirrored
ones of reflect, the projections of recover) atol 1e-6; crossing points
atol 1e-6 (XLA contracts o + t·(d - o) into an FMA, an ulp apart).  Fewer
than 1025 walkers, so the reference runs no compaction pyramid and recovers
every survivor as the port does; one test pins the case where the pyramid
leaves survivors unrecovered.
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

ATOL = 1e-6
HANDLERS = {"remove": (j_se.remove_on_exit, t_se.remove_on_exit),
            "reflect": (j_se.reflect_on_exit_3d, t_se.reflect_on_exit_3d)}
METHODS = ("bcc", "hybrid", "intersection")


def _sliver_box():
    """box_tet_mesh(4, 4, 4) with interior vertices moved up to 0.45 of a
    cell: slivers, no inverted tet."""
    coords, tets = j_gen.box_tet_mesh(4, 4, 4)
    rng = np.random.default_rng(29)
    inner = np.all((coords > 1e-9) & (coords < 1 - 1e-9), axis=1)
    c2 = coords.copy()
    c2[inner] += rng.uniform(-0.45, 0.45, (int(inner.sum()), 3)) * 0.25
    return c2, tets


def _quality(coords, tets):
    """Each tet's volume over its longest edge cubed (1 for the regular
    tet), negative where the jitter inverted the generator's tet."""
    def signed(c):
        v = c[tets]
        return np.einsum("ij,ij->i", v[:, 1] - v[:, 0],
                         np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0])) / 6, v
    vol, v = signed(coords)
    vol = vol * np.sign(signed(j_gen.box_tet_mesh(4, 4, 4)[0])[0])
    edge = np.max([np.linalg.norm(v[:, i] - v[:, j], axis=1)
                   for i in range(4) for j in range(i + 1, 4)], axis=0)
    return vol / edge ** 3 * 6 * np.sqrt(2)


def _setup(raw, seed):
    jm = JMesh3D.from_arrays(*raw)
    tm = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm, f))
                                    for f in interop.MESH3D_FIELDS}, device="cpu")
    jg = j_loc.build_locator_grid_3d(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     cells_per_elem=16.0, walk_geom=jm.walk_geom,
                                     peel="rows")
    tg = interop.locator3d_from_numpy({f: np.asarray(getattr(jg, f))
                                       for f in interop.LOCATOR3D_FIELDS}, device="cpu")
    rng = np.random.default_rng(seed)
    n = 900
    e0 = rng.integers(0, jm.nelems, n).astype(np.int32)
    e0[:20] = rng.integers(-3, 0, 20)                  # garbage starts clamp
    cent = np.asarray(jm.elem_centroids)[np.clip(e0, 0, jm.nelems - 1)]
    x0 = cent.astype(np.float32)
    xt = (cent + rng.normal(0, 0.3, (n, 3))).astype(np.float32)   # many leave the box
    xt[20:80] = x0[20:80]                              # stationary walkers
    xt[80:120] = np.round(xt[80:120] * 4) / 4          # on lattice points
    act = rng.uniform(size=n) < 0.93
    return dict(jm=jm, tm=tm, jg=jg, tg=tg, e0=e0, x0=x0, xt=xt, act=act)


@pytest.fixture(scope="module")
def meshes():
    box = _setup(j_gen.box_tet_mesh(4, 4, 4), 11)
    raw = _sliver_box()
    q = _quality(*raw)
    assert q.min() > 0 and q.min() < 0.01          # slivers, none inverted
    return {"box": box, "slivers": _setup(raw, 12)}


def _check_ids(tm, got, want, dest, bounded=True):
    """Ids equal except at shared-face ties (both tets contain the point
    within the BCC tolerance), at most 0.5% of them when ``bounded``;
    returns the number of ties."""
    got, want = got.numpy(), np.asarray(want)
    bad = np.nonzero(got != want)[0]
    if bad.size:
        d = torch.from_numpy(np.asarray(dest)[bad]).unbind(1)
        for e in (got[bad], want[bad]):
            assert (e >= 0).all(), "an id differs where one side deleted the walker"
            rows = tm.walk_geom[torch.from_numpy(e).long()]
            assert bool(t_se.bary_inside_3d(rows[:, :12].unbind(1), *d)[4].all())
    assert not bounded or bad.size <= max(2, got.size // 200), bad.size
    return bad.size


def _compare(s, jr, tr, record_exit, recover):
    _check_ids(s["tm"], tr.elem_ids, jr.elem_ids, np.asarray(jr.dest))
    assert int(tr.iters) == int(jr.iters)
    assert bool(tr.all_found) == bool(jr.all_found)
    np.testing.assert_allclose(tr.dest.numpy(), np.asarray(jr.dest), rtol=0, atol=ATOL)
    assert torch.equal(tr.active, tr.elem_ids >= 0)
    if record_exit:
        np.testing.assert_array_equal(tr.exit_side.numpy(), np.asarray(jr.exit_side))
        np.testing.assert_array_equal(tr.num_hits.numpy(), np.asarray(jr.num_hits))
        np.testing.assert_allclose(torch.stack(tr.hit_c, 1).numpy(),
                                   np.stack([np.asarray(h) for h in jr.hit_c], 1),
                                   rtol=0, atol=ATOL)
    else:
        assert tr.exit_side is None and tr.num_hits is None and tr.hit_c is None
    if recover == "project":
        assert int(tr.num_recovered) == int(jr.num_recovered)
    else:
        assert tr.num_recovered is None


def _args(s):
    j = (jnp.asarray(s["x0"]), jnp.asarray(s["xt"]), jnp.asarray(s["e0"]),
         jnp.asarray(s["act"]))
    t = (torch.from_numpy(s["x0"]), torch.from_numpy(s["xt"]),
         torch.from_numpy(s["e0"]), torch.from_numpy(s["act"]))
    return j, t


@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", ["box", "slivers"])
def test_search_mesh_3d_matches_reference(meshes, mesh, method, handler, record_exit,
                                          recover):
    """Every core, handler, exit record and recovery mode of the plain walk;
    with recovery a budget of 3 iterations leaves survivors to recover."""
    s = meshes[mesh]
    mi = 3 if recover == "project" else 80
    ja, ta = _args(s)
    jh, th = HANDLERS[handler]
    kw = dict(method=method, record_exit=record_exit, recover=recover)
    jr = j_se.search_mesh_3d(s["jm"], *ja, mi, boundary_handler=jh, **kw)
    tr = t_se.search_mesh_3d(s["tm"], *ta, mi, boundary_handler=th, **kw)
    _compare(s, jr, tr, record_exit, recover)
    if recover == "project":
        assert 0 < int(tr.num_recovered) and not bool(tr.all_found)
    else:
        assert bool(tr.all_found)
    if handler == "reflect" and recover == "off":
        # a reflecting box keeps every active walker
        assert torch.equal(tr.active, torch.from_numpy(s["act"]))
    if record_exit:
        hits = tr.num_hits > 0
        assert int(hits.sum()) > 0 and torch.equal(hits, tr.exit_side >= 0)
        assert bool(s["tm"].side_is_exposed[tr.exit_side[hits].long()].all())


@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("method", METHODS)
def test_search_mesh_3d_accel_matches_reference(meshes, method, handler, record_exit):
    """The peel form (the cell's candidate pair, then a guess walk whose
    boundary hit retries from the previous tet and is never a real hit)."""
    s = meshes["box"]
    ja, ta = _args(s)
    jh, th = HANDLERS[handler]
    kw = dict(method=method, record_exit=record_exit)
    jr = j_se.search_mesh_3d_accel(s["jm"], s["jg"], *ja, 80, boundary_handler=jh,
                                   widths=None, **kw)
    tr = t_se.search_mesh_3d_accel(s["tm"], s["tg"], *ta, 80, boundary_handler=th, **kw)
    _compare(s, jr, tr, record_exit, "off")
    # and the walk from the plain start ends in the same tets, but where a
    # point lies on a shared face or vertex (the 40 lattice points: ties)
    plain = t_se.search_mesh_3d(s["tm"], *ta, 80, boundary_handler=th, **kw)
    _check_ids(s["tm"], tr.elem_ids, plain.elem_ids.numpy(), plain.dest.numpy(),
               bounded=False)


@pytest.mark.parametrize("method", METHODS)
def test_accel_recover_matches_reference(meshes, method):
    s = meshes["slivers"]
    ja, ta = _args(s)
    jr = j_se.search_mesh_3d_accel(s["jm"], s["jg"], *ja, 2, widths=None, method=method,
                                   recover="project")
    tr = t_se.search_mesh_3d_accel(s["tm"], s["tg"], *ta, 2, method=method,
                                   recover="project")
    _compare(s, jr, tr, False, "project")


def test_fast_case_stays_on_kernel_l3s_walk(meshes):
    """BCC + remove + no record + no recovery is kernel L3's walk; its result
    equals kernel M's plain version of the same walk."""
    s = meshes["box"]
    _, ta = _args(s)
    fast = t_se.search_mesh_3d(s["tm"], *ta, 80)
    m = t_se.trace_3d_plain(s["tm"], ta[0], ta[1], ta[2], ta[3], 80)
    assert fast.exit_side is None and fast.num_recovered is None
    assert torch.equal(fast.elem_ids, m.elem_ids) and int(fast.iters) == int(m.iters)
    fast_a = t_se.search_mesh_3d_accel(s["tm"], s["tg"], *ta, 80)
    m_a = t_se.trace_3d_plain(s["tm"], ta[0], ta[1], ta[2], ta[3], 80, grid=s["tg"])
    assert torch.equal(fast_a.elem_ids, m_a.elem_ids) and int(fast_a.iters) == int(m_a.iters)


def test_a_custom_handler_runs_the_protocol_on_the_cpu(meshes):
    """Any handler of the protocol runs in the plain walk on CPU tensors
    (the card knows only the two ported ones)."""
    s = meshes["box"]
    _, ta = _args(s)

    def remove_too(ctx):
        return t_se.remove_on_exit(ctx)

    remove_too.modifies_dest = False
    a = t_se.search_mesh_3d(s["tm"], *ta, 80, boundary_handler=remove_too,
                            method="hybrid")
    b = t_se.search_mesh_3d(s["tm"], *ta, 80, method="hybrid")
    assert torch.equal(a.elem_ids, b.elem_ids) and int(a.iters) == int(b.iters)
    with pytest.raises(ValueError, match="segment origins"):
        t_se.trace_3d(s["tm"], None, ta[1], ta[2], ta[3], 8, method="intersection")
    with pytest.raises(ValueError, match="recover"):
        t_se.search_mesh_3d(s["tm"], *ta, 8, recover="nearest")


@pytest.mark.parametrize("method", ["intersection", "hybrid"])
def test_stationary_walkers_from_wrong_parent_3d(method):
    """The reference's regression (tests/test_search.py): zero-displacement
    walkers started at a wrong tet must walk to the containing tet; the
    intersection core must not declare a stationary walker inside, and the
    hybrid core's falling rate is the directional derivative, exactly 0."""
    coords, tets = j_gen.box_tet_mesh(5, 5, 5)
    jm = JMesh3D.from_arrays(coords, tets)
    tm = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm, f))
                                    for f in interop.MESH3D_FIELDS}, device="cpu")
    rng = np.random.default_rng(23)
    n = 1024
    e_true = rng.integers(0, jm.nelems, n)
    w = rng.dirichlet([2, 2, 2, 2], n)
    pts = np.einsum("nk,nkd->nd", w, np.asarray(jm.coords)[
        np.asarray(jm.elem2verts)[e_true]]).astype(np.float32)
    e_wrong = ((e_true + 137) % jm.nelems).astype(np.int32)
    act = np.ones(n, bool)
    tr = t_se.search_mesh_3d(tm, torch.from_numpy(pts), torch.from_numpy(pts),
                             torch.from_numpy(e_wrong), torch.from_numpy(act), 300,
                             method=method)
    assert bool(tr.all_found)
    ids = tr.elem_ids.long()
    rows = tm.walk_geom[ids]
    assert bool(t_se.bary_inside_3d(rows[:, :12].unbind(1),
                                    *torch.from_numpy(pts).unbind(1))[4].all())
    jr = j_se.search_mesh_3d(jm, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(e_wrong),
                             jnp.asarray(act), 300, method=method)
    _check_ids(tm, tr.elem_ids, jr.elem_ids, pts)
    assert int(tr.iters) == int(jr.iters)


def test_pyramid_recover_difference_is_pinned():
    """The reference recovers loop-limit survivors only on its deepest
    compaction level (a TPU artefact, search.py:860-887); survivors that do
    not fit it are deleted.  3000 walkers, each one face away from its
    start, with a budget of 1: every one survives the limit in the tet that
    contains its destination.  The reference (widths (1024,)) recovers the
    first 1024 in slot order and deletes the rest; the port recovers all,
    the same tets and points where the reference recovers."""
    coords, tets = j_gen.box_tet_mesh(5, 5, 5)
    jm = JMesh3D.from_arrays(coords, tets)
    tm = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm, f))
                                    for f in interop.MESH3D_FIELDS}, device="cpu")
    rng = np.random.default_rng(3)
    geom = np.asarray(jm.walk_geom)
    ev, cz = np.asarray(jm.elem2verts), np.asarray(jm.coords).astype(np.float64)
    n = 3000
    e0 = rng.integers(0, jm.nelems, 4 * n)
    k = rng.integers(0, 4, 4 * n)
    nbr = geom[e0, 12 + k].astype(np.int64)
    keep = np.nonzero(nbr >= 0)[0][:n]
    e0, k, nbr = e0[keep], k[keep], nbr[keep]
    face = np.stack([cz[ev[e0, j]] for j in range(4)], 1)             # (n, 4, 3)
    fc = (face.sum(1) - face[np.arange(n), k]) / 3                     # face centroid
    cn = cz[ev[nbr]].mean(1)
    dest = (fc + 0.3 * (cn - fc)).astype(np.float32)
    orig = face.mean(1).astype(np.float32)
    act = np.ones(n, bool)
    jr = j_se.search_mesh_3d(jm, jnp.asarray(orig), jnp.asarray(dest),
                             jnp.asarray(e0.astype(np.int32)), jnp.asarray(act), 1,
                             recover="project")
    tr = t_se.search_mesh_3d(tm, torch.from_numpy(orig), torch.from_numpy(dest),
                             torch.from_numpy(e0.astype(np.int32)), torch.from_numpy(act),
                             1, recover="project")
    assert int(tr.num_recovered) == n and bool(tr.all_found)
    assert np.array_equal(tr.elem_ids.numpy(), nbr.astype(np.int32))
    # the reference's all_found reads only the deepest level: True, though
    # it deleted the 1976 survivors that did not fit there
    assert int(jr.num_recovered) == 1024 and bool(jr.all_found)
    je = np.asarray(jr.elem_ids)
    rec = je >= 0
    assert rec.sum() == 1024 and np.array_equal(np.nonzero(rec)[0], np.arange(1024))
    np.testing.assert_array_equal(tr.elem_ids.numpy()[rec], je[rec])
    np.testing.assert_allclose(tr.dest.numpy()[rec], np.asarray(jr.dest)[rec], atol=ATOL)


# ---------------------------------------------------------------------------
# check_initial_parents and trace_particle_through_mesh
# ---------------------------------------------------------------------------

def _mesh2d():
    coords, tris, cls = j_gen.disk_mesh(6, 24)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    tm = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    jg = j_loc.build_locator_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                  cells_per_elem=4.0, walk_geom=jm.walk_geom)
    tg = interop.locator_from_numpy({f: np.asarray(getattr(jg, f))
                                     for f in interop.LOCATOR_FIELDS}, device="cpu")
    return jm, tm, jg, tg


def _parents(jm, dim, seed):
    """Points in random elements, with claimed parents: right, a neighbour
    (wrong), random (wrong), out of range; some inactive, some points off
    the mesh."""
    rng = np.random.default_rng(seed)
    n = 800
    ev, cz = np.asarray(jm.elem2verts), np.asarray(jm.coords)
    e = rng.integers(0, jm.nelems, n)
    w = rng.dirichlet(np.ones(dim + 1), n)
    pts = np.einsum("nk,nkd->nd", w, cz[ev[e]]).astype(np.float32)
    claim = e.copy()
    claim[100:200] = np.maximum(e[100:200] - 1, 0)
    claim[200:300] = rng.integers(0, jm.nelems, 100)
    claim[300:320] = -1
    claim[320:340] = jm.nelems + 7
    pts[340:360] = 3.0                                  # off the mesh
    act = rng.uniform(size=n) < 0.9
    return pts, claim.astype(np.int32), act


@pytest.mark.parametrize("locator", [False, True])
@pytest.mark.parametrize("mode", ["delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_check_initial_parents_matches_reference(meshes, dim, mode, locator):
    if dim == 2:
        jm, tm, jg, tg = _mesh2d()
    else:
        s = meshes["box"]
        jm, tm, jg, tg = s["jm"], s["tm"], s["jg"], s["tg"]
    pts, claim, act = _parents(jm, dim, 7 + dim)
    je, jb, jrep = j_se.check_initial_parents(
        jm, jnp.asarray(pts), jnp.asarray(claim), jnp.asarray(act), mode=mode,
        locator=jg if locator else None)
    te, tb, trep = t_se.check_initial_parents(
        tm, torch.from_numpy(pts), torch.from_numpy(claim), torch.from_numpy(act),
        mode=mode, locator=tg if locator else None)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(tb) == int(jb) and int(trep) == int(jrep)
    assert int(tb) > 100
    if mode == "repair":
        assert int(trep) > 100 and int(trep) < int(tb)      # off-mesh origins deleted
    # the tuple-of-components form gives the same
    te2, _, _ = t_se.check_initial_parents(
        tm, tuple(torch.from_numpy(pts).unbind(1)), torch.from_numpy(claim),
        torch.from_numpy(act), mode=mode, locator=tg if locator else None)
    assert torch.equal(te, te2)
    with pytest.raises(ValueError):
        t_se.check_initial_parents(tm, torch.from_numpy(pts), torch.from_numpy(claim),
                                   torch.from_numpy(act), mode="fix")


@pytest.mark.parametrize("validate", ["off", "delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_trace_particle_through_mesh_matches_reference(meshes, dim, validate):
    if dim == 2:
        jm, tm, _, _ = _mesh2d()
    else:
        jm, tm = meshes["box"]["jm"], meshes["box"]["tm"]
    pts, claim, act = _parents(jm, dim, 20 + dim)
    pts = pts[:340]
    claim, act = claim[:340], act[:340]
    rng = np.random.default_rng(dim)
    tgt = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    jr = j_se.trace_particle_through_mesh(
        jm, jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(claim), jnp.asarray(act), 100,
        validate_parents=validate)
    tr = t_se.trace_particle_through_mesh(
        tm, torch.from_numpy(pts), torch.from_numpy(tgt), torch.from_numpy(claim),
        torch.from_numpy(act), 100, validate_parents=validate)
    np.testing.assert_array_equal(tr.elem_ids.numpy(), np.asarray(jr.elem_ids))
    assert int(tr.iters) == int(jr.iters) and bool(tr.all_found) == bool(jr.all_found)
    if dim == 3:
        tr3 = t_se.trace_particle_through_mesh(
            tm, torch.from_numpy(pts), torch.from_numpy(tgt), torch.from_numpy(claim),
            torch.from_numpy(act), 100, boundary_handler=t_se.reflect_on_exit_3d,
            record_exit=True, validate_parents=validate)
        jr3 = j_se.trace_particle_through_mesh(
            jm, jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(claim), jnp.asarray(act),
            100, boundary_handler=j_se.reflect_on_exit_3d, record_exit=True,
            validate_parents=validate)
        np.testing.assert_array_equal(tr3.elem_ids.numpy(), np.asarray(jr3.elem_ids))
        np.testing.assert_array_equal(tr3.num_hits.numpy(), np.asarray(jr3.num_hits))
    else:
        # the 2D reflect, record_exit and recovery run (kernel M2's plain
        # version) and match the reference
        for kw in (dict(record_exit=True), dict(recover="project")):
            tr2 = t_se.trace_particle_through_mesh(
                tm, torch.from_numpy(pts), torch.from_numpy(tgt),
                torch.from_numpy(claim), torch.from_numpy(act), 100,
                boundary_handler=t_se.reflect_on_exit_2d, validate_parents=validate, **kw)
            jr2 = j_se.trace_particle_through_mesh(
                jm, jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(claim),
                jnp.asarray(act), 100, boundary_handler=j_se.reflect_on_exit_2d,
                validate_parents=validate, **kw)
            np.testing.assert_array_equal(tr2.elem_ids.numpy(), np.asarray(jr2.elem_ids))
            np.testing.assert_allclose(tr2.dest.numpy(), np.asarray(jr2.dest), atol=ATOL)
            if "record_exit" in kw:
                np.testing.assert_array_equal(tr2.num_hits.numpy(),
                                              np.asarray(jr2.num_hits))
            else:
                assert int(tr2.num_recovered) == int(jr2.num_recovered)
