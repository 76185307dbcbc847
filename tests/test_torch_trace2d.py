"""Parity of the port's 2D walk modes (kernel M2's plain version behind
``search_mesh_2d``, ``search_mesh_2d_accel``, ``check_initial_parents``,
``trace_particle_through_mesh`` and ``search_mesh_2d_pt``) with the JAX
reference, and of the port's mesh generators with the JAX package's.

Inputs are made from a seed with numpy and handed to both packages.  Meshes:
``rectangle_mesh(8, 8)``, ``disk_mesh(6, 24)`` and ``tokamak_mesh(8, 40)``
(with the reference's cartesian cell-row grid carried across), and the
flux-band grid of ``tokamak_mesh(24, 120)``.

Tolerances.  Element ids, ``iters``, ``all_found``, exit sides, hit counts
and recovered counts are equal; element ids may differ only where both
triangles contain the destination within the walk's BCC tolerance (a
shared-side tie: counted, and at most 0.5% of the walkers).  Destinations
(the mirrored ones of reflect, the projections of recover) and crossing
points atol 1e-6: XLA on the CPU contracts o + t·(d - o) and the mirror's
products into FMAs, an ulp apart.  Fewer than 1025 walkers, so the
reference runs no compaction pyramid and recovers every survivor as the
port does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.ops import search as j_se
from pumipic_torch import interop
from pumipic_torch.mesh import generate as t_gen
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.locator import build_locator_grid
from pumipic_torch.ops import search as t_se

ATOL = 1e-6
HANDLERS = {"remove": (j_se.remove_on_exit, t_se.remove_on_exit),
            "reflect": (j_se.reflect_on_exit_2d, t_se.reflect_on_exit_2d)}
MESHES = {"rect": lambda: t_gen.rectangle_mesh(8, 8),
          "disk": lambda: t_gen.disk_mesh(6, 24),
          "tokamak": lambda: t_gen.tokamak_mesh(8, 40)}


def _setup(name, seed):
    raw = MESHES[name]()
    jm = JMesh2D.from_arrays(*raw)
    tm = Mesh2D.from_arrays(*raw, device="cpu")
    assert np.array_equal(tm.walk_geom.numpy(), np.asarray(jm.walk_geom))
    jg = j_loc.build_locator_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                  cells_per_elem=4.0, walk_geom=jm.walk_geom, peel="rows")
    tg = interop.locator_from_numpy({f: np.asarray(getattr(jg, f))
                                     for f in interop.LOCATOR_FIELDS}, device="cpu")
    rng = np.random.default_rng(seed)
    n = 900
    e0 = rng.integers(0, jm.nelems, n).astype(np.int32)
    e0[:20] = rng.integers(-3, 0, 20)                  # garbage starts clamp
    cent = np.asarray(jm.elem_centroids)[np.clip(e0, 0, jm.nelems - 1)]
    span = np.ptp(np.asarray(jm.coords), axis=0).max()
    x0 = cent.astype(np.float32)
    xt = (cent + rng.normal(0, 0.25 * span, (n, 2))).astype(np.float32)  # many leave
    xt[20:80] = x0[20:80]                              # stationary walkers
    act = rng.uniform(size=n) < 0.93
    return dict(jm=jm, tm=tm, jg=jg, tg=tg, e0=e0, x0=x0, xt=xt, act=act)


@pytest.fixture(scope="module")
def meshes():
    return {name: _setup(name, 11 + i) for i, name in enumerate(MESHES)}


def _check_ids(tm, got, want, dest, bounded=True):
    """Ids equal except at shared-side ties (both triangles contain the
    point within the BCC tolerance), at most 0.5% of them when
    ``bounded``; returns the number of ties."""
    got, want = got.numpy(), np.asarray(want)
    bad = np.nonzero(got != want)[0]
    if bad.size:
        d = torch.from_numpy(np.asarray(dest)[bad]).unbind(1)
        for e in (got[bad], want[bad]):
            assert (e >= 0).all(), "an id differs where one side deleted the walker"
            rows = tm.walk_geom[torch.from_numpy(e).long()]
            assert bool(t_se.bary_inside(*rows[:, :6].unbind(1), *d)[3].all())
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
        np.testing.assert_allclose(tr.hit.numpy(),
                                   np.stack([np.asarray(h) for h in jr.hit_c], 1),
                                   rtol=0, atol=ATOL)
    else:
        assert tr.exit_side is None and tr.num_hits is None and tr.hit_c is None
    if recover == "project":
        assert int(tr.num_recovered) == int(jr.num_recovered)
    else:
        assert tr.num_recovered is None


def _args(s, x0=None, xt=None, e0=None, act=None):
    x0 = s["x0"] if x0 is None else x0
    xt = s["xt"] if xt is None else xt
    e0 = s["e0"] if e0 is None else e0
    act = s["act"] if act is None else act
    j = (jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(e0), jnp.asarray(act))
    t = (torch.from_numpy(x0), torch.from_numpy(xt), torch.from_numpy(e0),
         torch.from_numpy(act))
    return j, t


def _checks(s, tr, handler, record_exit, recover):
    if recover == "project":
        assert 0 < int(tr.num_recovered) and not bool(tr.all_found)
    else:
        assert bool(tr.all_found)
    if handler == "reflect" and recover == "off":
        # a reflecting wall keeps every active walker
        assert torch.equal(tr.active, torch.from_numpy(s["act"]))
    if handler == "remove" and record_exit and recover == "off":
        # lost = walkers with a real hit
        assert torch.equal(~tr.active & torch.from_numpy(s["act"]), tr.num_hits >= 1)
    if record_exit:
        hits = tr.num_hits > 0
        assert torch.equal(hits, tr.exit_side >= 0)
        assert recover == "project" or int(hits.sum()) > 0
        assert bool(s["tm"].side_is_exposed[tr.exit_side[hits].long()].all())


@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("mesh", ["rect", "disk"])
def test_search_mesh_2d_matches_reference(meshes, mesh, handler, record_exit, recover):
    """Every handler, exit record and recovery mode of the plain walk; with
    recovery a budget of 3 iterations leaves survivors to recover."""
    s = meshes[mesh]
    mi = 3 if recover == "project" else 200
    ja, ta = _args(s)
    jh, th = HANDLERS[handler]
    kw = dict(record_exit=record_exit, recover=recover)
    jr = j_se.search_mesh_2d(s["jm"], *ja, mi, boundary_handler=jh, **kw)
    tr = t_se.search_mesh_2d(s["tm"], *ta, mi, boundary_handler=th, **kw)
    _compare(s, jr, tr, record_exit, recover)
    _checks(s, tr, handler, record_exit, recover)


@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
def test_search_mesh_2d_accel_matches_reference(meshes, handler, record_exit, recover):
    """The peel form (the cell's two candidate rows, then a guess walk whose
    boundary hit retries from the previous triangle and is never a real
    hit), on the tokamak mesh's cartesian grid."""
    s = meshes["tokamak"]
    mi = 2 if recover == "project" else 200
    ja, ta = _args(s)
    jh, th = HANDLERS[handler]
    kw = dict(record_exit=record_exit, recover=recover)
    jr = j_se.search_mesh_2d_accel(s["jm"], s["jg"], *ja, mi, boundary_handler=jh,
                                   widths=None, **kw)
    tr = t_se.search_mesh_2d_accel(s["tm"], s["tg"], *ta, mi, boundary_handler=th, **kw)
    _compare(s, jr, tr, record_exit, recover)
    _checks(s, tr, handler, record_exit, recover)


def _permuted(jr, perm):
    """The JAX result's per-particle fields in the order ``perm``."""
    def p(a):
        return None if a is None else (tuple(c[perm] for c in a) if isinstance(a, tuple)
                                       else a[perm])
    return jr._replace(elem_ids=jr.elem_ids[perm], dest_c=p(jr.dest_c),
                       exit_side=p(jr.exit_side), hit_c=p(jr.hit_c), num_hits=p(jr.num_hits))


@pytest.mark.parametrize("case", ["reflect+record", "remove+record", "recover", "peel"])
def test_walk_result_does_not_depend_on_the_particle_order(meshes, case):
    """The port's walk of the particles in a random order gives the JAX
    package's result of the original order, permuted: a particle's walk
    depends on its own state alone, so kernel M2 may walk it whenever a
    warp's pool round takes it.  Reflect and remove with the exit record
    from the plain start, reflect with a budget of 3 and recovery, and the
    peel (reflect + record) on the tokamak mesh's cartesian grid."""
    s = meshes["tokamak" if case == "peel" else "disk"]
    perm = np.random.default_rng(23).permutation(len(s["e0"]))
    ja, _ = _args(s)
    _, ta = _args(s, *(s[k][perm] for k in ("x0", "xt", "e0", "act")))
    handler = "remove" if case == "remove+record" else "reflect"
    jh, th = HANDLERS[handler]
    record_exit = case != "recover"
    recover = "project" if case == "recover" else "off"
    mi = 3 if case == "recover" else 200
    kw = dict(record_exit=record_exit, recover=recover)
    if case == "peel":
        jr = j_se.search_mesh_2d_accel(s["jm"], s["jg"], *ja, mi, boundary_handler=jh,
                                       widths=None, **kw)
        tr = t_se.search_mesh_2d_accel(s["tm"], s["tg"], *ta, mi, boundary_handler=th, **kw)
    else:
        jr = j_se.search_mesh_2d(s["jm"], *ja, mi, boundary_handler=jh, **kw)
        tr = t_se.search_mesh_2d(s["tm"], *ta, mi, boundary_handler=th, **kw)
    _compare(s, _permuted(jr, perm), tr, record_exit, recover)
    _checks({**s, "act": s["act"][perm]}, tr, handler, record_exit, recover)


@pytest.fixture(scope="module")
def band():
    """tests/test_search.py's band mesh (tokamak_mesh(24, 120)) with the JAX
    package's flux-band grid carried across, and walkers some of whose
    destinations leave the domain."""
    raw = j_gen.tokamak_mesh(24, 120)
    jm = JMesh2D.from_arrays(*raw)
    tm = Mesh2D.from_arrays(*raw, device="cpu")
    jg = j_loc.detect_banded_locator(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     np.asarray(jm.class_id), jm.walk_geom)
    tg = interop.band_grid_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in interop.BAND_FIELDS}, device="cpu")
    rng = np.random.default_rng(9)
    n = 800
    e0 = rng.integers(0, jm.nelems, n).astype(np.int32)
    x0 = np.asarray(jm.elem_centroids)[e0].astype(np.float32)
    xt = (x0 * rng.uniform(0.9, 1.3, (n, 1))).astype(np.float32)
    act = np.ones(n, bool)
    return dict(jm=jm, tm=tm, jg=jg, tg=tg, e0=e0, x0=x0, xt=xt, act=act)


@pytest.mark.parametrize("handler", ["remove", "reflect"])
def test_band_peel_with_record_matches_reference(band, handler):
    """The flux-band grid's peel (kernel B's cells, then M2's walk) with the
    exit record, against the JAX package on the same band grid."""
    s = band
    ja, ta = _args(s)
    jh, th = HANDLERS[handler]
    jr = j_se.search_mesh_2d_accel(s["jm"], s["jg"], *ja, 200, boundary_handler=jh,
                                   record_exit=True)
    tr = t_se.search_mesh_2d_accel(s["tm"], s["tg"], *ta, 200, boundary_handler=th,
                                   record_exit=True)
    _compare(s, jr, tr, True, "off")
    assert int((tr.num_hits > 0).sum()) > 50


def test_reference_reflect_case():
    """tests/test_search.py's own case: [0.9, 0.52] -> [1.3, 0.52] across the
    x = 1 wall of rectangle_mesh(4, 4) mirrors to [0.7, 0.52], from the
    plain start and through the peel."""
    raw = t_gen.rectangle_mesh(4, 4)
    tm = Mesh2D.from_arrays(*raw, device="cpu")
    jm = JMesh2D.from_arrays(*j_gen.rectangle_mesh(4, 4))
    o, d = np.array([[0.9, 0.52]], np.float32), np.array([[1.3, 0.52]], np.float32)
    ja = (jnp.asarray(o), jnp.asarray(d), jnp.zeros(1, jnp.int32), jnp.ones(1, bool))
    ta = (torch.from_numpy(o), torch.from_numpy(d), torch.zeros(1, dtype=torch.int32),
          torch.ones(1, dtype=torch.bool))
    jr = j_se.search_mesh_2d(jm, *ja, boundary_handler=j_se.reflect_on_exit_2d,
                             record_exit=True)
    tr = t_se.search_mesh_2d(tm, *ta, boundary_handler=t_se.reflect_on_exit_2d,
                             record_exit=True)
    assert bool(tr.all_found) and int(tr.elem_ids[0]) == int(jr.elem_ids[0]) >= 0
    np.testing.assert_allclose(tr.dest.numpy()[0], [0.7, 0.52], atol=1e-5)
    np.testing.assert_allclose(tr.hit.numpy()[0], [1.0, 0.52], atol=1e-6)
    assert int(tr.num_hits[0]) == 1 and int(tr.exit_side[0]) == int(jr.exit_side[0])
    assert bool(tm.side_is_exposed[tr.exit_side[0]])
    tg = build_locator_grid(tm.coords.numpy(), tm.elem2verts.numpy(), cells_per_elem=4.0,
                            walk_geom=tm.walk_geom, peel="rows", device="cpu")
    ta_ = t_se.search_mesh_2d_accel(tm, tg, *ta, boundary_handler=t_se.reflect_on_exit_2d)
    assert torch.equal(ta_.elem_ids, tr.elem_ids)
    assert torch.equal(ta_.dest, tr.dest)


def test_reflect_restarts_at_the_crossing_point():
    """The 3bc9b4e regressions in 2D.  A walker mirrored off a wall goes on
    from the crossing point, not from its original origin: horizontal
    pushes to x in (2.05, 2.95) bounce off x = 1 and then x = 0, every walker is kept, each recorded crossing point lies on the
    wall at the walker's height, the destination is mirrored twice, and the
    reference agrees.  Zero-displacement walkers started at a wrong
    triangle (t's denominator 0) walk to their triangle with the handler
    and the record on, and record no hit."""
    raw = t_gen.rectangle_mesh(8, 8)
    jm, tm = JMesh2D.from_arrays(*raw), Mesh2D.from_arrays(*raw, device="cpu")
    rng = np.random.default_rng(7)
    n = 600
    e0 = rng.integers(0, tm.nelems, n).astype(np.int32)
    x0 = tm.elem_centroids.numpy()[e0]
    xt = x0.copy()
    xt[:, 0] = rng.uniform(2.05, 2.95, n).astype(np.float32)
    xt[:100] = x0[:100]                          # stationary ...
    e0[:100] = (e0[:100] + 37) % tm.nelems       # ... from a wrong start
    act = np.ones(n, bool)
    ja = (jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(e0), jnp.asarray(act))
    ta = (torch.from_numpy(x0), torch.from_numpy(xt), torch.from_numpy(e0),
          torch.from_numpy(act))
    jr = j_se.search_mesh_2d(jm, *ja, 400, boundary_handler=j_se.reflect_on_exit_2d,
                             record_exit=True)
    tr = t_se.search_mesh_2d(tm, *ta, 400, boundary_handler=t_se.reflect_on_exit_2d,
                             record_exit=True)
    _compare(dict(tm=tm), jr, tr, True, "off")
    assert bool(tr.all_found) and bool(tr.active.all())
    assert int(tr.num_hits[:100].max()) == 0            # the stationary ones: none
    assert bool((tr.num_hits[100:] == 2).all())         # x = 1, then x = 0
    d, h = tr.dest.numpy()[100:], tr.hit.numpy()[100:]
    np.testing.assert_allclose(h[:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(h[:, 1], x0[100:, 1], atol=1e-6)
    np.testing.assert_allclose(d[:, 0], xt[100:, 0] - 2.0, atol=1e-5)
    np.testing.assert_allclose(d[:, 1], x0[100:, 1], atol=1e-6)
    rows = tm.walk_geom[tr.elem_ids[:100].long()]
    assert bool(t_se.bary_inside(*rows[:, :6].unbind(1),
                                 *torch.from_numpy(x0[:100]).unbind(1))[3].all())


def test_recover_accepts_adjacent_strand_rejects_far():
    """tests/test_search.py's recovery case on rectangle_mesh(8, 8): with a
    budget of 1 the walker one hop away is recovered on its triangle, the
    far one stays deleted, as in the reference."""
    raw = t_gen.rectangle_mesh(8, 8)
    jm, tm = JMesh2D.from_arrays(*raw), Mesh2D.from_arrays(*raw, device="cpu")
    orig = np.array([[0.19, 0.05], [0.05, 0.05]], np.float32)
    tgt = np.array([[0.30, 0.05], [0.95, 0.95]], np.float32)
    one = np.ones(2, bool)
    e0 = t_se.search_mesh_2d(tm, torch.from_numpy(orig), torch.from_numpy(orig),
                             torch.zeros(2, dtype=torch.int32), torch.from_numpy(one)).elem_ids
    tr = t_se.search_mesh_2d(tm, torch.from_numpy(orig), torch.from_numpy(tgt), e0,
                             torch.from_numpy(one), max_iters=1, recover="project")
    jr = j_se.search_mesh_2d(jm, jnp.asarray(orig), jnp.asarray(tgt),
                             jnp.asarray(e0.numpy()), jnp.asarray(one), max_iters=1,
                             recover="project")
    assert int(tr.num_recovered) == int(jr.num_recovered) == 1
    assert int(tr.elem_ids[0]) == int(jr.elem_ids[0]) >= 0 and int(tr.elem_ids[1]) == -1
    np.testing.assert_allclose(tr.dest.numpy(), np.asarray(jr.dest), atol=ATOL)
    rows = tm.walk_geom[tr.elem_ids[:1].long()]
    assert bool(t_se.bary_inside(*rows[:, :6].unbind(1), *tr.dest[:1].unbind(1))[3].all())
    off = t_se.search_mesh_2d(tm, torch.from_numpy(orig), torch.from_numpy(tgt), e0,
                              torch.from_numpy(one), max_iters=1)
    assert int(off.elem_ids[0]) == -1 and not bool(off.all_found)


def test_reflect_tangents_mirror_equals_the_handler(meshes):
    """A mirror through a row of ``reflect_tangents`` (kernel M2's table)
    equals ``reflect_on_exit_2d`` bit for bit on every exposed edge; the
    table is kept on the mesh and rebuilt when ``coords`` is replaced."""
    tm = meshes["disk"]["tm"]
    sides = torch.nonzero(tm.side_is_exposed).flatten().to(torch.int32)
    rng = np.random.default_rng(3)
    d = tuple(torch.from_numpy(rng.uniform(-1.5, 1.5, (2, sides.numel())).astype(np.float32)))
    e = torch.zeros_like(sides)
    want = t_se.reflect_on_exit_2d(t_se.BoundaryCtx(e, sides, d, d, tm)).dest
    tab = t_se.reflect_tangents(tm)
    assert tab.shape == (tm.nedges, 4) and tab.dtype == torch.float32
    tx, ty, ax, ay = tab[sides.long()].unbind(1)
    adx, ady = d[0] - ax, d[1] - ay
    along = adx * tx + ady * ty
    got = (ax + 2 * along * tx - adx, ay + 2 * along * ty - ady)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert t_se.reflect_tangents(tm) is tab
    import dataclasses
    moved = dataclasses.replace(tm, coords=tm.coords * 2)
    assert not torch.equal(t_se.reflect_tangents(moved)[:, 2:], tab[:, 2:])


def test_trace_particle_through_mesh_all_2d_options(meshes):
    """The unified driver with every 2D option (parent repair, reflect,
    record, recovery) against the reference, and the single-point search."""
    s = meshes["disk"]
    rng = np.random.default_rng(5)
    claim = s["e0"].copy()
    claim[100:200] = rng.integers(0, s["tm"].nelems, 100)      # wrong parents
    ja, ta = _args(s, e0=claim)
    for recover, mi in (("off", 200), ("project", 3)):
        kw = dict(record_exit=True, validate_parents="repair", recover=recover)
        jr = j_se.trace_particle_through_mesh(
            s["jm"], *ja, mi, boundary_handler=j_se.reflect_on_exit_2d, **kw)
        tr = t_se.trace_particle_through_mesh(
            s["tm"], *ta, mi, boundary_handler=t_se.reflect_on_exit_2d, **kw)
        _compare(s, jr, tr, True, recover)
    pts = np.concatenate([s["x0"][:40], np.float32([[3.0, 3.0]])])
    for p, e in zip(pts, s["e0"][:41]):
        got = t_se.search_mesh_2d_pt(s["tm"], torch.from_numpy(p), int(e))
        want = j_se.search_mesh_2d_pt(s["jm"], jnp.asarray(p), int(e))
        assert got.shape == () and int(got) == int(want)
    assert int(t_se.search_mesh_2d_pt(s["tm"], [3.0, 3.0], 0)) == -1


def test_a_custom_handler_runs_the_protocol_on_the_cpu(meshes):
    """Any handler of the protocol runs in the plain walk on CPU tensors
    (the card knows only the two ported ones); the options' checks."""
    s = meshes["rect"]
    _, ta = _args(s)

    def remove_too(ctx):
        return t_se.remove_on_exit(ctx)

    remove_too.modifies_dest = False
    a = t_se.search_mesh_2d(s["tm"], *ta, 200, boundary_handler=remove_too)
    b = t_se.search_mesh_2d(s["tm"], *ta, 200)
    assert torch.equal(a.elem_ids, b.elem_ids) and int(a.iters) == int(b.iters)
    with pytest.raises(ValueError, match="segment origins"):
        t_se.trace_2d(s["tm"], None, ta[1], ta[2], ta[3], 8, record_exit=True)
    with pytest.raises(ValueError, match="recover"):
        t_se.search_mesh_2d(s["tm"], *ta, 8, recover="nearest")
    with pytest.raises(NotImplementedError):
        t_se.search_mesh_2d_accel(s["tm"], s["tg"], *ta, aux_capture=torch.zeros(1, 2))


@pytest.mark.parametrize("name", ["rectangle", "disk"])
def test_generators_equal_the_reference(name):
    """The port's numpy copies of rectangle_mesh and disk_mesh give the JAX
    package's arrays, array for array."""
    cases = {"rectangle": [(8, 8), (3, 5, 2.0, 0.5, -1.0, 0.25)],
             "disk": [(6, 24), (4, 8, 0.5, 0.1, -0.2)]}
    for args in cases[name]:
        got = getattr(t_gen, f"{name}_mesh")(*args)
        want = getattr(j_gen, f"{name}_mesh")(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
