"""Parity of the port's search (pumipic_torch.ops.search, kernel L's
module) with the JAX reference: the plain walk, the cell-row peel + guess
walk on the cartesian and on the flux-band grid, and the probes that held
the reference (garbage start elements, max_iters=1 deletion, boundary
exits).

Element ids must be equal, except for a counted number of mismatches, each
of whose destination lies within BCC_REL_TOL-scaled tolerance of both
elements (i.e. on a side they share).  ``iters`` and ``all_found`` must be
equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.locator import build_locator_grid as j_build_grid
from pumipic_tpu.ops import search as j_se
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.locator import build_locator_grid
from pumipic_torch.ops import search as t_se

# mismatches allowed per 10,000 walkers (observed: none on this mesh)
MAX_MISMATCH_PER_10K = 5


@pytest.fixture(scope="module")
def setup():
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    jg = j_build_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                      cells_per_elem=16.0, walk_geom=jm.walk_geom, peel="rows")
    g = build_locator_grid(m.coords.numpy(), m.elem2verts.numpy(),
                           cells_per_elem=16.0, walk_geom=m.walk_geom, peel="rows", device="cpu")
    return jm, m, jg, g


def _points_in(m, elems, rng):
    """Uniform points inside the given elements (f32), as the model seeds."""
    c = m.coords.numpy().astype(np.float64)
    ev = m.elem2verts.numpy()[elems]
    r1, r2 = rng.uniform(size=(2, len(elems)))
    over = r1 + r2 > 1
    r1[over], r2[over] = 1 - r1[over], 1 - r2[over]
    a, b, cc = c[ev[:, 0]], c[ev[:, 1]], c[ev[:, 2]]
    return (a + r1[:, None] * (b - a) + r2[:, None] * (cc - a)).astype(np.float32)


def _near_both(m, e1, e2, x, y):
    """Whether (x, y) lies within a loose multiple of the containment
    tolerance of both elements (a shared side or vertex)."""
    g = m.walk_geom.numpy().astype(np.float64)
    for e in (e1, e2):
        r = g[e]
        l1 = r[0] * x + r[1] * y + r[2]
        l2 = r[3] * x + r[4] * y + r[5]
        m1 = abs(r[0] * x) + abs(r[1] * y) + abs(r[2])
        m2 = abs(r[3] * x) + abs(r[4] * y) + abs(r[5])
        tol = 4 * (t_se.BCC_REL_TOL * (m1 + m2) + 2 * t_se.BCC_ABS_TOL)
        if min(l1, l2, 1.0 - l1 - l2) < -tol:
            return False
    return True


def _check_ids(m, ref, got, x, y):
    ref, got = np.asarray(ref), got.numpy()
    bad = np.nonzero(ref != got)[0]
    assert len(bad) <= MAX_MISMATCH_PER_10K * max(len(ref), 10_000) / 10_000, \
        f"{len(bad)} element-id mismatches"
    for i in bad:
        assert ref[i] >= 0 and got[i] >= 0, (i, ref[i], got[i])
        assert _near_both(m, ref[i], got[i], float(x[i]), float(y[i])), i
    return len(bad)


@pytest.mark.parametrize("max_iters", [200, 8])
def test_plain_walk_matches_reference(setup, max_iters):
    jm, m, _, _ = setup
    rng = np.random.default_rng(5)
    n = 6000
    dest = _points_in(m, rng.integers(0, m.nelems, n), rng)
    dest[:300] *= 1.6                                # outside: boundary exits
    start = rng.integers(0, m.nelems, n).astype(np.int32)
    active = rng.uniform(size=n) > 0.05
    ref = j_se.search_mesh_2d(jm, jnp.asarray(dest), jnp.asarray(dest),
                              jnp.asarray(start), jnp.asarray(active), max_iters)
    got = t_se.search_mesh_2d(m, torch.from_numpy(dest), torch.from_numpy(dest),
                              torch.from_numpy(start), torch.from_numpy(active),
                              max_iters)
    _check_ids(m, ref.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])
    assert int(got.iters) == int(ref.iters)
    assert bool(got.all_found) == bool(ref.all_found)
    assert bool(got.all_found) == (max_iters == 200)
    np.testing.assert_array_equal(got.active.numpy(), got.elem_ids.numpy() >= 0)
    assert (got.elem_ids.numpy()[~active] == -1).all()
    # scaled points from the inner band can land inside the mesh again
    assert (got.elem_ids.numpy()[:300][active[:300]] == -1).mean() > 0.5


def _moves(m, rng, n, scale):
    """Particles in random elements moved by a small random displacement."""
    prev = rng.integers(0, m.nelems, n).astype(np.int32)
    orig = _points_in(m, prev, rng)
    dest = (orig + rng.normal(0, scale, size=orig.shape)).astype(np.float32)
    return prev, orig, dest


@pytest.mark.parametrize("scale", [0.01, 0.08])
def test_accel_walk_matches_reference(setup, scale):
    jm, m, jg, g = setup
    rng = np.random.default_rng(6)
    n = 8000
    prev, orig, dest = _moves(m, rng, n, scale)
    active = rng.uniform(size=n) > 0.05
    ref = j_se.search_mesh_2d_accel(jm, jg, jnp.asarray(orig), jnp.asarray(dest),
                                    jnp.asarray(prev), jnp.asarray(active), 64)
    got = t_se.search_mesh_2d_accel(m, g, torch.from_numpy(orig),
                                    torch.from_numpy(dest), torch.from_numpy(prev),
                                    torch.from_numpy(active), 64)
    _check_ids(m, ref.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])
    assert int(got.iters) == int(ref.iters) >= 1
    assert bool(got.all_found) == bool(ref.all_found)
    for a, b in zip(ref.dest_c, got.dest_c):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the accelerated search finds what the plain walk from prev finds
    plain = t_se.search_mesh_2d(m, torch.from_numpy(orig), torch.from_numpy(dest),
                                torch.from_numpy(prev), torch.from_numpy(active), 200)
    _check_ids(m, plain.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])


def test_garbage_start_elements(setup):
    """Out-of-range start elements are clamped into the mesh (plain walk)
    and only serve as the retry element after a guess (accel walk)."""
    jm, m, jg, g = setup
    rng = np.random.default_rng(7)
    n = 3000
    dest = _points_in(m, rng.integers(0, m.nelems, n), rng)
    start = rng.choice(np.array([-7, -1, m.nelems, m.nelems + 99, 2 ** 30],
                                np.int32), n)
    active = np.ones(n, bool)
    for fn_j, fn_t, extra_j, extra_t in (
            (j_se.search_mesh_2d, t_se.search_mesh_2d, (), ()),
            (j_se.search_mesh_2d_accel, t_se.search_mesh_2d_accel, (jg,), (g,))):
        ref = fn_j(jm, *extra_j, jnp.asarray(dest), jnp.asarray(dest),
                   jnp.asarray(start), jnp.asarray(active), 500)
        got = fn_t(m, *extra_t, torch.from_numpy(dest), torch.from_numpy(dest),
                   torch.from_numpy(start), torch.from_numpy(active), 500)
        _check_ids(m, ref.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])
        ids = got.elem_ids.numpy()
        assert ((ids >= -1) & (ids < m.nelems)).all()
        assert int(got.iters) == int(ref.iters)
        assert bool(got.all_found) == bool(ref.all_found)


@pytest.mark.parametrize("accel", [False, True])
def test_max_iters_one_deletes_walkers(setup, accel):
    """max_iters=1: walkers not settled within one iteration are deleted,
    all_found is False, and nothing hangs."""
    jm, m, jg, g = setup
    rng = np.random.default_rng(8)
    prev, orig, dest = _moves(m, rng, 4000, 0.05)
    active = np.ones(len(prev), bool)
    args_j = (jnp.asarray(orig), jnp.asarray(dest), jnp.asarray(prev),
              jnp.asarray(active), 1)
    args_t = (torch.from_numpy(orig), torch.from_numpy(dest),
              torch.from_numpy(prev), torch.from_numpy(active), 1)
    if accel:
        ref = j_se.search_mesh_2d_accel(jm, jg, *args_j)
        got = t_se.search_mesh_2d_accel(m, g, *args_t)
    else:
        ref = j_se.search_mesh_2d(jm, *args_j)
        got = t_se.search_mesh_2d(m, *args_t)
    _check_ids(m, ref.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])
    assert int(got.iters) == int(ref.iters) == 1
    assert not bool(got.all_found) and not bool(ref.all_found)
    assert (got.elem_ids.numpy() == -1).sum() > 100


def test_boundary_exits_are_removed(setup):
    """Destinations outside the domain: removed (INVALID) by both packages
    through the peel's guess trajectory and the retry from prev."""
    jm, m, jg, g = setup
    rng = np.random.default_rng(9)
    prev, orig, _ = _moves(m, rng, 3000, 0.0)
    dest = (orig * 1.7).astype(np.float32)
    active = np.ones(len(prev), bool)
    ref = j_se.search_mesh_2d_accel(jm, jg, jnp.asarray(orig), jnp.asarray(dest),
                                    jnp.asarray(prev), jnp.asarray(active), 64)
    got = t_se.search_mesh_2d_accel(m, g, torch.from_numpy(orig),
                                    torch.from_numpy(dest), torch.from_numpy(prev),
                                    torch.from_numpy(active), 64)
    _check_ids(m, ref.elem_ids, got.elem_ids, dest[:, 0], dest[:, 1])
    assert (got.elem_ids.numpy() == -1).mean() > 0.5
    assert bool(got.all_found) == bool(ref.all_found)
    assert int(got.iters) == int(ref.iters)


def test_unported_options_raise(setup):
    """What the 2D search once refused runs now (the exit record, recovery,
    the reflecting wall and any handler of the protocol on the CPU: parity
    in tests/test_torch_trace2d.py); the TPU-only ``aux_capture`` still
    raises."""
    _, m, _, g = setup
    x = m.elem_centroids[:4].contiguous()
    e = torch.zeros(4, dtype=torch.int32)
    a = torch.ones(4, dtype=torch.bool)

    def remove_too(ctx):
        return t_se.remove_on_exit(ctx)

    remove_too.modifies_dest = False
    runs = [t_se.search_mesh_2d(m, x, x, e, a, record_exit=True),
            t_se.search_mesh_2d(m, x, x, e, a, recover="project"),
            t_se.search_mesh_2d(m, x, x, e, a, boundary_handler=remove_too),
            t_se.search_mesh_2d(m, x, x, e, a, boundary_handler=t_se.reflect_on_exit_2d),
            t_se.search_mesh_2d_accel(m, g, x, x, e, a, record_exit=True,
                                      boundary_handler=t_se.reflect_on_exit_2d,
                                      recover="project")]
    for r in runs:
        assert bool(r.all_found) and torch.equal(r.elem_ids, runs[0].elem_ids)
        assert bool((r.elem_ids >= 0).all())
    assert int(runs[0].num_hits.sum()) == 0 and int(runs[1].num_recovered) == 0
    with pytest.raises(NotImplementedError):
        t_se.search_mesh_2d_accel(m, g, x, x, e, a, aux_capture=torch.zeros(1, 2))
    # the TPU pyramid widths are accepted and change nothing
    r1 = t_se.search_mesh_2d(m, x, x, e, a, widths=(2,))
    r2 = t_se.search_mesh_2d(m, x, x, e, a)
    assert torch.equal(r1.elem_ids, r2.elem_ids)


@pytest.fixture(scope="module")
def band_setup():
    """tests/test_search.py's band mesh (tokamak_mesh(24, 120)) with the
    JAX package's band grid and the same grid carried across."""
    coords, tris, cls = j_gen.tokamak_mesh(24, 120)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    jg = j_loc.detect_banded_locator(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     np.asarray(jm.class_id), jm.walk_geom)
    tg = interop.band_grid_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in interop.BAND_FIELDS}, device="cpu")
    return jm, m, jg, tg


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


@pytest.mark.parametrize("max_iters", [64, 3])
def test_band_peel_walk_matches_reference(band_setup, max_iters):
    """The band-grid peel + walk (kernel B's and L's plain versions) against
    the JAX package's search_mesh_2d_accel on the same band grid, as
    tests/test_search.py drives it (some destinations leave the domain):
    equal iters and all_found, identical removals with the full budget,
    element ids equal except counted ties, each within that test's
    containment tolerance of both elements (with a 3-iteration budget,
    also walkers deleted at the limit on one side only: the JAX package's
    jitted cells differ from the op-by-op ones on ~0.3% of points)."""
    jm, m, jg, tg = band_setup
    rng = np.random.default_rng(9)
    n = 5000
    te = rng.integers(0, m.nelems, n).astype(np.int32)
    orig = _points_in(m, te, rng)
    tgt = (orig + rng.normal(0, 0.02, orig.shape)).astype(np.float32)
    active = np.ones(n, bool)
    active[::50] = False
    ref = j_se.search_mesh_2d_accel(jm, jg, jnp.asarray(orig), jnp.asarray(tgt),
                                    jnp.asarray(te), jnp.asarray(active), max_iters)
    got = t_se.search_mesh_2d_accel(m, tg, torch.from_numpy(orig), torch.from_numpy(tgt),
                                    torch.from_numpy(te), torch.from_numpy(active),
                                    max_iters)
    ra, ga = np.asarray(ref.elem_ids), got.elem_ids.numpy()
    # walkers in the band table's uncalibrated cells start from element 0
    # and some reach the limit in both packages: all_found is False at 64
    assert bool(got.all_found) == bool(ref.all_found)
    assert int(got.iters) == int(ref.iters)
    if max_iters == 64:
        np.testing.assert_array_equal(ra < 0, ga < 0)
    bad = np.nonzero(ra != ga)[0]
    assert len(bad) <= MAX_MISMATCH_PER_10K * n / 10_000 + (0 if max_iters == 64 else 50), len(bad)
    ev, cz = m.elem2verts.numpy(), m.coords.numpy().astype(np.float64)
    for i in bad:
        if min(ra[i], ga[i]) < 0:
            continue          # deleted at the 3-iteration limit on one side only
        for e in (ra[i], ga[i]):
            a, b, c = cz[ev[e]]
            p = tgt[i].astype(np.float64)
            s = _cross2(b - a, c - a)
            tol = 1e-4 * abs(s) + 2e-7
            assert _cross2(b - a, p - a) * np.sign(s) >= -tol, i
            assert _cross2(c - b, p - b) * np.sign(s) >= -tol, i
            assert _cross2(a - c, p - c) * np.sign(s) >= -tol, i
    assert (ga[~active] == -1).all()
    np.testing.assert_array_equal(got.active.numpy(), ga >= 0)
