"""Parity of the port's geometric helpers (``pumipic_torch.ops.geometry``)
with the JAX package's, on inputs made from a seed with numpy.

Tolerances: the barycentric forms and the triangle area are summed in the
JAX package's order but XLA may contract a product into an FMA or sum an
einsum in another order (rtol 1e-6, atol 1e-6 on values of order 1; the tet
weights atol 1e-5, an ulp of their largest terms |A||x| ~ 20); min_index,
exit_edge_2d are equal, and hit masks equal but for a counted few points
within an ulp of an edge.  Ray parameters: rtol 1e-5 where the
determinant is not small (|det| > 0.05), rtol 1e-3 elsewhere (1/det
amplifies an ulp).  closest_point_on_triangle is checked in each of its seven
Voronoi regions against the region's exact answer (atol 1e-6) and against
the reference (atol 1e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.ops import geometry as jg
from pumipic_torch.ops import geometry as tg

TOL = 1e-6
RNG = np.random.default_rng(21)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _tets(n=4000):
    """Random non-degenerate tets, their inverse bases, origin vertices and
    points in and around them (f32)."""
    v = RNG.uniform(-1, 1, (n, 4, 3))
    basis = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], -1)
    keep = np.abs(np.linalg.det(basis)) > 0.05
    v, basis = v[keep], basis[keep]
    inv = np.linalg.inv(basis).astype(np.float32)
    w = RNG.dirichlet(np.ones(4), len(v)) * 1.4 - 0.1
    pts = np.einsum("nk,nkd->nd", w, v).astype(np.float32)
    return inv, v[:, 0].astype(np.float32), pts


def test_bcc_2d_and_3d_match_reference():
    inv2 = RNG.uniform(-2, 2, (3000, 2, 2)).astype(np.float32)
    v0, pts = (RNG.uniform(-1, 1, (3000, 2)).astype(np.float32) for _ in range(2))
    _close(tg.bcc_2d(_t(inv2), _t(v0), _t(pts)), jg.bcc_2d(_j(inv2), _j(v0), _j(pts)))
    inv, v0, pts = _tets()
    got = tg.bcc_3d(_t(inv), _t(v0), _t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg.bcc_3d(_j(inv), _j(v0), _j(pts))),
                               rtol=TOL, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    ins = tg.all_positive(got, 1e-3)
    assert torch.equal(ins, _t(np.asarray(jg.all_positive(jnp.asarray(got.numpy()), 1e-3))))
    assert 0 < int(ins.sum()) < ins.numel()


def test_min_index_and_exit_edge_match_reference():
    bcc = RNG.normal(size=(5000, 3)).astype(np.float32)
    bcc[:50, 1] = bcc[:50, 0]                 # ties: the first index wins
    assert np.array_equal(tg.min_index(_t(bcc)).numpy(), np.asarray(jg.min_index(_j(bcc))))
    got = tg.exit_edge_2d(_t(bcc))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jg.exit_edge_2d(_j(bcc))))
    b4 = RNG.normal(size=(5000, 4)).astype(np.float32)
    assert np.array_equal(tg.min_index(_t(b4)).numpy(), np.asarray(jg.min_index(_j(b4))))


def test_tri_area_2d_matches_reference():
    a, b, c = (RNG.uniform(-1, 1, (4000, 2)).astype(np.float32) for _ in range(3))
    got = tg.tri_area_2d(_t(a), _t(b), _t(c))
    _close(got, jg.tri_area_2d(_j(a), _j(b), _j(c)))
    assert torch.equal(tg.tri_area_2d(_t(a), _t(c), _t(b)), -got)


def test_cross_matches_numpy():
    a, b = (RNG.normal(size=(1000, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tg.cross(_t(a), _t(b)).numpy(), np.cross(a, b), rtol=1e-5,
                               atol=1e-6)


def test_moller_trumbore_matches_reference():
    n = 6000
    va, vb, vc = (RNG.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(3))
    orig = RNG.uniform(-2, 2, (n, 3)).astype(np.float32)
    w = RNG.dirichlet(np.ones(3), n) * 1.3 - 0.1     # aim at, and near, the triangle
    target = np.einsum("nk,nkd->nd", w, np.stack([va, vb, vc], 1)).astype(np.float32)
    direc = (target - orig) * RNG.uniform(0.5, 2, (n, 1)).astype(np.float32)
    direc[:40] = np.cross(vb - va, vc - va)[:40] * 0   # degenerate direction
    direc[40:80] = -direc[40:80]                        # behind the origin
    hit, t = tg.moller_trumbore(_t(orig), _t(direc), _t(va), _t(vb), _t(vc))
    hr, tr = jg.moller_trumbore(_j(orig), _j(direc), _j(va), _j(vb), _j(vc))
    hr, tr = np.asarray(hr), np.asarray(tr)
    # the hit test compares with a 1e-10 slack: a point within an ulp of an
    # edge may fall either side of it (counted, and few)
    flips = hit.numpy() != hr
    assert flips.sum() <= 3, int(flips.sum())
    both = hit.numpy() & hr
    det = np.einsum("nd,nd->n", vb - va, np.cross(direc, vc - va))
    good = both & (np.abs(det) > 0.05)
    np.testing.assert_allclose(t.numpy()[good], tr[good], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.numpy()[both], tr[both], rtol=1e-3, atol=1e-6)
    assert np.isinf(t.numpy()[~hit.numpy()]).all()
    assert not hit[:80].any() and 0.5 * n < int(hit.sum()) < n


# the seven Voronoi regions of the triangle A(0,0,0) B(1,0,0) C(0,1,0):
# a point above the plane at z = 0.7 and its exact closest point
REGIONS = {
    "vertex A": ((-0.5, -0.3), (0.0, 0.0)),
    "vertex B": ((1.6, -0.4), (1.0, 0.0)),
    "vertex C": ((-0.2, 1.5), (0.0, 1.0)),
    "edge AB": ((0.4, -0.8), (0.4, 0.0)),
    "edge AC": ((-0.9, 0.3), (0.0, 0.3)),
    "edge BC": ((0.9, 0.7), (0.6, 0.4)),
    "face": ((0.2, 0.3), (0.2, 0.3)),
}


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_closest_point_on_triangle_in_each_region(region):
    (px, py), (qx, qy) = REGIONS[region]
    rng = np.random.default_rng(abs(hash(region)) % 2**32)
    # the region's canonical triangle, then the same configuration moved by
    # random rigid motions (the answer moves with it)
    n = 500
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    shift = rng.uniform(-3, 3, (n, 1, 3))
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    pts = np.array([[px, py, 0.7], [qx, qy, 0.0]])
    tri_n = np.einsum("nij,kj->nki", q, tri) + shift
    pts_n = np.einsum("nij,kj->nki", q, pts) + shift
    va, vb, vc = (tri_n[:, k].astype(np.float32) for k in range(3))
    p = pts_n[:, 0].astype(np.float32)
    got = tg.closest_point_on_triangle(_t(p), _t(va), _t(vb), _t(vc))
    want = jg.closest_point_on_triangle(_j(p), _j(va), _j(vb), _j(vc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pts_n[:, 1], atol=1e-5)


def test_closest_point_on_triangle_random_matches_reference():
    n = 5000
    va, vb, vc, p = (RNG.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4))
    got = tg.closest_point_on_triangle(_t(p), _t(va), _t(vb), _t(vc))
    want = np.asarray(jg.closest_point_on_triangle(_j(p), _j(va), _j(vb), _j(vc)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_segment_edge_intersect_2d_matches_reference():
    n = 6000
    p0, p1, a, b = (RNG.uniform(-1, 1, (n, 2)).astype(np.float32) for _ in range(4))
    p1[:30] = p0[:30]                                   # degenerate segment
    hit, t = tg.segment_edge_intersect_2d(_t(p0), _t(p1), _t(a), _t(b))
    hr, tr = jg.segment_edge_intersect_2d(_j(p0), _j(p1), _j(a), _j(b))
    hr, tr = np.asarray(hr), np.asarray(tr)
    assert (hit.numpy() != hr).sum() <= 3
    both = hit.numpy() & hr
    np.testing.assert_allclose(t.numpy()[both], tr[both], rtol=1e-5, atol=1e-5)
    assert not hit[:30].any() and 0 < int(hit.sum()) < n
