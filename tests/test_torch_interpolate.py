"""Parity of the port's field interpolation (``pumipic_torch.ops.interpolate``)
with the JAX package's, on fields and points made from a seed with numpy.

Tolerance: rtol 1e-5, atol 4e-6 (the corner sums follow the JAX package's
order, but XLA contracts some products into FMAs and sums an einsum in its
own order: a few ulps of the largest corner term, the field values being
N(0, 1), where the sum cancels to near 0).  The cylindrical rotation takes torch's
and XLA's libm cos/sin/atan2, an ulp apart (same tolerance)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.ops import interpolate as ji
from pumipic_torch.ops import interpolate as ti

RTOL, ATOL = 1e-5, 4e-6


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [None, 2])
def test_interpolate_vtx_field_matches_reference(k):
    rng = np.random.default_rng(1)
    V, E, n = 50, 80, 3000
    field = rng.normal(size=(V,) if k is None else (V, k)).astype(np.float32)
    ev = rng.integers(0, V, (E, 4)).astype(np.int32)
    elem = rng.integers(-1, E, n).astype(np.int32)            # -1 clamps to 0
    bcc = rng.dirichlet(np.ones(4), n).astype(np.float32)
    got = ti.interpolate_vtx_field(*(torch.from_numpy(a) for a in (field, ev, elem, bcc)))
    _close(got, ji.interpolate_vtx_field(*(jnp.asarray(a) for a in (field, ev, elem, bcc))))


def _grid_points(rng, n, dim):
    return rng.uniform(-0.2, 1.2, (n, dim)).astype(np.float32)     # some clamp


@pytest.mark.parametrize("k", [None, 3])
def test_interpolate_2d_grid_matches_reference(k):
    rng = np.random.default_rng(2)
    shape = (7, 9) + (() if k is None else (k,))
    grid = rng.normal(size=shape).astype(np.float32)
    o, h = np.array([0.0, -0.05], np.float32), np.array([1 / 6, 1 / 7], np.float32)
    pts = _grid_points(rng, 5000, 2)
    got = ti.interpolate_2d_grid(*(torch.from_numpy(a) for a in (grid, o, h, pts)))
    _close(got, ji.interpolate_2d_grid(*(jnp.asarray(a) for a in (grid, o, h, pts))))


@pytest.mark.parametrize("k", [None, 3])
def test_interpolate_3d_grid_matches_reference(k):
    rng = np.random.default_rng(3)
    shape = (5, 6, 4) + (() if k is None else (k,))
    grid = rng.normal(size=shape).astype(np.float32)
    o = np.array([0.0, 0.1, -0.1], np.float32)
    h = np.array([0.25, 0.2, 1 / 3], np.float32)
    pts = _grid_points(rng, 8000, 3)
    pts[:20] = o + h * np.array([1, 2, 1], np.float32)        # on grid nodes
    got = ti.interpolate_3d_grid(*(torch.from_numpy(a) for a in (grid, o, h, pts)))
    _close(got, ji.interpolate_3d_grid(*(jnp.asarray(a) for a in (grid, o, h, pts))))
    # a node returns its value exactly
    node = grid[1, 2, 1]
    np.testing.assert_allclose(got[:20].numpy(), np.broadcast_to(node, got[:20].shape),
                               rtol=1e-6, atol=1e-6)


def test_interpolate_3d_grid_is_exact_on_linear_fields():
    """Trilinear interpolation reproduces a linear field inside the grid."""
    rng = np.random.default_rng(4)
    ax = [np.arange(n, dtype=np.float64) * s for n, s in ((5, 0.25), (5, 0.25), (5, 0.25))]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    grid = (0.3 * X - 1.2 * Y + 2.0 * Z + 0.5).astype(np.float32)
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    got = ti.interpolate_3d_grid(torch.from_numpy(grid), torch.zeros(3),
                                 torch.full((3,), 0.25), torch.from_numpy(pts))
    want = 0.3 * pts[:, 0] - 1.2 * pts[:, 1] + 2.0 * pts[:, 2] + 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("cylindrical", [True, False])
def test_interp_2d_vector_matches_reference(cylindrical):
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(8, 6, 3)).astype(np.float32)
    o, h = np.array([0.5, -1.0], np.float32), np.array([0.2, 0.4], np.float32)
    pts = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    got = ti.interp_2d_vector(*(torch.from_numpy(a) for a in (grid, o, h, pts)),
                              cylindrical=cylindrical)
    _close(got, ji.interp_2d_vector(*(jnp.asarray(a) for a in (grid, o, h, pts)),
                                    cylindrical=cylindrical))
