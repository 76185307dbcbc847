"""Parity of the port's gyro scatter (pumipic_torch.ops.scatter, the
module of kernels H and D) with the JAX reference.  Counts and fields are
integer counts and multiples of 1/P here, so they must be equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.ops import scatter as j_sc
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.ops import scatter as t_sc


@pytest.fixture(scope="module")
def meshes():
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    return JMesh2D.from_arrays(coords, tris, cls), Mesh2D.from_arrays(coords, tris, cls)


def _particles(E, n=20000, seed=0):
    rng = np.random.default_rng(seed)
    elem = rng.integers(-1, E, n).astype(np.int32)
    active = (rng.uniform(size=n) > 0.1) & (elem >= 0)
    return elem, active


def test_histogram_matches_reference(meshes):
    jm, m = meshes
    elem, active = _particles(m.nelems)
    key = jnp.where(jnp.asarray(active), jnp.asarray(elem), m.nelems)
    ref = np.asarray(j_sc.count_per_key_matmul(key, m.nelems))
    got = t_sc.histogram(torch.from_numpy(elem), torch.from_numpy(active), m.nelems)
    assert got.dtype == torch.int32 and got.shape == (m.nelems,)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    assert int(got.sum()) == int(active.sum())


@pytest.mark.parametrize("num_rings", [1, 2, 3])
def test_accumulate_to_rings_matches_reference(meshes, num_rings):
    """Uniform radius for R >= 2 (rings rd, ru = 0, 1) and the R == 1 case
    that deposits each particle once."""
    jm, m = meshes
    elem, active = _particles(m.nelems, seed=num_rings)
    ref = np.asarray(j_sc.accumulate_to_rings(
        jnp.asarray(elem), jnp.asarray(active), jm.elem2verts, jm.nverts,
        num_rings, 0.038))
    got = t_sc.accumulate_to_rings(torch.from_numpy(elem), torch.from_numpy(active),
                                   m, num_rings, 0.038)
    assert got.shape == (m.nverts, num_rings) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    rings = 1 if num_rings == 1 else 2
    assert float(got.sum()) == 3 * rings * int(active.sum())


@pytest.mark.parametrize("P", [8, 4])
def test_scatter_to_mapped_verts_matches_reference(meshes, P):
    jm, m = meshes
    V, R = m.nverts, 3
    rng = np.random.default_rng(P)
    gmap = rng.integers(0, V, V * R * P * 3).astype(np.int32)
    gmap[rng.uniform(size=gmap.size) < 0.1] = -1
    ring = rng.integers(0, 50, (V, R)).astype(np.float32)
    ref = np.asarray(j_sc.scatter_to_mapped_verts(
        jnp.asarray(ring), jnp.asarray(gmap), V, R, P))
    g = t_sc.GyroMap.from_flat(gmap, V, R, P)
    got = t_sc.scatter_to_mapped_verts(torch.from_numpy(ring), g, V, R, P)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gyro_map_transpose():
    """The CSR transpose lists, for each output vertex, the (v·R + r) slots
    of the entries naming it, in entry order."""
    V, R, P = 5, 2, 2
    rng = np.random.default_rng(1)
    flat = rng.integers(-1, V, V * R * P * 3)
    g = t_sc.GyroMap.from_flat(flat, V, R, P)
    off, src = g.offsets.numpy(), g.src.numpy()
    assert off[0] == 0 and off[-1] == (flat >= 0).sum()
    for u in range(V):
        want = [i // (P * 3) for i in range(flat.size) if flat[i] == u]
        assert src[off[u]:off[u + 1]].tolist() == want
    with pytest.raises(ValueError, match="gyro map shape"):
        t_sc.GyroMap.from_flat(flat[:-1], V, R, P)


def test_per_particle_radius_not_ported(meshes):
    _, m = meshes
    e = torch.zeros(3, dtype=torch.int32)
    a = torch.ones(3, dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        t_sc.accumulate_to_rings(e, a, m, 3, 0.038, ptcl_radius=torch.ones(3))
