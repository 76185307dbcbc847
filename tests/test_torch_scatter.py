"""Parity of the port's gyro scatter (pumipic_torch.ops.scatter, the
module of kernels H and D) with the JAX reference, for the uniform and the
per-particle gyro radius.  Counts and fields are integer counts and
multiples of 1/P here, so they must be equal."""
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
    return JMesh2D.from_arrays(coords, tris, cls), Mesh2D.from_arrays(coords, tris, cls, device="cpu")


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
    g = t_sc.GyroMap.from_flat(gmap, V, R, P, device="cpu")
    got = t_sc.scatter_to_mapped_verts(torch.from_numpy(ring), g, V, R, P)
    np.testing.assert_array_equal(got.numpy(), ref)


def _gyro_map(m, kind, P, rng):
    """The gyro map of the fixture mesh (the model's own, R = 3) or a
    random one with 10% of its entries outside the domain."""
    V, R = m.nverts, 3
    if kind == "model":
        from pumipic_torch.models import pseudo_xgcm as t_px

        return np.asarray(t_px.build_gyro_mappings(
            m, t_px.GyroConfig(points_per_ring=P))[0].cpu().numpy(), np.int64)
    flat = rng.integers(0, V, V * R * P * 3)
    flat[rng.uniform(size=flat.size) < 0.1] = -1
    return flat


@pytest.mark.parametrize("kind", ["model", "random"])
@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("P", [8, 4, 1])
def test_deposit_group_order_equals_plain_and_reference(meshes, P, group, kind):
    """Kernel D's pass 2 adds in its own fixed order (lanes over each
    vertex's entries, then a tree; its numpy model in deposit_order.py).
    With integer ring sums and P a power of 2 every term c/P and every
    partial sum is exact, so that order gives the plain version's and the
    JAX package's bits."""
    from deposit_order import mapped_group_order

    jm, m = meshes
    V, R = m.nverts, 3
    rng = np.random.default_rng(10 * P + group)
    flat = _gyro_map(m, kind, P, rng)
    ring = rng.integers(0, 500, (V, R)).astype(np.float32)
    g = t_sc.GyroMap.from_flat(flat, V, R, P, device="cpu")
    got = mapped_group_order(ring, g.offsets.numpy(), g.src.numpy(), P, group)
    plain = t_sc.mapped_plain(torch.from_numpy(ring), g, V, R, P).numpy()
    ref = np.asarray(j_sc.scatter_to_mapped_verts(jnp.asarray(ring), jnp.asarray(flat),
                                                  V, R, P))
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_deposit_group_order_rounds_per_term(meshes):
    """With P = 3 each term c/3 rounds, so the order shows: the fixed
    order agrees with the plain version (entry order) to the f32 rounding
    of sums of ~72 terms (relative 1e-6)."""
    from deposit_order import mapped_group_order

    _, m = meshes
    V, R, P = m.nverts, 3, 3
    rng = np.random.default_rng(3)
    flat = _gyro_map(m, "random", P, rng)
    ring = rng.integers(1, 500, (V, R)).astype(np.float32)
    g = t_sc.GyroMap.from_flat(flat, V, R, P, device="cpu")
    got = mapped_group_order(ring, g.offsets.numpy(), g.src.numpy(), P)
    plain = t_sc.mapped_plain(torch.from_numpy(ring), g, V, R, P).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-6)
    assert not np.array_equal(got, plain)


def test_gyro_map_transpose():
    """The CSR transpose lists, for each output vertex, the (v·R + r) slots
    of the entries naming it, in entry order."""
    V, R, P = 5, 2, 2
    rng = np.random.default_rng(1)
    flat = rng.integers(-1, V, V * R * P * 3)
    g = t_sc.GyroMap.from_flat(flat, V, R, P, device="cpu")
    off, src = g.offsets.numpy(), g.src.numpy()
    assert off[0] == 0 and off[-1] == (flat >= 0).sum()
    for u in range(V):
        want = [i // (P * 3) for i in range(flat.size) if flat[i] == u]
        assert src[off[u]:off[u + 1]].tolist() == want
    with pytest.raises(ValueError, match="gyro map shape"):
        t_sc.GyroMap.from_flat(flat[:-1], V, R, P, device="cpu")


def test_per_particle_radius_is_ported(meshes):
    """A radius per particle picks each particle's own ring pair; with one
    ring the radius is ignored, as in the JAX package."""
    _, m = meshes
    e = torch.zeros(3, dtype=torch.int32)
    a = torch.ones(3, dtype=torch.bool)
    rg = torch.tensor([0.0, 0.02, 0.5])           # rings (0,1), (0,1), (1,2)
    got = t_sc.accumulate_to_rings(e, a, m, 3, 0.038, ptcl_radius=rg)
    v = m.elem2verts[0].long()
    np.testing.assert_array_equal(got[v].numpy(), [[2.0, 3.0, 1.0]] * 3)
    assert float(got.sum()) == 3 * 2 * 3
    one = t_sc.accumulate_to_rings(e, a, m, 1, 0.038, ptcl_radius=rg)
    assert torch.equal(one, t_sc.accumulate_to_rings(e, a, m, 1, 0.038))


def _radii(n, rmax, R, rng):
    """Radii as the model draws them, plus ring-width multiples, zero and
    values past rmax."""
    rg = rng.uniform(0.25 * rmax, rmax, n).astype(np.float32)
    rw = np.float32(rmax / R)
    rg[:8] = np.arange(8, dtype=np.float32) * rw
    rg[8:11] = [0.0, 2 * rmax, 1e-9]
    return rg


@pytest.mark.parametrize("num_rings", [3, 2])
def test_accumulate_to_rings_per_particle_radius_matches_reference(meshes, num_rings):
    """Kernel H's (element, ring) key mode and D's pass 1 from (E, R)
    counts (their plain versions) against the JAX package's f32-key
    one-hot histograms: equal."""
    jm, m = meshes
    rmax = 0.038
    elem, active = _particles(m.nelems, seed=10 + num_rings)
    rg = _radii(len(elem), rmax, num_rings, np.random.default_rng(num_rings))
    ref = np.asarray(j_sc.accumulate_to_rings(
        jnp.asarray(elem), jnp.asarray(active), jm.elem2verts, jm.nverts,
        num_rings, rmax, ptcl_radius=jnp.asarray(rg)))
    got = t_sc.accumulate_to_rings(torch.from_numpy(elem), torch.from_numpy(active),
                                   m, num_rings, rmax,
                                   ptcl_radius=torch.from_numpy(rg))
    assert got.shape == (m.nverts, num_rings) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(got.sum()) == 3 * 2 * int(active.sum())
    # the keys: two per active particle, elem·R + rd and + 1
    counts = t_sc.histogram(torch.from_numpy(elem), torch.from_numpy(active),
                            m.nelems, torch.from_numpy(rg), num_rings, rmax)
    assert counts.shape == (m.nelems * num_rings,) and counts.dtype == torch.int32
    rd = t_sc.ring_of_radius(torch.from_numpy(rg), rmax, num_rings).numpy()
    rw = jnp.float32(rmax / num_rings)
    np.testing.assert_array_equal(
        rd, np.asarray(jnp.clip(jnp.floor(jnp.asarray(rg) / rw) - 1.0, 0.0,
                                num_rings - 2)))
    want = np.zeros(m.nelems * num_rings, np.int64)
    for k in (0, 1):
        np.add.at(want, (elem * num_rings + rd.astype(np.int64) + k)[active], 1)
    np.testing.assert_array_equal(counts.numpy(), want)


def test_ring_of_radius_nan_deposits_nothing(meshes):
    _, m = meshes
    e = torch.zeros(2, dtype=torch.int32)
    a = torch.ones(2, dtype=torch.bool)
    counts = t_sc.histogram(e, a, m.nelems, torch.tensor([float("nan"), 0.02]),
                            3, 0.038)
    assert int(counts.sum()) == 2 and counts[0:2].tolist() == [1, 1]
