"""Parity of the port's deposits (kernel V's plain version behind
``scatter_to_verts_bcc`` and the weighted ``particles_per_element``; kernel
H's behind ``count_per_key``, ``count_per_key_matmul`` and the unweighted
``particles_per_element``; ``gyro_scatter``) with the JAX reference.

Inputs are made from a seed with numpy on ``disk_mesh(6, 24)`` and a small
``tokamak_mesh``.  Counts are integers: equal.  The weighted sums state a
bound per output.  The JAX package's ``segment_sum`` adds in an order XLA
leaves open, within m·2^-24·Σ|terms| of the exact sum (m the output's
number of terms); the port's fixed-point sum is the f32 rounding of the
exact sum of its terms each rounded to a multiple of 2^-K
(K = 94 - ceil(log2(terms)) - e, |term| < 2^e; see
``vertex_deposit_plain``).  So

    |port - ref| <= m·2^-24·Σ|terms| + ulp(ref) + m·2^-(K+1)

for each output.  The port's result itself is checked against the exact
sum (``fractions.Fraction``): it is its correctly rounded f32 value where
every term is a multiple of 2^-K.
"""
import math
from fractions import Fraction

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
def mesh():
    raw = j_gen.disk_mesh(6, 24)
    return JMesh2D.from_arrays(*raw), Mesh2D.from_arrays(*raw, device="cpu")


def _particles(E, n, seed):
    rng = np.random.default_rng(seed)
    elem = rng.integers(-2, E + 2, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.9
    bcc = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    charge = rng.uniform(-1.0, 2.0, n).astype(np.float32)
    return rng, elem, active, bcc, charge


def _terms(elem, active, w, keys_of, n_out):
    """Per output: the list of f32 terms (as float) the reference sums."""
    out = [[] for _ in range(n_out)]
    for i in np.nonzero(active)[0]:
        for key, t in keys_of(i, elem[i], w[i]):
            if 0 <= key < n_out:
                out[key].append(float(t))
    return out


def _scale_ulp(terms_flat, n_terms):
    """2^-K of the port's fixed point for these (kept) terms."""
    mb = max((int(np.float32(abs(t)).view(np.int32)) for t in terms_flat), default=0)
    e = max(mb >> 23, 1) - 126
    K = t_sc.FIXED_BITS - max(n_terms - 1, 0).bit_length() - e
    return 2.0 ** -K


def _check_bound(got, ref, terms, n_terms):
    step = _scale_ulp([t for ts in terms for t in ts], n_terms)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float32)
    for o, ts in enumerate(terms):
        m = len(ts)
        s_abs = sum(abs(t) for t in ts)
        bound = m * 2.0 ** -24 * s_abs + float(np.spacing(np.abs(ref[o]))) + m * step / 2
        assert abs(got[o] - float(ref[o])) <= bound, (o, got[o], ref[o], bound)


def _check_exact(got, terms):
    """The port's output is the f32 rounding of the exact sum (the terms
    here are all multiples of its 2^-K)."""
    for o, ts in enumerate(terms):
        exact = sum((Fraction(t) for t in ts), Fraction(0))
        want = np.float32(float(exact)) if exact == Fraction(float(exact)) else None
        if want is None:          # round the Fraction itself to f32
            lo = np.float32(float(exact))
            cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                     np.nextafter(lo, np.float32(np.inf))]
            want = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                             int(np.asarray(c).view(np.int32)) & 1))
        assert np.float32(got[o]) == want, (o, got[o], want)


@pytest.mark.parametrize("with_charge", [False, True])
def test_scatter_to_verts_bcc_matches_reference(mesh, with_charge):
    """The charge deposit on the parents' vertices (inactive particles
    dropped, out-of-range parents clamped as the reference gathers them):
    within the stated bound of the reference, the correctly rounded exact
    sum, and the charge total conserved."""
    jm, tm = mesh
    rng, elem, active, bcc, charge = _particles(tm.nelems, 3000, 1)
    q = charge if with_charge else None
    ref = np.asarray(j_sc.scatter_to_verts_bcc(
        jnp.asarray(elem), jnp.asarray(active), jnp.asarray(bcc), jm.elem2verts,
        jm.nverts, None if q is None else jnp.asarray(q)))
    got = t_sc.scatter_to_verts_bcc(
        torch.from_numpy(elem), torch.from_numpy(active), torch.from_numpy(bcc),
        tm.elem2verts, tm.nverts, None if q is None else torch.from_numpy(q))
    assert got.shape == (tm.nverts,) and got.dtype == torch.float32
    ev = tm.elem2verts.numpy()
    w = bcc if q is None else bcc * q[:, None]
    terms = _terms(elem, active, w, lambda i, e, wi: zip(
        ev[min(max(e, 0), tm.nelems - 1)], wi), tm.nverts)
    _check_bound(got.numpy(), ref, terms, 3 * len(elem))
    _check_exact(got.numpy(), terms)
    total = math.fsum(float(t) for ts in terms for t in ts)
    assert abs(float(got.double().sum()) - total) <= 1e-5 * max(1.0, abs(total))


def test_weighted_particles_per_element_matches_reference(mesh):
    """One term a particle, keyed by its element; elements outside
    [0, E) dropped."""
    jm, tm = mesh
    rng, elem, active, _, _ = _particles(tm.nelems, 4000, 2)
    wts = rng.normal(0.0, 1.0, len(elem)).astype(np.float32)
    ref = np.asarray(j_sc.particles_per_element(
        jnp.asarray(elem), jnp.asarray(active), jm.nelems, jnp.asarray(wts)))
    got = t_sc.particles_per_element(torch.from_numpy(elem), torch.from_numpy(active),
                                     tm.nelems, torch.from_numpy(wts))
    assert got.shape == (tm.nelems,) and got.dtype == torch.float32
    terms = _terms(elem, active, wts[:, None], lambda i, e, wi: [(e, wi[0])], tm.nelems)
    _check_bound(got.numpy(), ref, terms, len(elem))
    _check_exact(got.numpy(), terms)


@pytest.mark.parametrize("scale", [1e-42, 1e-30, 1.0, 1e30])
def test_weighted_sum_is_exact_across_the_f32_range(mesh, scale):
    """Subnormal, small, unit and large weights: the correctly rounded exact
    sum each time, and within the bound of the reference, except where the
    reference's XLA CPU build flushes subnormal terms to zero (its sums of
    1e-42 weights are all 0; the port keeps them, as the card does with
    -ftz=false)."""
    jm, tm = mesh
    rng, elem, active, _, _ = _particles(tm.nelems, 2000, 3)
    wts = (rng.uniform(0.5, 1.5, len(elem)) * scale).astype(np.float32)
    wts[::3] *= -1
    got = t_sc.particles_per_element(torch.from_numpy(elem), torch.from_numpy(active),
                                     tm.nelems, torch.from_numpy(wts))
    terms = _terms(elem, active, wts[:, None], lambda i, e, wi: [(e, wi[0])], tm.nelems)
    _check_exact(got.numpy(), terms)
    ref = np.asarray(j_sc.particles_per_element(
        jnp.asarray(elem), jnp.asarray(active), jm.nelems, jnp.asarray(wts)))
    if scale < np.finfo(np.float32).tiny:
        assert not ref.any() and bool((got != 0).any())
    else:
        _check_bound(got.numpy(), ref, terms, len(elem))


@pytest.mark.parametrize("order", ["element-sorted", "random"])
def test_deposit_is_independent_of_the_particle_order(mesh, order):
    """The same terms in another order give the same bits (integer sums):
    the particles sorted by element (as the 2D path holds them: kernel V
    sums a warp's equal keys before its atomics) or in a random order, each
    within the stated bound of the reference's deposit of that order."""
    jm, tm = mesh
    rng, elem, active, bcc, charge = _particles(tm.nelems, 5000, 4)
    perm = (np.argsort(elem, kind="stable") if order == "element-sorted"
            else rng.permutation(len(elem)))
    args = [torch.from_numpy(a) for a in (elem, active, bcc, charge)]
    a = t_sc.scatter_to_verts_bcc(args[0], args[1], args[2], tm.elem2verts, tm.nverts,
                                  args[3])
    b = t_sc.scatter_to_verts_bcc(*(t[perm] for t in args[:3]), tm.elem2verts,
                                  tm.nverts, args[3][perm])
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref = np.asarray(j_sc.scatter_to_verts_bcc(
        jnp.asarray(elem[perm]), jnp.asarray(active[perm]), jnp.asarray(bcc[perm]),
        jm.elem2verts, jm.nverts, jnp.asarray(charge[perm])))
    ev = tm.elem2verts.numpy()
    terms = _terms(elem[perm], active[perm], bcc[perm] * charge[perm, None],
                   lambda i, e, wi: zip(ev[min(max(e, 0), tm.nelems - 1)], wi), tm.nverts)
    _check_bound(b.numpy(), ref, terms, 3 * len(elem))


NON_FINITE = {"nan": (np.nan,), "+inf": (np.inf,), "-inf": (-np.inf,),
              "+inf and -inf in one output": (np.inf, -np.inf),
              "inactive nan": (np.nan,)}


def _same_pattern(got, ref):
    """NaN where the reference is NaN, the same infinity where it is
    infinite, and every finite output equal."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[fin].view(np.int32), ref[fin].view(np.int32))


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_terms_match_the_reference(mesh, case):
    """NaN and infinite terms give the reference's ``segment_sum`` pattern:
    NaN only in the outputs that sum a NaN or both infinities, an infinity
    in those that sum only it, and every other output its finite sum (the
    terms are multiples of 1/16, so every order sums them exactly and the
    finite outputs are equal bit for bit).  An inactive particle's term is
    dropped by both."""
    jm, tm = mesh
    rng, elem, active, _, _ = _particles(tm.nelems, 1000, 5)
    elem = np.clip(elem, 0, tm.nelems - 1)
    wts = (rng.integers(-32, 33, len(elem)) / 4).astype(np.float32)
    bcc = (rng.integers(1, 5, (len(elem), 3)) / 4).astype(np.float32)
    charge = (rng.integers(-8, 9, len(elem)) / 4).astype(np.float32)
    pool = np.nonzero(~active if case == "inactive nan" else active)[0]
    # the bad particles share one element (the same output and vertices)
    first = pool[0]
    bad = [first] + [i for i in pool[1:] if elem[i] == elem[first]][:1]
    if len(bad) < len(NON_FINITE[case]):
        bad.append(pool[1])
        elem[pool[1]] = elem[first]
    for i, v in zip(bad, NON_FINITE[case]):
        wts[i] = v
        charge[i] = v
    got = t_sc.particles_per_element(torch.from_numpy(elem), torch.from_numpy(active),
                                     tm.nelems, torch.from_numpy(wts)).numpy()
    ref = np.asarray(j_sc.particles_per_element(
        jnp.asarray(elem), jnp.asarray(active), jm.nelems, jnp.asarray(wts)))
    _same_pattern(got, ref)
    got = t_sc.scatter_to_verts_bcc(torch.from_numpy(elem), torch.from_numpy(active),
                                    torch.from_numpy(bcc), tm.elem2verts, tm.nverts,
                                    torch.from_numpy(charge)).numpy()
    ref = np.asarray(j_sc.scatter_to_verts_bcc(
        jnp.asarray(elem), jnp.asarray(active), jnp.asarray(bcc), jm.elem2verts,
        jm.nverts, jnp.asarray(charge)))
    _same_pattern(got, ref)
    if case == "inactive nan":
        assert np.isfinite(got).all()
    else:
        assert not np.isfinite(got).all() and np.isfinite(got).any()


def test_counts_match_reference(mesh):
    """count_per_key, count_per_key_matmul and the unweighted
    particles_per_element (kernel H's plain version) equal the reference's
    counts, keys outside [0, num_keys) ignored."""
    jm, tm = mesh
    rng, elem, active, _, _ = _particles(tm.nelems, 6000, 6)
    key = np.where(active, elem, tm.nelems).astype(np.int32)
    for name, dtype in (("count_per_key", torch.int32),
                        ("count_per_key_matmul", torch.float32)):
        got = getattr(t_sc, name)(torch.from_numpy(key), tm.nelems)
        ref = np.asarray(getattr(j_sc, name)(jnp.asarray(key), tm.nelems))
        assert got.dtype == dtype and got.shape == (tm.nelems,)
        np.testing.assert_array_equal(got.numpy(), ref.astype(got.numpy().dtype))
    got = t_sc.particles_per_element(torch.from_numpy(elem), torch.from_numpy(active),
                                     tm.nelems)
    ref = np.asarray(j_sc.particles_per_element(jnp.asarray(elem), jnp.asarray(active),
                                                jm.nelems))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    inside = active & (elem >= 0) & (elem < tm.nelems)
    assert float(got.sum()) == int(inside.sum())


@pytest.mark.parametrize("num_rings", [1, 3])
def test_gyro_scatter_matches_reference(num_rings):
    """ring accumulation then the mapped scatter, through the port's
    GyroMap: equal fields (integer counts and multiples of 1/P)."""
    raw = j_gen.tokamak_mesh(8, 40)
    jm, tm = JMesh2D.from_arrays(*raw), Mesh2D.from_arrays(*raw, device="cpu")
    rng = np.random.default_rng(num_rings)
    n, P = 5000, 4
    elem = rng.integers(-1, tm.nelems, n).astype(np.int32)
    active = (rng.uniform(size=n) < 0.9) & (elem >= 0)
    flat = rng.integers(0, tm.nverts, tm.nverts * num_rings * P * 3).astype(np.int32)
    flat[rng.uniform(size=flat.size) < 0.1] = -1
    ref = np.asarray(j_sc.gyro_scatter(jnp.asarray(elem), jnp.asarray(active),
                                       jm.elem2verts, jnp.asarray(flat), jm.nverts,
                                       num_rings, P, 0.038))
    g = t_sc.GyroMap.from_flat(flat, tm.nverts, num_rings, P, device="cpu")
    got = t_sc.gyro_scatter(torch.from_numpy(elem), torch.from_numpy(active), tm, g,
                            num_rings, P, 0.038)
    assert got.shape == (tm.nverts,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
