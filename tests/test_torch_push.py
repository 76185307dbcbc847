"""Parity of the port's push (pumipic_torch.ops.push, kernel P's module)
with the JAX reference, plus the kernel wrappers' device rules.

Push floats: rtol 1e-6, atol 1e-6 — XLA's CPU libm and fusion differ from
torch's (the per-class cos/sin and the atan2 of the setup).  The rotation
table: within 1 ulp of XLA's f32 cos/sin (the port's are f64 rounded).  The
straight-line push: equal (one f32 add of the same f32 displacement).  The
Boris push: rtol 1e-6 on velocities and positions (XLA contracts some of the
trilinear sum's and the rotation's products into FMAs, torch rounds each
product; the difference is an ulp or two), and boris_push_grid's plain
version equals interpolate_3d_grid followed by boris_push bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.ops import interpolate as j_interp
from pumipic_tpu.ops import push as j_push
from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.mesh.generate import box_tet_mesh
from pumipic_torch.mesh.locator import AnnulusLocator2D, BandGrid2D, KuhnLocator3D
from pumipic_torch.ops import interpolate as t_interp
from pumipic_torch.ops import locate as t_lo
from pumipic_torch.ops import push as t_push
from pumipic_torch.ops import scatter as t_sc
from pumipic_torch.ops import search as t_se

RTOL = ATOL = 1e-6


def test_elliptical_setup_matches_reference():
    """phi everywhere; b = (y-k)/sin(phi) where |sin(phi)| >= 0.5, since
    near phi = ±pi it divides phi's 1-ulp libm difference by |sin(phi)|.
    Points exactly on the axis give phi = 0 or pi and b = 0 on both sides."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1.0, 1.0, size=(5000, 2))
    pos[:8, 1] = -0.05                    # on the sin(phi) == 0 axis
    phi_r, b_r = j_push.elliptical_setup(jnp.asarray(pos), 0.1, -0.05, 0.9)
    phi_r, b_r = np.asarray(phi_r), np.asarray(b_r)
    p32 = torch.as_tensor(pos, dtype=torch.float32)
    phi, b = t_push.elliptical_setup(p32[:, 0], p32[:, 1], 0.1, -0.05, 0.9)
    np.testing.assert_allclose(phi.numpy(), phi_r, rtol=RTOL, atol=ATOL)
    ok = np.abs(np.sin(phi_r)) >= 0.5
    ok[:8] = True
    assert ok.sum() > 2500
    np.testing.assert_allclose(b.numpy()[ok], b_r[ok], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["tokamak", "annulus", "shuffled", "gap"])
def test_detect_banded_class_matches_reference(case):
    if case == "tokamak":
        cls = j_gen.tokamak_mesh(16, 96)[2]
    elif case == "annulus":
        cls = j_gen.annulus_mesh(6, 40, 0.3, 1.0)[2]
    elif case == "shuffled":
        cls = np.random.default_rng(1).permutation(j_gen.tokamak_mesh(16, 96)[2])
    else:
        cls = np.repeat([1, 2, 4], 5)
    assert t_push.detect_banded_class(cls) == j_push.detect_banded_class(cls)


def test_class_and_rotation_match_reference():
    cls = j_gen.tokamak_mesh(16, 96)[2]
    starts = j_push.detect_banded_class(cls)
    elem = np.random.default_rng(2).integers(0, cls.size, 3000).astype(np.int32)
    cid_r = np.asarray(j_push.class_from_bands(jnp.asarray(elem), starts))
    cid = t_push.class_from_bands(torch.from_numpy(elem), starts)
    np.testing.assert_array_equal(cid.numpy(), cid_r)
    np.testing.assert_array_equal(cid_r, cls[elem])
    cd_r, sd_r = j_push.rot_vals_from_class(jnp.asarray(cid_r), 15.0)
    cd, sd = t_push.rot_vals_from_class(cid, 15.0)
    np.testing.assert_allclose(cd.numpy(), np.asarray(cd_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hkd", [(0.0, 0.0, 0.9), (0.2, -0.15, 0.3)])
def test_push_banded_matches_reference(hkd):
    """Kernel P's plain version (what the wrapper runs on CPU tensors) equals
    the JAX composite class_from_bands -> rot_vals_from_class ->
    elliptical_push_rot_vals -> active mask."""
    h, k, d = hkd
    cls = j_gen.tokamak_mesh(16, 96)[2]
    starts = j_push.detect_banded_class(cls)
    rng = np.random.default_rng(4)
    n = 6000
    phi = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    x0 = rng.uniform(-1, 1, n).astype(np.float32)
    x1 = rng.uniform(-1, 1, n).astype(np.float32)
    b = rng.uniform(0.2, 1.0, n).astype(np.float32)
    cphi, sphi = np.cos(phi), np.sin(phi)
    elem = rng.integers(-1, cls.size, n).astype(np.int32)
    active = rng.uniform(size=n) > 0.1
    deg = 15.0

    cd, sd = j_push.rot_vals_from_class(
        j_push.class_from_bands(jnp.maximum(jnp.asarray(elem), 0), starts), deg)
    tx, ty, c2, s2 = j_push.elliptical_push_rot_vals(
        jnp.asarray(cphi), jnp.asarray(sphi), jnp.asarray(b), cd, sd, h, k, d)
    ref = (np.where(active, tx, x0), np.where(active, ty, x1),
           np.where(active, c2, cphi), np.where(active, s2, sphi))

    rot = t_push.BandRotation.build(starts, deg, device="cpu")
    got = t_push.push_banded(
        *(torch.from_numpy(a) for a in (x0, x1, cphi, sphi, b, elem, active)),
        rot, h, k, d)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL)
    # inactive particles keep their position and angle exactly
    np.testing.assert_array_equal(got[0].numpy()[~active], x0[~active])
    np.testing.assert_array_equal(got[3].numpy()[~active], sphi[~active])


@pytest.mark.parametrize("deg", [15.0, 30.0, 7.5])
def test_elliptical_rot_table_within_one_ulp_of_reference(deg):
    cls = np.random.default_rng(3).permutation(j_gen.tokamak_mesh(16, 96)[2])
    want = np.asarray(j_push.elliptical_rot_table(jnp.asarray(cls), deg))
    got = t_push.elliptical_rot_table(cls, deg)
    assert got.dtype == torch.float32 and got.shape == (cls.size, 2)
    ulps = np.abs(got.numpy().view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # the band rotation's per-class values are the same function of the class
    cd, sd = t_push.rot_vals_from_class(torch.from_numpy(cls.astype(np.int32)), deg)
    np.testing.assert_allclose(got.numpy(), np.stack([cd, sd], 1), rtol=0, atol=1e-7)


@pytest.mark.parametrize("form", ["2d", "1d"])
@pytest.mark.parametrize("hkd", [(0.0, 0.0, 0.9), (0.2, -0.15, 0.3)])
def test_push_table_matches_reference(form, hkd):
    """Kernel P's table mode (plain version on CPU tensors) equals the JAX
    elliptical_push_rot on the per-element table (or its 1-D sin Δ form,
    mapped onto (E, 2)) followed by the active mask."""
    h, k, d = hkd
    cls = np.random.default_rng(5).permutation(j_gen.tokamak_mesh(16, 96)[2])
    rng = np.random.default_rng(6)
    n = 6000
    phi = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    x0, x1 = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    b = rng.uniform(0.2, 1.0, n).astype(np.float32)
    cphi, sphi = np.cos(phi), np.sin(phi)
    elem = rng.integers(-1, cls.size, n).astype(np.int32)
    active = rng.uniform(size=n) > 0.1
    jt = j_push.elliptical_rot_table(jnp.asarray(cls), 15.0)
    if form == "1d":
        jt = jt[:, 1]
    tx, ty, c2, s2 = j_push.elliptical_push_rot(
        jnp.asarray(cphi), jnp.asarray(sphi), jnp.asarray(b), jnp.asarray(elem),
        jt, h, k, d)
    ref = (np.where(active, tx, x0), np.where(active, ty, x1),
           np.where(active, c2, cphi), np.where(active, s2, sphi))
    rot = t_push.RotTable.build(cls, 15.0, device="cpu", one_dim=form == "1d")
    assert rot.table.shape == (cls.size, 2)
    args = [torch.from_numpy(a) for a in (x0, x1, cphi, sphi, b, elem, active)]
    got = t_push.push_table(*args, rot, h, k, d)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy()[~active], x1[~active])
    np.testing.assert_array_equal(got[2].numpy()[~active], cphi[~active])
    # the unmasked form, on the table or on its 1-D form
    raw = t_push.elliptical_push_rot(args[2], args[3], args[4], args[5],
                                     rot.table, h, k, d)
    np.testing.assert_allclose(raw[0].numpy(), np.asarray(tx), rtol=RTOL, atol=ATOL)


def test_straight_line_push_and_wrap_match_reference():
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.2, 1.2, (5000, 3)).astype(np.float32)
    d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    want = np.asarray(j_push.straight_line_push(jnp.asarray(x),
                                                jnp.asarray(d, jnp.float32), 0.05))
    got = t_push.straight_line_push(torch.from_numpy(x), d.astype(np.float32), 0.05)
    np.testing.assert_array_equal(got.numpy(), want)
    lo = np.zeros(3, np.float32)
    ext = np.ones(3, np.float32)
    wrapped = (jnp.asarray(want) - jnp.asarray(lo)) % jnp.asarray(ext) + jnp.asarray(lo)
    got = t_push.push_and_wrap(torch.from_numpy(x), t_push.step_vector(d, 0.05),
                               (lo, ext))
    np.testing.assert_array_equal(got.numpy(), np.asarray(wrapped))
    assert got.min() >= 0.0 and got.max() <= 1.0


def _wrapper_calls(dev):
    """One call per kernel wrapper with small tensors on ``dev``."""
    n = 4
    f = torch.zeros(n, device=dev)
    e = torch.zeros(n, dtype=torch.int32, device=dev)
    a = torch.ones(n, dtype=torch.bool, device=dev)
    rot = t_push.BandRotation(torch.zeros(0, dtype=torch.int32, device=dev),
                              torch.ones(1, device=dev), torch.zeros(1, device=dev))
    geom = torch.zeros(1, 12, device=dev)
    coords, tris, cls = j_gen.annulus_mesh(2, 8, 0.5, 1.0)
    mesh = Mesh2D.from_arrays(coords, tris, cls, device="cpu").to(dev)
    gmap = t_sc.GyroMap.from_flat(np.full(mesh.nverts * 1 * 1 * 3, -1),
                                  mesh.nverts, 1, 1, dev)
    band = BandGrid2D(0.0, 0.0, torch.ones(3, 2, device=dev),
                      torch.ones(2, 9, device=dev), torch.ones(4, device=dev),
                      torch.zeros(16, 14, device=dev),
                      torch.zeros(16, dtype=torch.int32, device=dev),
                      n_bands=4, n_theta=4, n_harm=4, n_cheb=2, rank=2)
    ann = AnnulusLocator2D(0.0, 0.0, 0.5, 0.25, 2, 8,
                           perm=torch.arange(32, dtype=torch.int32, device=dev))
    kuhn = KuhnLocator3D((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                         perm=torch.arange(6, dtype=torch.int32, device=dev))
    mesh3 = Mesh3D.from_arrays(*box_tet_mesh(1, 1, 1), device="cpu").to(dev)
    grid3 = torch.zeros(2, 2, 2, 3, device=dev)
    x3 = torch.zeros(n, 3, device=dev)
    x2 = torch.zeros(n, 2, device=dev)
    table = t_push.RotTable(torch.zeros(3, 2, device=dev))
    return {
        "push table": lambda: t_push.push_table(f, f, f, f, f, e, a, table, 0.0, 0.0, 0.9),
        "kuhn_locate": lambda: t_lo.kuhn_push_locate(kuhn, x3, a),
        "push_wrap": lambda: t_push.push_and_wrap(x3, np.ones(3, np.float32)),
        "locate3d": lambda: t_se.walk_locate_3d(torch.zeros(1, 16, device=dev), x3, e, a, 4),
        "band_cell": lambda: t_lo.band_cell_of(band, f, f),
        "annulus_locate": lambda: t_lo.annulus_locate(ann, f, f, a),
        "push": lambda: t_push.push_banded(f, f, f, f, f, e, a, rot, 0.0, 0.0, 0.9),
        "locate": lambda: t_se.walk_locate(geom, f, f, e, a, 4),
        "histogram": lambda: t_sc.histogram(e, a, 3),
        "deposit": lambda: t_sc.scatter_to_mapped_verts(
            torch.zeros(mesh.nverts, 1, device=dev), gmap, mesh.nverts, 1, 1),
        "boris": lambda: t_push.boris_push_grid(x3, x3, grid3, np.zeros(3), np.ones(3),
                                                np.zeros(3), 1e-8),
        "trace3d": lambda: t_se.trace_3d(mesh3, x3, x3, e, a, 4, method="intersection"),
        "wall_tally": lambda: t_sc.wall_tally(e, a, e, 3),
        "trace2d": lambda: t_se.trace_2d(mesh, x2, x2, e, a, 4, t_se.reflect_on_exit_2d,
                                         True),
        "vdeposit": lambda: t_sc.scatter_to_verts_bcc(e, a, x3, mesh.elem2verts,
                                                      mesh.nverts),
        "check_parents": lambda: t_se.check_initial_parents(mesh, x2, e, a),
    }


@pytest.mark.parametrize("name", ["push", "push table", "band_cell", "annulus_locate",
                                  "locate", "histogram", "deposit", "kuhn_locate",
                                  "push_wrap", "locate3d", "boris", "trace3d",
                                  "wall_tally", "trace2d", "vdeposit", "check_parents"])
def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices(name):
    """On CPU tensors a wrapper runs its plain version and counts no launch;
    on a device that is neither CPU nor CUDA it raises (no fallback)."""
    kernels.reset_launches()
    _wrapper_calls("cpu")[name]()
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        _wrapper_calls("meta")[name]()


def test_kernel_build_flags():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "-ftz=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert sorted(p.name for p in _build.sources()) == [
        "annulus.cu", "band.cu", "boris.cu", "counts.cu", "deposit.cu", "exchange.cu",
        "gather.cu",
        "gitr.cu", "histogram.cu", "kuhn.cu", "locate.cu", "locate3d.cu", "owner.cu",
        "parents.cu", "push.cu", "rebuild.cu", "reshuffle.cu", "route.cu", "slotmap.cu",
        "trace2d.cu", "trace3d.cu", "vdeposit.cu"]
    assert "-shared" not in _build.NVCC_FLAGS      # compile flags; the link adds it
    for name in _build.SIGNATURES:
        assert any(f'extern "C" int {name}(' in p.read_text()
                   for p in _build.sources()), name


# ---------------------------------------------------------------------------
# the Boris push and kernel R's plain version
# ---------------------------------------------------------------------------

def _boris_inputs(n=20_000, b=(0.0, 0.0, 1.3e-3)):
    """Positions over (and a little outside) a (5, 6, 7, 3) E grid of cell
    spacing (0.25, 0.2, 1/6) from the origin, N(0, 1e3) velocities, N(0,
    0.2) V/m field values, a uniform B."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    v = rng.normal(0, 1e3, (n, 3)).astype(np.float32)
    grid = rng.normal(0, 0.2, (5, 6, 7, 3)).astype(np.float32)
    o = np.zeros(3, np.float32)
    h = np.array([0.25, 0.2, 1 / 6], np.float32)
    return x, v, grid, o, h, np.asarray(b, np.float32)


@pytest.mark.parametrize("b", [(0.0, 0.0, 1.3e-3), (0.3, -0.2, 0.5), (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("dt", [2e-5, 1e-8])
def test_boris_push_matches_reference(b, dt):
    x, v, grid, o, h, bv = _boris_inputs(b=b)
    rng = np.random.default_rng(5)
    e = rng.normal(0, 0.2, x.shape).astype(np.float32)
    B = np.ascontiguousarray(np.broadcast_to(bv, x.shape))
    xr, vr = j_push.boris_push(jnp.asarray(x), jnp.asarray(v), jnp.asarray(e),
                               jnp.asarray(B), dt, 1.0, 10.0)
    xt, vt = t_push.boris_push(torch.from_numpy(x), torch.from_numpy(v),
                               torch.from_numpy(e), torch.from_numpy(B), dt, 1.0, 10.0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vr), rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=RTOL, atol=ATOL)
    # the f32 rounding of q' and 2q' is the JAX package's weak-type rounding
    qp, two_qp = t_push.boris_factors(dt, 1.0, 10.0)
    assert two_qp == 2 * qp and qp == float(np.float32(
        1.0 * t_push.ELEMENTARY_CHARGE / (10.0 * t_push.PROTON_MASS) * dt * 0.5))


@pytest.mark.parametrize("b", [(0.0, 0.0, 1.3e-3), (0.3, -0.2, 0.5)])
def test_boris_push_grid_matches_reference(b):
    """The fused wrapper on the CPU (its plain version) against the JAX
    package's interpolate_3d_grid + boris_push, and bit for bit against the
    port's two steps."""
    x, v, grid, o, h, bv = _boris_inputs(b=b)
    e_r = j_interp.interpolate_3d_grid(jnp.asarray(grid), jnp.asarray(o), jnp.asarray(h),
                                       jnp.asarray(x))
    xr, vr = j_push.boris_push(jnp.asarray(x), jnp.asarray(v), e_r,
                               jnp.broadcast_to(jnp.asarray(bv), x.shape), 2e-5, 1.0, 10.0)
    kernels.reset_launches()
    xt, vt = t_push.boris_push_grid(torch.from_numpy(x), torch.from_numpy(v),
                                    torch.from_numpy(grid), o, h, bv, 2e-5)
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vr), rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=RTOL, atol=ATOL)
    e_t = t_interp.interpolate_3d_grid(torch.from_numpy(grid), torch.from_numpy(o),
                                       torch.from_numpy(h), torch.from_numpy(x))
    x2, v2 = t_push.boris_push(torch.from_numpy(x), torch.from_numpy(v), e_t,
                               torch.from_numpy(np.ascontiguousarray(
                                   np.broadcast_to(bv, x.shape))), 2e-5, 1.0, 10.0)
    assert torch.equal(xt, x2) and torch.equal(vt, v2)


def test_boris_push_conserves_speed_without_e():
    """With E = 0 the Boris rotation conserves |v| to f32 rounding, and a
    zero B leaves v unchanged."""
    x, v, grid, o, h, bv = _boris_inputs(b=(0.2, 0.1, 0.9))
    zero = np.zeros_like(grid)
    _, vt = t_push.boris_push_grid(torch.from_numpy(x), torch.from_numpy(v),
                                   torch.from_numpy(zero), o, h, bv, 1e-6)
    np.testing.assert_allclose(vt.norm(dim=1).numpy(), np.linalg.norm(v, axis=1), rtol=1e-5)
    _, v0 = t_push.boris_push_grid(torch.from_numpy(x), torch.from_numpy(v),
                                   torch.from_numpy(zero), o, h, np.zeros(3), 1e-6)
    assert torch.equal(v0, torch.from_numpy(v))
