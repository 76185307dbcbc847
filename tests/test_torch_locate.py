"""Parity of the port's analytic locators with the JAX reference: the
flux-band grid (``detect_banded_locator``, kernel B's plain version
``band_cell_of_plain``) and the structured-annulus locator
(``detect_annulus_structured``, kernel A's plain version).

Tolerances: the band tables (coefficients, ``cell_rows``, ``cell_elem``)
are bit-equal.  Cell ids equal the JAX package's op-by-op ``cell_of``
exactly; against its jitted ``cell_of`` (XLA fuses and may contract
a*b+c on the CPU) at most 0.5% differ, and only in the band (measured
0.3% on this mesh, the same points where the JAX package's jitted and
op-by-op ids differ).
Annulus element ids are equal except for a counted number of points that
lie on a side shared by both elements (the containment tolerance of
``tests/test_search.py``'s annulus test)."""
import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_torch import interop
from pumipic_torch.mesh import locator as t_loc
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.ops import locate as lo
from pumipic_torch.ops import push as t_push

BAND_TABLES = ("coef_u", "coef_v", "inv_coef", "cell_rows", "cell_elem")


@pytest.fixture(scope="module")
def band():
    """The band mesh of tests/test_search.py (tokamak_mesh(24, 120)) with
    the JAX and the port's band grids."""
    coords, tris, cls = j_gen.tokamak_mesh(24, 120)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    jg = j_loc.detect_banded_locator(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     np.asarray(jm.class_id), jm.walk_geom)
    args = (m.coords.numpy(), m.elem2verts.numpy(), m.class_id.numpy(), m.walk_geom)
    return dict(jm=jm, m=m, jg=jg, args=args,
                tg=t_loc.detect_banded_locator(*args, device="cpu"))


def test_band_launch_params_layout(band):
    """Kernel B's parameter block (band.cu's BandParams) holds the JAX
    package's coefficients: coef_v's harmonic columns as (cos, sin) pairs,
    its constant column, coef_u, inv_coef, zero padding, then cx, cy and
    the grid's shape; packed once per grid."""
    jg, tg = band["jg"], band["tg"]
    w = tg.launch_params
    assert w is tg.launch_params and w.dtype == np.int32 and w.shape == (lo.MAX_COEF + 9,)
    f = w.view(np.float32)
    J, rank = tg.n_harm, tg.rank
    cv, cu, ic = (np.asarray(c) for c in (jg.coef_v, jg.coef_u, jg.inv_coef))
    pairs = f[:rank * J * 2].reshape(rank, J, 2)
    np.testing.assert_array_equal(pairs[..., 0], cv[:, 1:1 + J])
    np.testing.assert_array_equal(pairs[..., 1], cv[:, 1 + J:])
    o = rank * J * 2
    np.testing.assert_array_equal(f[o:o + rank], cv[:, 0])
    o += rank
    np.testing.assert_array_equal(f[o:o + cu.size], cu.reshape(-1))
    o += cu.size
    np.testing.assert_array_equal(f[o:o + ic.size], ic)
    assert not w[o + ic.size:lo.MAX_COEF].any()
    np.testing.assert_array_equal(f[lo.MAX_COEF:lo.MAX_COEF + 2],
                                  np.float32([tg.cx, tg.cy]))
    assert w[lo.MAX_COEF + 2:].tolist() == [tg.n_bands, tg.n_theta, J, tg.n_cheb, rank,
                                            ic.size, tg.newton_iters]


def test_band_detection_matches_reference(band):
    jg, tg = band["jg"], band["tg"]
    assert jg is not None and tg is not None
    for k in ("n_bands", "n_theta", "n_harm", "n_cheb", "rank", "newton_iters"):
        assert getattr(tg, k) == getattr(jg, k), k
    assert (tg.n_bands, tg.n_theta) == (24, 512)
    assert tg.cx == float(jg.cx) and tg.cy == float(jg.cy)
    for k in BAND_TABLES:
        a, b = np.asarray(getattr(jg, k)), getattr(tg, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the reference's fields carried across give the same grid
    carried = interop.band_grid_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in interop.BAND_FIELDS}, device="cpu")
    for f in dc.fields(t_loc.BandGrid2D):
        a, b = getattr(carried, f.name), getattr(tg, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


@pytest.mark.parametrize("chunk", [None, 1000])
def test_band_calibration_chunking_is_exact(band, chunk):
    """The calibration's cells, evaluated all at once or 1,000 points at a
    time, give the default (2^20-point chunks) tables bit for bit."""
    got = t_loc.detect_banded_locator(*band["args"], chunk=chunk, device="cpu")
    for k in BAND_TABLES:
        assert torch.equal(getattr(got, k), getattr(band["tg"], k)), k


@pytest.mark.parametrize("case", ["rectangle", "disk", "shuffled", "coarse"])
def test_band_detection_negatives(case):
    """Meshes without the stitched band structure give None in both
    packages (tests/test_search.py's negatives)."""
    cls = None
    if case == "rectangle":
        coords, tris = j_gen.rectangle_mesh(8, 8)
    elif case == "disk":
        coords, tris, cls = j_gen.disk_mesh(8, 8)
    elif case == "coarse":
        coords, tris, cls = j_gen.tokamak_mesh(8, 40)
    else:
        coords, tris, cls = j_gen.tokamak_mesh(6, 24)
        cls = np.asarray(cls).copy()
        cls[::7] = 1
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    assert j_loc.detect_banded_locator(np.asarray(coords), np.asarray(tris),
                                       np.asarray(jm.class_id), jm.walk_geom) is None
    assert t_loc.detect_banded_locator(np.asarray(coords), np.asarray(tris),
                                       m.class_id.numpy(), m.walk_geom, device="cpu") is None


def test_band_n_theta_guard_and_sizing_rule(band):
    with pytest.raises(ValueError, match="2\\^24"):
        t_loc.detect_banded_locator(*band["args"], n_theta=1 << 20, device="cpu")
    # the reference's TPU cost-model constants, kept as its sizing rule
    for rows in (100_000, 500_000, 2_000_000):
        for cols in (2, 14):
            assert t_loc.predict_rowgather_ms(rows, 14, cols) == \
                j_loc.predict_rowgather_ms(rows, 14, cols)
    assert t_loc.BAND_ROWS_BYTES_BUDGET == j_loc.BAND_ROWS_BYTES_BUDGET
    assert t_loc._F32_EXACT_ID_LIMIT == j_loc._F32_EXACT_ID_LIMIT
    # a generous cost gate admits, a tight one rejects (API parity)
    assert t_loc.detect_banded_locator(*band["args"], cost_gate_ms=1e9, device="cpu") is not None
    assert t_loc.detect_banded_locator(*band["args"], cost_gate_ms=1.0, device="cpu") is None


def test_band_cell_of_matches_reference(band):
    jg, tg = band["jg"], band["tg"]
    coords = band["m"].coords.numpy().astype(np.float64)
    tris = band["m"].elem2verts.numpy()
    rng = np.random.default_rng(21)
    te = rng.integers(0, len(tris), 20_000)
    w = rng.dirichlet((1.0, 1.0, 1.0), len(te))
    pts = (coords[tris[te]] * w[:, :, None]).sum(axis=1).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [5.0, 0.0], [0.08, 0.0], [-1e-3, 2e-3]]
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    got = lo.band_cell_of(tg, px, py)
    assert got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < tg.n_bands * tg.n_theta
    jx_pts = (jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    np.testing.assert_array_equal(np.asarray(jg.cell_of(jx_pts)), got.numpy())
    # jitted, XLA fuses the evaluation and the Newton steps round
    # differently; where a point's Newton path is ill-conditioned the band
    # moves by more than one (up to 8 on this mesh) -- the reference's own
    # jit-vs-eager difference, which the peel's walk absorbs
    jit = np.asarray(jax.jit(lambda a, b: jg.cell_of((a, b)))(*jx_pts))
    bad = np.nonzero(jit != got.numpy())[0]
    assert len(bad) <= 0.005 * len(pts), len(bad)
    T = tg.n_theta
    np.testing.assert_array_equal(jit[bad] % T, got.numpy()[bad] % T)
    # the cell method is the wrapper
    assert torch.equal(tg.cell_of(px, py), got)


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _contains(coords, tri, p, rel):
    a, b, c = coords[tri]
    s = _cross2(b - a, c - a)
    tol = rel * abs(s) + 1e-9
    return all(_cross2(q - o, p - o) * np.sign(s) >= -tol
               for o, q in ((a, b), (b, c), (c, a)))


def _annulus(case):
    coords, tris, cls = j_gen.annulus_mesh(8, 48, 0.3, 1.0)
    if case == "permuted":
        # tests/test_search.py:1064's import: shuffled vertices and
        # elements and a rigid rotation
        coords, tris, cls = j_gen.annulus_mesh(12, 64, 0.3, 1.0)
        rng = np.random.default_rng(3)
        pv = rng.permutation(len(coords))
        rot = 0.37
        R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
        coords2 = np.empty_like(coords)
        coords2[pv] = coords @ R.T
        pe = rng.permutation(len(tris))
        coords, tris, cls = coords2, pv[tris][pe], np.asarray(cls)[pe]
    return coords, tris, cls


@pytest.mark.parametrize("case", ["identity", "permuted"])
def test_annulus_locate_matches_reference(case):
    coords, tris, cls = _annulus(case)
    jl = j_loc.detect_annulus_structured(coords, tris, cls=cls)
    tl = t_loc.detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    assert (tl.n_rings, tl.n_sectors, tl.ring_class) == (
        jl.n_rings, jl.n_sectors, jl.ring_class)
    assert tl.ring_class == (case == "identity")
    for k in ("cx", "cy", "r_in", "dr", "theta0"):
        assert getattr(tl, k) == float(np.float32(getattr(jl, k))), k
    if case == "permuted":
        np.testing.assert_array_equal(np.asarray(jl.perm), tl.perm.numpy())
    else:
        assert jl.perm is None and tl.perm is None
    carried = interop.annulus_from_numpy(
        {f: getattr(jl, f) for f in interop.ANNULUS_FIELDS}, device="cpu")
    assert dc.replace(carried, perm=None) == dc.replace(tl, perm=None)

    rng = np.random.default_rng(44)
    n = 20_000
    te = rng.integers(0, len(tris), n)
    w = rng.dirichlet((1.0, 1.0, 1.0), n)
    pts = (coords[tris[te]] * w[:, :, None]).sum(axis=1)
    pts[:2000] *= rng.uniform(0.2, 1.3, (2000, 1))        # some outside
    pts = pts.astype(np.float32)
    active = rng.uniform(size=n) > 0.05
    ref = np.asarray(jax.jit(lambda p: jl.locate(p)[0])(jnp.asarray(pts)))
    ref = np.where(active, ref, -1)
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    elem, act = lo.annulus_locate(tl, px, py, torch.from_numpy(active))
    got = elem.numpy()
    np.testing.assert_array_equal(act.numpy(), got >= 0)
    assert (got[~active] == -1).all() and (got[active] >= 0).mean() > 0.8
    bad = np.nonzero(ref != got)[0]
    assert len(bad) <= 0.001 * n, len(bad)
    for i in bad:                 # ties on a side both elements share
        assert ref[i] >= 0 and got[i] >= 0, i
        for e in (ref[i], got[i]):
            assert _contains(coords, tris[e], pts[i].astype(np.float64), 1e-5), i
    # locate / locate_parts agree with the kernel's result
    e2, inside = tl.locate(px, py)
    assert torch.equal(e2[torch.from_numpy(active)], elem[torch.from_numpy(active)])
    parts = tl.locate_parts(px, py)
    assert torch.equal(parts[0], e2) and torch.equal(parts[1], inside)


def test_annulus_class_of_equals_banded_class():
    """On the bench annulus (make_default_mesh(24000)) the JAX push's
    analytic class equals kernel P's banded class on every element."""
    m = tx.make_default_mesh(24_000, device="cpu")
    jm = jx.make_default_mesh(24_000)
    np.testing.assert_array_equal(np.asarray(jm.coords), m.coords.numpy())
    np.testing.assert_array_equal(np.asarray(jm.elem2verts), m.elem2verts.numpy())
    assert (m.nelems, m.nverts) == (23_976, 12_210)
    cls = m.class_id.numpy()
    loc = t_loc.detect_annulus_structured(m.coords.numpy(), m.elem2verts.numpy(), cls=cls, device="cpu")
    assert loc.ring_class and (loc.n_rings, loc.n_sectors) == (54, 222)
    e = torch.arange(m.nelems, dtype=torch.int32)
    analytic = loc.class_of(e)
    np.testing.assert_array_equal(analytic.numpy(), cls)
    banded = t_push.detect_banded_class(cls)
    assert torch.equal(t_push.class_from_bands(e, banded), analytic)
    jloc = j_loc.detect_annulus_structured(np.asarray(jm.coords),
                                           np.asarray(jm.elem2verts), cls=cls)
    np.testing.assert_array_equal(np.asarray(jloc.class_of(jnp.asarray(e.numpy()))),
                                  analytic.numpy())
    with pytest.raises(ValueError, match="ring_class"):
        dc.replace(loc, ring_class=False).class_of(e)



@pytest.mark.parametrize("case", ["identity", "permuted"])
def test_annulus_sector_table_equals_per_point_trig(case, monkeypatch):
    """Kernel A reads cos/sin of each point's sector bisector and rays from
    ``AnnulusLocator2D.sector_table`` in place of computing them: the table
    gathered at each point's kf equals, bit for bit, the six per-point
    cos/sin values ``annulus_locate_parts_plain`` computes (captured from
    its torch.cos/torch.sin calls), with and without an element
    permutation."""
    coords, tris, cls = _annulus(case)
    loc = t_loc.detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    assert (loc.perm is not None) == (case == "permuted")
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.2, 1.2, (20_000, 2)).astype(np.float32)
    pts[:3] = [[loc.cx, loc.cy], [np.nan, 0.5], [np.inf, -np.inf]]
    px, py = torch.from_numpy(pts[:, 0].copy()), torch.from_numpy(pts[:, 1].copy())
    table = loc.sector_table("cpu")
    assert table is loc.sector_table(torch.device("cpu"))       # built once
    assert table.shape == (loc.n_sectors, 6) and table.dtype == torch.float32
    loc.scalars()
    seen = []
    for name in ("cos", "sin"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda t, fn=fn: seen.append(fn(t)) or seen[-1])
    kf = lo.annulus_locate_parts_plain(loc, px, py)[3]
    monkeypatch.undo()
    assert len(seen) == 6             # cos, sin of phi, tha and thd, in that order
    finite = ~torch.isnan(kf)
    rows_at = table[kf[finite].long()]
    for col, per_point in enumerate(seen):
        np.testing.assert_array_equal(rows_at[:, col].numpy().view(np.int32),
                                      per_point[finite].numpy().view(np.int32))
    # where kf is NaN (a NaN coordinate) the point is outside either way
    assert (lo.annulus_locate_parts_plain(loc, px, py)[0][~finite] == -1).all()


def test_annulus_scalars_are_kept_and_equal_a_fresh_computation():
    """``scalars()`` is computed once per eps and kept on the locator; the
    kept values equal a fresh locator's, and a caller's edit of the
    returned dict does not reach the kept one."""
    coords, tris, cls = _annulus("identity")
    loc = t_loc.detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    first = loc.scalars()
    first["dth"] = 0.0
    kept = loc.scalars()
    fresh = dc.replace(loc).scalars()
    assert kept == fresh and kept["dth"] != 0.0
    assert loc.scalars(eps=1e-3)["hi"] > fresh["hi"]      # another eps, its own entry
    assert loc.scalars() == fresh
    f = np.float32
    assert fresh["two_pi"] == f(2 * np.pi) and fresh["dth"] == f(f(2 * np.pi) / f(loc.n_sectors))
