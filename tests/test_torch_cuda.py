"""Card-only checks of the port's kernels: each kernel (P, B, A, L, H, D, G,
S, K, L3, the GITR-style app's R, M, F and W, the 2D walk modes' M2 and the
deposit V, with their modes, the rebuild's Q and C, and the distributed
step's X1, X2, X3 and O on tests/torch_ranks.py's adversarial cases, its
route and the balancer's selection (Y1 in each form, Y2, Y3), the parent
check J and L's plain walk in place and dense, the reshuffle's U1, U2 and
U3, the Sell-C-σ row order Z and the picparts step's counts N) against its
plain PyTorch
version on the same CUDA tensors (exact), and its launch counter; M's and M2's mixed walk
lengths and R's corner rows at their edges; L's count of the walkers deleted at
the limit; the locator grid built on the card against the host build.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports no JAX, so it also runs where JAX is not installed, without the
suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from pumipic_torch import kernels
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.generate import annulus_mesh, tokamak_mesh
from pumipic_torch.mesh.locator import (
    build_locator_grid,
    detect_annulus_structured,
    detect_banded_locator,
)
from pumipic_torch.models import pseudo_xgcm as px
from pumipic_torch.ops import exchange as ex
from pumipic_torch.ops import locate as lo
from pumipic_torch.ops import push as push_ops
from pumipic_torch.ops import rebuild as rb
from pumipic_torch.ops import scatter as sc
from pumipic_torch.ops import search as se

import slotmap_tiles
import torch_ranks as tr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh(dev):
    return Mesh2D.from_arrays(*tokamak_mesh(16, 96), device=dev)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _state(mesh, n=50_000):
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=8, deg_per_push=15.0,
                        max_search_iters=64)
    return cfg, px.initial_state(mesh, cfg)


def test_push_kernel_equals_plain(dev, mesh):
    cfg, s = _state(mesh)
    s["active"][::7] = False
    rot = push_ops.BandRotation.build(
        push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), 15.0, dev)
    args = (s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
            s["active"], rot, 0.1, -0.05, 0.7)
    n0 = kernels.LAUNCHES["push"]
    got = push_ops.push_banded(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["push"] == n0 + 1
    _equal(got, push_ops.push_banded_plain(*args))


@pytest.mark.parametrize("peel", [True, False])
def test_locate_kernel_equals_plain(dev, mesh, peel):
    cfg, s = _state(mesh)
    g = torch.Generator(device="cpu").manual_seed(0)
    dx = (s["x0"].cpu() + 0.05 * torch.randn(s["x0"].shape, generator=g)).to(dev)
    dy = (s["x1"].cpu() + 0.05 * torch.randn(s["x1"].shape, generator=g)).to(dev)
    grid = build_locator_grid(mesh.coords.cpu().numpy(),
                              mesh.elem2verts.cpu().numpy(),
                              walk_geom=mesh.walk_geom.cpu(),
                              device=dev) if peel else None
    for max_iters in (64, 2, 1):
        args = (mesh.walk_geom, dx, dy, s["elem"], s["active"], max_iters)
        n0 = kernels.LAUNCHES["locate"]
        got = se.walk_locate(*args, grid=grid)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["locate"] == n0 + 1
        _equal(got, se.walk_locate_plain(*args, grid=grid))


def test_histogram_and_deposit_kernels_equal_plain(dev, mesh):
    rng = np.random.default_rng(1)
    elem = torch.as_tensor(rng.integers(-1, mesh.nelems, 100_000), dtype=torch.int32,
                           device=dev)
    active = elem >= 0
    counts = sc.histogram(elem, active, mesh.nelems)
    assert torch.equal(counts, sc.histogram_plain(elem, active, mesh.nelems))
    fwd, _ = px.build_gyro_mappings(mesh, px.GyroConfig())
    gmap = sc.GyroMap.from_flat(fwd, mesh.nverts, 3, 8, dev)
    for R in (1, 3):
        ring = sc.deposit_rings(counts, mesh, R)
        assert torch.equal(ring, sc.ring_accum_plain(counts, mesh, R))
    out = sc.scatter_to_mapped_verts(ring, gmap, mesh.nverts, 3, 8)
    assert torch.equal(out, sc.mapped_plain(ring, gmap, mesh.nverts, 3, 8))


def _moved(mesh, n=50_000, scale=0.05, seed=0):
    """Seeded particles and destinations moved by a random displacement
    (some leave the domain)."""
    cfg, s = _state(mesh, n)
    g = torch.Generator(device="cpu").manual_seed(seed)
    dx = s["x0"].cpu() + scale * torch.randn(s["x0"].shape, generator=g)
    dy = s["x1"].cpu() + scale * torch.randn(s["x1"].shape, generator=g)
    return s, dx.to(mesh.device), dy.to(mesh.device)


def test_band_kernel_and_given_cells_locate_equal_plain(dev):
    m = Mesh2D.from_arrays(*tokamak_mesh(24, 120), device=dev)
    grid = detect_banded_locator(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(),
                                 m.class_id.cpu().numpy(), m.walk_geom, device=dev)
    s, dx, dy = _moved(m)
    n0 = kernels.LAUNCHES["band_cell"]
    cells = lo.band_cell_of(grid, dx, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_cell"] == n0 + 1
    assert torch.equal(cells, lo.band_cell_of_plain(grid, dx, dy))
    # non-finite and far-away points are clamped into the table alike
    odd = torch.tensor([float("nan"), float("inf"), 0.0, 1e30], device=dev)
    assert torch.equal(lo.band_cell_of(grid, odd, odd.flip(0)),
                       lo.band_cell_of_plain(grid, odd, odd.flip(0)))
    for max_iters in (64, 2):
        args = (m.walk_geom, dx, dy, s["elem"], s["active"], max_iters)
        n0 = kernels.LAUNCHES["locate"]
        got = se.walk_locate(*args, grid=grid)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["locate"] == n0 + 1
        _equal(got, se.walk_locate_plain(*args, grid=grid))


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("n", [0, 1, 31, 50_000])
def test_annulus_kernel_equals_plain(dev, permuted, n):
    """A equals its plain version on a detected annulus, generator order or
    imported (permuted and rotated), with inactive points, the centre,
    NaN and infinite coordinates, at sizes that leave partial blocks."""
    coords, tris, cls = annulus_mesh(8, 48, 0.3, 1.0)
    if permuted:
        rng = np.random.default_rng(3)
        pv = rng.permutation(len(coords))
        c2 = np.empty_like(coords)
        c2[pv] = coords @ np.array([[np.cos(0.37), np.sin(0.37)],
                                    [-np.sin(0.37), np.cos(0.37)]])
        coords, tris = c2, pv[tris][rng.permutation(len(tris))]
    loc = detect_annulus_structured(coords, tris, cls=None, device=dev)
    assert (loc.perm is not None) == permuted
    m = Mesh2D.from_arrays(coords, tris, device=dev)
    s, dx, dy = _moved(m, scale=0.1)
    dx, dy, active = dx[:n].clone(), dy[:n].clone(), s["active"][:n].clone()
    active[::5] = False
    odd = torch.tensor([(loc.cx, loc.cy)] + _ODD_POINTS, device=dev)
    k = max(min(n - 1, odd.shape[0]), 0)          # point 0 stays inactive
    dx[1:1 + k], dy[1:1 + k] = odd[:k, 0], odd[:k, 1]
    n0 = kernels.LAUNCHES["annulus_locate"]
    got = lo.annulus_locate(loc, dx, dy, active)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["annulus_locate"] == n0 + (1 if n else 0)
    _equal(got, lo.annulus_locate_plain(loc, dx, dy, active))
    assert (got[0][~active] == -1).all()


@pytest.mark.parametrize("n_sectors", [222, 2_100, 12_000])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("views", [False, True])
def test_annulus_kernel_sector_table_sizes(dev, n_sectors, permuted, views):
    """A's sector table in shared memory (222 sectors: the bench annulus;
    2,100: above 48 KB, the opt-in size) and read in place (12,000: above
    the card's shared memory per block), with and without a permutation,
    on points spread over and around the annulus, four to a thread (a
    count that leaves a tail of 1) or, from views one element in (not
    16-byte aligned), one at a time."""
    from pumipic_torch.mesh.locator import AnnulusLocator2D

    f32 = lambda v: float(np.float32(v))  # noqa: E731
    R = 5
    perm = None
    if permuted:
        perm = torch.as_tensor(np.random.default_rng(n_sectors).permutation(
            2 * R * n_sectors).astype(np.int32), device=dev)
    loc = AnnulusLocator2D(f32(0.01), f32(-0.02), f32(0.3), f32(0.14), R, n_sectors,
                           theta0=f32(0.1), perm=perm)
    rng = np.random.default_rng(1)
    r = rng.uniform(0.2, 1.1, 300_001)
    t = rng.uniform(-np.pi, np.pi, r.size)
    px = _on_card((0.01 + r * np.cos(t)).astype(np.float32), dev, views)
    py = _on_card((-0.02 + r * np.sin(t)).astype(np.float32), dev, views)
    active = _on_card(rng.uniform(size=r.size) < 0.9, dev, views)
    n0 = kernels.LAUNCHES["annulus_locate"]
    got = lo.annulus_locate(loc, px, py, active)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["annulus_locate"] == n0 + 1
    _equal(got, lo.annulus_locate_plain(loc, px, py, active))
    assert 0.5 < float(got[1].float().mean()) < 0.9
    assert loc.sector_table(dev) is loc.sector_table(dev)


def test_histogram_key_mode_and_deposit_er_equal_plain(dev, mesh):
    rng = np.random.default_rng(2)
    n = 100_000
    elem = torch.as_tensor(rng.integers(-1, mesh.nelems, n), dtype=torch.int32,
                           device=dev)
    active = elem >= 0
    rg = torch.as_tensor(rng.uniform(0.0, 0.05, n).astype(np.float32), device=dev)
    rg[:3] = float("nan")
    for R in (2, 3):
        args = (elem, active, mesh.nelems, rg, R, 0.038)
        n0 = kernels.LAUNCHES["histogram"]
        counts = sc.histogram(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["histogram"] == n0 + 1
        assert torch.equal(counts, sc.histogram_plain(*args))
        er = counts.view(mesh.nelems, R)
        assert torch.equal(sc.deposit_rings(er, mesh, R),
                           sc.ring_accum_plain(er, mesh, R))


def test_band_kernel_compiled_for_24_12_8_equals_plain(dev):
    """(J, P, rank) = (24, 12, 8), the 120k mesh's values, runs the
    kernel's compile-time instantiation: seeded coefficients, exact."""
    from pumipic_torch.mesh.locator import BandGrid2D

    rng = np.random.default_rng(4)

    def f32(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                               device=dev)

    grid = BandGrid2D(0.01, -0.02, f32(13, 8, scale=0.1), f32(8, 49, scale=0.1),
                      f32(11, scale=0.3), torch.zeros(120 * 4096, 14, device=dev),
                      torch.zeros(120 * 4096, dtype=torch.int32, device=dev),
                      n_bands=120, n_theta=4096, n_harm=24, n_cheb=12, rank=8)
    px, py = f32(200_000), f32(200_000)
    n0 = kernels.LAUNCHES["band_cell"]
    got = lo.band_cell_of(grid, px, py)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_cell"] == n0 + 1
    assert torch.equal(got, lo.band_cell_of_plain(grid, px, py))


# ---------------------------------------------------------------------------
# kernel B's two instantiations and kernel D's passes
# ---------------------------------------------------------------------------

_ODD_POINTS = [(float("nan"), 0.5), (0.5, float("nan")), (float("inf"), 0.0),
               (-float("inf"), 1.0), (0.0, float("inf")), (0.3, -float("inf")),
               (1e30, -1e30), (-1e6, 2e6), (float("inf"), -float("inf"))]


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("newton", [0, 1, 3, 5])
@pytest.mark.parametrize("shape", [(7, 5, 3, 4), (24, 12, 8, 11)])
def test_band_kernel_shapes_newton_steps_and_odd_points(dev, n, newton, shape):
    """B equals its plain version in its compile-time instantiation
    ((J, P, rank, seed terms) = (24, 12, 8, 11) with 3 Newton steps) and
    in the runtime one (the other shapes and step counts), at sizes that
    leave partial blocks, with points at the centre (r = 0), NaN and
    infinite coordinates and points far outside the grid first."""
    from pumipic_torch.mesh.locator import BandGrid2D

    J, P, rank, n_inv = shape
    K, T = (120, 4096) if J == 24 else (10, 64)
    rng = np.random.default_rng(n + 7 * newton + J)

    def f32(*dims, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(dims)).astype(np.float32),
                               device=dev)

    cx, cy = float(np.float32(0.01)), float(np.float32(-0.02))
    grid = BandGrid2D(cx, cy, f32(P + 1, rank, scale=0.1), f32(rank, 2 * J + 1, scale=0.1),
                      f32(n_inv, scale=0.3), torch.zeros(K * T, 14, device=dev),
                      torch.zeros(K * T, dtype=torch.int32, device=dev), n_bands=K,
                      n_theta=T, n_harm=J, n_cheb=P, rank=rank, newton_iters=newton)
    xy = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    odd = np.array([(cx, cy)] + _ODD_POINTS, np.float32)      # the centre: r = 0
    m = min(n, len(odd))
    xy[:m] = odd[:m]
    px, py = (torch.as_tensor(np.ascontiguousarray(xy[:, k]), device=dev) for k in (0, 1))
    n0 = kernels.LAUNCHES["band_cell"]
    got = lo.band_cell_of(grid, px, py)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_cell"] == n0 + (1 if n else 0)
    assert got.shape == (n,) and got.dtype == torch.int32
    assert torch.equal(got, lo.band_cell_of_plain(grid, px, py))


def _mapped_inputs(V, R, P, rng):
    """A gyro map over V vertices in which vertex 0 is named by more than
    1,024 entries (when the map has that many) and vertex V - 1 by none,
    and integer ring sums."""
    flat = rng.integers(-1, max(V - 1, 1), V * R * P * 3)
    if flat.size > 2048:
        flat[rng.choice(flat.size, 1100, replace=False)] = 0
    ring = rng.integers(0, 50, (V, R)).astype(np.float32)
    return flat, ring


@pytest.mark.parametrize("V", [5, 40, 3000])
@pytest.mark.parametrize("R", [1, 2, 3, 5])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_deposit_mapped_kernel_group_order(dev, V, R, P):
    """D's pass 2 equals the numpy model of its fixed order bit for bit
    (P = 3: each term c/3 rounds, so this tests the per-term IEEE division
    and the order), and the plain version bit for bit where the sums are
    exact (P = 1, 8); with fewer vertices than a warp, a vertex with no
    entries and one with more than 1,024."""
    from deposit_order import mapped_group_order

    rng = np.random.default_rng(V * 100 + R * 10 + P)
    flat, ring_np = _mapped_inputs(V, R, P, rng)
    gmap = sc.GyroMap.from_flat(flat, V, R, P, dev)
    ring = torch.as_tensor(ring_np, device=dev)
    n0 = kernels.LAUNCHES["deposit"]
    got = sc.scatter_to_mapped_verts(ring, gmap, V, R, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deposit"] == n0 + 1
    want = mapped_group_order(ring_np, gmap.offsets.cpu().numpy(), gmap.src.cpu().numpy(), P)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
    assert float(got[V - 1]) == 0.0
    if P != 3:
        assert torch.equal(got, sc.mapped_plain(ring, gmap, V, R, P))


@pytest.mark.parametrize("R", [1, 2, 3, 5])
@pytest.mark.parametrize("form", ["(E,)", "(E, R)"])
@pytest.mark.parametrize("size", ["two triangles", "tokamak"])
def test_deposit_rings_kernel_forms(dev, mesh, R, form, size):
    """D's pass 1 equals its plain version from (E,) counts (the uniform
    radius's ring pair) and from (E, R) counts, on a mesh of fewer
    vertices than a warp and on the tokamak mesh."""
    m = mesh if size == "tokamak" else Mesh2D.from_arrays(
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
        np.array([[0, 1, 2], [0, 2, 3]]), device=dev)
    rng = np.random.default_rng(R)
    shape = (m.nelems,) if form == "(E,)" else (m.nelems, R)
    counts = torch.as_tensor(rng.integers(0, 1000, shape).astype(np.int32), device=dev)
    n0 = kernels.LAUNCHES["deposit"]
    got = sc.deposit_rings(counts, m, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deposit"] == n0 + 1
    assert torch.equal(got, sc.ring_accum_plain(counts, m, R))


# ---------------------------------------------------------------------------
# kernels G (row gather), S (slot map) and P's phi mode
# ---------------------------------------------------------------------------

def _bits(rng, shape, dev):
    """f32 tensor of random 32-bit patterns (NaNs, infinities and
    denormals included): a gather must move them unchanged."""
    return torch.as_tensor(rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
                           .astype(np.int32), device=dev).view(torch.float32)


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("w", [1, 8, 14])
def test_row_gather_rows_form_equals_plain(dev, n, w):
    from pumipic_torch.ops import rows

    rng = np.random.default_rng(n + w)
    M = 24_576
    table = _bits(rng, (M, w), dev)
    idx = torch.as_tensor(rng.integers(0, M, n).astype(np.int32), device=dev)
    n0 = kernels.LAUNCHES["row_gather"]
    got = rows.row_gather(table, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_gather"] == n0 + (1 if n else 0)
    assert torch.equal(got.view(torch.int32),
                       rows.row_gather_plain(table, idx).view(torch.int32))


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("ncols", [1, 8, 14, 20])
def test_row_gather_columns_form_equals_plain(dev, n, ncols):
    from pumipic_torch.ops import rows

    rng = np.random.default_rng(7 * n + ncols)
    M = max(n, 1) + 5
    shapes = [(M, 2), (M, 2), (M,), (M,), (M,), (M,), (M, 3), (M,)]
    cols = []
    for j in range(ncols):
        shp = shapes[j % len(shapes)]
        c = _bits(rng, shp, dev)
        cols.append(c.view(torch.int32) if j % 3 == 2 else c)
    cols.append(torch.as_tensor(rng.integers(0, 9, M), device=dev))  # int64: 2 lanes
    idx = torch.as_tensor(rng.integers(0, M, n).astype(np.int32), device=dev)
    n0 = kernels.LAUNCHES["row_gather"]
    got = rows.row_gather(cols, idx)
    torch.cuda.synchronize()
    launches = 0 if n == 0 else -(-(ncols + 1) // rows.MAX_GATHER_ARRAYS)
    assert kernels.LAUNCHES["row_gather"] == n0 + launches
    for g, w in zip(got, rows.row_gather_plain(cols, idx)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


def _slot_inputs(layout, E, M, C, chunk, sigma, dev, seed=0):
    from pumipic_torch.particles import structure as st

    rng = np.random.default_rng(seed)
    elem = rng.integers(-1, E, M).astype(np.int32)
    elem[rng.uniform(size=M) < 0.3] = int(rng.integers(0, E))      # a skewed element
    elem_t = torch.as_tensor(elem, device=dev)
    key = torch.where(elem_t >= 0, elem_t, E)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.as_tensor(np.bincount(elem[elem >= 0], minlength=E).astype(np.int32),
                             device=dev)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    if layout == "cabm":
        seg = ((counts + 7) // 8) * 8
        offsets = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0, dtype=torch.int32)])
        return order, start, offsets, None
    r2e, _, cw = st._scs_row_order(counts, sigma, chunk, E)
    offsets = torch.cat([cw.new_zeros(1), torch.cumsum(chunk * cw, 0, dtype=torch.int32)])
    return order, start, offsets, r2e


@pytest.mark.parametrize("layout,chunk,sigma", [("scs", 8, 2**30), ("scs", 4, 8),
                                                ("scs", 3, 16), ("cabm", 1, 1)])
@pytest.mark.parametrize("M,C", [(1, 1), (31, 40), (1000, 700), ((1 << 20) + 7, (1 << 20) + 4099)])
def test_slot_map_kernel_equals_plain_on_every_slot(dev, layout, chunk, sigma, M, C):
    from pumipic_torch.ops import rows

    E = 97
    order, start, offsets, r2e = _slot_inputs(layout, E, M, C, chunk, sigma, dev)
    args = (layout, order, start, offsets, r2e, chunk, C, M)
    n0 = kernels.LAUNCHES["slot_map"]
    got = rows.slot_map(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["slot_map"] == n0 + 1
    for g, w in zip(got, rows.slot_map_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout,chunk", [("scs", 8), ("scs", 3), ("cabm", 8)])
@pytest.mark.parametrize("case", slotmap_tiles.SLOT_CASES)
@pytest.mark.parametrize("fill", slotmap_tiles.SLOT_FILLS)
def test_slot_map_kernel_corner_cases(dev, layout, chunk, case, fill):
    """S equals its plain version on every slot where its tiles meet the
    corner cases of tests/slotmap_tiles.py: a segment wider than a tile,
    empty segments and width-0 chunks, SCS pad rows, a window above the
    shared-memory cap, C not a multiple of the tile, and needed below,
    equal to and above C."""
    from pumipic_torch.ops import rows

    order, start, offsets, r2e, C, M = slotmap_tiles.slot_inputs(layout, case, fill, chunk,
                                                                 device=dev)
    args = (layout, order, start, offsets, r2e, chunk if layout == "scs" else 1, C, M)
    n0 = kernels.LAUNCHES["slot_map"]
    got = rows.slot_map(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["slot_map"] == n0 + 1
    for g, w in zip(got, rows.slot_map_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("form", ["bands", "class"])
def test_push_phi_kernel_equals_plain(dev, mesh, n, form):
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32), device=dev)
    phi = torch.as_tensor(rng.uniform(-3.2, 3.2, n).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.uniform(0.1, 1.2, n).astype(np.float32), device=dev)
    active = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    elem = torch.as_tensor(rng.integers(-1, mesh.nelems, n).astype(np.int32), device=dev)
    if form == "bands":
        bands = push_ops.BandClasses.build(
            push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), dev)
        cls = elem
    else:
        bands = None
        cls = mesh.class_id[torch.clamp(elem, min=0).long()]
    args = (x, phi, b, active, cls, 15.0, 0.1, -0.05, 0.9)
    n0 = kernels.LAUNCHES["push"]
    got = push_ops.push_phi(*args, bands=bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["push"] == n0 + 1
    _equal(got, push_ops.push_phi_plain(*args, bands=bands))


@pytest.mark.parametrize("layout", ["scs", "csr", "cabm", "dps"])
def test_structure_rebuilds_card_equal_cpu(dev, layout):
    """Sort and auto (reshuffle or fallback) rebuilds with removals,
    out-of-range ids and additions: every member equal on the card and on
    the CPU."""
    from pumipic_torch.particles import structure as st

    E, n = 97, 5000
    rng = np.random.default_rng(4)
    elems = rng.integers(0, E, n)
    fields = {"x": torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32)),
              "pid": torch.arange(n, dtype=torch.int32),
              "flag": torch.as_tensor(rng.uniform(size=n) < 0.5)}

    def build(device):
        f = {k: v.to(device) for k, v in fields.items()}
        if layout == "scs":
            return st.SellCSigma(E, elems, fields=f, device=device, scs_input=st.SCSInput(
                chunk_size=8, sigma=16, extra_padding=0.3))
        if layout == "cabm":
            return st.CabM(E, elems, fields=f, soa_width=16, extra_padding=0.2,
                           device=device)
        return {"csr": st.CSR, "dps": st.DPS}[layout](E, elems, fields=f, device=device)

    g, c = build(dev), build("cpu")
    for i, mode in enumerate(("auto", "sort", "auto", "auto")):
        cur = np.where(c.active.numpy(), c.elem.numpy(), -1)
        ne = cur.copy()
        mv = rng.uniform(size=ne.shape) < (0.05 if i != 2 else 0.5)
        ne[mv & (cur >= 0)] = rng.integers(-1, E + 2, int((mv & (cur >= 0)).sum()))
        add = None
        if i == 1:
            add = (rng.integers(-1, E, 64).astype(np.int32),
                   {"x": np.zeros((64, 2), np.float32),
                    "pid": np.arange(n, n + 64, dtype=np.int32),
                    "flag": np.ones(64, bool)})
        for ps, device in ((g, dev), (c, "cpu")):
            args = [torch.as_tensor(ne.astype(np.int32), device=device)]
            if add is not None:
                args += [torch.as_tensor(add[0], device=device),
                         {k: torch.as_tensor(v, device=device) for k, v in add[1].items()}]
            out = ps.rebuild(*args, mode=mode if add is None else "sort")
            if device == "cpu":
                c = out
            else:
                g = out
        for k in ("elem", "active", "num_ptcls", "overflowed", "elem_offsets",
                  "row_to_elem", "elem_to_row", "seg_cap"):
            a, b = getattr(g, k), getattr(c, k)
            assert (a is None) == (b is None), k
            assert a is None or torch.equal(a.cpu(), b), (i, k)
        for k in c.fields:
            assert torch.equal(g.fields[k].cpu(), c.fields[k]), (i, k)


# ---------------------------------------------------------------------------
# kernel H's vector loads, run merge and warp rounds; kernel G's edge cases
# ---------------------------------------------------------------------------

def _h_inputs(rng, n, order, E):
    """(elem, active) numpy arrays for one H case."""
    if order == "one element":
        return np.full(n, 7, np.int32), np.ones(n, bool)
    if order == "inactive":
        return rng.integers(0, E, n).astype(np.int32), np.zeros(n, bool)
    lo, hi = (-5, E + 5) if order == "out of range" else (0, E)
    elem = rng.integers(lo, hi, n).astype(np.int32)
    if order == "sorted":
        elem.sort()
    return elem, rng.uniform(size=n) < 0.9


def _on_card(a, dev, view):
    """``a`` on the card, at the start of its storage or (view) one element
    in, so that the tensor's data_ptr is not 16-byte aligned."""
    if not view:
        return torch.as_tensor(a, device=dev)
    pad = np.concatenate([a[:1] if len(a) else np.zeros(1, a.dtype), a])
    return torch.as_tensor(pad, device=dev)[1:]


@pytest.mark.parametrize("n", [0, 1, 15, 17, (1 << 20) + 7])
@pytest.mark.parametrize("order", ["one element", "sorted", "random", "inactive",
                                   "out of range"])
@pytest.mark.parametrize("mode", ["elem", "3 rings", "5 rings"])
@pytest.mark.parametrize("views", ["none", "all", "elem only"])
def test_histogram_kernel_orders_and_alignments(dev, n, order, mode, views):
    """H equals its plain version for ordered, random, inactive and
    out-of-range keys, at sizes that leave heads and tails, on views whose
    data_ptr is not 16-byte aligned (all inputs alike: the vector loads
    start after a head; elem alone: no common start, every load scalar);
    key mode with 3 and 5 rings and NaN radii."""
    E = 1000
    rng = np.random.default_rng(n)
    e_np, a_np = _h_inputs(rng, n, order, E)
    elem = _on_card(e_np, dev, views != "none")
    active = _on_card(a_np, dev, views == "all")
    args = (elem, active, E)
    if mode != "elem":
        rg_np = rng.uniform(0.0, 0.05, n).astype(np.float32)
        rg_np[::13] = np.nan
        args += (_on_card(rg_np, dev, views == "all"), int(mode[0]), 0.038)
    n0 = kernels.LAUNCHES["histogram"]
    got = sc.histogram(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["histogram"] == n0 + (1 if n else 0)
    assert torch.equal(got, sc.histogram_plain(*args))


def _g_cols(rng, M, dev, wide):
    """Columns for G: an (M, 2) f32 view at an odd 4-byte offset (4-byte
    units), aligned (M, 2) f32, i32, (M, 3) f32 and i64 columns (8-byte
    units); ``wide`` adds (M, 14) and (M, 20) f32 columns (rows of 7 and 10
    8-byte units)."""
    odd = _bits(rng, (2 * M + 1,), dev)[1:].view(M, 2)
    cols = [odd, _bits(rng, (M, 2), dev), _bits(rng, (M,), dev).view(torch.int32),
            _bits(rng, (M, 3), dev), torch.as_tensor(rng.integers(-2**62, 2**62, M),
                                                     device=dev)]
    if wide:
        cols += [_bits(rng, (M, 14), dev), _bits(rng, (M, 20), dev)]
    return cols


@pytest.mark.parametrize("n", [3, 1029, (1 << 20) + 7])
@pytest.mark.parametrize("index", ["random", "all equal", "reversed", "view"])
@pytest.mark.parametrize("wide", [False, True])
def test_row_gather_columns_form_edge_cases(dev, n, index, wide):
    """G equals the plain version on rows at an odd 4-byte offset (moved as
    4-byte units), 8-byte types as two words, widths of 14 and 20 lanes,
    all indices equal, a reversed permutation, and an index view whose
    data_ptr is not 16-byte aligned."""
    from pumipic_torch.ops import rows

    rng = np.random.default_rng(n + 11 * wide)
    M = n + 5
    cols = _g_cols(rng, M, dev, wide)
    if index == "all equal":
        idx_np = np.full(n, M - 1, np.int32)
    elif index == "reversed":
        idx_np = np.arange(n - 1, -1, -1, dtype=np.int32)
    else:
        idx_np = rng.integers(0, M, n).astype(np.int32)
    idx = _on_card(idx_np, dev, index == "view")
    n0 = kernels.LAUNCHES["row_gather"]
    got = rows.row_gather(cols, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_gather"] == n0 + 1
    for g, w in zip(got, rows.row_gather_plain(cols, idx)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


# ---------------------------------------------------------------------------
# P's table mode, K and L3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("one_dim", [False, True])
def test_push_table_kernel_equals_plain(dev, mesh, n, one_dim):
    rng = np.random.default_rng(n)
    cls = rng.permutation(mesh.class_id.cpu().numpy())
    rot = push_ops.RotTable.build(cls, 15.0, dev, one_dim=one_dim)
    phi = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)   # noqa: E731
    args = (f32(rng.uniform(-1, 1, n)), f32(rng.uniform(-1, 1, n)), f32(np.cos(phi)),
            f32(np.sin(phi)), f32(rng.uniform(0.1, 1.0, n)),
            torch.as_tensor(rng.integers(-1, mesh.nelems, n).astype(np.int32), device=dev),
            torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev), rot, 0.1, -0.05, 0.7)
    n0 = kernels.LAUNCHES["push_table"]
    got = push_ops.push_table(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["push_table"] == n0 + 1
    _equal(got, push_ops.push_table_plain(*args))


def _kuhn_box(dev, nside, permuted):
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.mesh.locator import detect_box_kuhn

    coords, tets = box_tet_mesh(nside, nside, nside)
    if permuted:
        tets = tets[np.random.default_rng(3).permutation(tets.shape[0])]
    m = Mesh3D.from_arrays(coords, tets, device=dev)
    loc = detect_box_kuhn(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(), device=dev)
    assert loc is not None and (loc.perm is not None) == permuted
    return m, loc


def _points3(n, seed, dev, nside=4):
    """Points in and around the unit box; a quarter on exact lattice
    vertices, edges and faces, another quarter on the fx = fy face."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.2, 1.2, (n, 3))
    k = n // 4
    p[:k] = rng.integers(-1, 2 * nside + 2, (k, 3)) / (2.0 * nside)
    p[k:2 * k, 0] = p[k:2 * k, 1]
    return torch.as_tensor(p.astype(np.float32), device=dev)


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("mode", ["locate", "push", "push+wrap"])
def test_kuhn_kernel_equals_plain(dev, n, permuted, mode):
    """K inside and outside the box, at exact cell faces, with and without
    the canonical-to-actual permutation, with the push and the wrap."""
    _, loc = _kuhn_box(dev, 4, permuted)
    x = _points3(n, n + 7, dev)
    active = torch.as_tensor(np.random.default_rng(n).uniform(size=n) < 0.85, device=dev)
    step = None if mode == "locate" else push_ops.step_vector(
        np.array([0.6, -0.48, 0.64], np.float32), 0.3)
    wrap = (np.zeros(3, np.float32), np.ones(3, np.float32)) if mode == "push+wrap" else None
    n0 = kernels.LAUNCHES["kuhn_locate"]
    got = lo.kuhn_push_locate(loc, x, active, step, wrap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["kuhn_locate"] == n0 + (1 if n else 0)
    want = lo.kuhn_push_locate_plain(loc, x, active, step, wrap)
    _equal(got, want)
    if n > 1000:
        e = got[1][active]
        assert bool((e >= 0).any()) and (mode == "push+wrap") == bool((e >= 0).all())


@pytest.mark.parametrize("n", [0, 1, 31, 128, (1 << 20) + 7])
@pytest.mark.parametrize("mode", ["push", "wrap", "push+wrap", "push+wrap, row view"])
def test_push_wrap_kernel_equals_plain(dev, n, mode):
    """K's push-only form over n particles (3n coordinates: below, at and
    past a block's 384 and a thread's 4-coordinate round), points inside
    and outside the box and on its faces, and a view starting one row in."""
    x = _points3(n + 1, n + 11, dev)
    x = x[1:] if mode.endswith("row view") else x[:n]
    step = None if mode == "wrap" else push_ops.step_vector(
        np.array([0.6, -0.48, 0.64], np.float32), 0.3)
    wrap = None if mode == "push" else (np.full(3, -0.25, np.float32),
                                        np.full(3, 1.5, np.float32))
    n0 = kernels.LAUNCHES["push_wrap"]
    got = push_ops.push_and_wrap(x, step, wrap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["push_wrap"] == n0 + (1 if n else 0)
    _equal(got, push_ops.push_and_wrap_plain(x, step, wrap))


def _tet_walkers(dev, m, n, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    e0 = torch.as_tensor(rng.integers(-1, m.nelems + 2, n).astype(np.int32), device=dev)
    act = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    cent = m.elem_centroids[torch.clamp(e0, 0, m.nelems - 1).long()]
    g = torch.Generator(device="cpu").manual_seed(seed)
    dest = (cent.cpu() + scale * torch.randn(n, 3, generator=g)).to(dev)
    dest[: n // 8] = torch.round(dest[: n // 8] * 8) / 8        # lattice faces
    return e0, act, dest.contiguous()


@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("peel", [True, False])
def test_locate3d_kernel_equals_plain(dev, n, peel):
    """L3 with the peel and as the plain walk, with boundary exits (some
    destinations leave the box), garbage starts, inactive particles and
    the iteration limit (64, 3, 1)."""
    from pumipic_torch.mesh.locator import build_locator_grid_3d

    m, _ = _kuhn_box(dev, 6, False)
    grid = build_locator_grid_3d(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(),
                                 cells_per_elem=16.0, walk_geom=m.walk_geom,
                                 device=dev) if peel else None
    e0, act, dest = _tet_walkers(dev, m, n, n + 5)
    for max_iters in (64, 3, 1):
        n0 = kernels.LAUNCHES["locate3d"]
        got = se.walk_locate_3d(m.walk_geom, dest, e0, act, max_iters, grid=grid)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["locate3d"] == n0 + 1
        want = se.walk_locate_3d_plain(m.walk_geom, dest, e0, act, max_iters, grid=grid)
        _equal(got, want)
        if n > 1000 and max_iters == 64:
            assert bool(got[3]) and bool((~got[1][act]).any())   # exits, none at the limit


def _peel_hits(dev, grid, n, seed):
    """``n`` destinations in the unit box that the peel finds (no walker)."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.uniform(0.01, 0.99, (8 * n + 64, 3)).astype(np.float32),
                        device=dev)
    p = p[se._peel_3d(grid, *p.unbind(1))[1]][:n]
    assert p.shape[0] == n
    return p


@pytest.mark.parametrize("case", ["all walk", "no walker in a tile", "found at once",
                                  "n 0", "n 1", "n 255", "n 257", "nan targets",
                                  "random order"])
def test_locate3d_kernel_walker_pool_cases(dev, case):
    """L3's per-warp walker pools at their edges, against the plain version
    with max_iters 64, 3 and 1: a grid whose candidates always miss (every
    particle walks), a first 256 particles that the peel all finds (eight
    tiles without a walker), every destination in its start tet (the plain
    walk's iters is 1), sizes around a 256-thread block, NaN targets (one
    coordinate and all three) and a random particle order; the peel and,
    where the case allows, the plain walk."""
    import dataclasses as dc

    from pumipic_torch.mesh.locator import build_locator_grid_3d

    m, _ = _kuhn_box(dev, 6, False)
    grid = build_locator_grid_3d(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(),
                                 cells_per_elem=16.0, walk_geom=m.walk_geom, device=dev)
    n = {"n 0": 0, "n 1": 1, "n 255": 255, "n 257": 257}.get(case, 5000)
    e0, act, dest = _tet_walkers(dev, m, n, n + 11)
    grids = [grid, None]
    if case == "all walk":
        wg = m.walk_geom
        one = torch.ones(1, device=dev)
        row = torch.cat([wg[0, :12], 0 * one, wg[1, :12], one])
        rows = row.expand(grid.cell_rows.shape[0], 26).contiguous()
        grid = dc.replace(grid, cell_rows=rows)
        grids = [grid]
        inside = se._peel_3d(grid, *dest.unbind(1))[1]
        assert float(inside[act].float().mean()) < 0.05
    elif case == "no walker in a tile":
        dest = torch.cat([_peel_hits(dev, grid, 256, 5), dest[256:]]).contiguous()
        act[:256] = True
        grids = [grid]
    elif case == "found at once":         # each in its start tet: iters 1 either way
        dest = m.elem_centroids[torch.clamp(e0, 0, m.nelems - 1).long()].contiguous()
    elif case == "nan targets":
        dest[::5, 0] = float("nan")
        dest[1::7] = float("nan")
    elif case == "random order":
        perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(1))
        e0, act, dest = e0[perm], act[perm], dest[perm].contiguous()
    for g in grids:
        for max_iters in (64, 3, 1):
            n0 = kernels.LAUNCHES["locate3d"]
            got = se.walk_locate_3d(m.walk_geom, dest, e0, act, max_iters, grid=g)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["locate3d"] == n0 + 1
            _equal(got, se.walk_locate_3d_plain(m.walk_geom, dest, e0, act, max_iters,
                                                grid=g))


@pytest.mark.parametrize("change", ["another walk_geom", "walk_geom written",
                                    "rows replaced", "an equal walk_geom"])
def test_locate3d_kernel_rechecks_the_id_pair_against_its_tensors(dev, change):
    """L3 reads the grid's candidate id pair in place of the rows.  A pair
    checked against one walk_geom is checked again for another walk_geom,
    for the same one written in place, and for a grid whose rows were
    replaced: where the candidates no longer equal walk_geom's rows, the
    wrapper raises before any launch; where they do, it launches and equals
    the plain version."""
    import dataclasses as dc

    from pumipic_torch.mesh.locator import build_locator_grid_3d

    m, _ = _kuhn_box(dev, 3, False)
    wg = m.walk_geom.clone()
    grid = build_locator_grid_3d(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(),
                                 walk_geom=wg, device=dev)
    e0, act, dest = _tet_walkers(dev, m, 100, 1)
    ids = grid.candidate_ids(wg)
    _equal(se.walk_locate_3d(wg, dest, e0, act, 64, grid=grid),
           se.walk_locate_3d_plain(wg, dest, e0, act, 64, grid=grid))
    c = int(ids[ids.shape[0] // 2, 0])
    other = wg.clone()
    other[c, 5] = torch.nextafter(other[c, 5], torch.tensor(np.inf, device=dev))
    if change == "an equal walk_geom":
        wg2 = wg.clone()
        n0 = kernels.LAUNCHES["locate3d"]
        _equal(se.walk_locate_3d(wg2, dest, e0, act, 64, grid=grid),
               se.walk_locate_3d_plain(wg2, dest, e0, act, 64, grid=grid))
        assert kernels.LAUNCHES["locate3d"] == n0 + 1
        return
    if change == "another walk_geom":
        wg = other
    elif change == "walk_geom written":
        wg.copy_(other)
    else:
        rows = grid.cell_rows.clone()
        rows[ids.shape[0] // 2, 5] = other[c, 5]
        grid = dc.replace(grid, cell_rows=rows)
    n0 = kernels.LAUNCHES["locate3d"]
    with pytest.raises(ValueError, match="bit for bit"):
        se.walk_locate_3d(wg, dest, e0, act, 64, grid=grid)
    assert kernels.LAUNCHES["locate3d"] == n0


def test_pps3d_app_card_equals_cpu(dev):
    """The pseudoPushAndSearch app at a small size, Kuhn and walk arms, on
    the card and on the CPU for 3 steps: structures equal bit for bit."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models import pseudo_push_and_search as pps

    raw = box_tet_mesh(6, 6, 6)
    for kuhn in ("auto", "off"):
        for wall in ("periodic", "remove"):
            cfg = pps.PushSearchConfig(num_ptcls=50_000, structure="cabm", wall=wall,
                                       kuhn=kuhn, max_search_iters=64)
            ag = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device=dev), cfg,
                                         device=dev)
            ac = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device="cpu"), cfg,
                                         device="cpu")
            for _ in range(3):
                ag.ptcls, ig = ag.step_fn(ag.ptcls)
                ac.ptcls, ic = ac.step_fn(ac.ptcls)
                assert int(ig) == int(ic)
                for k in ("elem", "active", "num_ptcls", "elem_offsets"):
                    assert torch.equal(getattr(ag.ptcls, k).cpu(), getattr(ac.ptcls, k))
                for k in ("x", "pid"):
                    assert torch.equal(ag.ptcls.fields[k].cpu(), ac.ptcls.fields[k])


# ---------------------------------------------------------------------------
# the GITR-style app's kernels: R (field + Boris push), M (3D walk modes), W
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 31, (1 << 20) + 7])
@pytest.mark.parametrize("b", [(0.0, 0.0, 1.3e-3), (0.3, -0.2, 0.5)])
def test_boris_kernel_equals_plain(dev, n, b):
    """R over points inside and outside a (5, 6, 7, 3) grid (the index and
    fraction clamps), N(0, 1e3) velocities, a uniform B."""
    rng = np.random.default_rng(n + 3)
    x = torch.as_tensor(rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1e3, (n, 3)).astype(np.float32), device=dev)
    grid = torch.as_tensor(rng.normal(0, 0.2, (5, 6, 7, 3)).astype(np.float32), device=dev)
    o, h = np.zeros(3, np.float32), np.array([0.25, 0.2, 1 / 6], np.float32)
    n0 = kernels.LAUNCHES["boris"]
    got = push_ops.boris_push_grid(x, v, grid, o, h, np.asarray(b, np.float32), 2e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["boris"] == n0 + (1 if n else 0)
    _equal(got, push_ops.boris_push_grid_plain(x, v, grid, o, h, np.asarray(b), 2e-5))


def _tet_mesh(dev, n_side=6):
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.mesh.locator import build_locator_grid_3d

    m = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=dev)
    grid = build_locator_grid_3d(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(),
                                 cells_per_elem=16.0, walk_geom=m.walk_geom, device=dev)
    return m, grid


def _same(a, b):
    """Equal values, NaN where the other is NaN."""
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def _trace_equal(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        for x, y in (zip(a, b) if isinstance(a, tuple) else ((a, b),) if a is not None
                     else ()):
            assert _same(x, y), f


@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("method", ["bcc", "hybrid", "intersection"])
def test_trace3d_kernel_equals_plain(dev, method, handler, record_exit, recover, peel):
    """M in every template (core, handler, record) and with the run-time
    recovery and peel, over walkers that leave the box, garbage starts,
    inactive particles, stationary walkers and lattice points, at budgets
    that leave survivors (3) and that do not (64).  The hybrid core with the
    reflecting wall leaves one walker at any budget (index 310, whose
    restarted segment runs in a shared face and cycles; the JAX reference
    loses it too)."""
    m, grid = _tet_mesh(dev)
    n = 20_011
    e0, act, dest = _tet_walkers(dev, m, n, 7)
    orig = m.elem_centroids[torch.clamp(e0, 0, m.nelems - 1).long()].contiguous()
    dest[n // 8: n // 8 + 500] = orig[n // 8: n // 8 + 500]
    h = se.reflect_on_exit_3d if handler == "reflect" else se.remove_on_exit
    for max_iters in (64, 3):
        args = (m, orig, dest, e0, act, max_iters, method, h, record_exit, recover,
                grid if peel else None)
        n0 = kernels.LAUNCHES["trace3d"]
        got = se.trace_3d(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["trace3d"] == n0 + 1
        _trace_equal(got, se.trace_3d_plain(*args))
        if max_iters == 64:
            assert bool(got.all_found) == ((method, handler) != ("hybrid", "reflect"))


def test_trace3d_kernel_far_targets_and_nan(dev):
    """Long walks (targets across the box from their start) and NaN targets
    (no hang; deleted at the limit, but for the intersection core, whose
    rule for a moving walker that exits no face accepts them, as the
    reference's does)."""
    m, grid = _tet_mesh(dev, 8)
    n = 50_000
    rng = np.random.default_rng(9)
    e0 = torch.as_tensor(rng.integers(0, m.nelems, n).astype(np.int32), device=dev)
    orig = m.elem_centroids[e0.long()].contiguous()
    dest = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
    dest[:7] = float("nan")
    act = torch.ones(n, dtype=torch.bool, device=dev)
    for method in ("bcc", "hybrid", "intersection"):
        args = (m, orig, dest, e0, act, 200, method, se.reflect_on_exit_3d, True, "project")
        got = se.trace_3d(*args)
        _trace_equal(got, se.trace_3d_plain(*args))
        assert int(got.iters) > 20
        assert bool(got.active[:7].all()) == (method == "intersection")


def _mixed_walks(dev, m, n, seed):
    """``n`` walkers from their tets' centroids: every third to a far point
    of the box (many hops), the rest a short push (a step or two), so that
    walks of very different lengths share each warp; every eleventh
    inactive."""
    rng = np.random.default_rng(seed)
    e0 = torch.as_tensor(rng.integers(0, m.nelems, n).astype(np.int32), device=dev)
    orig = m.elem_centroids[e0.long()].contiguous()
    near = orig + torch.as_tensor(rng.normal(0, 0.03, (n, 3)).astype(np.float32), device=dev)
    far = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
    pick = torch.arange(n, device=dev) % 3 == 0
    dest = torch.where(pick[:, None], far, near).contiguous()
    act = torch.ones(n, dtype=torch.bool, device=dev)
    act[5::11] = False
    return orig, dest, e0, act


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("method", ["bcc", "hybrid", "intersection"])
def test_trace3d_kernel_mixed_walk_lengths(dev, method, handler, record_exit, n):
    """M with near and far targets mixed inside each warp, n around the
    32-lane warp, from the plain start and through the peel, at budgets 200
    and 3 (with recovery after the walk); equal to the plain version, and a
    second run equal to the first."""
    m, grid = _tet_mesh(dev)
    orig, dest, e0, act = _mixed_walks(dev, m, n, n + 19)
    h = se.reflect_on_exit_3d if handler == "reflect" else se.remove_on_exit
    for g in (None, grid):
        for max_iters, recover in ((200, "off"), (3, "project")):
            args = (m, orig, dest, e0, act, max_iters, method, h, record_exit, recover, g)
            n0 = kernels.LAUNCHES["trace3d"]
            got = se.trace_3d(*args)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["trace3d"] == n0 + (1 if n else 0)
            _trace_equal(got, se.trace_3d_plain(*args))
            _trace_equal(got, se.trace_3d(*args))


@pytest.mark.parametrize("method", ["bcc", "hybrid", "intersection"])
def test_trace3d_kernel_every_particle_inactive(dev, method):
    """No lane ever walks: every tet -1, the destinations and the exit
    record's points unchanged, no hit, iters as the plain version's."""
    m, grid = _tet_mesh(dev)
    orig, dest, e0, _ = _mixed_walks(dev, m, 1000, 4)
    act = torch.zeros(1000, dtype=torch.bool, device=dev)
    for g in (None, grid):
        args = (m, orig, dest, e0, act, 64, method, se.reflect_on_exit_3d, True,
                "project", g)
        got = se.trace_3d(*args)
        _trace_equal(got, se.trace_3d_plain(*args))
        assert bool((got.elem_ids == -1).all()) and torch.equal(got.dest, dest)
        assert torch.equal(got.hit, dest) and int(got.num_hits.sum()) == 0


def test_trace3d_results_join_without_a_copy(dev):
    """SearchResult.dest and .hit give M's own (N, 3) outputs, not a copy."""
    m, _ = _tet_mesh(dev)
    orig, dest, e0, act = _mixed_walks(dev, m, 100, 2)
    res = se.trace_3d(m, orig, dest, e0, act, 64, "intersection", se.reflect_on_exit_3d,
                      True)
    assert res.dest.data_ptr() == res.dest_c[0].data_ptr()
    assert res.hit.data_ptr() == res.hit_c[0].data_ptr()
    assert torch.equal(res.dest, torch.stack(res.dest_c, 1))
    assert torch.equal(res.hit, torch.stack(res.hit_c, 1))


@pytest.mark.parametrize("n", [0, 1, 33])
@pytest.mark.parametrize("order", ["as made", "random", "view"])
def test_boris_kernel_corner_rows_orders_and_sizes(dev, n, order):
    """R on its corner rows, given and built by the wrapper, at n around a
    warp, in a random particle order (unrelated cells side by side) and on
    views that start one particle in (not 16-byte aligned: the scalar
    staging path)."""
    rng = np.random.default_rng(n + 11)
    x = torch.as_tensor(rng.uniform(-0.1, 1.1, (n + 1, 3)).astype(np.float32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1e3, (n + 1, 3)).astype(np.float32), device=dev)
    if order == "random":
        perm = torch.as_tensor(rng.permutation(n + 1), device=dev)
        x, v = x[perm].contiguous(), v[perm].contiguous()
    x, v = (x[1:], v[1:]) if order == "view" else (x[:n].contiguous(), v[:n].contiguous())
    grid = torch.as_tensor(rng.normal(0, 0.2, (9, 8, 7, 3)).astype(np.float32), device=dev)
    o, h = np.zeros(3, np.float32), np.array([1 / 8, 1 / 7, 1 / 6], np.float32)
    b = np.asarray((0.3, -0.2, 0.5), np.float32)
    rows = push_ops.grid_corner_rows(grid)
    want = push_ops.boris_push_grid_plain(x, v, grid, o, h, b, 2e-5)
    for corners in (rows, None):
        n0 = kernels.LAUNCHES["boris"]
        got = push_ops.boris_push_grid(x, v, grid, o, h, b, 2e-5, corners=corners)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["boris"] == n0 + (1 if n else 0)
        _equal(got, want)


def test_trace3d_kernel_refuses_other_handlers(dev):
    m, _ = _tet_mesh(dev, 2)
    x = torch.full((4, 3), 0.5, device=dev)
    e = torch.zeros(4, dtype=torch.int32, device=dev)
    a = torch.ones(4, dtype=torch.bool, device=dev)

    def my_handler(ctx):
        return se.remove_on_exit(ctx)

    n0 = kernels.LAUNCHES["trace3d"]
    with pytest.raises(NotImplementedError):
        se.search_mesh_3d(m, x, x, e, a, 8, boundary_handler=my_handler)
    assert kernels.LAUNCHES["trace3d"] == n0


@pytest.mark.parametrize("n", [0, 1, 15, 17, (1 << 20) + 7])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("view", [False, True])
def test_wall_tally_kernel_equals_plain(dev, n, weighted, view):
    """W: sides in and out of range, masked particles, weights <= 0, a view
    that starts one particle in (the scalar head of H's loads)."""
    rng = np.random.default_rng(n + 1)
    side = torch.as_tensor(rng.integers(-2, 400, n + 1).astype(np.int32), device=dev)
    mask = torch.as_tensor(rng.uniform(size=n + 1) < 0.3, device=dev)
    w = torch.as_tensor(rng.integers(-1, 5, n + 1).astype(np.int32), device=dev)
    sl = slice(1, None) if view else slice(0, n)
    args = (side[sl], mask[sl], w[sl] if weighted else None, 390)
    n0 = kernels.LAUNCHES["wall_tally"]
    got = sc.wall_tally(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wall_tally"] == n0 + (1 if n else 0)
    assert torch.equal(got, sc.wall_tally_plain(*args))


@pytest.mark.parametrize("wall", ["absorb", "reflect"])
def test_gitr_app_card_equals_cpu(dev, wall):
    """The GITR-style app at a small size on the card and on the CPU for 3
    steps: state and wall_hits equal bit for bit."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models import gitr_like as gl

    raw = box_tet_mesh(6, 6, 6)
    rng = np.random.default_rng(1)
    grid = rng.normal(0, 0.2, (7, 7, 7, 3)).astype(np.float32)
    o, h = np.zeros(3, np.float32), np.full(3, 1 / 6, np.float32)
    cfg = gl.GitrConfig(num_ptcls=50_000, dt=2e-5, b_field=(0.0, 0.0, 1.3e-3), wall=wall)
    apps = [gl.GitrLike(Mesh3D.from_arrays(*raw, device=d), cfg, grid, o, h, device=d)
            for d in (dev, "cpu")]
    for _ in range(3):
        hist = [a.run(1) for a in apps]
        assert hist[0] == hist[1]
        for k in ("x", "v", "elem", "active"):
            assert torch.equal(apps[0].state[k].cpu(), apps[1].state[k]), k
        assert torch.equal(apps[0].wall_hits.cpu(), apps[1].wall_hits)


# ---------------------------------------------------------------------------
# kernel M2 (2D walk modes) and kernel V (deterministic deposit)
# ---------------------------------------------------------------------------

def _tri_walkers(dev, mesh, n, seed, scale=3.0):
    """``n`` walkers from their triangles' centroids: displacements of
    ``scale`` element sizes (some leave the domain), garbage starts,
    stationary walkers, every eleventh inactive, far targets for a tenth."""
    rng = np.random.default_rng(seed)
    E = mesh.nelems
    e0 = rng.integers(0, E, n).astype(np.int32)
    e0[:17] = rng.integers(-4, 0, min(17, n))
    cent = mesh.elem_centroids.cpu().numpy()[np.clip(e0, 0, E - 1)]
    h = float(np.sqrt(np.abs(mesh.elem_area.cpu().numpy())).mean())
    dest = cent + rng.normal(0, scale * h, (n, 2))
    dest[17:60] = cent[17:60]
    far = rng.uniform(size=n) < 0.1
    dest[far] = rng.uniform(-1.3, 1.3, (int(far.sum()), 2))
    act = np.ones(n, bool)
    act[5::11] = False
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return (t(cent.astype(np.float32)), t(dest.astype(np.float32)), t(e0), t(act))


@pytest.fixture(scope="module")
def tri2d(dev):
    """tokamak_mesh(24, 120) on the card with its cartesian cell-row grid
    and its flux-band grid."""
    m = Mesh2D.from_arrays(*tokamak_mesh(24, 120), device=dev)
    args = (m.coords.cpu().numpy(), m.elem2verts.cpu().numpy())
    cart = build_locator_grid(*args, walk_geom=m.walk_geom, peel="rows", device=dev)
    band = detect_banded_locator(*args, m.class_id.cpu().numpy(), m.walk_geom, device=dev)
    assert band is not None
    return m, {"plain": None, "cartesian": cart, "band": band}


@pytest.mark.parametrize("grid_kind", ["plain", "cartesian", "band"])
@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
def test_trace2d_kernel_equals_plain(dev, tri2d, handler, record_exit, recover, grid_kind):
    """M2 in every template (handler, record) with the run-time recovery and
    the peel (the cartesian cell computed in the kernel, the band grid's
    given cells from kernel B), at budgets that leave survivors (2) and that
    do not (200)."""
    mesh, grids = tri2d
    grid = grids[grid_kind]
    orig, dest, e0, act = _tri_walkers(dev, mesh, 20_011, 3)
    h = se.reflect_on_exit_2d if handler == "reflect" else se.remove_on_exit
    for max_iters in (200, 2):
        args = (mesh, orig, dest, e0, act, max_iters, h, record_exit, recover, grid)
        n0 = kernels.LAUNCHES["trace2d"]
        got = se.trace_2d(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["trace2d"] == n0 + 1
        _trace_equal(got, se.trace_2d_plain(*args))
        if max_iters == 200 and recover == "off":
            # far targets in the hole or beyond the wall can bounce between
            # reflecting walls for the whole budget: a few per 10^4
            if h is se.reflect_on_exit_2d:
                assert int((act & ~got.active).sum()) <= act.numel() // 1000
            else:
                assert bool(got.all_found)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
@pytest.mark.parametrize("record_exit", [False, True])
@pytest.mark.parametrize("handler", ["remove", "reflect"])
def test_trace2d_kernel_mixed_walk_lengths(dev, tri2d, handler, record_exit, n):
    """M2 with near and far targets mixed inside each warp, n around the
    32-lane warp; a second run equal to the first; the search entry points
    route the case to M2 (and the fast case to L)."""
    mesh = tri2d[0]
    orig, dest, e0, act = _tri_walkers(dev, mesh, n, n + 5, scale=1.0)
    h = se.reflect_on_exit_2d if handler == "reflect" else se.remove_on_exit
    for max_iters, recover in ((200, "off"), (3, "project")):
        args = (mesh, orig, dest, e0, act, max_iters, h, record_exit, recover, None)
        got = se.trace_2d(*args)
        _trace_equal(got, se.trace_2d_plain(*args))
        _trace_equal(got, se.trace_2d(*args))
        n0, l0 = kernels.LAUNCHES["trace2d"], kernels.LAUNCHES["locate"]
        via = se.search_mesh_2d(mesh, orig, dest, e0, act, max_iters, h, record_exit,
                                recover=recover)
        fast = h is se.remove_on_exit and not record_exit and recover == "off"
        # M2 launches nothing for no particle; L's wrapper counts its
        # (empty) launch all the same
        assert kernels.LAUNCHES["trace2d"] == n0 + (0 if fast or not n else 1)
        assert kernels.LAUNCHES["locate"] == l0 + (1 if fast else 0)
        assert torch.equal(via.elem_ids, got.elem_ids)


def _pool_walkers(dev, mesh, n, long_mask, active_mask, seed):
    """``n`` walkers from their triangles' centroids: those of ``long_mask``
    to the centroid of a random triangle (walks of many rows, across the
    mesh or off its walls), the others a push of 0.3 element sizes (a row
    or two); ``active_mask`` active."""
    rng = np.random.default_rng(seed)
    E = mesh.nelems
    cents = mesh.elem_centroids.cpu().numpy()
    e0 = rng.integers(0, E, n).astype(np.int32)
    h = float(np.sqrt(np.abs(mesh.elem_area.cpu().numpy())).mean())
    dest = cents[e0] + rng.normal(0, 0.3 * h, (n, 2))
    far = cents[rng.integers(0, E, n)] * rng.uniform(0.5, 1.6, (n, 1))
    dest = np.where(long_mask[:, None], far, dest)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return (t(cents[e0].astype(np.float32)), t(dest.astype(np.float32)), t(e0),
            t(active_mask))


# case -> (n, long walkers, active particles) for _pool_walkers
POOL_CASES = {
    "n below a warp": (20, lambda i: i % 2 == 0, lambda i: i >= 0),
    "n not a multiple of 32": (32 * 97 + 13, lambda i: i % 7 == 0, lambda i: i >= 0),
    "a tile of long walkers": (32 * 40, lambda i: i // 32 == 5, lambda i: i >= 0),
    "every walker long: full pools": ((1 << 20) + 7, lambda i: i >= 0, lambda i: i >= 0),
    "inactive between long walkers": (32 * 300 + 5, lambda i: i >= 0, lambda i: i % 2 == 0),
}


@pytest.mark.parametrize("handler", ["remove", "reflect"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_trace2d_kernel_walker_pool_cases(dev, tri2d, case, handler):
    """M2's warp pool at its edges, each case bit-equal to the plain version
    with the exit record, from the plain start and through the cartesian
    peel: fewer particles than a warp, a ragged last tile, one tile whose 32
    walkers all walk long, every walker long (at 2^20 particles each warp
    takes several tiles, so its pool fills exactly to its size and drains at
    the end), inactive particles between long walkers."""
    mesh, grids = tri2d
    n, long_of, act_of = POOL_CASES[case]
    i = np.arange(n)
    args = _pool_walkers(dev, mesh, n, long_of(i), act_of(i), n)
    h = se.reflect_on_exit_2d if handler == "reflect" else se.remove_on_exit
    for grid in (None, grids["cartesian"]):
        full = (mesh, *args, 400, h, True, "off", grid)
        got = se.trace_2d(*full)
        _trace_equal(got, se.trace_2d_plain(*full))
        assert bool(got.all_found)
        _trace_equal(got, se.trace_2d(*full))


@pytest.mark.parametrize("recover", ["off", "project"])
@pytest.mark.parametrize("max_iters", [5, 9, 17, 41, 77, 137])
def test_trace2d_kernel_budget_inside_a_pool_round(dev, tri2d, max_iters, recover):
    """Long walkers reach the budget in their tile's round (M2_R0 = 8 steps)
    or inside the first, second or third pool round (M2_R = 64 steps each:
    the budget counts each walker's steps across rounds): deleted, or
    marked and recovered after the walk, as the plain version does."""
    mesh = tri2d[0]
    n = 32 * 200 + 9
    i = np.arange(n)
    args = _pool_walkers(dev, mesh, n, i % 3 != 0, i % 13 != 0, 31)
    full = (mesh, *args, max_iters, se.reflect_on_exit_2d, True, recover, None)
    got = se.trace_2d(*full)
    _trace_equal(got, se.trace_2d_plain(*full))
    assert not bool(got.all_found) or recover == "project"


def test_trace2d_kernel_peel_retries_in_the_pool(dev, tri2d):
    """The peel on a coarse cartesian grid (a cell spans many triangles, so
    a guess walk from candidate A takes many rows) toward destinations
    beyond the outer wall: guess walks meet the wall in pool rounds and
    retry once from the start triangle there.  Bit-equal to the plain
    version, remove and reflect, with the exit record."""
    mesh = tri2d[0]
    coarse = build_locator_grid(mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy(),
                                cells_per_elem=0.02, walk_geom=mesh.walk_geom, peel="rows",
                                device=dev)
    n = 32 * 500
    rng = np.random.default_rng(41)
    e0 = rng.integers(0, mesh.nelems, n).astype(np.int32)
    cents = mesh.elem_centroids.cpu().numpy()
    dest = cents[e0] * rng.uniform(1.0, 1.5, (n, 1))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    args = (t(cents[e0].astype(np.float32)), t(dest.astype(np.float32)), t(e0),
            t(np.ones(n, bool)))
    for h in (se.remove_on_exit, se.reflect_on_exit_2d):
        full = (mesh, *args, 400, h, True, "off", coarse)
        got = se.trace_2d(*full)
        _trace_equal(got, se.trace_2d_plain(*full))
        assert int((got.num_hits > 0).sum()) > n // 10


def test_trace2d_kernel_refuses_other_handlers(dev, tri2d):
    mesh = tri2d[0]
    x = mesh.elem_centroids[:4].contiguous()
    e = torch.zeros(4, dtype=torch.int32, device=dev)
    a = torch.ones(4, dtype=torch.bool, device=dev)

    def my_handler(ctx):
        return se.remove_on_exit(ctx)

    n0 = kernels.LAUNCHES["trace2d"]
    with pytest.raises(NotImplementedError):
        se.search_mesh_2d(mesh, x, x, e, a, 8, boundary_handler=my_handler)
    assert kernels.LAUNCHES["trace2d"] == n0
    res = se.trace_2d(mesh, x, x, e, a, 8, se.reflect_on_exit_2d, True)
    assert res.dest.data_ptr() == res.dest_c[0].data_ptr()
    assert res.hit.data_ptr() == res.hit_c[0].data_ptr()


@pytest.mark.parametrize("n", [0, 1, 31, 33, 100_003])
@pytest.mark.parametrize("kind", ["bcc", "bcc+charge", "weights"])
def test_vdeposit_kernel_equals_plain(dev, mesh, kind, n):
    """V as scatter_to_verts_bcc (with and without charge) and as the
    weighted particles_per_element: equal to the plain version bit for bit,
    the same bits in a random order of the particles and on a second run."""
    rng = np.random.default_rng(n)
    elem = torch.as_tensor(rng.integers(-2, mesh.nelems + 2, n).astype(np.int32), device=dev)
    act = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    bcc = torch.as_tensor(rng.dirichlet([1, 1, 1], n).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.uniform(-1, 2, n).astype(np.float32), device=dev)
    perm = torch.as_tensor(rng.permutation(n), device=dev)

    def run(p):
        if kind == "weights":
            return sc.particles_per_element(elem[p], act[p], mesh.nelems, q[p])
        return sc.scatter_to_verts_bcc(elem[p], act[p], bcc[p].contiguous(), mesh.elem2verts,
                                       mesh.nverts, q[p] if kind == "bcc+charge" else None)

    ident = torch.arange(n, device=dev)
    n0 = kernels.LAUNCHES["vdeposit"]
    got = run(ident)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["vdeposit"] == n0 + 1
    if kind == "weights":
        want = sc.vertex_deposit_plain(q, None, elem, act, None, mesh.nelems)
    else:
        want = sc.vertex_deposit_plain(bcc, q if kind == "bcc+charge" else None, elem, act,
                                       mesh.elem2verts, mesh.nverts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(run(perm).view(torch.int32), got.view(torch.int32))
    assert torch.equal(run(ident).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("n", [31, 1000, 100_003])
@pytest.mark.parametrize("kind", ["bcc+charge", "weights"])
@pytest.mark.parametrize("order", ["all terms on one key", "element order", "random order"])
def test_vdeposit_kernel_key_orders(dev, mesh, order, kind, n):
    """V where a block tile's terms share keys (every term on one output,
    so one slot of the block's table takes them all; the particles in
    element order, as the 2D path seeds them) and where they do not (a
    random order: the table fills and terms go to L2 directly), with terms
    over 40 binades: bit-equal to the plain version, and a second run equal
    to the first."""
    rng = np.random.default_rng(n + 3)
    E = mesh.nelems
    elem = rng.integers(0, E, n).astype(np.int32)
    e2v = mesh.elem2verts
    if order == "all terms on one key":
        elem[:] = 7
        e2v = torch.full_like(mesh.elem2verts, 11)
    elif order == "element order":
        elem.sort()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    elem = t(elem)
    act = t(rng.uniform(size=n) < 0.95)
    bcc = t(rng.dirichlet([1, 1, 1], n).astype(np.float32))
    # charges over 40 binades: the small terms' fixed-point images have low
    # words (Lo) that are not 0
    q = t((rng.uniform(-1, 2, n) * 2.0 ** rng.integers(-40, 1, n)).astype(np.float32))
    if kind == "weights":
        run = lambda: sc.particles_per_element(elem, act, E, q)  # noqa: E731
        want = sc.vertex_deposit_plain(q, None, elem, act, None, E)
    else:
        run = lambda: sc.scatter_to_verts_bcc(elem, act, bcc, e2v, mesh.nverts, q)  # noqa: E731
        want = sc.vertex_deposit_plain(bcc, q, elem, act, e2v, mesh.nverts)
    got = run()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(run().view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("scale", [1e-42, 1e-20, 1.0, 1e30])
def test_vdeposit_kernel_across_the_f32_range(dev, mesh, scale):
    """Subnormal to large weights, and a NaN term (NaN in its own output
    alone, as the plain version)."""
    rng = np.random.default_rng(1)
    n = 50_000
    elem = torch.as_tensor(rng.integers(0, mesh.nelems, n).astype(np.int32), device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    w = torch.as_tensor((rng.normal(0, 1, n) * scale).astype(np.float32), device=dev)
    for wt in (w, torch.where(torch.arange(n, device=dev) == 77, float("nan"), w)):
        got = sc.particles_per_element(elem, act, mesh.nelems, wt)
        want = sc.vertex_deposit_plain(wt, None, elem, act, None, mesh.nelems)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.nonzero(torch.isnan(got)).flatten(), elem[77:78].long())


V_NON_FINITE = {"nan": (float("nan"),), "+inf": (float("inf"),), "-inf": (-float("inf"),),
                "+inf and -inf in one output": (float("inf"), -float("inf")),
                "inactive nan": (float("nan"),)}


@pytest.mark.parametrize("n", [1000, 1_000_003])
@pytest.mark.parametrize("kind", ["bcc+charge", "weights"])
@pytest.mark.parametrize("case", list(V_NON_FINITE))
def test_vdeposit_kernel_non_finite_terms(dev, mesh, case, kind, n):
    """NaN and infinite terms: V equals its plain version bit for bit (NaN
    where an active term is NaN or both infinities meet, the infinity where
    only it does), and every other output is the finite sum the same
    particles give with the bad ones dropped."""
    rng = np.random.default_rng(n + len(case))
    E = mesh.nelems
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    elem = rng.integers(0, E, n).astype(np.int32)
    act = rng.uniform(size=n) < 0.9
    pool = np.nonzero(~act if case == "inactive nan" else act)[0][:len(V_NON_FINITE[case])]
    elem[pool] = elem[pool[0]]
    q = rng.uniform(-1, 2, n).astype(np.float32)
    q[pool] = V_NON_FINITE[case]
    bcc = t(rng.dirichlet([1, 1, 1], n).astype(np.float32) + np.float32(0.01))
    elem, act, q = t(elem), t(act), t(q)
    dropped = act.clone()
    dropped[t(pool).long()] = False
    if kind == "weights":
        got = sc.particles_per_element(elem, act, E, q)
        want = sc.vertex_deposit_plain(q, None, elem, act, None, E)
        finite = sc.vertex_deposit_plain(q, None, elem, dropped, None, E)
    else:
        got = sc.scatter_to_verts_bcc(elem, act, bcc, mesh.elem2verts, mesh.nverts, q)
        want = sc.vertex_deposit_plain(bcc, q, elem, act, mesh.elem2verts, mesh.nverts)
        finite = sc.vertex_deposit_plain(bcc, q, elem, dropped, mesh.elem2verts,
                                         mesh.nverts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ok = torch.isfinite(got)
    assert torch.equal(got[ok].view(torch.int32), finite[ok].view(torch.int32))
    if case == "inactive nan":
        assert bool(ok.all())
    else:
        assert not bool(ok.all())
        assert bool(torch.isnan(got).any()) == (case in ("nan", "+inf and -inf in one output"))


# ---------------------------------------------------------------------------
# X1, X2, X3, O: the distributed step's exchange and owner reduction
# ---------------------------------------------------------------------------

def _dev_tensor(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _same_bits(got, want, nan_positions=False):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _same_bits(got[k], want[k], nan_positions)
        return
    if isinstance(got, (tuple, list)):
        for x, y in zip(got, want):
            _same_bits(x, y, nan_positions)
        return
    if got is None:
        assert want is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        if nan_positions:
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            got, want = torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0)
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", tr.RANK_CASES + ("large, 33 keys", "large, 100 keys"))
def test_rank_in_key_kernel_equals_plain(dev, case):
    if case.startswith("large"):
        K = int(case.split()[1])            # 100 keys: the wide mode (more than 62)
        key = np.random.default_rng(2).integers(0, K + 1, (1 << 20) + 7).astype(np.int32)
    else:
        key, K = tr.rank_case(case)
    k = _dev_tensor(key, dev)
    n0 = kernels.LAUNCHES["rank_in_key"]
    got = ex.rank_in_key(k, K)
    assert kernels.LAUNCHES["rank_in_key"] == n0 + 1
    _same_bits(got, ex.rank_in_key_plain(k, K))
    _same_bits(ex.rank_in_key(k, K, ranks=False), ex.rank_in_key_plain(k, K, ranks=False))


def test_rank_in_key_kernel_refuses_keys_outside(dev):
    for bad in ([0, 4, 1], [-1]):
        with pytest.raises(ValueError, match="outside"):
            ex.rank_in_key(_dev_tensor(np.asarray(bad, np.int32), dev), 3)
    with pytest.raises(ValueError, match="table holds"):
        ex.rank_in_key(_dev_tensor(np.zeros(4, np.int32), dev), ex.X1_MAX_KEYS)
    key = np.random.default_rng(3).integers(0, ex.X1_MAX_KEYS, 100_000).astype(np.int32)
    k = _dev_tensor(key, dev)
    _same_bits(ex.rank_in_key(k, ex.X1_MAX_KEYS - 1),
               ex.rank_in_key_plain(k, ex.X1_MAX_KEYS - 1))


@pytest.mark.parametrize("case", tr.SEND_CASES)
def test_pack_send_kernel_equals_plain(dev, case):
    st, key, quota, rows, cap, ne, eg = tr.send_case(case)
    st = {n: _dev_tensor(v, dev) for n, v in st.items()}
    k = _dev_tensor(key, dev)
    rank, counts = ex.rank_in_key(k, len(rows))
    args = (st, k, rank, counts, _dev_tensor(quota, dev), rows, cap, _dev_tensor(ne, dev),
            _dev_tensor(eg, dev))
    n0 = kernels.LAUNCHES["pack_send"]
    got = ex.pack_send(*args)
    assert kernels.LAUNCHES["pack_send"] == n0 + 1
    want = ex.pack_send_plain(*args)
    _same_bits(got[:4], want[:4])
    assert got[4] == want[4]


@pytest.mark.parametrize("case", ["misaligned views", "wide rows"])
def test_pack_send_kernel_one_by_one_and_wide_rows(dev, case):
    """X2's items one by one (keys and ranks one item into their storage:
    no 16-byte groups) and rows wider than a warp (a (5, 8) f32 field)."""
    st, key, quota, rows, cap, ne, eg = tr.send_case("random")
    if case == "wide rows":
        st["W"] = tr.odd_floats(np.random.default_rng(9), 40 * len(key)).reshape(-1, 5, 8)
    st = {n: _dev_tensor(v, dev) for n, v in st.items()}
    k = _dev_tensor(key, dev)
    ne = _dev_tensor(ne, dev)
    if case == "misaligned views":
        st = {n: v[1:].contiguous() for n, v in st.items()}
        k, ne = k[1:], ne[1:]
    rank, counts = ex.rank_in_key(k, len(rows))
    if case == "misaligned views":
        rank = torch.cat([rank[:1], rank])[1:]
        assert rank.data_ptr() % 16 and k.data_ptr() % 16
    q = torch.minimum(_dev_tensor(quota, dev), counts[:len(rows)])
    args = (st, k, rank, counts, q, q.tolist(), cap, ne, _dev_tensor(eg, dev))
    got = ex.pack_send(*args)
    _same_bits(got[:4], ex.pack_send_plain(*args)[:4])


def test_rank_in_key_kernel_counts_only_one_launch(dev):
    """X1's counts only is one counted launch, as the ranks are; no key
    gives zero counts."""
    k = _dev_tensor(np.random.default_rng(6).integers(0, 5, 300_000).astype(np.int32), dev)
    n0 = kernels.LAUNCHES["rank_in_key"]
    got = ex.key_counts(k, 4)
    assert kernels.LAUNCHES["rank_in_key"] == n0 + 1
    _same_bits(got, ex.rank_in_key_plain(k, 4, ranks=False)[1][:4])
    empty = ex.rank_in_key(k[:0], 4, ranks=False)
    _same_bits(empty, ex.rank_in_key_plain(k[:0], 4, ranks=False))


@pytest.mark.parametrize("case", tr.PLACE_CASES)
def test_place_arrivals_kernel_equals_plain(dev, case):
    st, staying, ne, recv, gs, gp = tr.place_case(case)
    st = {n: _dev_tensor(v, dev) for n, v in st.items()}
    fs, _ = ex.payload_layout(st)
    args = (st, _dev_tensor(staying, dev), _dev_tensor(ne, dev), _dev_tensor(recv, dev), fs,
            _dev_tensor(gs, dev), _dev_tensor(gp, dev))
    before = {k: v.clone() for k, v in st.items()}
    n0 = (kernels.LAUNCHES["place_arrivals"], kernels.LAUNCHES["rank_in_key"])
    got = ex.place_arrivals(*args)
    assert (kernels.LAUNCHES["place_arrivals"], kernels.LAUNCHES["rank_in_key"]) == \
        (n0[0] + 1, n0[1])
    _same_bits(got, ex.place_arrivals_plain(*args))
    _same_bits(got, ex.place_arrivals_plain(before, *args[1:]))
    stay = args[1]
    for k in fs:        # in place: the state's own tensors, stayers untouched
        assert got[0][k].data_ptr() == st[k].data_ptr()
        keep = stay.reshape((-1,) + (1,) * (st[k].dim() - 1))
        _same_bits(torch.where(keep, st[k], before[k]), before[k])
    assert got[0]["elem"].data_ptr() != st["elem"].data_ptr()
    again = ex.place_arrivals(*args)        # idempotent: the free slots rewritten
    _same_bits(again, got)


@pytest.mark.parametrize("case", tr.OWNER_CASES)
def test_owner_kernels_equal_plain(dev, case):
    f, rid, rv, sid, back, op = (_dev_tensor(a, dev) if isinstance(a, np.ndarray) else a
                                 for a in tr.owner_case(case))
    nan = "nan" in case
    n0 = kernels.LAUNCHES["owner_reduce"]
    fill = ex.neutral(op, f.dtype)
    _same_bits(ex.owner_gather(f, sid, fill), ex.owner_gather_plain(f, sid, fill), nan)
    _same_bits(ex.owner_fan_in(f, rv, rid, op), ex.owner_fan_in_plain(f, rv, rid, op), nan)
    before = f.clone()
    _same_bits(ex.owner_fan_out(f, back, sid), ex.owner_fan_out_plain(f, back, sid), nan)
    _same_bits(f, before, nan)
    mine = f.clone()
    assert ex.owner_fan_out_(mine, back, sid) is mine
    _same_bits(mine, ex.owner_fan_out_plain(f, back, sid), nan)
    assert kernels.LAUNCHES["owner_reduce"] == n0 + 4


@pytest.mark.parametrize("V", [40, 3000])
def test_deposit_send_rows_equal_the_gather(dev, V):
    """D's pass 2 with the owner SUM's send rows: the field's bits as
    without them, the rows equal to O's gather of that field, rows naming
    no vertex untouched; one D launch, no O launch."""
    from pumipic_torch.parallel import reduce as red

    R, P = 3, 8
    rng = np.random.default_rng(V)
    flat, ring_np = _mapped_inputs(V, R, P, rng)
    gmap = sc.GyroMap.from_flat(flat, V, R, P, dev)
    ring = torch.as_tensor(ring_np, device=dev)
    send_ids = np.full((4, V // 3 + 1), -1, np.int32)
    pick = rng.permutation(V)[:V // 2]
    send_ids.reshape(-1)[rng.permutation(send_ids.size)[:len(pick)]] = pick
    sid = _dev_tensor(send_ids, dev)
    row_of, buf = red.sum_send_rows(sid, V)
    buf.fill_(7.0)
    n0 = (kernels.LAUNCHES["deposit"], kernels.LAUNCHES["owner_reduce"])
    got = sc.scatter_to_mapped_verts(ring, gmap, V, R, P, (row_of, buf))
    assert (kernels.LAUNCHES["deposit"], kernels.LAUNCHES["owner_reduce"]) == (n0[0] + 1, n0[1])
    alone = sc.scatter_to_mapped_verts(ring, gmap, V, R, P)
    _same_bits(got, alone)
    _same_bits(buf, torch.where(sid >= 0, ex.owner_gather(alone, sid, 0.0), 7.0))
    want = sc.mapped_plain(ring, gmap, V, R, P)
    plain_buf = torch.full_like(buf, 7.0)
    sc.write_send_rows(want, (row_of, plain_buf))
    _same_bits((got, buf), (want, plain_buf))


# ---------------------------------------------------------------------------
# F (the GITR step's update), Q (the rebuild's mask) and C (its sort)
# ---------------------------------------------------------------------------

def _gitr_update_case(n, dev, seed):
    """Kernel F's inputs: active and inactive, lost, hit counts 0 to 3,
    last legs of zero, of ~1e-21 (subnormal squares: |leg| just above 0)
    and of ~1e-2, NaN destinations, N(0, 1e3) velocities."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.uniform(0, 1, (n, 3)).astype(f)
    v, v_new = (rng.normal(0, 1e3, (n, 3)).astype(f) for _ in range(2))
    dest = rng.uniform(0, 1, (n, 3)).astype(f)
    pick = rng.random(n)[:, None]
    leg = np.where(pick < 0.1, 0.0, np.where(pick < 0.2, 1e-21, 1e-2)) * rng.normal(size=(n, 3))
    hit = (dest - leg.astype(f)).astype(f)
    tiny = pick[:, 0] < 0.2                # near the origin, so the legs stay exact
    hit[tiny] = 0.0
    dest[tiny] = leg[tiny].astype(f)
    dest[rng.random(n) < 0.01] = np.nan
    elem = np.where(rng.random(n) < 0.1, -1, rng.integers(0, 50, n)).astype(np.int32)
    num_hits = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 4, n)).astype(np.int32)
    active = rng.random(n) < 0.8
    return [_dev_tensor(a, dev) for a in (x, v, v_new, dest, hit, elem, num_hits, active)]


@pytest.mark.parametrize("n", [0, 1, 255, 257, 1_000_003])
@pytest.mark.parametrize("reflect", [False, True])
def test_gitr_update_kernel_equals_plain(dev, reflect, n):
    args = _gitr_update_case(n, dev, n + reflect)
    n0 = kernels.LAUNCHES["gitr_update"]
    got = push_ops.gitr_update(*args, reflect)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gitr_update"] == n0 + (1 if n else 0)
    _same_bits(got, push_ops.gitr_update_plain(*args, reflect))
    if reflect and n > 1000:        # ~45% bounce, the subnormal legs among them
        assert int((got[1] != args[2]).any(1)[args[7]].sum()) > n // 3


def _mask_case(mode, n, dev, seed):
    rng = np.random.default_rng(seed)
    E = 1000
    a = _dev_tensor(np.where(rng.random(n) < 0.2, rng.integers(-3, E + 3, n),
                             rng.integers(0, E, n)).astype(np.int32), dev)
    m = _dev_tensor(rng.random(n) < 0.8, dev)
    if mode == "dps":
        return rb.rebuild_mask_dps, rb.rebuild_mask_dps_plain, (a, m, E)
    if mode == "epilogue":
        b = torch.where(_dev_tensor(rng.random(n) < 0.7, dev), a,
                        _dev_tensor(rng.integers(0, E, n).astype(np.int32), dev))
        return rb.rebuild_mask_epilogue, rb.rebuild_mask_epilogue_plain, (m, b, a)
    needed = torch.tensor(int(rng.integers(0, n + 2)) if n else 0, dtype=torch.int32,
                          device=dev)
    return rb.rebuild_mask_prefix, rb.rebuild_mask_prefix_plain, (a, needed)


@pytest.mark.parametrize("n", [0, 1, 1000, 1_000_003, 11_999_376])
@pytest.mark.parametrize("mode", ["dps", "epilogue", "prefix"])
def test_rebuild_mask_kernel_equals_plain(dev, mode, n):
    fn, plain, args = _mask_case(mode, n, dev, n)
    n0 = kernels.LAUNCHES["rebuild_mask"]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rebuild_mask"] == n0 + (1 if n else 0)
    _same_bits(got, plain(*args))


def _sort_case(case, dev):
    """(keys, max_key) on the card."""
    g = torch.Generator(device=dev).manual_seed(len(case))

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    E = 122_603
    if case.startswith("app"):
        n = 11_999_376
        k = torch.sort(randint(0, E, n)).values
        k = torch.where(torch.rand(n, generator=g, device=dev) < 0.05, E, k)
        if case.endswith("random order"):
            k = k[torch.randperm(n, generator=g, device=dev)]
        else:                              # nearly sorted: a few moves
            sel = torch.randperm(n, generator=g, device=dev)[:n // 100]
            k[sel] = randint(0, E + 1, sel.shape[0])
        return k, E
    n = {"K = 2, 10M": 10_000_000, "0/1 partition, 10M": 10_000_000,
         "pps3d, 24,576 tets": 10_000_000}.get(case, 1_000_003)
    if case == "K = 2, 10M":
        return randint(0, 3, n), 2
    if case == "0/1 partition, 10M":
        return (torch.rand(n, generator=g, device=dev) < 0.3).to(torch.int32), 1
    if case == "pps3d, 24,576 tets":
        return randint(0, 24_577, n), 24_576
    if case == "K = 2^31 - 1 (4 passes)":
        return randint(0, 2**31 - 1, n), 2**31 - 1
    if case == "K = 2^18 (3 passes)":
        return randint(0, 2**18 + 1, n), 2**18
    if case == "all equal":
        return torch.full((n,), 7, dtype=torch.int32, device=dev), 9
    if case == "all sentinel":
        return torch.full((n,), E, dtype=torch.int32, device=dev), E
    if case == "negative keys":
        return randint(-300, 300, n), 300
    if case == "keys above K":
        return randint(0, 5000, n), 300
    if case == "every int32":
        return randint(-(2**31), 2**31 - 1, n), E
    if case == "app keys, a few outside":
        k = randint(0, E + 1, 11_999_376)
        k[torch.randperm(k.shape[0], generator=g, device=dev)[:50]] = randint(
            -(2**31), 2**31 - 1, 50)
        return k, E
    size = int(case.split()[-1])
    return randint(0, 300, size), 299


SORT_CASES = ["app, nearly sorted", "app, random order", "K = 2, 10M", "0/1 partition, 10M",
              "pps3d, 24,576 tets", "K = 2^31 - 1 (4 passes)", "K = 2^18 (3 passes)",
              "all equal", "all sentinel", "n = 0", "n = 1", "n = 4095", "n = 4096",
              "n = 4097", "negative keys", "keys above K", "every int32",
              "app keys, a few outside"]


@pytest.mark.parametrize("case", SORT_CASES)
def test_key_sort_kernel_equals_plain(dev, case):
    key, K = _sort_case(case, dev)
    n0 = kernels.LAUNCHES["key_sort"]
    got = rb.key_sort(key, K)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["key_sort"] == n0 + (1 if key.numel() else 0)
    assert got.dtype == torch.int32
    assert torch.equal(got, rb.key_sort_plain(key, K))
    assert torch.equal(rb.key_sort(key, K), got)


@pytest.mark.parametrize("case", ["app's rebuild", "inactive slots hold -1",
                                  "0/1 partition", "elements outside [0, E]", "n = 4097"])
def test_masked_key_sort_kernel_equals_plain(dev, case):
    """C's fused mode: the key formed from (elem, active, fill) in the
    histogram and the first pass, kept where asked, equal to the plain
    version's where and stable sort."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    E = 122_603
    n = 4097 if case == "n = 4097" else 11_999_376
    elem = torch.sort(torch.randint(0, E, (n,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    active = torch.rand(n, generator=g, device=dev) < 0.95
    if case == "inactive slots hold -1":
        elem = torch.where(active, elem, -1)
    if case == "elements outside [0, E]":
        elem[torch.randperm(n, generator=g, device=dev)[:100]] = -7
        elem[torch.randperm(n, generator=g, device=dev)[:100]] = 5 * E
    e, fill = (None, 1) if case == "0/1 partition" else (elem, E)
    n0 = kernels.LAUNCHES["key_sort"]
    order, key = rb.masked_key_sort(e, active, fill, keep_key=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["key_sort"] == n0 + 1
    want_order, want_key = rb.masked_key_sort_plain(e, active, fill)
    assert torch.equal(key, want_key) and torch.equal(order, want_order)
    assert rb.masked_key_sort(e, active, fill)[1] is None
    assert torch.equal(rb.masked_key_sort(e, active, fill)[0], want_order)


# ---------------------------------------------------------------------------
# kernel J (check_parents) and kernel L's plain walk, sparse and in place
# ---------------------------------------------------------------------------

def _parent_claims(m, n, seed, dev):
    """Origins in random elements of ``m`` (2D or 3D) with claims right,
    random, below 0 and at E or above, NaN and infinite origins, points off
    the mesh; a tenth inactive."""
    rng = np.random.default_rng(seed)
    ev, cz = m.elem2verts.cpu().numpy(), m.coords.cpu().numpy()
    dim = cz.shape[1]
    e = rng.integers(0, m.nelems, n)
    w = rng.dirichlet(np.ones(dim + 1), n)
    pts = np.einsum("nk,nkd->nd", w, cz[ev[e]]).astype(np.float32)
    claim = e.copy()
    k = n // 100
    claim[:k] = rng.integers(0, m.nelems, k)
    claim[k:k + 20] = -3
    claim[k + 20:k + 40] = m.nelems + 1
    pts[k + 40:k + 50] = np.nan
    pts[k + 50:k + 55, 0] = np.inf
    pts[k + 55:k + 60] = 5.0
    act = rng.uniform(size=n) < 0.9
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(claim.astype(np.int32)).to(dev),
            torch.from_numpy(act).to(dev))


@pytest.mark.parametrize("order", ["grouped", "scattered"])
@pytest.mark.parametrize("n", [0, 1000, 300_001])
@pytest.mark.parametrize("form", ["rows", "columns"])
@pytest.mark.parametrize("locator", [False, True])
@pytest.mark.parametrize("mode", ["delete", "repair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_check_parents_kernel_equals_plain(dev, mesh, dim, mode, locator, form, n, order):
    """Kernel J and the repair walk in place (L's in 2D, L3's in 3D)
    against the plain version, with the walks started from the clamped
    parent or from the locator's guess; the slots grouped by claimed
    parent (neighbouring slots share rows) or scattered against slot order
    (the 2D path's order after a walk).  The repair launches J and one
    walk, the delete mode J alone."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.mesh.locator import build_locator_grid_3d

    m = mesh if dim == 2 else Mesh3D.from_arrays(*box_tet_mesh(6, 6, 6), device=dev)
    grid = None
    if locator:
        build = build_locator_grid if dim == 2 else build_locator_grid_3d
        grid = build(m.coords.cpu().numpy(), m.elem2verts.cpu().numpy(), device=dev)
    x, claim, act = _parent_claims(m, n, 5 + dim, dev)
    if order == "grouped":
        perm = torch.argsort(claim, stable=True)
    else:
        perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(n),
                              device=dev)
    x, claim, act = x[perm].contiguous(), claim[perm], act[perm]
    xo = x if form == "rows" else tuple(x.unbind(1))     # strided views, no copy
    walk = "locate" if dim == 2 else "locate3d"
    n0 = dict(kernels.LAUNCHES)
    got = se.check_initial_parents(m, xo, claim, act, mode, locator=grid)
    torch.cuda.synchronize()
    grown = {k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]}
    assert grown == ({"check_parents": 1} if mode == "delete"
                     else {"check_parents": 1, walk: 1})
    want = se.check_parents_plain(m, xo, claim, act, mode, locator=grid)
    _equal(got, want)
    if n:
        assert int(got[1]) > 0 and (mode == "delete") == (int(got[2]) == 0)


@pytest.mark.parametrize("max_iters", [64, 3, 0])
@pytest.mark.parametrize("share", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 4097, 400_000])
def test_plain_walk_3d_kernel_in_place_equals_plain(dev, n, share, max_iters):
    """Kernel L3's sparse plain walk in place on column views of an (N, 3)
    tensor against its plain version, at walker shares from none to all:
    the walkers' slots and the counts added to the stats; the other slots
    untouched."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh

    m = Mesh3D.from_arrays(*box_tet_mesh(6, 6, 6), device=dev)
    g = torch.Generator(device=dev).manual_seed(n + int(share * 1000))
    lo_, hi = m.coords.amin(0), m.coords.amax(0)
    x = lo_ - 0.1 + (hi - lo_ + 0.2) * torch.rand(n, 3, generator=g, device=dev)
    x[:5] = float("nan")
    start = torch.randint(-2, m.nelems + 2, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    walkers = torch.rand(n, generator=g, device=dev) < share
    base = torch.randint(-1, m.nelems, (n,), generator=g, device=dev, dtype=torch.int32)
    e_k, e_p = base.clone(), base.clone()
    s_k = torch.tensor([0, 0, 0, 5], dtype=torch.int32, device=dev)
    s_p = s_k.clone()
    args = (m.walk_geom, *x.unbind(1), start, walkers, max_iters)
    n0 = kernels.LAUNCHES["locate3d"]
    se.walk_locate_3d_into(*args, e_k, s_k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["locate3d"] == n0 + 1
    se.walk_locate_3d_into_plain(*args, e_p, s_p)
    assert torch.equal(e_k, e_p) and torch.equal(s_k, s_p)
    assert torch.equal(e_k[~walkers], base[~walkers])
    full = se.walk_locate_3d_plain(m.walk_geom, x, start, walkers, max_iters)
    assert torch.equal(e_k[walkers], full[0][walkers])


@pytest.mark.parametrize("max_iters", [64, 3, 0])
@pytest.mark.parametrize("share", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 4097, 400_000])
def test_plain_walk_kernel_sparse_and_in_place_equal_plain(dev, mesh, n, share, max_iters):
    """Kernel L's plain walk: every slot written (the first version, on
    contiguous columns), and the sparse kernel in place and for its counts
    alone on column views of an (N, 2) tensor, at walker shares from none
    to all."""
    g = torch.Generator(device=dev).manual_seed(n + int(share * 1000))
    x = mesh.coords.amin(0) + (mesh.coords.amax(0) - mesh.coords.amin(0)) * torch.rand(
        n, 2, generator=g, device=dev)
    x[:5] = float("nan")
    start = torch.randint(-2, mesh.nelems + 2, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    walkers = torch.rand(n, generator=g, device=dev) < share
    dx, dy = x.unbind(1)
    n0 = kernels.LAUNCHES["locate"]
    cx, cy = dx.contiguous(), dy.contiguous()     # the first version's walk
    got = se.walk_locate(mesh.walk_geom, cx, cy, start, walkers, max_iters)
    _equal(got, se.walk_locate_plain(mesh.walk_geom, dx, dy, start, walkers, max_iters))
    base = torch.randint(-1, mesh.nelems, (n,), generator=g, device=dev, dtype=torch.int32)
    e_k, s_k = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
    e_p, s_p = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
    se.walk_locate_into(mesh.walk_geom, dx, dy, start, walkers, max_iters, e_k, s_k)
    found, all_found = se.walk_locate_count(mesh.walk_geom, dx, dy, start, walkers,
                                            max_iters)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["locate"] == n0 + 3
    assert int(found) == int((got[0] >= 0).sum()) and bool(all_found) == bool(got[3])
    se.walk_locate_into_plain(mesh.walk_geom, dx, dy, start, walkers, max_iters, e_p, s_p)
    assert torch.equal(e_k, e_p) and torch.equal(s_k, s_p)
    assert torch.equal(e_k[~walkers], base[~walkers])


@pytest.mark.parametrize("case", SORT_CASES)
def test_key_sort_kernel_values_equal_plain(dev, case):
    """C with a payload: the last pass writes values[order] (the
    reshuffle's mover slots in destination order)."""
    key, K = _sort_case(case, dev)
    g = torch.Generator(device=dev).manual_seed(key.numel())
    values = torch.randint(-2**31, 2**31 - 1, key.shape, generator=g, device=dev,
                           dtype=torch.int32)
    got = rb.key_sort(key, K, values=values)
    assert torch.equal(got, rb.key_sort_plain(key, K, values))
    assert torch.equal(got, values[rb.key_sort(key, K).long()])


def _reshuffle_case(dev, layout, kind, n=60_000, E=997, seed=0):
    """A structure of ``layout`` (Sell-C-σ chunks of 8, or CabM) with
    ``n`` particles over E elements, extra padding 0.3, three fields (f32
    (N, 3), int32, bool), on the card, and a rebuild's destinations (Q's
    DPS output): a swap churn (each mover's source another mover's hole),
    a random churn with removals, or most particles moving (the fallback)."""
    from pumipic_torch.particles import structure as st

    rng = np.random.default_rng(seed)
    elems = np.sort(rng.integers(0, E, n))
    fields = {"x": torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)),
              "pid": torch.arange(n, dtype=torch.int32),
              "flag": torch.as_tensor(rng.uniform(size=n) < 0.5)}
    f = {k: v.to(dev) for k, v in fields.items()}
    if layout == "scs":
        ps = st.SellCSigma(E, elems, fields=f, device=dev, scs_input=st.SCSInput(
            chunk_size=8, extra_padding=0.3))
    else:
        ps = st.CabM(E, elems, fields=f, soa_width=8, extra_padding=0.3, device=dev)
    cur = np.where(ps.active.cpu().numpy(), ps.elem.cpu().numpy(), -1)
    new = cur.copy()
    live = np.flatnonzero(cur >= 0)
    if kind == "swap":
        sel = rng.choice(live, size=len(live) // 20 * 2, replace=False)
        a, b = np.split(sel, 2)
        new[a], new[b] = cur[b], cur[a]
    elif kind == "random":
        mv = rng.uniform(size=len(live)) < 0.05
        new[live[mv]] = rng.integers(-1, E + 1, int(mv.sum()))
    else:
        new[live] = rng.integers(0, E, len(live))
    elem, _, _ = rb.rebuild_mask_dps(torch.as_tensor(new, device=dev), ps.active, E)
    return ps, elem


@pytest.mark.parametrize("n", [60_000, 3_000])
@pytest.mark.parametrize("mb", ["capacity", "small"])
@pytest.mark.parametrize("kind", ["swap", "random", "most"])
@pytest.mark.parametrize("layout", ["scs", "cabm"])
def test_reshuffle_count_kernel_equals_plain(dev, layout, kind, mb, n):
    """U1 against its plain version, over many tiles and one: fits,
    n_mov, the count and the first min(n_mov, MB) movers always; the
    stayers' and movers' counts and the movers' first places where n_mov
    <= MB (U1 counts movers only while the budget holds, and a tile that
    starts after the budget was passed counts its particles alone)."""
    ps, elem = _reshuffle_case(dev, layout, kind, n=n)
    MB = ps.capacity if mb == "capacity" else 1000
    n0 = kernels.LAUNCHES["reshuffle_count"]
    got = rb.reshuffle_count(elem, ps.elem, ps.seg_cap, MB)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["reshuffle_count"] == n0 + 1
    want = rb.reshuffle_count_plain(elem, ps.elem, ps.seg_cap, MB)
    assert got.info.tolist() == want.info.tolist() and int(got.num) == int(want.num)
    n_mov = int(want.info[1])
    k = min(n_mov, MB)
    assert torch.equal(got.msrc[:k], want.msrc[:k]) and torch.equal(got.mkey[:k], want.mkey[:k])
    if n_mov <= MB:
        assert torch.equal(got.stay_cnt, want.stay_cnt)
        assert torch.equal(got.mov_cnt, want.mov_cnt)
        assert torch.equal(got.mov_start, want.mov_start)
    if n == 60_000:                     # the churns fit this structure's padding
        assert bool(want.info[0]) == (kind != "most" and mb == "capacity")


@pytest.mark.parametrize("share", [0.027, 0.84])
def test_reshuffle_count_kernel_skips_past_the_budget(dev, share):
    """U1 at 8M slots (1,954 tiles, several waves) over 24,576 elements,
    ids at random with ``share`` of the slots moving: with the budget the
    capacity, every output equal to the plain version; with a budget of
    1,000 (passed in the first tile) fits, n_mov, the count and the first
    MB movers equal, and the tiles that start after the budget was passed
    add no stayers (the fallback's skip: fewer stayers counted than
    there are)."""
    C, E = 8_000_000, 24_576
    g = torch.Generator(device=dev).manual_seed(int(share * 1000))
    old = torch.randint(-1, E, (C,), generator=g, device=dev, dtype=torch.int32)
    move = torch.rand(C, generator=g, device=dev) < share
    elem = torch.where(move, torch.randint(0, E, (C,), generator=g, device=dev,
                                           dtype=torch.int32), old)
    seg_cap = torch.full((E,), 2 * C // E, dtype=torch.int32, device=dev)
    for MB in (C, 1000):
        got = rb.reshuffle_count(elem, old, seg_cap, MB)
        want = rb.reshuffle_count_plain(elem, old, seg_cap, MB)
        torch.cuda.synchronize()
        assert got.info.tolist() == want.info.tolist() and int(got.num) == int(want.num)
        n_mov = int(want.info[1])
        k = min(n_mov, MB)
        assert torch.equal(got.msrc[:k], want.msrc[:k])
        assert torch.equal(got.mkey[:k], want.mkey[:k])
        if MB == C:
            assert bool(want.info[0])
            for a, b in ((got.stay_cnt, want.stay_cnt), (got.mov_cnt, want.mov_cnt),
                         (got.mov_start, want.mov_start)):
                assert torch.equal(a, b)
        else:
            assert int(got.stay_cnt.sum()) < int(want.stay_cnt.sum())


def _place_args(ps, elem, fields=None):
    """U2's arguments at a reshuffle of ``ps`` into ``elem`` (U1's counts,
    U3's order, the staged rows), the fields a copy of ``ps``'s (U2 writes
    them in place) or ``fields``; and the counts."""
    c = rb.reshuffle_count(elem, ps.elem, ps.seg_cap, ps.capacity)
    fits, n_mov = c.info.tolist()
    assert fits and n_mov > 0
    take = rb.reshuffle_order(c.mkey[:n_mov], c.msrc[:n_mov], c.mov_start)
    staged = {k: v[take.long()] for k, v in ps.fields.items()}
    stride = ps.chunk_size if ps.layout == "scs" else 1
    f = fields if fields is not None else {k: v.clone() for k, v in ps.fields.items()}
    return (elem, ps.elem, ps.elem_offsets, ps.seg_cap, c.mov_cnt, c.mov_start, f, staged,
            stride, ps.overflowed, ps.row_to_elem), c


def _with_fields(args, fields):
    return args[:6] + (fields,) + args[7:]


@pytest.mark.parametrize("kind", ["swap", "random"])
@pytest.mark.parametrize("layout", ["scs", "cabm"])
def test_reshuffle_place_kernel_equals_plain(dev, layout, kind):
    """U2 against its plain version on a rebuild's own inputs, each writing
    into its own copy of the fields: every slot's element and mask, every
    field (f32 (N, 3), int32, bool), written in place into the tensors
    given, the count and the flag; a second call gives the same; its other
    inputs untouched; a Sell-C-σ call without the row order is refused."""
    ps, elem = _reshuffle_case(dev, layout, kind, seed=3)
    args, c = _place_args(ps, elem)
    pargs = _with_fields(args, {k: v.clone() for k, v in ps.fields.items()})
    before = [t.clone() for t in args[:6]] + [v.clone() for v in args[7].values()]
    n0 = kernels.LAUNCHES["reshuffle_place"]
    got = rb.reshuffle_place(*args)
    got_fields = {k: v.clone() for k, v in got[2].items()}
    again = rb.reshuffle_place(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["reshuffle_place"] == n0 + 2
    want = rb.reshuffle_place_plain(*pargs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in want[2]:
        assert got[2][k] is args[6][k] and again[2][k] is args[6][k]
        assert torch.equal(got_fields[k], want[2][k]) and torch.equal(args[6][k], want[2][k])
    assert int(got[3]) == int(want[3]) == int(got[1].sum()) and not bool(got[4])
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert int(again[3]) == int(want[3]) and not bool(again[4])
    for a, b in zip(before, list(args[:6]) + list(args[7].values())):
        assert torch.equal(a, b)
    if layout == "scs":
        with pytest.raises(ValueError):
            rb.reshuffle_place(*args[:-1])
    # a segment short of holes: the flag, and only the placed counted
    short = c.mov_cnt.clone()
    short[0] += int(ps.seg_cap[0]) + 1
    sargs = args[:4] + (short,) + args[5:]
    g = rb.reshuffle_place(*_with_fields(sargs, {k: v.clone() for k, v in
                                                  ps.fields.items()}))
    w = rb.reshuffle_place_plain(*_with_fields(sargs, {k: v.clone() for k, v in
                                                        ps.fields.items()}))
    assert bool(g[4]) and bool(w[4]) and int(g[3]) == int(w[3])
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    for k in w[2]:
        assert torch.equal(g[2][k], w[2][k])


@pytest.mark.parametrize("layout,chunk", [("scs", 8), ("scs", 3), ("scs", 32), ("scs", 40),
                                          ("cabm", 1)])
def test_reshuffle_place_kernel_writes_every_slot_once(dev, layout, chunk):
    """U2 through its launcher on poisoned outputs: every slot's element
    and mask written (a stayer, a filled hole, an empty hole, a padding
    row's slot, the slots past the layout's end), equal to the plain
    version, at chunks of 3, 8, 32 and 40 rows (a round of 30, 32, 32 and
    32 slots) and for CabM; the count and the flag word in one memset."""
    import ctypes

    from pumipic_torch.kernels import _build
    from pumipic_torch.particles import structure as st

    rng = np.random.default_rng(chunk)
    E, n = 501, 30_000
    elems = np.sort(rng.integers(0, E, n))
    f = {"x": torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=dev),
         "pid": torch.arange(n, dtype=torch.int32, device=dev)}
    if layout == "scs":
        ps = st.SellCSigma(E, elems, fields=f, device=dev, capacity=int(n * 1.7),
                           scs_input=st.SCSInput(chunk_size=chunk, extra_padding=0.3))
    else:
        ps = st.CabM(E, elems, fields=f, soa_width=8, extra_padding=0.3, device=dev,
                     capacity=int(n * 1.7))
    cur = np.where(ps.active.cpu().numpy(), ps.elem.cpu().numpy(), -1)
    live = np.flatnonzero(cur >= 0)
    new = cur.copy()
    mv = rng.uniform(size=len(live)) < 0.05
    new[live[mv]] = rng.integers(-1, E, int(mv.sum()))
    elem, _, _ = rb.rebuild_mask_dps(torch.as_tensor(new, device=dev), ps.active, E)
    args, _ = _place_args(ps, elem)
    want = rb.reshuffle_place_plain(*_with_fields(args, {k: v.clone() for k, v in
                                                          ps.fields.items()}))
    C = ps.capacity
    e_out = torch.full((C,), 12345, dtype=torch.int32, device=dev)
    a_out = torch.full((C,), 7, dtype=torch.uint8, device=dev)
    num_ovf = torch.full((2,), 99, dtype=torch.int32, device=dev)
    names = list(args[6])
    m = len(names)
    P = ctypes.c_void_p
    r2e = ps.row_to_elem
    err = _build.lib().pp_reshuffle_place(
        *(P(t.data_ptr()) for t in args[:6]), P(r2e.data_ptr() if r2e is not None else 0),
        0 if r2e is None else r2e.shape[0], E, C, args[8], P(ps.overflowed.data_ptr()), m,
        (P * m)(*(args[7][k].data_ptr() for k in names)),
        (P * m)(*(args[6][k].data_ptr() for k in names)),
        (ctypes.c_int * m)(*(rb._row_bytes(args[6][k]) for k in names)),
        P(e_out.data_ptr()), P(a_out.data_ptr()), P(num_ovf.data_ptr()),
        P(kernels.stream_handle()))
    torch.cuda.synchronize()
    assert err == 0
    assert int((e_out == 12345).sum()) == 0 and int((a_out > 1).sum()) == 0
    assert torch.equal(e_out, want[0]) and torch.equal(a_out.bool(), want[1])
    assert num_ovf.tolist() == [int(want[3]), 0]
    for k in names:
        assert torch.equal(args[6][k], want[2][k])


@pytest.mark.parametrize("layout", ["scs", "cabm"])
@pytest.mark.parametrize("kind", ["swap", "random", "most"])
def test_auto_rebuild_launches_and_equals_cpu(dev, layout, kind):
    """rebuild(mode="auto") on the card equals the CPU's, member for member;
    a reshuffle launches Q, U1, U3, G and U2 once each (no C), a fallback
    Q, U1 and the sort rebuild (C, H, S, G, Q; Z for SCS), not U2."""
    import dataclasses

    ps, elem = _reshuffle_case(dev, layout, kind, seed=5)
    new = torch.where(elem >= 0, elem, -1)
    cpu = ps
    cpu = dataclasses.replace(
        ps, fields={k: v.cpu() for k, v in ps.fields.items()},
        **{f.name: getattr(ps, f.name).cpu() for f in dataclasses.fields(ps)
           if isinstance(getattr(ps, f.name), torch.Tensor)})
    kernels.reset_launches()
    got = ps.rebuild(new, mode="auto")
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = cpu.rebuild(new.cpu(), mode="auto")
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "fields":
            for k in a:
                assert torch.equal(a[k].cpu(), b[k]), k
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a.cpu(), b), f.name
    if kind == "most":
        sort = {"histogram": 1, "key_sort": 1, "slot_map": 1, "row_gather": 1}
        if layout == "scs":
            sort.update(scs_row_order=1)
        assert counts == {"rebuild_mask": 2, "reshuffle_count": 1, **sort}, counts
    else:
        assert counts == {"rebuild_mask": 1, "reshuffle_count": 1, "reshuffle_order": 1,
                          "row_gather": 1, "reshuffle_place": 1}, counts


def _row_order_ref(counts, R, sigma, chunk):
    """The Sell-C-σ row order by torch's stable sort of the negated counts
    in σ windows (int64: exact for every int32 count), its inverse and
    the chunks' largest counts."""
    E, dev = counts.shape[0], counts.device
    sigma = min(sigma, R)
    nwin = -(-R // sigma)
    cpad = torch.full((nwin * sigma,), -1, dtype=torch.int64, device=dev)
    cpad[:E] = counts
    order = torch.sort(-cpad.reshape(nwin, sigma), dim=1, stable=True).indices
    r2e = (order + torch.arange(nwin, device=dev)[:, None] * sigma).reshape(-1)[:R]
    e2r = torch.zeros(R, dtype=torch.int64, device=dev)
    e2r[r2e] = torch.arange(R, device=dev)
    rc = torch.clamp(cpad[r2e], min=0).reshape(R // chunk, chunk)
    return (r2e.to(torch.int32), e2r[:E].to(torch.int32),
            torch.amax(rc, dim=1).to(torch.int32))


@pytest.mark.parametrize("E,chunk,sigma", [(24_576, 8, 2**30), (122_603, 8, 2**30),
                                           (997, 4, 16), (37, 3, 8), (1, 8, 2**30),
                                           (24_576, 3, 16), (122_603, 4, 8),
                                           (2_500_003, 8, 2**30), (2_500_003, 8, 4096)])
@pytest.mark.parametrize("bound", ["tight", "none"])
def test_scs_row_order_kernels_equal_plain(dev, E, chunk, sigma, bound):
    """Z, one launch, against its plain version (the key, the stable sort,
    the maps) on the card and on the CPU and against torch's sort of the
    negated counts in σ windows: ties, zeros, a count above the one-window
    key's bits (70,000), σ of 8, 16, 4096 and all rows, chunks of 3, 4 and
    8, E = 1, the apps' 24,576 and 122,603, and 2.5M rows (beyond what one
    cluster's shared memory would hold); the counts' bound given (tight)
    or not."""
    from pumipic_torch.particles import structure as st

    g = torch.Generator(device=dev).manual_seed(E + chunk + sigma % 1000)
    counts = torch.randint(0, 600, (E,), generator=g, device=dev, dtype=torch.int32)
    counts[::7] = 0
    counts[1::5] = 300
    counts[E // 2] = 70_000
    padded = st._scs_pad_counts(counts, 0.15, "proportionally").to(torch.int32)
    num = int(padded.sum()) if bound == "tight" else None
    n0 = kernels.LAUNCHES["scs_row_order"]
    got = st._scs_row_order(counts, sigma, chunk, E, 0.15, "proportionally", num_ptcls=num)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scs_row_order"] == n0 + 1
    R = got[0].shape[0]
    _equal(got, _row_order_ref(padded, R, sigma, chunk))
    if E <= 200_000:
        cpu = st._scs_row_order(counts.cpu(), sigma, chunk, E, 0.15, "proportionally",
                                num_ptcls=num)
        for a, b in zip(got, cpu):
            assert torch.equal(a.cpu(), b)
    nwin = -(-R // min(sigma, R))
    bits = st._scs_key_bits(nwin, E, num if num is not None else 2**29, 0.15)
    _equal(got, rb.scs_row_order_plain(padded, R, sigma, chunk, bits))


@pytest.mark.parametrize("kind", ["equal", "zero", "wide", "above bits", "one"])
@pytest.mark.parametrize("chunk,sigma", [(8, 2**30), (3, 8), (4, 16)])
def test_scs_row_order_kernel_edge_counts(dev, kind, chunk, sigma):
    """Z on the counts its passes turn on, against torch's sort of the
    negated counts: all equal (no count bits: one pass of one bin), all
    zero, counts over the whole int32 range (three count passes), the
    one-window key's overflow (a few counts far above the mean), a single
    element; each one launch."""
    rng = np.random.default_rng(len(kind) * 10 + chunk)
    E = 5000 if kind != "one" else 1
    if kind == "equal":
        c = np.full(E, 77, np.int64)
    elif kind == "zero":
        c = np.zeros(E, np.int64)
    elif kind == "wide":
        c = rng.integers(0, 2**31 - 1, E)
    elif kind == "above bits":
        c = rng.integers(0, 40, E)
        c[rng.choice(E, 9, replace=False)] = rng.integers(5000, 9000, 9)
    else:
        c = np.array([12])
    counts = torch.as_tensor(c.astype(np.int32), device=dev)
    R = -(-E // chunk) * chunk
    n0 = kernels.LAUNCHES["scs_row_order"]
    got = rb.scs_row_order(counts, R, sigma, chunk, 30)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scs_row_order"] == n0 + 1
    _equal(got, _row_order_ref(counts, R, sigma, chunk))


def _movers(rng, n, E, kind, slots=12_660_000):
    """U1's mover list: n movers' slots ascending in [0, slots) and their
    destinations (at random, all one, runs of 40, or a slot's own element
    of a sorted layout plus a step of up to 3); the destinations' first
    places."""
    src = np.sort(rng.choice(slots, n, replace=False)).astype(np.int32)
    if kind == "one key":
        key = np.full(n, E // 3, np.int64)
    elif kind == "runs":
        key = np.repeat(rng.integers(0, E, n // 40 + 1), 40)[:n]
    elif kind == "near":
        key = np.clip(src.astype(np.int64) * E // slots + rng.integers(-3, 4, n), 0, E - 1)
    else:
        key = rng.integers(0, E, n)
    cnt = np.bincount(key, minlength=E)
    return (torch.as_tensor(key.astype(np.int32)), torch.as_tensor(src),
            torch.as_tensor((np.cumsum(cnt) - cnt).astype(np.int32)))


@pytest.mark.parametrize("n,E,kind", [(1, 24_576, "random"), (2, 24_576, "one key"),
                                      (341_820, 24_576, "near"), (341_820, 24_576, "random"),
                                      (677_000, 24_576, "near"),
                                      (1_354_620, 24_576, "near"), (1_582_500, 24_576, "random"),
                                      (341_820, 24_576, "one key"), (341_820, 24_576, "runs"),
                                      (341_820, 122_603, "near"), (341_820, 122_603, "random"),
                                      (50_000, 400_000, "random"), (60_000, 1_500_000, "random"),
                                      (5_000, 122_603, "one key")])
def test_reshuffle_order_kernel_equals_plain(dev, n, E, kind):
    """U3, one launch, against its plain version (kernel C's: the stable
    sort of the destinations with the slots as payload) on the card: n of
    1 and 2, 2.7%, 5.4% and 10.7% of pseudoPushAndSearch's 12.66M slots
    and its budget MB (1,582,500); destinations near the slot's element,
    at random, all one and in runs; the 16^3 box's 24,576 tets, 122,603,
    400,000 and 1,500,000 destinations (buckets of 128, 512, 2,048 and
    8,192 keys: the last beyond a warp's table, 4 key turns)."""
    rng = np.random.default_rng(n + E)
    key, src, starts = (t.to(dev) for t in _movers(rng, n, E, kind))
    n0 = kernels.LAUNCHES["reshuffle_order"]
    got = rb.reshuffle_order(key, src, starts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["reshuffle_order"] == n0 + 1
    assert torch.equal(got, rb.reshuffle_order_plain(key, src, starts))
    assert rb.reshuffle_order_turns(E) == -(-(1 << max((E - 1).bit_length() - 8, 0)) // 2048)
    again = rb.reshuffle_order(key, src, starts)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# Y1, Y2, Y3: the picparts step's route and the balancer's selection
# ---------------------------------------------------------------------------

def _route_slots(rng, n, E, dev):
    elem = np.where(rng.random(n) < 0.85, rng.integers(0, E, n), -1).astype(np.int32)
    return (torch.as_tensor(elem, device=dev),
            torch.as_tensor(rng.random(n) < 0.9, device=dev))


def _route_words(rng, E, R, S):
    safe = rng.random(E) < 0.6
    owner = rng.integers(0, R, E)
    sbar = np.where(rng.random(E) < 0.7, rng.integers(0, S, E), -1)
    return (((sbar + 2) * 2 + safe) * R + owner).astype(np.int64)


def _routed_equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 4097, 300_000])
@pytest.mark.parametrize("R", [1, 4, 7])
def test_route_packed_kernel_equals_plain(dev, R, n):
    from pumipic_torch.ops import route as rt

    rng = np.random.default_rng(R * 7 + n)
    E = 5000
    route = torch.as_tensor(_route_words(rng, E, R, 40).astype(np.float32), device=dev)
    elem, active = _route_slots(rng, n, E, dev)
    for me in sorted({0, R - 1}):
        n0 = kernels.LAUNCHES["route_packed"]
        got = rt.route_packed(route, elem, active, me, R)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["route_packed"] == n0 + 1
        _routed_equal(got, rt.route_packed_plain(route, elem, active, me, R))


@pytest.mark.parametrize("above_bound", [False, True])
@pytest.mark.parametrize("n", [4097, 300_000])
@pytest.mark.parametrize("R", [2, 7])
def test_route_g2l_kernel_equals_plain(dev, R, n, above_bound):
    from pumipic_torch.ops import route as rt

    rng = np.random.default_rng(R * 11 + n)
    E_g, E = 20_000, 6000
    words = _route_words(rng, E, R, 40)
    if above_bound:           # route words f32 rounds: the f32 decode, not the integer one
        words = rng.integers(2 ** 24, 2 ** 26, E)
    g2l = np.full(E_g, -1, np.int64)
    held = rng.choice(E_g, E, replace=False)
    g2l[held] = np.arange(E)
    tbl = np.zeros((E_g, 2), np.int32)
    tbl[:, 0] = g2l
    tbl[held, 1] = words[g2l[held]]
    tbl = torch.as_tensor(tbl, device=dev)
    e_gl, active = _route_slots(rng, n, E_g, dev)
    for me in sorted({0, R - 1}):
        for gelem in (True, False):
            n0 = kernels.LAUNCHES["route_g2l"]
            got = rt.route_g2l(tbl, e_gl, active, me, R, gelem)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["route_g2l"] == n0 + 1
            _routed_equal(got, rt.route_g2l_plain(tbl, e_gl, active, me, R, gelem))


@pytest.mark.parametrize("sbars", [True, False])
@pytest.mark.parametrize("R", [2, 4, 8])
def test_route_banded_kernel_equals_plain(dev, R, sbars):
    from pumipic_torch.ops import route as rt
    from pumipic_torch.parallel import balancer as lbm
    from pumipic_torch.parallel import banded_route as brm
    from pumipic_torch.parallel import picparts as ppm

    Nr, Ns = 5, 8 * R
    coords, tris, cls = annulus_mesh(Nr, Ns, 0.3, 1.0)
    owners = brm.sector_band_owners(Nr, Ns, R)
    pp = ppm.build_picparts(coords, tris, owners, R, ppm.PicPartsInput(), cls)
    ann = detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    br = brm.derive_banded_route(pp, owners, ann, lbm.build_balancer(pp, R) if sbars else None,
                                 R)
    assert br is not None and bool(br.sbar_runs) == sbars
    rng = np.random.default_rng(R)
    e_gl, active = _route_slots(rng, 200_000, 2 * Nr * Ns, dev)
    for me in range(R):
        n0 = kernels.LAUNCHES["route_banded"]
        got = rt.route_banded(br.params(me), e_gl, active)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["route_banded"] == n0 + 1
        _routed_equal(got, rt.route_banded_plain(br.params(me), e_gl, active))


def _balance_case(rng, n, R, S, me, dev):
    dest = np.where(rng.random(n) < 0.7, me, rng.integers(0, R, n)).astype(np.int32)
    live = rng.random(n) < 0.85
    sbar = np.where(live & (rng.random(n) < 0.75), rng.integers(0, S, n), -1).astype(np.int32)
    nc = live & (rng.random(n) < 0.3)
    return tuple(torch.as_tensor(a, device=dev) for a in (dest, sbar, live, nc))


@pytest.mark.parametrize("n", [1, 4097, 1_000_000])
@pytest.mark.parametrize("noncore", [True, False])
def test_balance_keys_kernel_equals_plain(dev, noncore, n):
    from pumipic_torch.ops import route as rt

    rng = np.random.default_rng(n)
    R, S = 4, 9
    for me in range(R):
        dest, sbar, live, nc = _balance_case(rng, n, R, S, me, dev)
        nc = nc if noncore else None
        n0 = kernels.LAUNCHES["balance_keys"]
        got = rt.balance_keys(dest, sbar, live, nc, me, S, R)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["balance_keys"] == n0 + 1
        _routed_equal(got, rt.balance_keys_plain(dest, sbar, live, nc, me, S, R))


@pytest.mark.parametrize("kind", ["mixed", "zero", "large"])
@pytest.mark.parametrize("noncore", [True, False])
def test_balance_select_kernel_equals_plain(dev, noncore, kind):
    from pumipic_torch.ops import route as rt
    from pumipic_torch.parallel import balancer as lbm

    members = ((0, 1, 2), (0, 3), (1, 2, 3), (0, 1, 2, 3))
    R, S = 4, len(members)
    edges = sorted([(s, a, b) for s, mem in enumerate(members) for a in mem for b in mem
                    if a != b], key=lambda e: (e[1], e[0]))
    per = [[i for i, e in enumerate(edges) if e[1] == r] for r in range(R)]
    my = np.full((R, max(map(len, per))), -1, np.int32)
    for r, idx in enumerate(per):
        my[r, :len(idx)] = idx
    e = np.asarray(edges, np.int32)
    bt = lbm.BalancerTables(np.zeros((R, 4), np.int32), e[:, 0], e[:, 1], e[:, 2], my, S,
                            len(edges))
    rng = np.random.default_rng(3)
    flows = {"zero": np.zeros(len(edges), np.int32),
             "large": rng.integers(500_000, 2_000_000, len(edges)).astype(np.int32),
             "mixed": np.where(rng.random(len(edges)) < 0.4, 0,
                               rng.integers(0, 60_000, len(edges))).astype(np.int32)}[kind]
    for me in range(R):
        dest, sbar, live, nc = _balance_case(rng, 1_000_000, R, S, me, dev)
        keys = rt.balance_keys(dest, sbar, live, nc if noncore else None, me, S, R)
        tabs = lbm._edge_intervals(bt, torch.as_tensor(flows), me, dev)
        rank, counts = ex.rank_in_key(keys.candidates, 2 * S if noncore else S)
        args = (keys.candidates, rank, counts, dest, *tabs, S, noncore)
        n0 = kernels.LAUNCHES["balance_select"]
        got = rt.balance_select(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["balance_select"] == n0 + 1
        want = rt.balance_select_plain(*args)
        assert torch.equal(got, want)
        if kind != "zero":
            assert bool((got != dest).any())


@pytest.mark.parametrize("max_iters", [100, 1, 0])
@pytest.mark.parametrize("n", [0, 1, 31, 65, 200_003])
def test_dense_walk_kernel_equals_plain(dev, mesh, n, max_iters):
    """Kernel L's dense plain walk (every slot written) on ring points
    around the vertices, far targets, NaN targets and starts out of range,
    with inactive slots, at sizes that leave partial tiles: equal to the
    plain version, one launch."""
    g = torch.Generator(device=dev).manual_seed(n + max_iters)
    px_, py_, start = (t.to(dev) for t in px.gyro_ring_points(mesh, px.GyroConfig()))
    reps = -(-n // px_.shape[0]) if n else 0
    dx, dy = px_.repeat(reps)[:n].clone(), py_.repeat(reps)[:n].clone()
    start = start.to(torch.int32).repeat(reps)[:n].clone()
    lo_, hi = mesh.coords.amin(0), mesh.coords.amax(0)
    far = torch.rand(n, 2, generator=g, device=dev) < 0.05
    rnd = lo_ + (hi - lo_) * torch.rand(n, 2, generator=g, device=dev)
    dx, dy = torch.where(far[:, 0], rnd[:, 0], dx), torch.where(far[:, 0], rnd[:, 1], dy)
    dx[3:9] = float("nan")
    bad = torch.rand(n, generator=g, device=dev) < 0.02
    start = torch.where(bad, torch.randint(-5, mesh.nelems + 5, (n,), generator=g, device=dev,
                                           dtype=torch.int32), start)
    active = torch.rand(n, generator=g, device=dev) < 0.9
    args = (mesh.walk_geom, dx, dy, start, active, max_iters)
    n0 = kernels.LAUNCHES["locate"]
    got = se.walk_locate(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["locate"] == n0 + 1
    _equal(got, se.walk_locate_plain(*args))


def _count_case(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(n, generator=g, device=dev) < 0.7
    b = torch.rand(n, generator=g, device=dev) < 0.2
    e = torch.randint(-3, 50, (n,), generator=g, device=dev, dtype=torch.int32)
    f = torch.randint(-1, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    return a, b, e, f


@pytest.mark.parametrize("n", [0, 1, 257, 1_000_003])
def test_slot_counts_kernel_equals_plain(dev, n):
    """Kernel N: up to four counts of up to three terms each, of their own
    lengths, less a device count where given; called again (its
    accumulators set back to 0) and replayed from a CUDA graph."""
    from pumipic_torch.ops import counts as cn

    a, b, e, f = _count_case(dev, n, n)
    m = n // 2
    a2, _, e2, _ = _count_case(dev, m, n + 1)
    sub = torch.tensor(7, dtype=torch.int32, device=dev)
    cases = [
        ([[("set", a)]], None),
        ([[("clear", a)], [("set", a), ("neg", e)]], None),
        ([[("set", a), ("neg", e), ("nonneg", f)], [("set", a), ("neg", e), ("neg", f)],
          [("set", b)], [("set", a2), ("nonneg", e2)]], [None, sub, None, sub]),
        # terms not 16-byte aligned: the slots one by one
        ([[("set", a[1:]), ("neg", e[1:])], [("clear", b[3:])]], None),
    ]
    for counts, subs in cases:
        want = cn.slot_counts_plain(counts, subs or [None] * len(counts))
        for _ in range(2):
            n0 = kernels.LAUNCHES["slot_counts"]
            got = cn.slot_counts(counts, subs)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["slot_counts"] == n0 + 1
            assert torch.equal(got, want)
    counts, subs = cases[2]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cn.slot_counts(counts, subs)
    for _ in range(3):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cn.slot_counts_plain(counts, subs))


@pytest.mark.parametrize("R", [1, 2, 4, 7])
def test_rank_stats_kernel_equals_plain(dev, R):
    """Kernel N's reduction over the ranks: the int32 column sums, the
    max of one column and the f32 imbalance (totals below and above 2^24,
    and no particle at all)."""
    from pumipic_torch.ops import counts as cn

    g = torch.Generator(device=dev).manual_seed(R)
    for hi in (0, 1, 1000, 9_000_000, 2**30):
        gat = torch.randint(0, hi + 1, (R, 8), generator=g, device=dev, dtype=torch.int32)
        gat[:, 3] = torch.randint(0, 2, (R,), generator=g, device=dev, dtype=torch.int32)
        n0 = kernels.LAUNCHES["slot_counts"]
        got = cn.rank_stats(gat, 3)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["slot_counts"] == n0 + 1
        assert torch.equal(got, cn.rank_stats_plain(gat, 3))


@pytest.mark.parametrize("cpe", [16.0, 4.0])
def test_locator_grid_built_on_the_card_equals_host_build(dev, mesh, cpe):
    """The cartesian grid built on the card (its flood fill and its cell
    rows' calibration walk as torch ops there) equals the host build (the
    flood fill on the CPU, the numpy walk) bit for bit."""
    args = (mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy())
    got = build_locator_grid(*args, cells_per_elem=cpe, walk_geom=mesh.walk_geom, device=dev)
    want = build_locator_grid(*args, cells_per_elem=cpe, walk_geom=mesh.walk_geom.cpu(),
                              device="cpu")
    assert got.cell_elem.device.type == "cuda"
    assert torch.equal(got.cell_elem.cpu(), want.cell_elem)
    assert torch.equal(got.cell_rows.cpu(), want.cell_rows)


@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("max_iters", [64, 2, 0])
def test_walk_locate_counted_counts_the_limit(dev, mesh, peel, max_iters):
    """Kernel L's count of the walkers deleted at the limit (the dense walk
    and the peel form) equals the plain batch walk's, its other outputs
    equal ``walk_locate``'s, and ``walk_locate``'s all_found is the count's
    zero test."""
    g = torch.Generator(device=dev).manual_seed(max_iters)
    px_, py_, start = (t.to(dev) for t in px.gyro_ring_points(mesh, px.GyroConfig()))
    lo_, hi = mesh.coords.amin(0), mesh.coords.amax(0)
    far = lo_ + (hi - lo_) * torch.rand(px_.shape[0], 2, generator=g, device=dev)
    dx, dy = far[:, 0].contiguous(), far[:, 1].contiguous()
    active = torch.rand(px_.shape[0], generator=g, device=dev) < 0.9
    grid = (build_locator_grid(mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy(),
                               walk_geom=mesh.walk_geom, device=dev) if peel else None)
    args = (mesh.walk_geom, dx, dy, start.to(torch.int32), active, max_iters)
    got = se.walk_locate_counted(*args, grid=grid)
    elem, iters, unfinished = se._walk_batch(*args, grid)
    assert torch.equal(got[0], elem) and int(got[2]) == iters
    assert int(got[3]) == unfinished
    assert bool(se.walk_locate(*args, grid=grid)[3]) == (unfinished == 0)
    if max_iters == 2:
        assert unfinished > 0
