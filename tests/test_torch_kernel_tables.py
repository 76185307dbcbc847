"""The derived tables kernels R and M read in place of what they replace,
held bit for bit against it on the CPU: R's cell-major corner rows of the E
grid and its per-launch coefficient, M's per-face reflect normals; and the
search result's (N, 3) views of M's own outputs.

Every comparison is exact: each table is a copy, or is formed with the
same f32 operations in the same order as the plain version it stands in
for."""
import numpy as np
import pytest
import torch

from pumipic_torch.mesh.core import Mesh3D
from pumipic_torch.mesh.generate import box_tet_mesh
from pumipic_torch.ops import interpolate as t_interp
from pumipic_torch.ops import push as t_push
from pumipic_torch.ops import search as t_se
from pumipic_torch.ops.geometry import sqrt_rn


@pytest.mark.parametrize("shape", [(2, 2, 2), (5, 6, 7), (9, 8, 3)])
def test_grid_corner_rows_hold_each_cells_corners(shape):
    """Row (i·(ny-1) + j)·(nz-1) + k holds corner m = 4·di + 2·dj + dk of
    cell (i, j, k) at floats 3m .. 3m+2, then 8 zeros."""
    rng = np.random.default_rng(sum(shape))
    grid = torch.as_tensor(rng.normal(0, 0.2, (*shape, 3)).astype(np.float32))
    rows = t_push.grid_corner_rows(grid)
    nx, ny, nz = shape
    assert rows.shape == ((nx - 1) * (ny - 1) * (nz - 1), 32) and rows.is_contiguous()
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                row = rows[(i * (ny - 1) + j) * (nz - 1) + k]
                for m in range(8):
                    di, dj, dk = m >> 2, (m >> 1) & 1, m & 1
                    assert torch.equal(row[3 * m:3 * m + 3], grid[i + di, j + dj, k + dk])
                assert torch.equal(row[24:], torch.zeros(8))


def test_corner_rows_sum_equals_interpolate_3d_grid():
    """The trilinear sum kernel R takes off a cell's row (corners in row
    order, each weight a left-to-right product, summed from 0.0) equals
    interpolate_3d_grid bit for bit, points outside the grid included."""
    rng = np.random.default_rng(3)
    grid = torch.as_tensor(rng.normal(0, 0.2, (5, 6, 7, 3)).astype(np.float32))
    o = torch.zeros(3)
    h = torch.as_tensor(np.array([0.25, 0.2, 1 / 6], np.float32))
    x = torch.as_tensor(rng.uniform(-0.1, 1.1, (4000, 3)).astype(np.float32))
    rows = t_push.grid_corner_rows(grid)
    rel = (x - o) / h
    n = torch.tensor(grid.shape[:3])
    idx = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int64), min=0), n - 2)
    f = torch.clamp(rel - idx.to(torch.float32), 0.0, 1.0)
    cell = (idx[:, 0] * (n[1] - 1) + idx[:, 1]) * (n[2] - 1) + idx[:, 2]
    g = rows[cell]
    e = torch.zeros_like(x)
    for m in range(8):
        di, dj, dk = m >> 2, (m >> 1) & 1, m & 1
        w = ((f[:, 0] if di else 1.0 - f[:, 0]) * (f[:, 1] if dj else 1.0 - f[:, 1])
             * (f[:, 2] if dk else 1.0 - f[:, 2]))
        e = e + g[:, 3 * m:3 * m + 3] * w[:, None]
    assert torch.equal(e, t_interp.interpolate_3d_grid(grid, o, h, x))


@pytest.mark.parametrize("b", [(0.0, 0.0, 1.3e-3), (0.3, -0.2, 0.5), (0.0, 0.0, 0.0),
                               (1e-20, 3e4, -7.5)])
@pytest.mark.parametrize("dt", [2e-5, 1e-8, 3.3e-7])
def test_boris_coeff_equals_the_plain_versions(b, dt):
    """The host's 2q'/(1 + (q'|B|)²) in numpy f32 scalars equals what
    boris_push computes per particle in f32 tensors."""
    qp, two_qp = t_push.boris_factors(dt, 1.0, 10.0)
    bt = torch.tensor([b], dtype=torch.float32)
    b_mag = sqrt_rn(bt[:, 0] * bt[:, 0] + bt[:, 1] * bt[:, 1] + bt[:, 2] * bt[:, 2])
    s = torch.tensor(qp) * b_mag
    want = torch.tensor(two_qp) / (1.0 + s * s)
    got = t_push.boris_coeff(np.asarray(b, np.float32), qp, two_qp)
    assert torch.equal(torch.tensor([got], dtype=torch.float32), want)


def _jittered_box(seed=7):
    coords, tets = box_tet_mesh(3, 3, 3)
    rng = np.random.default_rng(seed)
    inner = np.all((coords > 1e-9) & (coords < 1 - 1e-9), axis=1)
    coords = coords.copy()
    coords[inner] += rng.uniform(-0.1, 0.1, (int(inner.sum()), 3))
    return Mesh3D.from_arrays(coords, tets, device="cpu")


@pytest.mark.parametrize("jitter", [False, True])
def test_reflect_normals_mirror_equals_reflect_on_exit_3d(jitter):
    """Kernel M mirrors a destination through a face's table row as
    s = (d - a)·n, d - 2·s·n; over every face, for random destinations,
    that equals reflect_on_exit_3d bit for bit."""
    m = _jittered_box() if jitter else Mesh3D.from_arrays(*box_tet_mesh(3, 3, 3),
                                                          device="cpu")
    table = t_se.reflect_normals(m)
    assert table.shape == (m.nfaces, 8) and table.dtype == torch.float32
    assert torch.equal(table[:, 3], torch.zeros(m.nfaces))
    assert torch.equal(table[:, 7], torch.zeros(m.nfaces))
    rng = np.random.default_rng(1)
    side = torch.arange(m.nfaces, dtype=torch.int32).repeat(3)
    d = torch.as_tensor(rng.uniform(-0.5, 1.5, (side.shape[0], 3)).astype(np.float32))
    want = t_se.reflect_on_exit_3d(t_se.BoundaryCtx(
        torch.zeros_like(side), side, None, tuple(d.unbind(1)), m)).dest
    r = table[side.long()]
    s = (d[:, 0] - r[:, 4]) * r[:, 0] + (d[:, 1] - r[:, 5]) * r[:, 1] + \
        (d[:, 2] - r[:, 6]) * r[:, 2]
    got = [d[:, c] - 2.0 * s * r[:, c] for c in range(3)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_reflect_normals_kept_per_mesh_and_rebuilt_after_a_write():
    m = Mesh3D.from_arrays(*box_tet_mesh(2, 2, 2), device="cpu")
    t1 = t_se.reflect_normals(m)
    assert t_se.reflect_normals(m) is t1
    other = _jittered_box()
    t2 = t_se.reflect_normals(other)
    assert t_se.reflect_normals(m) is t1 and t_se.reflect_normals(other) is t2
    m.coords.mul_(2.0)                     # written in place: built again
    t3 = t_se.reflect_normals(m)
    assert t3 is not t1 and torch.equal(t3[:, 4:7], 2.0 * t1[:, 4:7])


def test_search_result_joins_its_own_rows_without_a_copy():
    """dest and hit give back the (N, 3) tensor their components were split
    from (M's outputs), and a stack of anything else."""
    rows = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    res = t_se.SearchResult(torch.zeros(4, dtype=torch.int32), tuple(rows.unbind(1)),
                            torch.tensor(1), torch.tensor(True), hit_c=tuple(rows.unbind(1)))
    for joined in (res.dest, res.hit):
        assert joined.data_ptr() == rows.data_ptr() and torch.equal(joined, rows)
    parts = tuple(c.clone() for c in rows.unbind(1))
    for comps in (parts, tuple(rows.unbind(1))[::-1],
                  tuple(torch.arange(15.0).reshape(5, 3)[:4].unbind(1)),
                  tuple(rows.t().contiguous().t().unbind(1))):
        out = t_se.SearchResult(rows[:, 0], comps, torch.tensor(1), torch.tensor(True)).dest
        assert torch.equal(out, torch.stack(comps, 1))
    assert t_se.SearchResult(rows[:, 0], parts, torch.tensor(1), torch.tensor(True)).hit is None
