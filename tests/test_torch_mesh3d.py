"""Parity of the port's tet-mesh modules with the JAX reference: the mesh
(``Mesh3D``, ``build_tet_adjacency``, ``box_tet_mesh``), mesh tags, the
structured Kuhn-box detector and kernel K's plain version (push, wrap and
analytic locate), the 3D locator grid and the interop converters.

Tolerances: none.  Every array, id, count and table is compared for
equality (``walk_geom`` and ``walk_planes`` bit for bit), and K's pushed
positions are equal: both sides round the same f32 operations in the same
order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import adjacency as j_adj
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh3D as JMesh3D
from pumipic_tpu.ops import push as j_push
from pumipic_tpu.ops import search as j_se
from pumipic_torch import interop
from pumipic_torch.mesh import adjacency as t_adj
from pumipic_torch.mesh import generate as t_gen
from pumipic_torch.mesh import locator as t_loc
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.ops import locate as t_lo
from pumipic_torch.ops import push as t_push


def _jelly(nx, ny, nz, seed=0):
    """A box mesh whose interior vertices are jittered: not a Kuhn box."""
    coords, tets = j_gen.box_tet_mesh(nx, ny, nz)
    rng = np.random.default_rng(seed)
    inner = np.all((coords > 1e-9) & (coords < 1 - 1e-9), axis=1)
    coords = coords.copy()
    coords[inner] += rng.uniform(-0.1, 0.1, (inner.sum(), 3)) / max(nx, ny, nz)
    return coords, tets


def _permuted(nx, ny, nz, seed=1):
    """The Kuhn box with shuffled vertex and element order (an import)."""
    coords, tets = j_gen.box_tet_mesh(nx, ny, nz)
    rng = np.random.default_rng(seed)
    pv = rng.permutation(coords.shape[0])
    inv = np.empty_like(pv)
    inv[pv] = np.arange(pv.size)
    return coords[pv], inv[tets][rng.permutation(tets.shape[0])]


MESHES = {
    "box 3": lambda: j_gen.box_tet_mesh(3, 3, 3),
    "box 2x3x5": lambda: j_gen.box_tet_mesh(2, 3, 5, 1.0, 2.0, 0.5),
    "permuted box 4": lambda: _permuted(4, 4, 4),
    "jittered box 4": lambda: _jelly(4, 4, 4),
}


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 4, 5), (5, 5, 5)])
def test_box_tet_mesh_matches_reference(shape):
    jc, jt = j_gen.box_tet_mesh(*shape, 1.0, 2.0, 3.0)
    tc, tt = t_gen.box_tet_mesh(*shape, 1.0, 2.0, 3.0)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tt, jt)
    assert tt.dtype == jt.dtype


@pytest.mark.parametrize("name", list(MESHES))
def test_tet_adjacency_matches_reference(name):
    coords, tets = MESHES[name]()
    want = j_adj.build_tet_adjacency(coords, tets)
    got = t_adj.build_tet_adjacency(coords, tets)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(t_adj.TET_FACE_VERTS, j_adj.TET_FACE_VERTS)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh3d_matches_reference(name):
    coords, tets = MESHES[name]()
    cls = np.arange(tets.shape[0]) % 3 + 1
    jm = JMesh3D.from_arrays(coords, tets, cls)
    tm = Mesh3D.from_arrays(coords, tets, cls, device="cpu")
    for f in interop.MESH3D_FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in ("walk_geom", "walk_planes"):
            np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32), err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert (tm.nelems, tm.nverts, tm.nfaces) == (jm.nelems, jm.nverts, jm.nfaces)
    assert tm.dim == 3 and tm.device.type == "cpu"
    np.testing.assert_allclose(tm.elem_centroids.numpy(), np.asarray(jm.elem_centroids),
                               rtol=0, atol=1e-6)
    # the converter carries the reference's arrays across unchanged
    cm = interop.mesh3d_from_numpy({f: np.asarray(getattr(jm, f))
                                    for f in interop.MESH3D_FIELDS}, device="cpu")
    for f in interop.MESH3D_FIELDS:
        assert torch.equal(getattr(cm, f), getattr(tm, f)), f


@pytest.mark.parametrize("dim", [2, 3])
def test_mesh_tags(dim):
    if dim == 2:
        m = Mesh2D.from_arrays(*t_gen.annulus_mesh(2, 8, 0.5, 1.0), device="cpu")
    else:
        m = Mesh3D.from_arrays(*t_gen.box_tet_mesh(2, 2, 2), device="cpu")
    e = torch.arange(m.nelems, dtype=torch.float32)
    v = torch.ones(m.nverts)
    m2 = m.set_tag(dim, "weight", e).set_tag(0, "charge", v)
    assert torch.equal(m2.get_tag(dim, "weight"), e)
    assert torch.equal(m2.get_tag(0, "charge"), v)
    assert m.elem_tags == {} and m.vert_tags == {}      # the original is unchanged
    with pytest.raises(KeyError):
        m2.get_tag(dim, "charge")
    moved = m2.to("cpu")
    assert torch.equal(moved.get_tag(dim, "weight"), e)


def test_mesh3d_refuses_degenerate_tets():
    coords = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float)
    with pytest.raises(ValueError, match="degenerate"):
        Mesh3D.from_arrays(coords, np.array([[0, 1, 2, 3]]), device="cpu")


# ---------------------------------------------------------------------------
# the Kuhn-box detector and kernel K
# ---------------------------------------------------------------------------

def _detect_pair(name):
    coords, tets = MESHES[name]()
    jm = JMesh3D.from_arrays(coords, tets)
    tm = Mesh3D.from_arrays(coords, tets, device="cpu")
    jk = j_loc.detect_box_kuhn(np.asarray(jm.coords), np.asarray(jm.elem2verts))
    tk = t_loc.detect_box_kuhn(tm.coords.numpy(), tm.elem2verts.numpy(), device="cpu")
    return jm, tm, jk, tk


@pytest.mark.parametrize("name", list(MESHES))
def test_detect_box_kuhn_matches_reference(name):
    jm, tm, jk, tk = _detect_pair(name)
    assert (jk is None) == (tk is None) == name.startswith("jittered")
    if jk is None:
        return
    assert tk.origin == tuple(float(v) for v in np.asarray(jk.origin))
    assert tk.inv_h == tuple(float(v) for v in np.asarray(jk.inv_h))
    assert (tk.nx, tk.ny, tk.nz) == (jk.nx, jk.ny, jk.nz)
    assert (tk.perm is None) == (jk.perm is None) == (not name.startswith("permuted"))
    if jk.perm is not None:
        np.testing.assert_array_equal(tk.perm.numpy(), np.asarray(jk.perm))
    conv = interop.kuhn_from_numpy(
        {f: getattr(jk, f) for f in interop.KUHN_FIELDS}, device="cpu")
    assert conv.origin == tk.origin and conv.inv_h == tk.inv_h
    assert (conv.perm is None) == (tk.perm is None)


def test_detect_box_kuhn_rejects_other_meshes():
    coords, tris, _ = t_gen.annulus_mesh(2, 8, 0.5, 1.0)
    assert t_loc.detect_box_kuhn(coords, tris, device="cpu") is None
    coords, tets = t_gen.box_tet_mesh(2, 2, 2)
    assert t_loc.detect_box_kuhn(coords, tets[:-1], device="cpu") is None
    assert t_loc.detect_box_kuhn(coords[:, :2], tets, device="cpu") is None


def _points(n, seed, lo=-0.15, hi=1.15):
    """Random points in and around the unit box, with some on exact cell
    faces, edges and corners of a 4-cell lattice."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, hi, (n, 3))
    k = n // 4
    p[:k] = rng.integers(0, 5, (k, 3)) / 4.0
    p[k:2 * k, 0] = p[k:2 * k, 1]              # on the fx = fy diagonal face
    return p.astype(np.float32)


@pytest.mark.parametrize("name", ["box 3", "box 2x3x5", "permuted box 4"])
def test_kuhn_locate_plain_matches_reference(name):
    jm, tm, jk, tk = _detect_pair(name)
    p = _points(20_000, 3) * np.array([1.0, 2.0, 0.5] if "2x3x5" in name else 1.0,
                                      np.float32)
    je, ji = jk.locate(jnp.asarray(p))
    te, ti = tk.locate(*torch.from_numpy(p).unbind(1))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert 0 < int((te < 0).sum()) < p.shape[0]


@pytest.mark.parametrize("wall", ["remove", "periodic"])
@pytest.mark.parametrize("name", ["box 3", "permuted box 4"])
def test_kuhn_push_locate_matches_reference_step(wall, name):
    """Kernel K's plain version = the JAX step's straight_line_push, wrap,
    KuhnLocator3D.locate and active mask (pseudo_push_and_search.py:193-207)."""
    jm, tm, jk, tk = _detect_pair(name)
    rng = np.random.default_rng(4)
    n = 12_000
    x = _points(n, 5, 0.0, 1.0)
    active = rng.uniform(size=n) < 0.85
    d = np.array([1.0, 2.0, -0.5])
    d = (d / np.linalg.norm(d)).astype(np.float32)
    coords = np.asarray(jm.coords)
    lo = coords.min(axis=0)
    ext = coords.max(axis=0) - coords.min(axis=0)
    xt = j_push.straight_line_push(jnp.asarray(x), jnp.asarray(d), 0.3)
    if wall == "periodic":
        xt = (xt - jnp.asarray(lo)) % jnp.asarray(ext) + jnp.asarray(lo)
    e, _ = jk.locate((xt[:, 0], xt[:, 1], xt[:, 2]))
    want_e = np.asarray(jnp.where(jnp.asarray(active), e, j_se.INVALID))
    xn, got_e = t_lo.kuhn_push_locate(
        tk, torch.from_numpy(x), torch.from_numpy(active),
        t_push.step_vector(d, 0.3), (lo, ext) if wall == "periodic" else None)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(xt))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert got_e.dtype == torch.int32
    if wall == "periodic":
        assert bool((got_e[torch.from_numpy(active)] >= 0).all())
    else:
        assert int((got_e[torch.from_numpy(active)] < 0).sum()) > 0


# ---------------------------------------------------------------------------
# the 3D locator grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cpe", [2.0, 16.0])
@pytest.mark.parametrize("name", ["box 3", "jittered box 4"])
def test_locator_grid_3d_matches_reference(name, cpe):
    coords, tets = MESHES[name]()
    jm = JMesh3D.from_arrays(coords, tets)
    tm = Mesh3D.from_arrays(coords, tets, device="cpu")
    jg = j_loc.build_locator_grid_3d(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                     cells_per_elem=cpe, walk_geom=jm.walk_geom,
                                     peel="rows")
    tg = t_loc.build_locator_grid_3d(tm.coords.numpy(), tm.elem2verts.numpy(),
                                     cells_per_elem=cpe, walk_geom=tm.walk_geom,
                                     device="cpu")
    assert (tg.nx, tg.ny, tg.nz) == (jg.nx, jg.ny, jg.nz)
    assert tg.origin == tuple(float(v) for v in np.asarray(jg.origin))
    assert tg.inv_h == tuple(float(v) for v in np.asarray(jg.inv_h))
    np.testing.assert_array_equal(tg.cell_elem.numpy(), np.asarray(jg.cell_elem))
    assert tg.cell_rows.shape == (tg.nx * tg.ny * tg.nz, 26)
    np.testing.assert_array_equal(tg.cell_rows.numpy().view(np.int32),
                                  np.asarray(jg.cell_rows).view(np.int32))
    p = _points(5000, 6)
    want = np.asarray(jg.cell_of(jnp.asarray(p)))
    got = tg.cell_of(*torch.from_numpy(p).unbind(1))
    np.testing.assert_array_equal(got.numpy(), want)
    conv = interop.locator3d_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in interop.LOCATOR3D_FIELDS}, device="cpu")
    assert torch.equal(conv.cell_rows, tg.cell_rows) and conv.origin == tg.origin


@pytest.mark.parametrize("peel", ["auto", "lines", "rows_split", "rows_ab",
                                  "rows_abc", "ids", "ids4"])
def test_locator_grid_3d_peels_map_onto_rows(peel):
    coords, tets = MESHES["box 3"]()
    tm = Mesh3D.from_arrays(coords, tets, device="cpu")
    args = (tm.coords.numpy(), tm.elem2verts.numpy())
    rows = t_loc.build_locator_grid_3d(*args, cells_per_elem=8.0, walk_geom=tm.walk_geom,
                                       peel="rows", device="cpu")
    got = t_loc.build_locator_grid_3d(*args, cells_per_elem=8.0, walk_geom=tm.walk_geom,
                                      peel=peel, device="cpu")
    assert torch.equal(got.cell_rows, rows.cell_rows)


def test_locator_grid_3d_refuses_an_unknown_peel():
    coords, tets = MESHES["box 3"]()
    with pytest.raises(ValueError, match="unknown peel"):
        t_loc.build_locator_grid_3d(coords, tets, peel="bogus", device="cpu")
