"""Parity of the port's mesh layer (pumipic_torch.mesh) with the JAX
reference: gmsh reader, generators, adjacency, Mesh2D tables and the
locator grid.  Tables are compared bit for bit."""
import os

import numpy as np
import pytest
import torch

from pumipic_tpu.mesh import adjacency as j_adj
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.mesh.gmsh import read_msh as j_read_msh
from pumipic_torch import interop
from pumipic_torch.mesh import adjacency as t_adj
from pumipic_torch.mesh import generate as t_gen
from pumipic_torch.mesh import locator as t_loc
from pumipic_torch.mesh.core import Mesh2D, check_f32_ids
from pumipic_torch.mesh.gmsh import read_msh

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
MESH_24K = os.path.join(DATA, "xgc_like_24k.msh.gz")


@pytest.fixture(scope="module")
def meshes():
    """(coords, tris, cls) of the two test meshes: the 2,513-triangle
    tokamak_mesh(16, 96) and the 24k gmsh import."""
    return {"tokamak": t_gen.tokamak_mesh(16, 96), "24k": read_msh(MESH_24K)}


def test_read_msh_matches_reference():
    ref = j_read_msh(MESH_24K)
    got = read_msh(MESH_24K)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("gen", ["tokamak", "annulus"])
def test_generators_match_reference(gen):
    if gen == "tokamak":
        ref, got = j_gen.tokamak_mesh(16, 96), t_gen.tokamak_mesh(16, 96)
    else:
        ref, got = j_gen.annulus_mesh(6, 40, 0.3, 1.0), t_gen.annulus_mesh(6, 40, 0.3, 1.0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["tokamak", "24k"])
def test_adjacency_matches_reference(meshes, name):
    coords, tris, _ = meshes[name]
    ref = j_adj.build_tri_adjacency(coords, tris)
    got = t_adj.build_tri_adjacency(coords, tris)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


@pytest.mark.parametrize("name", ["tokamak", "24k"])
def test_mesh2d_tables_bit_equal(meshes, name):
    """Every carried Mesh2D field, walk_geom included, equals the JAX one
    bit for bit and in dtype."""
    coords, tris, cls = meshes[name]
    ref = JMesh2D.from_arrays(coords, tris, cls)
    got = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    for f in interop.MESH_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.nelems, got.nverts, got.nedges) == (ref.nelems, ref.nverts, ref.nedges)
    assert got.walk_geom.dtype == torch.float32 and got.walk_geom.shape[1] == 12


def test_f32_id_guard():
    check_f32_ids((1 << 24) - 1, 10)
    with pytest.raises(ValueError, match="2\\^24"):
        check_f32_ids(1 << 24, 10)
    with pytest.raises(ValueError, match="2\\^24"):
        check_f32_ids(10, 1 << 24)


@pytest.mark.parametrize("name,cpe", [("tokamak", 16.0), ("24k", 4.0)])
def test_locator_tables_bit_equal(meshes, name, cpe):
    coords, tris, cls = meshes[name]
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    ref = j_loc.build_locator_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                   cells_per_elem=cpe, walk_geom=jm.walk_geom,
                                   peel="rows")
    got = t_loc.build_locator_grid(m.coords.numpy(), m.elem2verts.numpy(),
                                   cells_per_elem=cpe, walk_geom=m.walk_geom,
                                   peel="rows", device="cpu")
    assert not ref.polar
    assert (got.nx, got.ny) == (int(ref.nx), int(ref.ny))
    assert got.origin == tuple(float(v) for v in np.asarray(ref.origin))
    assert got.inv_h == tuple(float(v) for v in np.asarray(ref.inv_h))
    np.testing.assert_array_equal(np.asarray(ref.cell_elem), got.cell_elem.numpy())
    rows_ref = np.asarray(ref.cell_rows)
    assert rows_ref.dtype == got.cell_rows.numpy().dtype
    np.testing.assert_array_equal(rows_ref, got.cell_rows.numpy())
    # cell ids of random points agree too
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, size=(4000, 2)).astype(np.float32)
    c_ref = np.asarray(ref.cell_of((pts[:, 0], pts[:, 1])))
    c_got = got.cell_of(torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]))
    np.testing.assert_array_equal(c_ref, c_got.numpy())


def test_locator_knobs(meshes):
    coords, tris, cls = meshes["tokamak"]
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    args = (m.coords.numpy(), m.elem2verts.numpy())
    rows = t_loc.build_locator_grid(*args, walk_geom=m.walk_geom, peel="rows", device="cpu")
    for peel in ("auto", "lines", "rows_split", "rows_ab"):
        g = t_loc.build_locator_grid(*args, walk_geom=m.walk_geom, peel=peel, device="cpu")
        assert torch.equal(g.cell_rows, rows.cell_rows), peel
    for peel in ("rows_abc", "ids", "bogus"):
        with pytest.raises(ValueError):
            t_loc.build_locator_grid(*args, walk_geom=m.walk_geom, peel=peel, device="cpu")
    with pytest.raises(NotImplementedError):
        t_loc.build_locator_grid(*args, polar=True, device="cpu")
    with pytest.raises(NotImplementedError):
        t_loc.build_locator_grid(*args, walk_geom=m.walk_geom,
                                 aux=np.zeros((m.nelems, 2), np.float32), device="cpu")


@pytest.mark.parametrize("case", ["identity", "permuted", "tokamak"])
def test_detect_annulus_structured_matches_reference(case):
    coords, tris, cls = j_gen.annulus_mesh(5, 24, 0.3, 1.0)
    if case == "permuted":
        rng = np.random.default_rng(11)
        vp = rng.permutation(coords.shape[0])
        inv = np.empty_like(vp)
        inv[vp] = np.arange(vp.size)
        ep = rng.permutation(tris.shape[0])
        coords, tris, cls = coords[vp], inv[tris][ep], cls[ep]
    elif case == "tokamak":
        coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    ref = j_loc.detect_annulus_structured(coords, tris, cls=cls)
    got = t_loc.detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    if case == "tokamak":
        assert ref is None and got is None
        return
    assert got is not None
    assert (got.n_rings, got.n_sectors, got.ring_class) == (
        ref.n_rings, ref.n_sectors, ref.ring_class)
    if case == "permuted":
        np.testing.assert_array_equal(np.asarray(ref.perm), got.perm)
        assert np.float32(got.theta0) == np.asarray(ref.theta0)
    else:
        assert ref.perm is None and got.perm is None
