"""Parity of the port at production mesh size (the ~1M-element tokamak
mesh) with the JAX reference, on the CPU.

- The port's ``tokamak_mesh(340, 1750)`` (981,178 triangles) equals the JAX
  package's bit for bit and its ids stay exact as f32; both packages'
  flux-band locator refuses it (its radius model's residual gate);
  ``bench_torch``'s
  production mesh file is written once, reused, and read back through
  ``read_msh`` equal to the generator's arrays.
- The locator calibration walk's device form (``_device_walk``: torch f64
  ops, here on the CPU) equals the host walk (``_host_walk``, numpy) on a
  sample set of the 120k mesh, and the grid tables it gives equal the JAX
  package's ``build_locator_grid``; so does the grid's flood fill as torch
  ops (``_flood_fill``) on the 120k mesh's cells.
- The plain versions at the 1M widths against the JAX functions on the same
  numpy inputs from a seed: kernel C's stable key sort on keys in
  [0, 981,178], kernel Z's row order on 981,178 counts (``_scs_row_order``)
  and kernel H's counts into 981,178 keys (``count_per_key_matmul``).
- The locator-less FULL-mode step on a fine small tokamak, whose walks
  reach the 64-iteration limit, deletes the same walkers as the JAX
  reference, and its count of them is those walkers.

Tolerance: none.  Every compared output is an integer, a mask, an f32
table or a deposit of multiples of 1/8, and must be equal."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.ops import push as j_push
from pumipic_tpu.ops import scatter as j_sc
from pumipic_tpu.ops import search as j_se
from pumipic_tpu.parallel.mesh_axis import make_device_mesh
from pumipic_tpu.particles import structure as JS
from pumipic_torch import interop
from pumipic_torch.mesh import adjacency as t_adj
from pumipic_torch.mesh import generate as t_gen
from pumipic_torch.mesh import locator as t_loc
from pumipic_torch.mesh.core import Mesh2D, check_f32_ids
from pumipic_torch.mesh.gmsh import read_msh
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.ops import rebuild as rb
from pumipic_torch.ops import scatter as t_sc
from pumipic_torch.particles import structure as TS

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

DATA = os.path.join(REPO, "data")
E_1M = 981_178           # tokamak_mesh(340, 1750)'s triangles


def test_production_tokamak_equals_reference():
    """``tokamak_mesh(340, 1750)``: coords, triangles and classes equal
    the JAX package's bit for bit; 981,178 triangles and 491,770 vertices,
    element and edge ids below 2^24."""
    got = t_gen.tokamak_mesh(*bench_torch.PRODUCTION_SHAPE)
    ref = j_gen.tokamak_mesh(340, 1750)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    coords, tris, _ = got
    assert tris.shape == (E_1M, 3) and coords.shape[0] == 491_770
    check_f32_ids(tris.shape[0], t_adj.build_tri_adjacency(coords, tris)["edge2verts"].shape[0])


def test_band_locator_refuses_the_production_mesh_in_both_packages():
    """The flux-band locator's radius model (24 harmonics, 12 Chebyshev
    terms, rank 8) misses the 1M mesh's 340 rings by more than the
    residual gate allows (a quarter of the local ring spacing), so
    ``detect_banded_locator`` gives None in the port and in the JAX
    package alike: ``band_locator="force"`` refuses the mesh; the test
    band mesh's 24 rings pass."""
    coords, tris, cls = t_gen.tokamak_mesh(*bench_torch.PRODUCTION_SHAPE)
    geom = np.zeros((tris.shape[0], 12), np.float32)      # read after the gate
    assert t_loc.detect_banded_locator(coords, tris, cls, geom, device="cpu") is None
    assert j_loc.detect_banded_locator(coords, tris, cls, geom) is None
    coords, tris, cls = t_gen.tokamak_mesh(24, 120)
    geom = np.zeros((tris.shape[0], 12), np.float32)
    assert t_loc.detect_banded_locator(coords, tris, cls, geom, n_theta=256,
                                       device="cpu") is not None


def test_production_mesh_file_written_once_and_read_back(tmp_path, monkeypatch):
    """``production_mesh`` writes the generator's mesh as gzip'd gmsh (here
    at a small shape), reuses the file once it exists, and ``read_msh``
    gives the generator's arrays back."""
    monkeypatch.setattr(bench_torch, "PRODUCTION_SHAPE", (24, 120))
    path = str(tmp_path / "sub" / "mesh.msh.gz")
    assert bench_torch.production_mesh(path) == path
    coords, tris, cls = t_gen.tokamak_mesh(24, 120)
    got = read_msh(path)
    np.testing.assert_array_equal(got[0], coords.astype(got[0].dtype))
    np.testing.assert_array_equal(got[1], tris)
    np.testing.assert_array_equal(got[2], cls)
    stamp = os.stat(path).st_mtime_ns
    bench_torch.production_mesh(path)
    assert os.stat(path).st_mtime_ns == stamp
    assert os.listdir(tmp_path / "sub") == ["mesh.msh.gz"]


def _calibration_samples(grid, step: int):
    """Every ``step``-th of ``attach_cell_rows``' samples on ``grid`` (its
    seed and draws): (start elements, px, py)."""
    n_grid, K = grid.nx * grid.ny, 8
    rng = np.random.default_rng(1729)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=n_grid * K)
    v = rng.uniform(size=n_grid * K)
    px = grid.origin[0] + (cell // grid.ny + u) * (1.0 / grid.inv_h[0])
    py = grid.origin[1] + (cell % grid.ny + v) * (1.0 / grid.inv_h[1])
    ce = grid.cell_elem.numpy().astype(np.int64)
    return ce[cell][::step], px[::step], py[::step]


def test_device_walk_equals_host_walk_on_120k_samples():
    """The calibration walk as torch f64 ops equals the numpy host walk on
    every 13th sample of the 120k mesh's cpe-4 grid (301k samples: found,
    outside the domain and stopped at the budget alike)."""
    coords, tris, cls = read_msh(os.path.join(DATA, "xgc_like_120k.msh.gz"))
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    grid = t_loc.build_locator_grid(coords, tris, cells_per_elem=4.0, device="cpu")
    e0, px, py = _calibration_samples(grid, 13)
    geom = m.walk_geom.numpy()
    want = t_loc._host_walk(geom, e0, px, py)
    got = t_loc._device_walk(torch.as_tensor(geom), torch.as_tensor(e0),
                             torch.as_tensor(px), torch.as_tensor(py))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).sum() > 0 and (want >= 0).sum() > 0.5 * want.size
    # a budget that stops walkers early: those end at -1 in both
    e0, px, py, want = e0[:60_000], px[:60_000], py[:60_000], want[:60_000]
    short = t_loc._host_walk(geom, e0, px, py, iters=1)
    np.testing.assert_array_equal(
        t_loc._device_walk(torch.as_tensor(geom), torch.as_tensor(e0),
                           torch.as_tensor(px), torch.as_tensor(py), iters=1).numpy(),
        short)
    assert (short < 0).sum() > (want < 0).sum()


def test_flood_fill_equals_reference_on_120k_grid():
    """The grid's flood fill as torch ops (the card's path; here on the
    CPU) gives the 120k mesh's cpe-4 cells (489,958, 135 rounds) the JAX
    package's ``cell_elem``, bit for bit."""
    coords, tris, _ = read_msh(os.path.join(DATA, "xgc_like_120k.msh.gz"))
    ref = j_loc.build_locator_grid(coords, tris, cells_per_elem=4.0, polar=False)
    got = t_loc.build_locator_grid(coords, tris, cells_per_elem=4.0, device="cpu")
    assert (got.nx, got.ny) == (int(ref.nx), int(ref.ny))
    assert got.cell_elem.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref.cell_elem), got.cell_elem.numpy())
    with pytest.raises(ValueError, match="flood fill"):
        t_loc._flood_fill(torch.full((3, 4), -1, dtype=torch.int64))


@pytest.mark.parametrize("name,cpe", [("tokamak", 16.0), ("24k", 4.0)])
def test_device_walk_grid_equals_reference(name, cpe, monkeypatch):
    """Cell rows calibrated by the device walk (standing in for the host
    walk here, as a CUDA grid takes it) equal the JAX package's
    ``build_locator_grid`` tables bit for bit, and the host walk's."""
    coords, tris, cls = (t_gen.tokamak_mesh(16, 96) if name == "tokamak"
                         else read_msh(os.path.join(DATA, "xgc_like_24k.msh.gz")))
    jm = JMesh2D.from_arrays(coords, tris, cls)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    ref = j_loc.build_locator_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                                   cells_per_elem=cpe, walk_geom=jm.walk_geom,
                                   peel="rows")
    bare = t_loc.build_locator_grid(m.coords.numpy(), m.elem2verts.numpy(),
                                    cells_per_elem=cpe, device="cpu")
    host = t_loc.attach_cell_rows(bare, m.walk_geom)
    walks = []

    def device_walk(geom, e0, px, py):
        walks.append(e0.size)
        return t_loc._device_walk(*(torch.as_tensor(a) for a in (geom, e0, px, py))).numpy()

    monkeypatch.setattr(t_loc, "_host_walk", device_walk)
    got = t_loc.attach_cell_rows(bare, m.walk_geom)
    assert walks == [8 * bare.nx * bare.ny]
    assert not ref.polar and (got.nx, got.ny) == (int(ref.nx), int(ref.ny))
    np.testing.assert_array_equal(np.asarray(ref.cell_elem), got.cell_elem.numpy())
    rows_ref = np.asarray(ref.cell_rows)
    assert rows_ref.dtype == got.cell_rows.numpy().dtype
    np.testing.assert_array_equal(rows_ref, got.cell_rows.numpy())
    assert torch.equal(host.cell_rows, got.cell_rows)


def _app_keys(n: int, seed: int):
    """(elem, active) of ``n`` particles over the 1M mesh's ids:
    the app's key population (half the elements hold none, as outside
    ``mdl_face``; 3% of the slots inactive)."""
    rng = np.random.default_rng(seed)
    held = np.sort(rng.choice(E_1M, E_1M // 2, replace=False))
    elem = held[rng.integers(0, held.size, n)].astype(np.int32)
    active = rng.random(n) >= 0.03
    return elem, active


def test_key_sort_plain_at_1m_width():
    """Kernel C's plain version on 2M keys in [0, 981,178] (the rebuild's
    ``where(active, elem, E)``: 20-bit keys) equals the JAX rebuild's
    ``jnp.argsort(key, stable=True)``; the kernel's passes cover 20 bits."""
    elem, active = _app_keys(2_000_000, 5)
    key = np.where(active, elem, E_1M).astype(np.int32)
    want = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
    got = rb.key_sort_plain(torch.as_tensor(key), E_1M)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(w for _, w in rb.key_sort_passes(E_1M)) >= 20
    # the fused mode (the key formed from elem and active) gives it too
    order, formed = rb.masked_key_sort_plain(torch.as_tensor(elem), torch.as_tensor(active),
                                             E_1M)
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(formed.numpy(), key)


@pytest.mark.parametrize("bound", ["tight", "none"])
def test_scs_row_order_plain_at_1m_rows(bound):
    """Kernel Z's row order (its wrapper's plain version) on 981,178 counts
    of the app's Sell-C-σ layout (chunks of 8, one σ window) equals the JAX
    ``_scs_row_order``; with the counts' bound given and without."""
    elem, active = _app_keys(10_000_000 // 8, 6)
    counts = np.bincount(elem[active], minlength=E_1M).astype(np.int32)
    counts[np.random.default_rng(7).choice(E_1M, 64, replace=False)] = 90   # ties far above
    num = int(counts.sum()) if bound == "tight" else None
    want = JS._scs_row_order(jnp.asarray(counts), 2**30, 8, E_1M)
    got = TS._scs_row_order(torch.as_tensor(counts), 2**30, 8, E_1M, num_ptcls=num)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_histogram_plain_at_1m_keys():
    """Kernel H's plain counts into 981,178 keys equal the JAX
    ``count_per_key_matmul`` (its matmul form, 24k keys) and its sorted
    histogram ``count_per_key`` (2M keys)."""
    elem, active = _app_keys(2_000_000, 8)
    got = t_sc.histogram_plain(torch.as_tensor(elem), torch.as_tensor(active), E_1M)
    want = np.asarray(j_sc.count_per_key(jnp.asarray(np.where(active, elem, E_1M)), E_1M))
    np.testing.assert_array_equal(got.numpy(), want)
    e, a = elem[:24_000], active[:24_000]
    got = t_sc.histogram_plain(torch.as_tensor(e), torch.as_tensor(a), E_1M)
    want = np.asarray(j_sc.count_per_key_matmul(jnp.asarray(np.where(a, e, E_1M)), E_1M))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# ---------------------------------------------------------------------------
# the locator-less step where walks reach the limit
# ---------------------------------------------------------------------------

FINE = (8, 2400)         # 31,398 triangles, ~2,400 points a flux surface
N = 20_000
MAX_ITERS = 64


def test_locator_less_step_at_the_limit_deletes_what_reference_deletes():
    """On ``tokamak_mesh(8, 2400)`` a 15° push crosses ~40 triangles, and
    walks of over 64 exist: three steps of the port's locator-less step
    from the JAX reference's state delete, at the 64-iteration limit, the
    same walkers as the reference's step (element ids, masks and fields
    equal), ``all_found`` is False in both, and the port's ``deleted``
    counts the walkers that a budget of 4096 iterations finds."""
    coords, tris, cls = j_gen.tokamak_mesh(*FINE)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    kw = dict(num_ptcls=N, mdl_face=max(int(cls.max()) // 2, 2), deg_per_push=15.0,
              max_search_iters=MAX_ITERS, use_locator=False)
    jcfg = jx.XGCmConfig(band_locator="off", **kw)
    js, jstep = jx.make_dp_setup(jm, jcfg, make_device_mesh(1))
    gmap, _ = jx.build_gyro_mappings(jm, jcfg.gyro)
    bands = j_push.detect_banded_class(np.asarray(jm.class_id))
    cfg = tx.XGCmConfig(**kw)
    model, state = interop.from_reference(
        {f: np.asarray(getattr(jm, f)) for f in interop.MESH_FIELDS}, None,
        np.asarray(gmap), None, bands, {k: np.asarray(v) for k, v in js.items()}, cfg,
        device="cpu")
    step = tx.make_dp_step(model, cfg)
    deleted_total = 0
    for i in range(3):
        # the reference's search on its step's targets: its all_found
        cd, sd = j_push.rot_vals_from_class(
            j_push.class_from_bands(jnp.maximum(js["elem"], 0), bands), jcfg.deg_per_push)
        ttx, tty, _, _ = j_push.elliptical_push_rot_vals(
            js["cphi"], js["sphi"], js["b"], cd, sd, jcfg.h, jcfg.k, jcfg.d)
        args = (jm, (js["x0"], js["x1"]), (jnp.where(js["active"], ttx, js["x0"]),
                                           jnp.where(js["active"], tty, js["x1"])),
                js["elem"], js["active"])
        jres = j_se.search_mesh_2d(*args, MAX_ITERS)
        # the walkers the limit deleted: those a long budget finds
        found_late = np.asarray((jres.elem_ids < 0) & args[4]
                                & (j_se.search_mesh_2d(*args, 4096).elem_ids >= 0))
        before = state["active"].clone()
        js, jf = jstep(js)
        jax.block_until_ready(jf)
        state, f = step(state)
        np.testing.assert_array_equal(state["elem"].numpy(), np.asarray(js["elem"]),
                                      err_msg=f"step {i}")
        np.testing.assert_array_equal(state["elem"].numpy(), np.asarray(jres.elem_ids))
        np.testing.assert_array_equal(state["active"].numpy(), np.asarray(js["active"]))
        for k in ("fwd", "bwd"):
            np.testing.assert_array_equal(f[k].numpy(), np.asarray(jf[k]), err_msg=k)
        gone = int((before & ~state["active"]).sum())
        assert int(f["deleted"]) == int(found_late.sum()) > 0
        assert gone - int(f["deleted"]) <= 2        # walkers leaving the domain
        assert not bool(f["all_found"]) and not bool(jres.all_found)
        assert int(f["iters"]) == int(jres.iters) == MAX_ITERS
        deleted_total += gone
    assert deleted_total > 100
