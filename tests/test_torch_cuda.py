"""Card-only checks of the port's kernels: each kernel against its plain
PyTorch version on the same CUDA tensors (exact), and its launch counter.

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
from pumipic_torch.mesh.generate import tokamak_mesh
from pumipic_torch.mesh.locator import build_locator_grid
from pumipic_torch.models import pseudo_xgcm as px
from pumipic_torch.ops import push as push_ops
from pumipic_torch.ops import scatter as sc
from pumipic_torch.ops import search as se

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
