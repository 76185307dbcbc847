"""The port's I/O and utilities, against the JAX package: picparts,
particle and structure checkpoints read across both packages (the same
``.npz`` format; a port-written picparts file equals the JAX package's
key for key, bit for bit), the ``.osh`` mesh files (the same bytes) and
``load_mesh``, the live-tensor audit, and the timing additions
(``DeviceFence``, ``summarize_across_devices``, ``profiling_region``).

Structures are integer and bit moves: every array of a structure read
back equals, slot for slot, that of a structure built directly from the
same particles (tolerance: none)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu import particles as J
from pumipic_tpu.io import checkpoint as j_ck
from pumipic_tpu.io import osh as j_osh
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.mesh.core import Mesh3D as JMesh3D
from pumipic_tpu.parallel import picparts as j_pp
from pumipic_tpu.utils import timing as j_tm
from pumipic_torch import interop
from pumipic_torch import particles as T
from pumipic_torch.io import checkpoint as t_ck
from pumipic_torch.io import osh as t_osh
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.mesh.gmsh import write_msh2
from pumipic_torch.parallel import picparts as t_pp
from pumipic_torch.utils import memaudit
from pumipic_torch.utils import timing as t_tm

E, N = 25, 200


def _layouts(m, device_kw):
    return {
        "scs": lambda e, f: m.SellCSigma(
            E, e, fields=f, scs_input=m.SCSInput(chunk_size=4, sigma=8,
                                                 extra_padding=0.2,
                                                 pad_strategy="evenly"),
            name="ions", **device_kw),
        "csr": lambda e, f: m.CSR(E, e, fields=f, **device_kw),
        "cabm": lambda e, f: m.CabM(E, e, fields=f, soa_width=16, extra_padding=0.1,
                                    **device_kw),
        "dps": lambda e, f: m.DPS(E, e, fields=f, **device_kw),
    }


def _inputs():
    rng = np.random.default_rng(4)
    elems = rng.integers(-1, E, N).astype(np.int32)
    fields = {"pos": rng.normal(size=(N, 3)).astype(np.float32),
              "pid": np.arange(N, dtype=np.int32)}
    return elems, fields


def _same(j, t):
    """Every member of the JAX structure equals the port's."""
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "fields":
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
        elif f.name in interop.STRUCTURE_STATIC:
            assert a == b, f.name
        elif a is None or b is None:
            assert a is None and b is None, f.name
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)


@pytest.mark.parametrize("layout", ["scs", "csr", "cabm", "dps"])
def test_structure_checkpoints_cross_both_ways(tmp_path, layout):
    """A structure the JAX package wrote is read by the port, one the port
    wrote by the JAX package; each is rebuilt in its layout with its
    padding settings and equals a structure built directly."""
    elems, fields = _inputs()
    j = _layouts(J, {})[layout](elems, {k: jnp.asarray(v) for k, v in fields.items()})
    t = _layouts(T, {"device": "cpu"})[layout](
        elems, {k: torch.as_tensor(v) for k, v in fields.items()})
    _same(j, t)
    p = j_ck.write_particle_structure(str(tmp_path / "from_jax"), j, step=7)
    t2, step = t_ck.read_particle_structure(p, device="cpu")
    assert step == 7
    _same(j, t2)
    p = t_ck.write_particle_structure(str(tmp_path / "from_port.npz"), t, step=9)
    assert p.endswith("from_port.npz")
    j2, step = j_ck.read_particle_structure(p)
    assert step == 9
    _same(j2, t)


def _picparts_pair(dim):
    if dim == 2:
        coords, cells, cls = j_gen.annulus_mesh(4, 32, 0.3, 1.0)
    else:
        (coords, cells), cls = j_gen.box_tet_mesh(3, 3, 3), None
    owners = t_pp.partition_rcb(coords, cells, 4)
    tp = t_pp.build_picparts(coords, cells, owners, 4, t_pp.PicPartsInput(), cls)
    jp = j_pp.build_picparts(coords, cells, owners, 4, j_pp.PicPartsInput(), cls,
                             mesh_cls=JMesh2D if dim == 2 else JMesh3D)
    return tp, jp


def _same_picparts(a, b):
    assert (a.num_ranks, a.dim, a.nelems, a.nverts, a.num_core_elems) == \
        (b.num_ranks, b.dim, b.nelems, b.nverts, b.num_core_elems)
    assert set(a.tables) == set(b.tables)
    for k in a.tables:
        np.testing.assert_array_equal(a.tables[k], b.tables[k], err_msg=k)
    np.testing.assert_array_equal(a.elem_safe, b.elem_safe)
    for r in range(a.num_ranks):
        ma, mb = a.local_mesh(r, "cpu"), b.local_mesh(r, "cpu")
        for f in dataclasses.fields(ma):
            x, y = getattr(ma, f.name), getattr(mb, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (r, f.name)


@pytest.mark.parametrize("dim", [2, 3])
def test_picparts_checkpoints_cross_both_ways(tmp_path, dim):
    """Each package reads the other's ``<prefix>_<R>.ppm.npz`` with equal
    tables and meshes, and the port writes the JAX package's file."""
    tp, jp = _picparts_pair(dim)
    t_path = t_ck.write_picparts(str(tmp_path / "t"), tp)
    j_path = j_ck.write_picparts(str(tmp_path / "j"), jp)
    assert t_path.endswith("t_4.ppm.npz") and j_path.endswith("j_4.ppm.npz")
    t_file, j_file = np.load(t_path), np.load(j_path)
    assert set(t_file.files) == set(j_file.files)
    for k in j_file.files:
        a, b = t_file[k], j_file[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    _same_picparts(t_ck.read_picparts(j_path), tp)
    _same_picparts(t_ck.read_picparts(t_path), tp)
    back = j_ck.read_picparts(t_path)
    for name in t_pp.TABLES + (t_pp.TABLES_3D if dim == 3 else ()):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), tp.tables[name],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(back.mesh.walk_geom),
                                  np.asarray(jp.mesh.walk_geom))


def test_particle_state_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    state = {"x": rng.normal(size=(50, 2)).astype(np.float32),
             "elem": rng.integers(0, 9, 50).astype(np.int32),
             "active": rng.uniform(size=50) < 0.5}
    p = t_ck.write_particles(str(tmp_path / "s"), {k: torch.as_tensor(v)
                                                    for k, v in state.items()}, step=3)
    got, step = j_ck.read_particles(p)
    assert step == 3 and sorted(got) == sorted(state)
    for k in state:
        assert got[k].dtype == state[k].dtype and np.array_equal(got[k], state[k])
    p = j_ck.write_particles(str(tmp_path / "j"), {k: jnp.asarray(v)
                                                    for k, v in state.items()}, step=4)
    got, step = t_ck.read_particles(p)
    assert step == 4
    for k in state:
        assert got[k].dtype == state[k].dtype and np.array_equal(got[k], state[k])


def test_osh_files_cross_both_ways(tmp_path):
    """The port's .osh writer and reader give and take the JAX package's
    bytes (compressed and not, with tags), across ranks."""
    coords, tris, cls = j_gen.annulus_mesh(3, 12, 0.3, 1.0)
    vt = {"phi": np.linspace(0, 1, coords.shape[0])}
    et = {"w": np.arange(2 * tris.shape[0], dtype=np.int32).reshape(-1, 2)}
    for compress in (True, False):
        a, b = str(tmp_path / f"j{compress}.osh"), str(tmp_path / f"t{compress}.osh")
        j_osh.write_osh(a, coords, tris, cls, vert_tags=vt, elem_tags=et, compress=compress)
        t_osh.write_osh(b, coords, tris, cls, vert_tags=vt, elem_tags=et, compress=compress)
        assert open(f"{a}/0.osh", "rb").read() == open(f"{b}/0.osh", "rb").read()
        for got in (t_osh.read_osh(a), j_osh.read_osh(b)):
            c2, ev2, cls2, vt2, et2 = got
            np.testing.assert_array_equal(c2, coords)
            np.testing.assert_array_equal(ev2, tris)
            np.testing.assert_array_equal(cls2, cls)
            np.testing.assert_array_equal(vt2["phi"], vt["phi"])
            np.testing.assert_array_equal(et2["w"], et["w"])
    path = str(tmp_path / "multi.osh")
    half = tris.shape[0] // 2
    t_osh.write_osh(path, coords, tris[:half], cls[:half], nparts=2, rank=0)
    t_osh.write_osh(path, coords, tris[half:], cls[half:], nparts=2, rank=1)
    assert j_osh.read_osh(path, rank=1)[1].shape[0] == tris.shape[0] - half
    with pytest.raises(ValueError):
        t_osh.read_osh(path, rank=2)
    bad = tmp_path / "bad.osh"
    bad.write_bytes(b"\x00\x01 definitely not a mesh")
    with pytest.raises(ValueError):
        t_osh.read_osh(str(bad))


def test_load_mesh_gives_the_ports_meshes(tmp_path):
    """load_mesh reads .osh and .msh.gz into the port's Mesh2D (walk table
    equal to the JAX package's) and Mesh3D; load_mesh_arrays returns what
    the JAX package's load_mesh does."""
    coords, tris, cls = j_gen.disk_mesh(4, 8)
    path = str(tmp_path / "disk.osh")
    t_osh.write_osh(path, coords, tris, cls)
    m = t_osh.load_mesh(path, device="cpu")
    assert isinstance(m, Mesh2D) and m.device.type == "cpu"
    jm = JMesh2D.from_arrays(coords, tris, cls)
    np.testing.assert_array_equal(m.walk_geom.numpy(), np.asarray(jm.walk_geom))
    np.testing.assert_array_equal(m.class_id.numpy(), cls)
    gz = str(tmp_path / "box.msh.gz")
    c3, t3 = j_gen.box_tet_mesh(2, 2, 2)
    write_msh2(gz, c3, t3)
    m3 = t_osh.load_mesh(gz, device="cpu")
    assert isinstance(m3, Mesh3D) and m3.nelems == t3.shape[0]
    for got, want in zip(t_osh.load_mesh_arrays(gz), j_osh.load_mesh(gz)):
        np.testing.assert_array_equal(got, want)


def test_memaudit_leak_check_detects_growth_and_flat_loops():
    """Live-tensor audit (the memcheck/destroy_test analog): a loop that
    replaces its state leaves the census flat; tensors a host list keeps
    are reported, by shape and dtype."""
    def step(s):
        return {"x": s["x"] * 1.01 + 1.0, "y": s["y"] - 0.5}

    state = {"x": torch.zeros(1024), "y": torch.ones(1024)}
    state = step(state)
    lc = memaudit.LeakCheck()
    for _ in range(10):
        state = step(state)
    d = lc.assert_flat(tol_buffers=2)
    assert abs(d.count) <= 2
    lc.reset()
    pinned = []
    for _ in range(8):
        state = step(state)
        pinned.append(state["x"])
    with pytest.raises(AssertionError, match="live-tensor delta"):
        lc.assert_flat(tol_buffers=2)
    d = lc.diff()      # the last one replaced the state's own x
    assert d.by_key.get("(1024,)float32@cpu", 0) >= 7 and d.nbytes >= 7 * 4096
    snap = memaudit.snapshot()
    assert snap.count >= 8 and snap.cuda_allocated == ({} if not torch.cuda.is_available()
                                                       else snap.cuda_allocated)
    del pinned


def test_timing_fence_summary_and_region():
    """DeviceFence is a no-op returning 0.0 without a CUDA device (a CPU
    device in its list is left out); the cross-device table is the JAX
    package's text; profiling_region names a profiler range."""
    fence = t_tm.DeviceFence(devices=[] if not torch.cuda.is_available() else None)
    assert isinstance(fence(), float)
    assert t_tm.DeviceFence(devices=["cpu"])() == 0.0
    vals = {"alive": np.array([10.0, 12.0, 8.0]), "moved": np.array([1.0, 3.0, 2.0])}
    want = j_tm.summarize_across_devices(vals, print_fn=None)
    got = t_tm.summarize_across_devices(
        {"alive": torch.tensor([10.0, 12.0, 8.0]), "moved": [1.0, 3.0, 2.0]},
        print_fn=None)
    assert got == want
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t_tm.profiling_region("push-search"):
            torch.ones(4).sum()
    assert any(e.name == "push-search" for e in prof.events())
