"""Parity of the port's FULL-mode pseudoXGCm slice
(pumipic_torch.models.pseudo_xgcm) with the JAX reference's make_dp_setup
on the cartesian main path: setup (particle counts, positions, initial
elements, gyro map), three steps from a carried-over state, and the
setup's own last-bit divergence pinned; the per-element rotation-table
push (a classification that is not band-ordered, and ``rot_analytic`` off)
over three steps.  Also: the port imports without JAX, its knobs, and the
bench entry point on the CPU.  The band, annulus and per-particle-radius
arms are in tests/test_torch_arms.py.

Tolerances: counts, positions' seeds and initial elements are equal; the
f32 angles from the setup's atan2/sin/cos within rtol/atol 1e-6; element
ids equal except for counted mismatches on shared sides; fwd/bwd equal
where the ids are equal."""
import dataclasses as dc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.mesh.locator import build_locator_grid as j_build_grid
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.ops import push as j_push
from pumipic_tpu.parallel.mesh_axis import make_device_mesh
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.gmsh import write_msh2
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.ops import push as t_push
from pumipic_torch.ops import search as t_se
from pumipic_torch.parallel import full_mode

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N = 20_000
KW = dict(num_ptcls=N, mdl_face=8, deg_per_push=15.0, max_search_iters=64)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's setup on tokamak_mesh(16, 96) at 20k particles
    (band_locator='off': the cartesian grid the port uses), and its parts
    as numpy for carrying across."""
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    cfg = jx.XGCmConfig(band_locator="off", **KW)
    state, step = jx.make_dp_setup(jm, cfg, make_device_mesh(1))
    cpe, peel, _ = jx.resolve_locator_policy(cfg, jm.nelems, N)
    grid = j_build_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                        walk_geom=jm.walk_geom, peel=peel, cells_per_elem=cpe)
    gmap, _ = jx.build_gyro_mappings(jm, cfg.gyro)
    return dict(
        raw=(coords, tris, cls), jm=jm, state=state, step=step,
        mesh_np={f: np.asarray(getattr(jm, f)) for f in interop.MESH_FIELDS},
        grid_np={f: np.asarray(getattr(grid, f)) for f in interop.LOCATOR_FIELDS},
        gmap=np.asarray(gmap),
        bands=j_push.detect_banded_class(np.asarray(jm.class_id)))


def test_setup_parity(ref):
    coords, tris, cls = ref["raw"]
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    cfg = tx.XGCmConfig(**KW)
    rng_j, rng_t = np.random.default_rng(tx.ELEMENT_SEED), np.random.default_rng(tx.ELEMENT_SEED)
    np.testing.assert_array_equal(
        tx.seed_particles_per_element(m, cfg, rng_t),
        jx.seed_particles_per_element(ref["jm"], jx.XGCmConfig(**KW), rng_j))
    state, _ = tx.make_dp_setup(m, cfg, "cpu")
    js = {k: np.asarray(v) for k, v in ref["state"].items()}
    for k in ("x0", "x1", "elem", "active"):
        np.testing.assert_array_equal(state[k].numpy(), js[k], err_msg=k)
    for k in ("cphi", "sphi"):
        np.testing.assert_allclose(state[k].numpy(), js[k], rtol=1e-6, atol=1e-6)
    # b = (y-k)/sin(phi): compared where sin(phi) is not tiny (see
    # test_torch_push.test_elliptical_setup_matches_reference)
    ok = np.abs(js["sphi"]) >= 0.5
    np.testing.assert_allclose(state["b"].numpy()[ok], js["b"][ok], rtol=1e-6, atol=1e-6)
    # gyro map: ring points come from torch's cos/sin, which may differ from
    # XLA's by an ulp; a point on a shared side may then land in the
    # neighbour.  Count such mismatches and bound them.
    fwd, bwd = tx.build_gyro_mappings(m, cfg.gyro)
    assert bwd is fwd
    mism = int((fwd.numpy() != ref["gmap"]).sum())
    assert mism <= 0.001 * fwd.numel(), mism


def test_three_step_slice_parity_from_carried_state(ref):
    cfg = tx.XGCmConfig(**KW)
    model, state = interop.from_reference(
        ref["mesh_np"], ref["grid_np"], ref["gmap"], None, ref["bands"],
        {k: np.asarray(v) for k, v in ref["state"].items()}, cfg, device="cpu")
    assert model.gyro_bwd is model.gyro_fwd
    step = tx.make_dp_step(model, cfg)
    js, jstep = ref["state"], ref["step"]
    for i in range(3):
        js, jf = jstep(js)
        jax.block_until_ready(jf)
        state, f = step(state)
        je, te = np.asarray(js["elem"]), state["elem"].numpy()
        mism = int((je != te).sum())
        assert mism <= 5, f"step {i}: {mism} element-id mismatches"
        np.testing.assert_array_equal(state["active"].numpy(), te >= 0)
        for k in ("x0", "x1", "cphi", "sphi"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{i} {k}")
        if mism == 0:
            for k in ("fwd", "bwd"):
                np.testing.assert_array_equal(f[k].numpy(), np.asarray(jf[k]),
                                              err_msg=f"step {i} {k}")
        assert bool(f["all_found"]) and int(f["iters"]) >= 1
        assert f["bwd"] is f["fwd"]


@pytest.mark.parametrize("nelems,nptcls", [(2_000, 20_000), (24_000, 100_000),
                                           (122_603, 10_000_000)])
def test_resolve_locator_policy_matches_reference(nelems, nptcls):
    got = tx.resolve_locator_policy(tx.XGCmConfig(), nelems, nptcls)
    want = jx.resolve_locator_policy(jx.XGCmConfig(), nelems, nptcls)
    assert got == want


def test_config_fields_match_reference():
    def fields(cls):
        return {f.name: f.default for f in dc.fields(cls)}
    assert fields(tx.GyroConfig) == fields(jx.GyroConfig)
    got, want = fields(tx.XGCmConfig), fields(jx.XGCmConfig)
    assert got.keys() == want.keys()
    for k in got:
        if k != "gyro":
            assert got[k] == want[k], k


def test_knobs_mapped_or_refused():
    coords, tris, cls = j_gen.tokamak_mesh(8, 32)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    base = tx.XGCmConfig(num_ptcls=500, mdl_face=4, deg_per_push=15.0,
                         max_search_iters=64)
    s0, step0 = tx.make_dp_setup(m, base, device="cpu")
    s0, f0 = step0(s0)
    # TPU-only knobs map onto the one GPU path: same result
    for kw in (dict(peel="lines"), dict(rot_aux_capture=True),
               dict(search_widths=(64,)), dict(rot_analytic=False),
               dict(band_locator="off"), dict(analytic_locate="off")):
        s, step = tx.make_dp_setup(m, dc.replace(base, **kw), device="cpu")
        s, f = step(s)
        assert torch.equal(s["elem"], s0["elem"]) and torch.equal(f["fwd"], f0["fwd"]), kw
    # the three further arms run: the band locator where the mesh is a
    # stitched flux-band structure (this coarse one is not: the JAX
    # package's ValueError), the per-particle radius, and the annulus
    with pytest.raises(ValueError, match="flux-band"):
        tx.make_dp_setup(m, dc.replace(base, band_locator="force"), device="cpu")
    bm = Mesh2D.from_arrays(*j_gen.tokamak_mesh(24, 120), device="cpu")
    s, step = tx.make_dp_setup(bm, dc.replace(base, mdl_face=12, band_locator="force"), device="cpu")
    assert type(step.model.locator).__name__ == "BandGrid2D"
    s, f = step(s)
    assert bool(f["all_found"]) and int(s["active"].sum()) >= 499
    s, step = tx.make_dp_setup(m, dc.replace(base, gyro=tx.GyroConfig(per_particle_radius=True)), device="cpu")
    s, f = step(s)
    assert "rg" in s and torch.equal(s["elem"], s0["elem"])
    assert float(f["fwd"].sum()) == float(f0["fwd"].sum())
    with pytest.raises(ValueError):
        tx.make_dp_setup(m, dc.replace(base, band_locator="banded"), device="cpu")
    with pytest.raises(ValueError):
        tx.make_dp_setup(m, dc.replace(base, analytic_locate="force"), device="cpu")
    # a proven structured annulus is located analytically (no walk: iters
    # 0); "off" walks, to the same elements
    ac, at, acl = j_gen.annulus_mesh(4, 24, 0.3, 1.0)
    am = Mesh2D.from_arrays(ac, at, acl, device="cpu")
    s, step = tx.make_dp_setup(am, base, device="cpu")
    assert step.model.analytic is not None and step.model.locator is None
    s, f = step(s)
    assert int(f["iters"]) == 0 and bool(f["all_found"])
    sw, stepw = tx.make_dp_setup(am, dc.replace(base, analytic_locate="off"), device="cpu")
    assert stepw.model.analytic is None
    sw, fw = stepw(sw)
    assert int(fw["iters"]) >= 1
    assert (s["elem"] != sw["elem"]).sum() <= 2
    # a classification that is not band-ordered takes the rotation table
    cm = Mesh2D.from_arrays(coords, tris, cls[::-1].copy(), device="cpu")
    s, step = tx.make_dp_setup(cm, base, device="cpu")
    assert isinstance(step.model.rot, t_push.RotTable)
    s, f = step(s)
    assert bool(f["all_found"]) and int(s["active"].sum()) > 0


def test_setup_divergence_is_the_references_own_ill_conditioning(ref):
    """From the port's own setup (not the carried state): torch's and
    XLA's atan2/sin/cos differ in the last bits, so cphi/sphi differ by at
    most one ulp of phi (2^-22 for |phi| in [2, pi]) on ~17% of the
    particles, and b = (y-k)/sin(phi) turns that into larger differences
    (up to ~1e-5 here).  Every element id that then differs from the JAX
    package's after 3 steps belongs to a particle whose initial b differs,
    or lies on a side shared by both elements; both counts are bounded.
    (On this mesh and at 20k particles both are 0.)"""
    coords, tris, cls = ref["raw"]
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    state, step = tx.make_dp_setup(m, tx.XGCmConfig(**KW), "cpu")
    js = {k: np.asarray(v) for k, v in ref["state"].items()}
    for k in ("cphi", "sphi"):
        d = np.abs(state[k].numpy().astype(np.float64) - js[k])
        assert d.max() <= 2.0 ** -22, k
        assert 0.05 < (d > 0).mean() < 0.4, k
    b_differs = state["b"].numpy() != js["b"]
    assert 0.05 < b_differs.mean() < 0.4
    assert np.abs(state["b"].numpy() - js["b"]).max() < 1e-4
    geom = m.walk_geom.numpy().astype(np.float64)
    jstate, jstep = ref["state"], ref["step"]
    for i in range(3):
        jstate, _ = jstep(jstate)
        state, _ = step(state)
        je, te = np.asarray(jstate["elem"]), state["elem"].numpy()
        bad = np.nonzero(je != te)[0]
        from_b = b_differs[bad]
        x, y = state["x0"].numpy(), state["x1"].numpy()
        ties = [p for p in bad[~from_b]
                if je[p] >= 0 and te[p] >= 0
                and _near_both_side(geom, je[p], te[p], float(x[p]), float(y[p]))]
        assert len(ties) == (~from_b).sum(), f"step {i}: unexplained mismatches"
        assert from_b.sum() <= 0.005 * N and len(ties) <= 5, (i, from_b.sum(), len(ties))


def _near_both_side(geom, e1, e2, x, y):
    """(x, y) within a loose multiple of the walk's containment tolerance
    of both elements."""
    for e in (e1, e2):
        r = geom[e]
        l1 = r[0] * x + r[1] * y + r[2]
        l2 = r[3] * x + r[4] * y + r[5]
        mag = sum(abs(v) for v in (r[0] * x, r[1] * y, r[2], r[3] * x, r[4] * y, r[5]))
        tol = 4 * (t_se.BCC_REL_TOL * mag + 2 * t_se.BCC_ABS_TOL)
        if min(l1, l2, 1.0 - l1 - l2) < -tol:
            return False
    return True


def _permuted_tokamak():
    """tokamak_mesh(16, 96) with a seeded element permutation: the same
    mesh, its classification no longer band-ordered."""
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    perm = np.random.default_rng(5).permutation(len(tris))
    return coords, tris[perm], cls[perm]


@pytest.mark.parametrize("case", ["permuted elements", "rot_analytic off",
                                  "ROT_TABLE_1D"])
def test_table_push_step_matches_reference(case, monkeypatch):
    """make_dp_setup takes the rotation-table push (P's table mode) where
    the JAX package does: on a classification that is not band-ordered and
    with rot_analytic=False (and its 1-D table maps onto the same rows).
    Three steps from the reference's carried state match its step."""
    raw = _permuted_tokamak() if case == "permuted elements" else j_gen.tokamak_mesh(16, 96)
    kw = dict(KW, rot_analytic=case != "rot_analytic off")
    if case == "ROT_TABLE_1D":
        kw["rot_analytic"] = False
        monkeypatch.setattr(jx, "ROT_TABLE_1D", True)
        monkeypatch.setattr(tx, "ROT_TABLE_1D", True)
    jm = JMesh2D.from_arrays(*raw)
    jcfg = jx.XGCmConfig(band_locator="off", **kw)
    jstate, jstep = jx.make_dp_setup(jm, jcfg, make_device_mesh(1))
    cpe, peel, _ = jx.resolve_locator_policy(jcfg, jm.nelems, N)
    grid = j_build_grid(np.asarray(jm.coords), np.asarray(jm.elem2verts),
                        walk_geom=jm.walk_geom, peel=peel, cells_per_elem=cpe)
    gmap, _ = jx.build_gyro_mappings(jm, jcfg.gyro)
    cfg = tx.XGCmConfig(**kw)
    # the port's own setup picks the table
    _, own = tx.make_dp_setup(Mesh2D.from_arrays(*raw, device="cpu"), cfg, "cpu")
    assert isinstance(own.model.rot, t_push.RotTable)
    model, state = interop.from_reference(
        {f: np.asarray(getattr(jm, f)) for f in interop.MESH_FIELDS},
        {f: np.asarray(getattr(grid, f)) for f in interop.LOCATOR_FIELDS},
        np.asarray(gmap), None, (1,), {k: np.asarray(v) for k, v in jstate.items()},
        cfg, device="cpu")
    model = dc.replace(model, rot=own.model.rot)
    step = tx.make_dp_step(model, cfg)
    geom = model.mesh.walk_geom.numpy().astype(np.float64)
    for i in range(3):
        jstate, jf = jstep(jstate)
        state, f = step(state)
        je, te = np.asarray(jstate["elem"]), state["elem"].numpy()
        bad = np.nonzero(je != te)[0]
        x, y = state["x0"].numpy(), state["x1"].numpy()
        assert all(je[p] >= 0 and te[p] >= 0 and _near_both_side(
            geom, je[p], te[p], float(x[p]), float(y[p])) for p in bad), i
        assert len(bad) <= 5, f"step {i}: {len(bad)} element-id mismatches"
        for k in ("x0", "x1", "cphi", "sphi"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{i} {k}")
        if len(bad) == 0:
            np.testing.assert_array_equal(f["fwd"].numpy(), np.asarray(jf["fwd"]))
        assert bool(f["all_found"])


def test_full_mode_is_identity_on_one_process():
    f = torch.arange(5.0)
    out = full_mode.reduce_fields({"fwd": f, "bwd": f})
    assert out["fwd"] is f and out["bwd"] is f
    state = {"x0": torch.zeros(3)}
    assert full_mode.shard_particles(state) is state


_RANK_SCRIPT = """
import sys, torch, torch.distributed as dist
from pumipic_torch.mesh.generate import tokamak_mesh
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.models.pseudo_xgcm import XGCmConfig, make_dp_setup
port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
m = Mesh2D.from_arrays(*tokamak_mesh(8, 32), device="cpu")
state, step = make_dp_setup(m, XGCmConfig(num_ptcls=601, mdl_face=4), device="cpu")
for _ in range(2):
    state, fields = step(state)
torch.save({"fwd": fields["fwd"], "n": state["x0"].shape[0],
            "alive": int(state["active"].sum())}, out)
dist.destroy_process_group()
"""


def test_full_mode_all_reduce_over_two_gloo_ranks(tmp_path):
    """Two CPU processes (gloo), each stepping half the particles: the
    all_reduced field equals the one-process field, and the shares hold
    every particle once (601 -> 2 x 301 with one inactive pad slot)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(r),
                               str(tmp_path / f"r{r}.pt")], cwd=REPO, env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt") for r in range(2))
    m = Mesh2D.from_arrays(*j_gen.tokamak_mesh(8, 32), device="cpu")
    state, step = tx.make_dp_setup(m, tx.XGCmConfig(num_ptcls=601, mdl_face=4), device="cpu")
    for _ in range(2):
        state, fields = step(state)
    assert r0["n"] == r1["n"] == 301
    assert r0["alive"] + r1["alive"] == int(state["active"].sum())
    assert torch.equal(r0["fwd"], r1["fwd"])
    assert torch.equal(r0["fwd"], fields["fwd"])


def test_port_imports_and_runs_without_jax():
    code = """
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import pumipic_torch
for mod in pkgutil.walk_packages(pumipic_torch.__path__, "pumipic_torch."):
    importlib.import_module(mod.name)
import bench_torch, chip_smoke
from pumipic_torch.mesh.generate import tokamak_mesh
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.models.pseudo_xgcm import XGCmConfig, make_dp_setup
m = Mesh2D.from_arrays(*tokamak_mesh(8, 32), device="cpu")
state, step = make_dp_setup(m, XGCmConfig(num_ptcls=300, mdl_face=4), device="cpu")
state, fields = step(state)
assert fields["fwd"].shape == (m.nverts,)
from pumipic_torch.models.pseudo_xgcm import PseudoXGCm
app = PseudoXGCm(m, XGCmConfig(num_ptcls=300, mdl_face=4), device="cpu")
fwd, bwd = app.run(1, verbose=False)
assert fwd.shape == (m.nverts,) and int(app.ptcls.num_ptcls) > 0
state, step = make_dp_setup(m, XGCmConfig(num_ptcls=300, mdl_face=4, rot_analytic=False), device="cpu")
state, fields = step(state)
from pumipic_torch.mesh.core import Mesh3D
from pumipic_torch.mesh.generate import box_tet_mesh
from pumipic_torch.models.pseudo_push_and_search import PseudoPushAndSearch, PushSearchConfig
m3 = Mesh3D.from_arrays(*box_tet_mesh(2, 2, 2), device="cpu")
for kuhn in ("auto", "off"):
    pps = PseudoPushAndSearch(m3, PushSearchConfig(num_ptcls=300, wall="periodic", kuhn=kuhn), device="cpu")
    assert pps.run(2) == [300, 300]
loaded = [k for k, v in sys.modules.items() if k.split(".")[0] in ("jax", "jaxlib", "pumipic_tpu") and v is not None]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_bench_torch_runs_on_cpu(tmp_path, capsys):
    """The bench entry point on a small written mesh, on the CPU: one JSON
    line with bench.py's keys plus impl/gpu, and no file written."""
    sys.path.insert(0, REPO)
    import bench_torch

    path = str(tmp_path / "tok.msh")
    coords, tris, cls = j_gen.tokamak_mesh(8, 32)
    write_msh2(path, coords, tris, cls)
    before = set(os.listdir(REPO))
    rec, state, fields = bench_torch.main(device="cpu", num_ptcls=2000, iters=2,
                                          mesh_path=path)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    assert json.loads(line)["detail"]["alive"] == rec["detail"]["alive"]
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= rec.keys()
    d = rec["detail"]
    assert {"num_ptcls", "mesh_elems", "ms_per_step", "chips", "alive"} <= d.keys()
    assert d["impl"] == "torch" and d["device"] == "cpu" and d["gpu"] is None
    assert set(d["setup_s"]) == {"mesh", "particles", "gyro_map", "locator"}
    assert 0 < d["alive"] <= 2000 and d["all_found"]
    assert set(os.listdir(REPO)) == before


def test_bench_torch_rotgather_runs_on_cpu(tmp_path, monkeypatch):
    """BENCH_ROT_ANALYTIC=0: the table push, tag ``...-rotgather``; the same
    particles survive as with the band classes (the table's values are
    within an ulp of the band rotation's)."""
    sys.path.insert(0, REPO)
    import bench_torch

    path = str(tmp_path / "tok.msh")
    write_msh2(path, *j_gen.tokamak_mesh(8, 32))
    monkeypatch.setenv("BENCH_ROT_ANALYTIC", "0")
    rec, state, _ = bench_torch.main(device="cpu", num_ptcls=2000, iters=2,
                                     mesh_path=path, verbose=False)
    assert rec["detail"]["tag"] == "dp-tok-rotgather-0M"
    monkeypatch.delenv("BENCH_ROT_ANALYTIC")
    rec2, state2, _ = bench_torch.main(device="cpu", num_ptcls=2000, iters=2,
                                       mesh_path=path, verbose=False)
    assert rec2["detail"]["tag"] == "dp-tok-0M"
    assert abs(rec["detail"]["alive"] - rec2["detail"]["alive"]) <= 2
