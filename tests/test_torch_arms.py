"""Parity of the port's three further FULL-mode arms with the JAX
reference's ``make_dp_setup``: the flux-band locator
(``band_locator="force"``, kernels B + L), the structured-annulus analytic
locate (kernel A) and the per-particle gyro radius (kernel H's key mode,
D's pass 1 from (E, R) counts).  For each arm: the port's own setup builds
the reference's structures, and three steps from the reference's carried
state match its steps.  Also: the bench entry point runs each arm on the
CPU and tags it as ``bench.py`` does.

Tolerances (as tests/test_torch_pseudo_xgcm.py): element ids equal except
for at most 5 counted mismatches, each with its destination within the
containment tolerance of both elements; positions and angles within
rtol/atol 1e-6; fwd/bwd equal where the ids are equal."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh import locator as j_loc
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.ops import push as j_push
from pumipic_tpu.parallel.mesh_axis import make_device_mesh
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.gmsh import write_msh2
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.ops import search as t_se

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N = 20_000
BASE = dict(num_ptcls=N, deg_per_push=15.0, max_search_iters=64)
# arm -> (mesh, config keywords; "ppr" selects the per-particle radius)
ARMS = {
    "band": (lambda: j_gen.tokamak_mesh(24, 120),
             dict(mdl_face=12, band_locator="force")),
    "annulus": (lambda: j_gen.annulus_mesh(8, 48, 0.3, 1.0), dict(mdl_face=4)),
    "pprad": (lambda: j_gen.tokamak_mesh(16, 96), dict(mdl_face=8, ppr=True)),
}


def _cfgs(kw):
    kw = dict(kw)
    ppr = kw.pop("ppr", False)
    return (jx.XGCmConfig(gyro=jx.GyroConfig(per_particle_radius=ppr), **BASE, **kw),
            tx.XGCmConfig(gyro=tx.GyroConfig(per_particle_radius=ppr), **BASE, **kw))


def _near_both(geom, e1, e2, x, y):
    """(x, y) lies within a loose multiple of the walk's containment
    tolerance of both elements: a side or vertex they share."""
    for e in (e1, e2):
        r = geom[e]
        l1 = r[0] * x + r[1] * y + r[2]
        l2 = r[3] * x + r[4] * y + r[5]
        m = abs(r[0] * x) + abs(r[1] * y) + abs(r[2]) + \
            abs(r[3] * x) + abs(r[4] * y) + abs(r[5])
        tol = 4 * (t_se.BCC_REL_TOL * m + 2 * t_se.BCC_ABS_TOL)
        if min(l1, l2, 1.0 - l1 - l2) < -tol:
            return False
    return True


@pytest.fixture(scope="module", params=list(ARMS))
def arm(request):
    """The reference's setup of one arm, and what the port carries across."""
    name = request.param
    coords, tris, cls = ARMS[name][0]()
    jcfg, tcfg = _cfgs(ARMS[name][1])
    jm = JMesh2D.from_arrays(coords, tris, cls)
    state, step = jx.make_dp_setup(jm, jcfg, make_device_mesh(1))
    a = (np.asarray(jm.coords), np.asarray(jm.elem2verts))
    carry = {}
    if name == "band":
        g = j_loc.detect_banded_locator(*a, np.asarray(jm.class_id), jm.walk_geom)
        carry["band_grid"] = {f: np.asarray(getattr(g, f)) for f in interop.BAND_FIELDS}
    elif name == "annulus":
        loc = j_loc.detect_annulus_structured(*a, cls=np.asarray(jm.class_id))
        carry["annulus"] = {f: getattr(loc, f) for f in interop.ANNULUS_FIELDS}
    else:
        cpe, peel, _ = jx.resolve_locator_policy(jcfg, jm.nelems, N)
        g = j_loc.build_locator_grid(*a, walk_geom=jm.walk_geom, peel=peel,
                                     cells_per_elem=cpe)
        carry["locator"] = {f: np.asarray(getattr(g, f)) for f in interop.LOCATOR_FIELDS}
    gmap, _ = jx.build_gyro_mappings(jm, jcfg.gyro)
    return dict(name=name, raw=(coords, tris, cls), jm=jm, state=state,
                step=step, tcfg=tcfg, carry=carry, gmap=np.asarray(gmap),
                bands=j_push.detect_banded_class(np.asarray(jm.class_id)))


def test_arm_setup_builds_the_reference_structures(arm):
    m = Mesh2D.from_arrays(*arm["raw"], device="cpu")
    state, step = tx.make_dp_setup(m, arm["tcfg"], "cpu")
    model = step.model
    js = {k: np.asarray(v) for k, v in arm["state"].items()}
    assert set(state) == set(js)
    for k in ("x0", "x1", "elem", "active") + (("rg",) if "rg" in js else ()):
        np.testing.assert_array_equal(state[k].numpy(), js[k], err_msg=k)
    if arm["name"] == "band":
        want = interop.band_grid_from_numpy(arm["carry"]["band_grid"], device="cpu")
        assert model.analytic is None and model.locator.n_theta == want.n_theta
        for k in ("coef_u", "coef_v", "inv_coef", "cell_rows", "cell_elem"):
            assert torch.equal(getattr(model.locator, k), getattr(want, k)), k
    elif arm["name"] == "annulus":
        want = interop.annulus_from_numpy(arm["carry"]["annulus"], device="cpu")
        assert model.locator is None and model.analytic == want
        assert model.analytic.ring_class
    else:
        assert state["rg"].dtype == torch.float32
        assert float(state["rg"].min()) >= 0.25 * 0.038
        assert type(model.locator).__name__ == "LocatorGrid2D"


def test_arm_three_step_slice_parity_from_carried_state(arm):
    cfg = arm["tcfg"]
    model, state = interop.from_reference(
        {f: np.asarray(getattr(arm["jm"], f)) for f in interop.MESH_FIELDS},
        arm["carry"].get("locator"), arm["gmap"], None, arm["bands"],
        {k: np.asarray(v) for k, v in arm["state"].items()}, cfg,
        band_grid=arm["carry"].get("band_grid"),
        annulus=arm["carry"].get("annulus"), device="cpu")
    step = tx.make_dp_step(model, cfg)
    geom = model.mesh.walk_geom.numpy().astype(np.float64)
    js, jstep = arm["state"], arm["step"]
    for i in range(3):
        js, jf = jstep(js)
        jax.block_until_ready(jf)
        state, f = step(state)
        je, te = np.asarray(js["elem"]), state["elem"].numpy()
        bad = np.nonzero(je != te)[0]
        assert len(bad) <= 5, f"step {i}: {len(bad)} element-id mismatches"
        x, y = state["x0"].numpy(), state["x1"].numpy()
        for p in bad:
            assert je[p] >= 0 and te[p] >= 0, (i, p)
            assert _near_both(geom, je[p], te[p], float(x[p]), float(y[p])), (i, p)
        np.testing.assert_array_equal(state["active"].numpy(), te >= 0)
        for k in ("x0", "x1", "cphi", "sphi"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{i} {k}")
        if "rg" in js:
            np.testing.assert_array_equal(state["rg"].numpy(), np.asarray(js["rg"]))
        if len(bad) == 0:
            for k in ("fwd", "bwd"):
                np.testing.assert_array_equal(f[k].numpy(), np.asarray(jf[k]),
                                              err_msg=f"step {i} {k}")
        if arm["name"] == "annulus":
            assert int(f["iters"]) == 0 and bool(f["all_found"])
        else:
            assert bool(f["all_found"]) and int(f["iters"]) >= 1
        assert int(state["active"].sum()) > 0.99 * N


@pytest.mark.parametrize("knobs,tag", [
    (dict(band_locator="force"), "dp-tok-bandloc-0M"),
    (dict(gyro_ppr=True), "dp-tok-pprad-0M"),
    (dict(mesh_path="annulus", mesh_elems=2000), "dp-0M"),
    (dict(mesh_path="annulus", mesh_elems=2000, analytic_locate="off"),
     "dp-walk-0M"),
])
def test_bench_torch_arms_on_cpu(tmp_path, capsys, knobs, tag):
    """bench_torch.main runs each arm through make_dp_setup and tags its
    record as bench.py tags its rows; the same knobs from the environment
    give the same run."""
    sys.path.insert(0, REPO)
    import bench_torch

    if knobs.get("mesh_path") != "annulus":
        knobs = dict(knobs, mesh_path=str(tmp_path / "tok.msh"))
        write_msh2(knobs["mesh_path"], *j_gen.tokamak_mesh(24, 120))
    rec, state, fields = bench_torch.main(device="cpu", num_ptcls=3000, iters=2,
                                          **knobs)
    d = rec["detail"]
    assert d["tag"] == tag
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]["tag"] == tag
    assert 0.99 * 3000 < d["alive"] <= 3000 and d["all_found"]
    assert fields["fwd"].shape == (d["mesh_verts"],)
    assert ("rg" in state) == bool(knobs.get("gyro_ppr"))
    if tag == "dp-0M":                    # the analytic locate: no walk
        assert d["mesh_elems"] == 1980 and d["iters"] == 0
    env = {"BENCH_MESH": knobs["mesh_path"], "BENCH_ELEMS": "2000",
           "BENCH_BANDLOC": knobs.get("band_locator", "auto"),
           "BENCH_ANALYTIC": knobs.get("analytic_locate", "auto"),
           "BENCH_GYRO_PPR": "1" if knobs.get("gyro_ppr") else "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rec2, state2, _ = bench_torch.main(device="cpu", num_ptcls=3000, iters=2,
                                           verbose=False)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert rec2["detail"]["tag"] == tag
    assert torch.equal(state2["elem"], state["elem"])
