"""Parity of the port's single-device pseudoXGCm app
(``pumipic_torch.models.pseudo_xgcm.PseudoXGCm``) with the JAX reference's,
of kernel P's phi mode with ``elliptical_push_components``, and of the
``search2d`` driver; the ``run()`` timing path; and the entry points'
device rule (no device and no CUDA: they raise).

Tolerances:
- the push's f32 x, y: 2.4e-7 absolute (two ulps at |x| ~ 1): the port
  takes cos/sin in f64 rounded to f32, XLA's CPU f32 cos/sin differ from
  that in the last bit; the angle (exact arithmetic, no libm) is equal;
- the app, compared particle by particle (by ``pid``, since one differing
  element id moves every later SCS slot): element ids and alive flags
  equal except where the destination lies within the containment
  tolerance of a side both elements share (counted, at most 5 per step);
  x and phi within 1e-6 (the jitted JAX step rounds phi's increment
  differently in the last bit); where no id differs, every structure array
  (slots, offsets, row maps), ``fwd``/``bwd`` and ``iters`` equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.models import search2d as j_search2d
from pumipic_tpu.ops import push as j_push
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.models import search2d as t_search2d
from pumipic_torch.ops import push as t_push
from pumipic_torch.ops import search as t_se
from pumipic_torch.utils import timing

N = 20_000
KW = dict(num_ptcls=N, deg_per_push=15.0, max_search_iters=64)
XY_TOL = 2.4e-7
STATE_TOL = 1e-6
STRUCT_ARRAYS = ("elem", "active", "num_ptcls", "overflowed", "elem_offsets",
                 "row_to_elem", "elem_to_row", "seg_cap")


# ---------------------------------------------------------------------------
# kernel P, phi mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["bands", "class"])
def test_push_phi_matches_reference_components(form):
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    rng = np.random.default_rng(2)
    n = 50_000
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    phi = rng.uniform(-3.2, 3.2, n).astype(np.float32)
    b = rng.uniform(0.1, 1.2, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    elem = rng.integers(-1, len(tris), n).astype(np.int32)
    cid = cls[np.maximum(elem, 0)].astype(np.int32)
    h, k, d, deg = 0.1, -0.05, 0.9, 15.0
    jxs, jys, jr = (np.asarray(a) for a in j_push.elliptical_push_components(
        jnp.asarray(phi), jnp.asarray(b), jnp.asarray(cid), deg, h, k, d))
    want_x = np.where(active, jxs, x[:, 0])
    want_y = np.where(active, jys, x[:, 1])
    want_phi = np.where(active, jr, phi)
    if form == "bands":
        bands = t_push.BandClasses.build(t_push.detect_banded_class(cls), "cpu")
        c = torch.from_numpy(elem)
    else:
        bands, c = None, torch.from_numpy(cid)
    tx_, ty_, xy, tphi = t_push.push_phi(
        torch.from_numpy(x), torch.from_numpy(phi), torch.from_numpy(b),
        torch.from_numpy(active), c, deg, h, k, d, bands=bands)
    np.testing.assert_array_equal(tphi.numpy(), want_phi)
    np.testing.assert_allclose(tx_.numpy(), want_x, rtol=0, atol=XY_TOL)
    np.testing.assert_allclose(ty_.numpy(), want_y, rtol=0, atol=XY_TOL)
    np.testing.assert_array_equal(xy.numpy(), np.stack([tx_.numpy(), ty_.numpy()], 1))
    # the stacked form
    jxy, jphi = j_push.elliptical_push(jnp.asarray(phi), jnp.asarray(b),
                                       jnp.asarray(cid), deg, h, k, d)
    txy, tphi2 = t_push.elliptical_push(torch.from_numpy(phi), torch.from_numpy(b),
                                        torch.from_numpy(cid), deg, h, k, d)
    assert txy.shape == (n, 2)
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=0, atol=XY_TOL)
    np.testing.assert_array_equal(tphi2.numpy(), np.asarray(jphi))


# ---------------------------------------------------------------------------
# the app against the JAX package's, from its carried structure
# ---------------------------------------------------------------------------

def _members(jps):
    out = {}
    for f in dataclasses.fields(jps):
        v = getattr(jps, f.name)
        if f.name in interop.STRUCTURE_STATIC:
            out[f.name] = v
        elif f.name == "fields":
            out[f.name] = {k: np.asarray(a) for k, a in v.items()}
        else:
            out[f.name] = None if v is None else np.asarray(v)
    return out


def _near_both_side(geom, e1, e2, x, y):
    """(x, y) within a loose multiple of the walk's containment tolerance of
    both elements."""
    for e in (e1, e2):
        r = geom[e]
        l1 = r[0] * x + r[1] * y + r[2]
        l2 = r[3] * x + r[4] * y + r[5]
        mag = sum(abs(v) for v in (r[0] * x, r[1] * y, r[2], r[3] * x, r[4] * y, r[5]))
        tol = 4 * (t_se.BCC_REL_TOL * mag + 2 * t_se.BCC_ABS_TOL)
        if min(l1, l2, 1.0 - l1 - l2) < -tol:
            return False
    return True


def _by_pid(ps, to_np):
    h = {k: to_np(v) for k, v in ps.fields.items()}
    act = to_np(ps.active)
    pid = h["pid"][act]
    o = np.argsort(pid)
    return (pid[o], to_np(ps.elem)[act][o], h["x"][act][o], h["phi"][act][o])


def _run_pair(raw, cfg_kw, steps=3):
    """Step the JAX app and the port's (from the JAX app's structure) and
    compare after each step."""
    jm = JMesh2D.from_arrays(*raw)
    japp = jx.PseudoXGCm(jm, jx.XGCmConfig(band_locator="off", **cfg_kw))
    tapp = tx.PseudoXGCm(Mesh2D.from_arrays(*raw, device="cpu"),
                         tx.XGCmConfig(**cfg_kw), device="cpu")
    tapp.ptcls = interop.structure_from_numpy(_members(japp.ptcls), device="cpu")
    geom = tapp.mesh.walk_geom.numpy().astype(np.float64)
    jps = japp.ptcls
    ties_total = 0
    for i in range(steps):
        jps, jf, jb, jit = japp._step(jps)
        tps, tf, tb, tit = tapp.step_fn(tapp.ptcls)
        tapp.ptcls = tps
        jp, je, jxx, jph = _by_pid(jps, np.asarray)
        tp, te, txx, tph = _by_pid(tps, lambda a: a.numpy())
        # alive particles and their elements, by pid
        common, ji, ti = np.intersect1d(jp, tp, return_indices=True)
        lost = len(jp) + len(tp) - 2 * len(common)
        bad = np.nonzero(je[ji] != te[ti])[0]
        ties = [p for p in bad
                if _near_both_side(geom, je[ji][p], te[ti][p], *txx[ti][p].astype(float))]
        assert len(ties) == len(bad), f"step {i}: unexplained element mismatches"
        assert len(bad) + lost <= 5, (i, len(bad), lost)
        ties_total += len(bad) + lost
        np.testing.assert_allclose(txx[ti], jxx[ji], rtol=0, atol=STATE_TOL)
        np.testing.assert_allclose(tph[ti], jph[ji], rtol=0, atol=STATE_TOL)
        if ties_total == 0:
            for k in STRUCT_ARRAYS:
                a, b = getattr(jps, k), getattr(tps, k)
                assert (a is None) == (b is None), k
                if a is not None:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{i} {k}")
            for k in ("pid", "b", "xtgt"):
                np.testing.assert_array_equal(tps.fields[k].numpy(),
                                              np.asarray(jps.fields[k]), err_msg=k)
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            assert int(tit) == int(jit)
        assert int(tps.num_ptcls) == int(tps.active.sum())
        assert not bool(tps.overflowed)
    return tapp, ties_total


@pytest.mark.parametrize("structure", ["scs", "csr", "cabm", "dps"])
def test_app_matches_reference_on_tokamak(structure):
    tapp, ties = _run_pair(j_gen.tokamak_mesh(16, 96),
                           dict(KW, mdl_face=8, structure=structure))
    assert tapp.locator is not None and tapp.analytic is None
    assert ties == 0          # none on this mesh at 20k particles


@pytest.mark.parametrize("structure", ["scs", "csr", "cabm", "dps"])
def test_app_matches_reference_on_annulus(structure):
    tapp, ties = _run_pair(j_gen.annulus_mesh(8, 48, 0.3, 1.0),
                           dict(KW, mdl_face=4, structure=structure))
    assert tapp.analytic is not None and tapp.locator is None


def test_app_takes_a_classification_that_is_not_band_ordered():
    """Class per particle gathered from ``mesh.class_id`` (P's class form),
    where make_dp_setup refuses the mesh."""
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    cls = cls[::-1].copy()
    tapp, _ = _run_pair((coords, tris, cls), dict(KW, mdl_face=8, structure="csr"),
                        steps=2)
    assert tapp.bands is None


def test_app_own_setup_matches_reference():
    raw = j_gen.tokamak_mesh(16, 96)
    cfg = dict(KW, mdl_face=8, structure="scs")
    japp = jx.PseudoXGCm(JMesh2D.from_arrays(*raw),
                         jx.XGCmConfig(band_locator="off", **cfg))
    tapp = tx.PseudoXGCm(Mesh2D.from_arrays(*raw, device="cpu"), tx.XGCmConfig(**cfg),
                         device="cpu")
    j, t = japp.ptcls, tapp.ptcls
    for k in STRUCT_ARRAYS:
        a, b = getattr(j, k), getattr(t, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=k)
    for k in ("x", "xtgt", "pid"):
        np.testing.assert_array_equal(t.fields[k].numpy(), np.asarray(j.fields[k]), err_msg=k)
    assert sorted(t.fields) == sorted(j.fields)
    # atan2/sin in the setup: torch's and XLA's libm (see
    # test_torch_pseudo_xgcm.test_setup_divergence_is_the_references_own_ill_conditioning)
    np.testing.assert_allclose(t.fields["phi"].numpy(), np.asarray(j.fields["phi"]),
                               rtol=0, atol=2.0 ** -21)
    jb = np.asarray(j.fields["b"])
    ok = np.abs(np.sin(np.asarray(j.fields["phi"]))) >= 0.5
    np.testing.assert_allclose(t.fields["b"].numpy()[ok], jb[ok], rtol=1e-6, atol=1e-6)


def test_app_run_records_timing_and_renders(tmp_path):
    raw = j_gen.tokamak_mesh(8, 32)
    app = tx.PseudoXGCm(Mesh2D.from_arrays(*raw, device="cpu"),
                        tx.XGCmConfig(num_ptcls=500, mdl_face=4,
                                      gyro=tx.GyroConfig(per_particle_radius=True)),
                        device="cpu")
    assert "rg" in app.ptcls.fields
    reg = timing.get_registry()
    before = reg.ops["xgcm step"].count if "xgcm step" in reg.ops else 0
    fwd, bwd = app.run(2, verbose=True, render_prefix=str(tmp_path / "xgcm"))
    assert reg.ops["xgcm step"].count == before + 2
    assert fwd.shape == (app.mesh.nverts,) and torch.isfinite(fwd).all()
    assert float(fwd.sum()) > 0
    for i in range(2):
        text = (tmp_path / f"xgcm_t{i}.vtk").read_text()
        assert "has_particles" in text and "gyro_bwd" in text
    assert "xgcm step" in timing.summarize_time(None)


def test_search2d_run_has_no_failures():
    raw = j_gen.disk_mesh(8, 8)
    assert j_search2d.run(JMesh2D.from_arrays(*raw), 500, seed=1) == 0
    assert t_search2d.run(Mesh2D.from_arrays(*raw, device="cpu"), 500, seed=1) == 0


def test_timing_and_memory_without_a_card():
    from pumipic_torch.utils import memory

    assert memory.get_mem_usage("cpu") == (0, 0)
    assert memory.memory_imbalance()["imbalance"] == 1.0
    with timing.timed("probe", block_on=torch.zeros(1), with_prebarrier=True):
        pass
    assert timing.get_registry().ops["probe"].count >= 1
    assert timing.prebarrier() >= 0.0


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def _raw():
    return j_gen.tokamak_mesh(8, 32)


def _entry_points():
    from pumipic_torch.mesh import locator as t_loc
    from pumipic_torch.ops import scatter as t_sc
    from pumipic_torch.particles import CSR, DPS, CabM, SellCSigma
    from pumipic_torch.particles.structure import create_member_fields

    cfg = tx.XGCmConfig(num_ptcls=300, mdl_face=4)
    coords, tris, cls = _raw()
    elems = np.arange(20) % 5
    return {
        "Mesh2D.from_arrays": lambda m: Mesh2D.from_arrays(coords, tris, cls),
        "make_default_mesh": lambda m: tx.make_default_mesh(2000),
        "make_dp_setup": lambda m: tx.make_dp_setup(m, cfg),
        "initial_state": lambda m: tx.initial_state(m, cfg),
        "PseudoXGCm": lambda m: tx.PseudoXGCm(m, cfg),
        "build_locator_grid": lambda m: t_loc.build_locator_grid(coords, tris),
        "detect_annulus_structured": lambda m: t_loc.detect_annulus_structured(coords, tris),
        "GyroMap.from_flat": lambda m: t_sc.GyroMap.from_flat(
            np.full(m.nverts * 3, -1), m.nverts, 1, 1),
        "SellCSigma": lambda m: SellCSigma(5, elems),
        "CSR": lambda m: CSR(5, elems),
        "CabM": lambda m: CabM(5, elems),
        "DPS": lambda m: DPS(5, elems),
        "create_member_fields": lambda m: create_member_fields(4, {}),
        "state_from_numpy": lambda m: interop.state_from_numpy({}),
        "BandClasses.build": lambda m: t_push.BandClasses.build((1, 3)),
    }


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_entry_points_raise_without_a_device_and_cuda(entry, monkeypatch):
    """With no device named and no CUDA device, an entry point raises
    (telling the caller to pass device="cpu") rather than running on the
    CPU."""
    mesh = Mesh2D.from_arrays(*_raw(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points()[entry](mesh)
