"""Parity of the port's GITR-style app (``pumipic_torch.models.gitr_like``)
and of pseudoPushAndSearch's reflecting wall with the JAX reference.

Both apps seed from the same numpy Generator calls, so the initial states
are bit-identical.  Over 5 steps on a box of 384 tets with a non-zero E grid
(N(0, 0.2) V/m, the bench's field), B = 1.3e-3 T and dt = 2e-5 s (a step of
about one tet edge): the alive history, element ids and ``wall_hits`` are
equal (ids but for counted shared-face ties); positions atol 1e-5 and
velocities rtol 1e-4 of |v|, because XLA contracts some of the field sum's
and the push's products into FMAs (an ulp) and the specular velocity
divides by the last leg's length, which turns a position ulp into a larger
velocity one.  Kernel F's plain version (the step's update after the
walk) against the JAX step's expressions: positions, masks and which
particles bounce equal, velocities within V_RTOL.  pseudoPushAndSearch
with the reflecting wall: every structure array, position and pid equal.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh3D as JMesh3D
from pumipic_tpu.models import gitr_like as jg
from pumipic_tpu.models import pseudo_push_and_search as jp
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh3D
from pumipic_torch.models import gitr_like as tg
from pumipic_torch.models import pseudo_push_and_search as tp
from pumipic_torch.ops import push as t_push
from pumipic_torch.ops import search as t_se

X_ATOL, V_RTOL = 1e-5, 1e-4


def _field(seed=2, n=5):
    rng = np.random.default_rng(seed)
    grid = rng.normal(0, 0.2, (n, n, n, 3)).astype(np.float32)
    return grid, np.zeros(3, np.float32), np.full(3, 1.0 / (n - 1), np.float32)


def _pair(wall, num_ptcls=3000, **kw):
    raw = j_gen.box_tet_mesh(4, 4, 4)
    grid, o, h = _field()
    cfg = dict(num_ptcls=num_ptcls, num_iterations=5, dt=2e-5, b_field=(0.0, 0.0, 1.3e-3),
               wall=wall, max_search_iters=100, **kw)
    ja = jg.GitrLike(JMesh3D.from_arrays(*raw), jg.GitrConfig(**cfg),
                     e_grid=jnp.asarray(grid), e_origin=o, e_spacing=h, seed=3)
    ta = tg.GitrLike(Mesh3D.from_arrays(*raw, device="cpu"), tg.GitrConfig(**cfg),
                     e_grid=grid, e_origin=o, e_spacing=h, seed=3, device="cpu")
    return ja, ta


def _ties(ta, je, te, x):
    """Element ids equal but where both tets contain the point (counted)."""
    bad = np.nonzero(je != te)[0]
    if bad.size:
        d = torch.from_numpy(x[bad]).unbind(1)
        for e in (je[bad], te[bad]):
            assert (e >= 0).all()
            rows = ta.mesh.walk_geom[torch.from_numpy(e).long()]
            assert bool(t_se.bary_inside_3d(rows[:, :12].unbind(1), *d)[4].all())
    return bad.size


@pytest.mark.parametrize("wall", ["absorb", "reflect"])
def test_gitr_matches_reference(wall):
    ja, ta = _pair(wall)
    for k in ("x", "v", "elem", "active"):
        np.testing.assert_array_equal(ta.state[k].numpy(), np.asarray(ja.state[k]))
    ties = 0
    for i in range(5):
        hj, ht = ja.run(1), ta.run(1)
        assert hj == ht, (i, hj, ht)
        s = {k: (np.asarray(ja.state[k]), ta.state[k].numpy()) for k in ja.state}
        np.testing.assert_array_equal(s["active"][1], s["active"][0])
        ties += _ties(ta, s["elem"][0], s["elem"][1], s["x"][1])
        np.testing.assert_allclose(s["x"][1], s["x"][0], rtol=0, atol=X_ATOL)
        vmag = np.linalg.norm(s["v"][0], axis=1, keepdims=True)
        assert (np.abs(s["v"][1] - s["v"][0]) <= V_RTOL * vmag).all(), i
        np.testing.assert_array_equal(ta.wall_hits.numpy(), np.asarray(ja.wall_hits))
    assert ties <= 3
    alive = int(ta.state["active"].sum())
    hits = float(ta.wall_hits.sum())
    if wall == "absorb":
        # each lost particle counts once, on its exit face
        assert 0 < alive < 3000 and hits == 3000 - alive
    else:
        assert alive == 3000 and hits > 0
    exposed = ta.mesh.side_is_exposed
    assert not bool((ta.wall_hits[~exposed] != 0).any())


def test_gitr_config_and_interop_match_reference():
    assert {f.name: f.default for f in dc.fields(tg.GitrConfig)} == \
        {f.name: f.default for f in dc.fields(jg.GitrConfig)}
    ja, _ = _pair("reflect", num_ptcls=500)
    ja.run(2)
    grid, o, h = _field()
    jm = ja.mesh
    tb = interop.gitr_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in interop.MESH3D_FIELDS},
        tg.GitrConfig(**dc.asdict(ja.cfg)), np.asarray(ja.e_grid), np.asarray(ja.e_origin),
        np.asarray(ja.e_spacing), {k: np.asarray(v) for k, v in ja.state.items()},
        np.asarray(ja.wall_hits), device="cpu")
    assert tb.state["elem"].dtype == torch.int32 and tb.state["active"].dtype == torch.bool
    hj, ht = ja.run(2), tb.run(2)
    assert hj == ht
    np.testing.assert_allclose(tb.state["x"].numpy(), np.asarray(ja.state["x"]), atol=X_ATOL)
    np.testing.assert_array_equal(tb.wall_hits.numpy(), np.asarray(ja.wall_hits))


def test_gitr_default_field_and_device():
    """Without an E grid the field is zero on a 2x2x2 grid over the box, as
    the reference sets it; without a device the app needs the card."""
    raw = j_gen.box_tet_mesh(3, 3, 3)
    cfg = dict(num_ptcls=200, num_iterations=3, dt=5e-10, b_field=(0.0, 0.0, 0.5))
    ja = jg.GitrLike(JMesh3D.from_arrays(*raw), jg.GitrConfig(**cfg), seed=5)
    ta = tg.GitrLike(Mesh3D.from_arrays(*raw, device="cpu"), tg.GitrConfig(**cfg), seed=5,
                     device="cpu")
    for a, b in ((ta.e_grid, ja.e_grid), (ta.e_origin, ja.e_origin),
                 (ta.e_spacing, ja.e_spacing)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ja.run() == ta.run()
    np.testing.assert_array_equal(ta.wall_hits.numpy(), np.asarray(ja.wall_hits))
    with pytest.raises(ValueError, match="e_spacing"):
        tg.GitrLike(Mesh3D.from_arrays(*raw, device="cpu"), tg.GitrConfig(**cfg),
                    e_grid=np.zeros((2, 2, 2, 3)), device="cpu")
    with pytest.raises(ValueError, match="wall"):
        tg.GitrLike(Mesh3D.from_arrays(*raw, device="cpu"),
                    tg.GitrConfig(wall="stick", **cfg), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tg.GitrLike(Mesh3D.from_arrays(*raw, device="cpu"), tg.GitrConfig(**cfg))


def test_gitr_reflect_reflects_velocity():
    """The reference's regression (tests/test_models.py): a zero-field
    particle aimed at the +x wall of the unit box comes back with v_x < 0,
    |v| unchanged and inside the box, and moves away from the wall next."""
    raw = j_gen.box_tet_mesh(3, 3, 3)
    mesh = Mesh3D.from_arrays(*raw, device="cpu")
    cfg = tg.GitrConfig(num_ptcls=4, num_iterations=1, dt=5e-4, b_field=(0.0, 0.0, 0.0),
                        wall="reflect")
    app = tg.GitrLike(mesh, cfg, seed=1, device="cpu")
    start = np.array([0.7, 0.52, 0.47], np.float32)
    cz, ev = mesh.coords.numpy(), mesh.elem2verts.numpy()
    vv = cz[ev]
    T = np.stack([vv[:, 1] - vv[:, 0], vv[:, 2] - vv[:, 0], vv[:, 3] - vv[:, 0]], axis=-1)
    lam = np.linalg.solve(T, np.broadcast_to(start - vv[:, 0], (len(ev), 3))[..., None])[..., 0]
    bc = np.concatenate([1 - lam.sum(-1, keepdims=True), lam], axis=-1)
    e0 = int(np.argmax(bc.min(axis=-1)))
    assert bc[e0].min() > -1e-6
    v0 = np.array([1000.0, 0.0, 0.0], np.float32)        # hits x = 1 mid-step
    app.state = {
        "x": torch.from_numpy(np.tile(start, (4, 1))),
        "v": torch.from_numpy(np.tile(v0, (4, 1))),
        "elem": torch.full((4,), e0, dtype=torch.int32),
        "active": torch.ones(4, dtype=torch.bool),
    }
    assert app.run() == [4]
    v1, x1 = app.state["v"].numpy(), app.state["x"].numpy()
    assert (v1[:, 0] < 0).all(), v1
    np.testing.assert_allclose(np.linalg.norm(v1, axis=1), np.linalg.norm(v0), rtol=1e-5)
    assert (x1[:, 0] <= 1.0 + 1e-5).all()
    app.run(1)
    assert (app.state["x"].numpy()[:, 0] < x1[:, 0]).all()
    # one reflection each, on an exposed face of the +x wall
    hit = torch.nonzero(app.wall_hits).flatten()
    assert float(app.wall_hits.sum()) == 4.0 and bool(mesh.side_is_exposed[hit].all())
    fx = mesh.coords[mesh.face2verts[hit].long()][..., 0]
    assert bool((fx == 1.0).all())


# ---------------------------------------------------------------------------
# kernel F's plain version (the step's update after the walk)
# ---------------------------------------------------------------------------

def _jax_update(x, v, v_new, dest, hit, elem, num_hits, active, reflect):
    """The JAX package's step between the walk and the tally
    (``pumipic_tpu/models/gitr_like.py:119-141``), on jnp arrays."""
    x, v, v_new, dest, hit = (jnp.asarray(a) for a in (x, v, v_new, dest, hit))
    elem, num_hits, active = (jnp.asarray(a) for a in (elem, num_hits, active))
    lost = active & (elem < 0)
    if reflect:
        leg = jnp.stack([d - h for d, h in zip(dest.T, hit.T)], axis=-1)
        leg_n = jnp.linalg.norm(leg, axis=-1, keepdims=True)
        v_spec = (jnp.linalg.norm(v_new, axis=-1, keepdims=True)
                  * leg / jnp.maximum(leg_n, 1e-30))
        bounced = (active & (elem >= 0) & (num_hits > 0) & (leg_n[:, 0] > 1e-30))
        v_new = jnp.where(bounced[:, None], v_spec, v_new)
    return (jnp.where(lost[:, None], x, dest), jnp.where(active[:, None], v_new, v),
            active & (elem >= 0), lost)


def _update_inputs(n, seed):
    """Active and inactive particles, lost ones (element -1), hit counts 0
    to 3, last legs of zero (the destination on the hit point), of 1e-12
    and of ~1e-2, N(0, 1e3) velocities."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.uniform(0, 1, (n, 3)).astype(f)
    v = rng.normal(0, 1e3, (n, 3)).astype(f)
    v_new = rng.normal(0, 1e3, (n, 3)).astype(f)
    dest = rng.uniform(0, 1, (n, 3)).astype(f)
    pick = rng.random(n)[:, None]
    leg = np.where(pick < 0.1, 0.0, np.where(pick < 0.2, 1e-12, 1e-2)) * rng.normal(
        size=(n, 3))
    hit = (dest - leg.astype(f)).astype(f)
    elem = np.where(rng.random(n) < 0.1, -1, rng.integers(0, 50, n)).astype(np.int32)
    num_hits = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 4, n)).astype(np.int32)
    active = rng.random(n) < 0.8
    return x, v, v_new, dest, hit, elem, num_hits, active


@pytest.mark.parametrize("reflect", [False, True])
def test_gitr_update_plain_matches_reference(reflect):
    """Kernel F's plain version against the JAX step's expressions: x,
    active and lost equal; v within V_RTOL of |v| (XLA's norm may round its
    sum otherwise), the particles that bounced the same."""
    args = _update_inputs(5000, 9 + reflect)
    want = _jax_update(*args, reflect)
    got = t_push.gitr_update(*(torch.as_tensor(a) for a in args), reflect)
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(bool): torch.bool}[np.asarray(w).dtype]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    vj = np.asarray(want[1])
    vmag = np.linalg.norm(vj, axis=1, keepdims=True)
    assert (np.abs(got[1].numpy() - vj) <= V_RTOL * vmag).all()
    # which particles took the specular velocity
    vn = args[2]
    np.testing.assert_array_equal((got[1].numpy() != vn).any(1), (vj != vn).any(1))
    if reflect:
        kept = args[7] & (args[5] >= 0)
        moved = kept & (args[6] > 0) & (np.abs(args[3] - args[4]).max(1) > 0)
        act = args[7]
        assert ((vj != vn).any(1)[act] == moved[act]).all() and moved.sum() > 1000
        # speed conserved where reflected
        np.testing.assert_allclose(np.linalg.norm(got[1].numpy()[moved], axis=1),
                                   np.linalg.norm(vn[moved], axis=1), rtol=1e-5)
    else:
        assert not (vj[args[7]] != vn[args[7]]).any()


def test_gitr_update_threshold_is_the_f32_rounding_of_1e_30():
    """The specular update clamps and compares |leg| with 1e-30: torch and
    JAX both take its f32 rounding on an f32 array, so f32(1e-30) itself is
    not above it (the f64 constant would be below it) and the next f32 up
    is; kernel F is given that constant."""
    f = np.float32
    t = f(1e-30)
    vals = np.array([np.nextafter(t, f(0)), t, np.nextafter(t, f(1))], f)
    want = [False, False, True]
    assert (torch.as_tensor(vals) > 1e-30).tolist() == want
    assert np.asarray(jnp.asarray(vals) > 1e-30).tolist() == want
    assert t_push.GITR_TINY == float(t) and float(t) > 1e-30
    np.testing.assert_array_equal(torch.clamp(torch.as_tensor(vals), min=1e-30).numpy(),
                                  np.asarray(jnp.maximum(jnp.asarray(vals), 1e-30)))


# ---------------------------------------------------------------------------
# pseudoPushAndSearch's reflecting wall
# ---------------------------------------------------------------------------

STRUCT_ARRAYS = ("elem", "active", "num_ptcls", "overflowed", "elem_offsets",
                 "row_to_elem", "elem_to_row", "seg_cap")


@pytest.mark.parametrize("use_locator", [True, False])
@pytest.mark.parametrize("structure", ["dps", "scs"])
def test_pps_reflect_matches_reference(structure, use_locator):
    """Three steps of the reference's app and the port's with the
    reflecting wall (the walk always: the analytic locate cannot reflect;
    with the locator, kernel M's peel form): structures, x and pid equal."""
    raw = j_gen.box_tet_mesh(4, 4, 4)
    kw = dict(num_ptcls=4000, structure=structure, wall="reflect", kuhn="auto",
              max_search_iters=64, distance=0.2, use_locator=use_locator)
    japp = jp.PseudoPushAndSearch(JMesh3D.from_arrays(*raw), jp.PushSearchConfig(**kw))
    tapp = tp.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device="cpu"),
                                  tp.PushSearchConfig(**kw), device="cpu")
    assert tapp.kuhn is None and (tapp.locator is not None) == use_locator
    jps, tps = japp.ptcls, tapp.ptcls
    for i in range(3):
        jps, jit = japp._step(jps)
        tps, tit = tapp.step_fn(tps)
        assert int(tit) == int(jit)
        for k in STRUCT_ARRAYS:
            a, b = getattr(jps, k), getattr(tps, k)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{i} {k}")
        for k in ("x", "pid"):
            np.testing.assert_array_equal(tps.fields[k].numpy(), np.asarray(jps.fields[k]),
                                          err_msg=f"{i} {k}")
    x = tps.get("x")[tps.active]
    assert bool(((x >= -1e-5) & (x <= 1 + 1e-5)).all())
