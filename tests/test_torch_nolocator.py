"""Parity of the port's locator-less FULL-mode step (``use_locator=False``:
the plain walk from each particle's previous element, kernel L's dense
plain walk on the card) with the JAX reference's, a numpy emulation of the
dense walk's schedule against the plain version, and kernel N's plain
versions (the picparts step's counts) against the JAX sums.

Tolerances: every compared output is an integer, a mask or a deposit of
multiples of 1/8, and must be equal; the setup's f32 angles within
rtol/atol 1e-6 (tests/test_torch_pseudo_xgcm.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pumipic_tpu.mesh import generate as j_gen
from pumipic_tpu.mesh.core import Mesh2D as JMesh2D
from pumipic_tpu.models import pseudo_xgcm as jx
from pumipic_tpu.ops import push as j_push
from pumipic_tpu.ops import search as j_se
from pumipic_tpu.parallel.mesh_axis import make_device_mesh
from pumipic_torch import interop
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.models import pseudo_xgcm as tx
from pumipic_torch.ops import counts as cn
from pumipic_torch.ops import search as t_se

N = 20_000
MAX_ITERS = 64
KW = dict(num_ptcls=N, mdl_face=8, deg_per_push=15.0, max_search_iters=MAX_ITERS,
          use_locator=False)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's locator-less setup on tokamak_mesh(16, 96) at 20k
    particles, and its parts as numpy for carrying across."""
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    jm = JMesh2D.from_arrays(coords, tris, cls)
    cfg = jx.XGCmConfig(band_locator="off", **KW)
    state, step = jx.make_dp_setup(jm, cfg, make_device_mesh(1))
    gmap, _ = jx.build_gyro_mappings(jm, cfg.gyro)
    return dict(raw=(coords, tris, cls), jm=jm, cfg=cfg, state=state, step=step,
                mesh_np={f: np.asarray(getattr(jm, f)) for f in interop.MESH_FIELDS},
                gmap=np.asarray(gmap),
                bands=j_push.detect_banded_class(np.asarray(jm.class_id)))


def test_setup_without_locator_matches_reference(ref):
    """``make_dp_setup(use_locator=False)`` builds no grid; its particles
    and the gyro map equal the reference's (the map's ring points within
    the bound of tests/test_torch_pseudo_xgcm.py)."""
    m = Mesh2D.from_arrays(*ref["raw"], device="cpu")
    state, step = tx.make_dp_setup(m, tx.XGCmConfig(**KW), "cpu")
    assert step.model.locator is None and step.model.analytic is None
    js = {k: np.asarray(v) for k, v in ref["state"].items()}
    for k in ("x0", "x1", "elem", "active"):
        np.testing.assert_array_equal(state[k].numpy(), js[k], err_msg=k)
    for k in ("cphi", "sphi"):
        np.testing.assert_allclose(state[k].numpy(), js[k], rtol=1e-6, atol=1e-6)
    fwd = step.model.gyro_fwd
    flat = tx.build_gyro_mappings(m, tx.XGCmConfig(**KW).gyro)[0]
    assert int((flat.numpy() != ref["gmap"]).sum()) <= 0.001 * flat.numel()
    assert fwd is step.model.gyro_bwd


def _j_targets(jstate, bands, cfg):
    """The reference step's push targets and origins (its banded path)."""
    elem, active = jstate["elem"], jstate["active"]
    cd, sd = j_push.rot_vals_from_class(
        j_push.class_from_bands(jnp.maximum(elem, 0), bands), cfg.deg_per_push)
    tx_, ty_, _, _ = j_push.elliptical_push_rot_vals(
        jstate["cphi"], jstate["sphi"], jstate["b"], cd, sd, cfg.h, cfg.k, cfg.d)
    return ((jstate["x0"], jstate["x1"]),
            (jnp.where(active, tx_, jstate["x0"]), jnp.where(active, ty_, jstate["x1"])))


def test_three_locator_less_steps_equal_reference(ref):
    """Three steps of the port's locator-less step from the reference's
    state and gyro map: element ids, active masks, the fields, and the
    search's iters and all_found (the reference's ``search_mesh_2d`` on the
    same targets) equal; no walker comes near the limit, so the
    reference's loop-limit recovery (ROADMAP queue 3) never acts."""
    cfg = tx.XGCmConfig(**KW)
    model, state = interop.from_reference(
        ref["mesh_np"], None, ref["gmap"], None, ref["bands"],
        {k: np.asarray(v) for k, v in ref["state"].items()}, cfg, device="cpu")
    assert model.locator is None
    step = tx.make_dp_step(model, cfg)
    js, jstep, jm = ref["state"], ref["step"], ref["jm"]
    for i in range(3):
        orig, xtgt = _j_targets(js, ref["bands"], ref["cfg"])
        jres = j_se.search_mesh_2d(jm, orig, xtgt, js["elem"], js["active"], MAX_ITERS)
        js, jf = jstep(js)
        jax.block_until_ready(jf)
        state, f = step(state)
        np.testing.assert_array_equal(state["elem"].numpy(), np.asarray(js["elem"]),
                                      err_msg=f"step {i}")
        np.testing.assert_array_equal(state["elem"].numpy(), np.asarray(jres.elem_ids))
        np.testing.assert_array_equal(state["active"].numpy(), np.asarray(js["active"]))
        for k in ("fwd", "bwd"):
            np.testing.assert_array_equal(f[k].numpy(), np.asarray(jf[k]), err_msg=k)
        assert int(f["iters"]) == int(jres.iters)
        assert bool(f["all_found"]) and bool(jres.all_found)
        assert 1 <= int(f["iters"]) < MAX_ITERS // 2


# ---------------------------------------------------------------------------
# the dense walk's schedule, emulated
# ---------------------------------------------------------------------------

def dense_walk_emulated(walk_geom, dx, dy, start, active, max_iters: int, lazy: bool):
    """Kernel L's dense plain walk as the card runs it, in numpy: a warp
    walks tiles of 32 consecutive slots, a lane a slot, in lockstep: each
    round every walking lane reads its row (with ``lazy`` the first 8
    columns, and the third exit only where it leaves across it) and steps;
    a walker stops inside, at an exposed side (removed) or at the budget
    (deleted).  Returns (elem, active, max steps, walkers deleted at the
    limit, the tiles' rounds, the row bytes read, each slot's steps)."""
    g = walk_geom.numpy()
    dx, dy = dx.numpy(), dy.numpy()
    n, E = dx.shape[0], g.shape[0]
    budget = max(max_iters, 0)
    out = np.full(n, -1, np.int32)
    steps_all = np.zeros(n, np.int64)
    unfinished, rounds, row_bytes = 0, 0, 0
    f32 = np.float32
    rel, ab = f32(t_se.BCC_REL_TOL), f32(t_se.BCC_ABS_TOL)
    for t0 in range(0, n, 32):
        idx = np.arange(t0, min(t0 + 32, n))          # the tile's slots, a lane each
        act = active.numpy()[idx]
        elem = np.where(act, np.clip(start.numpy()[idx], 0, E - 1), -1).astype(np.int64)
        done = ~act
        steps = np.zeros(idx.size, np.int64)
        while True:
            walk = ~done & (steps < budget)
            if not walk.any():
                break
            rounds += 1
            w = np.nonzero(walk)[0]
            row = g[elem[w], :9]
            a = [row[:, j] for j in range(6)]
            x, y = dx[idx[w]], dy[idx[w]]
            with np.errstate(invalid="ignore", over="ignore"):
                l1 = a[0] * x + a[1] * y + a[2]
                l2 = a[3] * x + a[4] * y + a[5]
                w0 = f32(1.0) - l1 - l2
                m1 = np.abs(a[0] * x) + np.abs(a[1] * y) + np.abs(a[2])
                m2 = np.abs(a[3] * x) + np.abs(a[4] * y) + np.abs(a[5])
                t1, t2 = rel * m1 + ab, rel * m2 + ab
                inside = (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)
                kmin = np.where(w0 <= l1, 0, 1)
                wmin = np.where(np.isnan(w0) | np.isnan(l1), np.nan, np.fmin(w0, l1))
                kmin = np.where(l2 < wmin, 2, kmin)
            steps[w] += 1
            leave = ~inside
            third = leave & (kmin == 2)
            row_bytes += w.size * 32 + (int(third.sum()) * 4 if lazy else w.size * 4)
            nxt = np.where(kmin == 0, row[:, 6], np.where(kmin == 1, row[:, 7],
                                                           row[:, 8])).astype(np.int64)
            elem[w] = np.where(inside, elem[w], nxt)
            done[w] = inside | (leave & (nxt == -1))
        unfinished += int((~done).sum())
        out[idx] = np.where(done, elem, -1)
        steps_all[idx] = steps
    return (out, out >= 0, int(steps_all.max(initial=0)), unfinished, rounds, row_bytes,
            steps_all)


def _walk_inputs(kind: str, n: int, seed: int):
    coords, tris, cls = j_gen.tokamak_mesh(16, 96)
    m = Mesh2D.from_arrays(coords, tris, cls, device="cpu")
    px_, py_, start = tx.gyro_ring_points(m, tx.GyroConfig())
    rng = np.random.default_rng(seed)
    reps = -(-n // px_.shape[0])
    dx, dy = px_.repeat(reps)[:n].clone(), py_.repeat(reps)[:n].clone()
    start = start.to(torch.int32).repeat(reps)[:n].clone()
    active = torch.as_tensor(rng.random(n) < 0.9)
    lo, hi = m.coords.amin(0).numpy(), m.coords.amax(0).numpy()
    if kind == "far":
        pts = torch.as_tensor((lo + (hi - lo) * rng.random((n, 2))).astype(np.float32))
        dx, dy = pts[:, 0].contiguous(), pts[:, 1].contiguous()
    elif kind == "nan":
        dx[::3] = float("nan")
    elif kind == "garbage":
        start = torch.as_tensor(rng.integers(-50, m.nelems + 50, n).astype(np.int32))
    return m, dx, dy, start, active


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("kind,max_iters", [("rings", 100), ("far", 100), ("rings", 1),
                                            ("nan", 100), ("garbage", 100), ("far", 0)])
def test_dense_walk_schedule_emulated_equals_plain(kind, max_iters, lazy):
    """The dense walk's schedule gives the plain walk's elements, masks,
    iters and all_found on ring points, far targets (budget 100 and 0),
    a budget of 1, NaN targets and starts out of range, reading the third
    exit only where a walker leaves across it or always; its rounds are the
    tiles' longest walks (``scripts/count_walk_steps.py``'s warp steps)."""
    n = 4_000 + 37
    m, dx, dy, start, active = _walk_inputs(kind, n, seed=len(kind) + max_iters)
    elem, act, steps, unf, rounds, row_bytes, each = dense_walk_emulated(
        m.walk_geom, dx, dy, start, active, max_iters, lazy)
    want = t_se.walk_locate_plain(m.walk_geom, dx, dy, start, active, max_iters)
    np.testing.assert_array_equal(elem, want[0].numpy())
    np.testing.assert_array_equal(act, want[1].numpy())
    assert steps == int(want[2]) and (unf == 0) == bool(want[3])
    tiles = np.pad(each, (0, -n % 32)).reshape(-1, 32)
    assert rounds == int(tiles.max(1).sum())
    lane_steps = int(each.sum())
    assert lane_steps * 32 <= row_bytes <= lane_steps * 36
    assert (row_bytes < lane_steps * 36) == (lazy and lane_steps > 0)
    if kind == "nan":
        assert unf > 0 and steps == max_iters
    if max_iters == 0:
        assert rounds == 0 and not act.any()


# ---------------------------------------------------------------------------
# kernel N's plain versions against the reference's sums
# ---------------------------------------------------------------------------

def test_slot_counts_plain_equals_reference_sums():
    """The step's and migrate's counts as N's plain version forms them equal
    the reference's ``jnp.sum`` of the same masks."""
    rng = np.random.default_rng(5)
    n = 10_007
    active = rng.random(n) < 0.8
    elem = rng.integers(-2, 40, n).astype(np.int32)
    e_gl = rng.integers(-1, 40, n).astype(np.int32)
    leaving, kept, wants = (rng.random(n) < p for p in (0.05, 0.01, 0.1))
    bucket = rng.integers(-1, 3, n).astype(np.int32)
    lost = np.int32(17)
    T = {k: torch.as_tensor(v) for k, v in dict(
        active=active, elem=elem, e_gl=e_gl, leaving=leaving, kept=kept, wants=wants,
        bucket=bucket).items()}
    removed = [("set", T["active"]), ("neg", T["elem"])]
    got = cn.slot_counts_plain(
        [[("set", T["active"])], removed + [("nonneg", T["e_gl"])],
         removed + [("neg", T["e_gl"])], removed],
        [None, None, None, torch.tensor(lost)])
    ja, je, jg = jnp.asarray(active), jnp.asarray(elem), jnp.asarray(e_gl)
    s32 = lambda m: int(jnp.sum(m.astype(jnp.int32)))  # noqa: E731
    j_lost = s32(ja & (jg >= 0) & (je < 0))
    want = [s32(ja), j_lost, s32(ja & (je < 0)) - j_lost, s32(ja & (je < 0)) - int(lost)]
    assert got.dtype == torch.int32 and got.tolist() == want
    mig = cn.slot_counts_plain(
        [[("clear", T["active"])], [("set", T["leaving"])], [("set", T["kept"])],
         [("set", T["wants"]), ("neg", T["bucket"])]], [None] * 4)
    jw, jb = jnp.asarray(wants), jnp.asarray(bucket)
    assert mig.tolist() == [n - s32(ja), s32(jnp.asarray(leaving)), s32(jnp.asarray(kept)),
                            s32(jw & (jb < 0))]


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_rank_stats_plain_equals_reference(R):
    """step_stats' reduction as N's plain version forms it equals the
    reference's psum / pmax and ``ptcl_imbalance`` (its f32 psum of the
    alive counts) where that sum is exact, and its imbalance is the exact
    sum rounded once beyond."""
    rng = np.random.default_rng(R)
    for hi in (0, 5, 2_000_000, 2**27):
        g = rng.integers(0, hi + 1, (R, 8)).astype(np.int32)
        g[:, 3] = rng.integers(0, 2, R)
        got = cn.rank_stats_plain(torch.as_tensor(g), 3)
        jg = jnp.asarray(g)
        sums = [int(jnp.sum(jg[:, i])) if i != 3 else int(jnp.max(jg[:, i]))
                for i in range(8)]
        n = jg[:, 0].astype(jnp.float32)
        total = jnp.sum(n)
        avg = total / R
        imb = np.float32(jnp.where(avg > 0, jnp.max(n) / avg, 1.0))
        assert got[:8].tolist() == sums
        got_imb = got[8:].view(torch.float32)[0].numpy()
        exact = np.float32(int(g[:, 0].astype(np.int64).sum())) / np.float32(R)
        want = np.float32(1.0) if exact <= 0 else np.float32(g[:, 0].max()) / exact
        assert got_imb.tobytes() == np.float32(want).tobytes()
        if int(g[:, 0].astype(np.int64).sum()) < 2**24:
            assert got_imb.tobytes() == imb.tobytes()
