"""Parity of kernels Y1-Y3's plain versions (``pumipic_torch.ops.route``)
with the JAX package: Y1's three forms against ``set_unsafe_procs``,
``route_particles``, ``route_decode`` with the [g2l | route] gather and
``banded_decode``; Y2 against ``repartition``'s weight keys and counts; Y3
(with X1's ranks) against ``select_particles``; and the picparts steps (2D
and 3D, two gloo CPU ranks) calling the wrappers.  Every output is an
integer or a mask: equal, element for element."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pumipic_tpu.mesh import generate as jgen
from pumipic_tpu.mesh.locator import detect_annulus_structured as jdetect
from pumipic_tpu.parallel import balancer as jlb
from pumipic_tpu.parallel import banded_route as jbr
from pumipic_tpu.parallel import migrate as jmig
from pumipic_tpu.parallel import picparts as jpp
from pumipic_torch.mesh.locator import detect_annulus_structured
from pumipic_torch.ops import exchange as ex
from pumipic_torch.ops import route as rt
from pumipic_torch.parallel import balancer as tlb
from pumipic_torch.parallel import banded_route as tbr
from pumipic_torch.parallel import group
from pumipic_torch.parallel import migrate as tmig
from pumipic_torch.parallel import picparts as tpp

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = (1, 2, 4, 7, 8)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _element_tables(rng, E: int, R: int, S: int, sbars: bool):
    safe = rng.random(E) < 0.6
    owner = rng.integers(0, R, E).astype(np.int32)
    sbar = (np.where(rng.random(E) < 0.7, rng.integers(0, S, E), -1).astype(np.int32)
            if sbars else None)
    return safe, owner, sbar


def _slots(rng, N: int, E: int):
    elem = np.where(rng.random(N) < 0.85, rng.integers(0, E, N), -1).astype(np.int32)
    active = rng.random(N) < 0.9
    return elem, active


def _jax_route(safe, owner, sbar, R):
    return jmig.pack_route(jnp.asarray(safe), jnp.asarray(owner),
                           None if sbar is None else jnp.asarray(sbar), R)


# ---------------------------------------------------------------------------
# Y1, packed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sbars", [True, False])
@pytest.mark.parametrize("R", RANKS)
def test_route_packed_matches_jax(R, sbars):
    rng = np.random.default_rng(100 + R)
    E, N, S = 700, 5000, 23
    safe, owner, sbar = _element_tables(rng, E, R, S, sbars)
    elem, active = _slots(rng, N, E)
    route = tmig.pack_route(torch.as_tensor(safe), torch.as_tensor(owner),
                            None if sbar is None else torch.as_tensor(sbar), R)
    jroute = _jax_route(safe, owner, sbar, R)
    _eq(route.numpy(), jroute)
    for me in sorted({0, R - 1, R // 2}):
        got = rt.route_packed(route, torch.as_tensor(elem), torch.as_tensor(active), me, R)
        assert got.elem is None and got.gelem is None
        jdest, jsbar, jnc = jmig.route_particles(jroute, jnp.asarray(elem),
                                                 jnp.asarray(active), jnp.int32(me), R)
        _eq(got.dest, jdest, "dest")
        _eq(got.sbar, jsbar, "sbar")
        _eq(got.noncore, jnc, "noncore")
        _eq(got.live, active & (elem >= 0), "live")
        # set_unsafe_procs' destinations, the balancer's sbar and owner gathers
        _eq(got.dest, jmig.set_unsafe_procs(jnp.asarray(safe), jnp.asarray(owner),
                                            jnp.asarray(elem), jnp.asarray(active),
                                            jnp.int32(me)), "set_unsafe_procs")
        ok = active & (elem >= 0)
        e = np.maximum(elem, 0)
        _eq(got.sbar, np.where(ok, sbar[e], -1) if sbars else np.full(N, -1), "sbar gather")
        _eq(got.noncore, ok & (owner[e] != me), "owner gather")
        # the port's route_particles is the packed form
        _eq(torch.stack(tmig.route_particles(route, torch.as_tensor(elem),
                                             torch.as_tensor(active), me, R)[:2]),
            torch.stack([got.dest, got.sbar]))


# ---------------------------------------------------------------------------
# Y1, g2l form
# ---------------------------------------------------------------------------

def _g2l_table(rng, E_g: int, E: int, route_words: np.ndarray):
    g2l = np.full(E_g, -1, np.int64)
    held = rng.choice(E_g, E, replace=False)
    g2l[held] = np.arange(E)
    tbl = np.zeros((E_g, 2), np.int32)
    tbl[:, 0] = g2l
    tbl[held, 1] = route_words[g2l[held]]
    return tbl


def _jax_g2l(tbl, e_gl, active, me, R):
    """The JAX step's g2l route (pumipic_tpu/models/pseudo_xgcm.py:1113-1154)."""
    g_row = jnp.asarray(tbl)[jnp.maximum(jnp.asarray(e_gl), 0)]
    lid = jnp.where(jnp.asarray(e_gl) >= 0, g_row[:, 0], -1)
    ok = jnp.asarray(active) & (lid >= 0)
    dest, sbar, nc = jmig.route_decode(g_row[:, 1].astype(jnp.float32), ok, jnp.int32(me), R)
    gelem = jnp.where(lid >= 0, jnp.asarray(e_gl), -1)
    return lid, ok, dest, sbar, nc, gelem


@pytest.mark.parametrize("sbars", [True, False])
@pytest.mark.parametrize("R", RANKS)
def test_route_g2l_matches_jax(R, sbars):
    rng = np.random.default_rng(200 + R)
    E_g, E, N, S = 3000, 900, 5000, 31
    safe, owner, sbar = _element_tables(rng, E, R, S, sbars)
    words = np.asarray(_jax_route(safe, owner, sbar, R)).astype(np.int64)
    tbl = _g2l_table(rng, E_g, E, words)
    e_gl, active = _slots(rng, N, E_g)
    for me in sorted({0, R - 1}):
        got = rt.route_g2l(torch.as_tensor(tbl), torch.as_tensor(e_gl),
                           torch.as_tensor(active), me, R)
        want = _jax_g2l(tbl, e_gl, active, me, R)
        for name, g, w in zip(("elem", "live", "dest", "sbar", "noncore", "gelem"),
                              (got.elem, got.live, got.dest, got.sbar, got.noncore, got.gelem),
                              want):
            _eq(g, w, name)
        assert rt.route_g2l(torch.as_tensor(tbl), torch.as_tensor(e_gl),
                            torch.as_tensor(active), me, R, gelem=False).gelem is None


def test_route_decode_at_the_pack_bound():
    """Just under pack_route's 2^24 bound (the largest sbar count R = 7
    allows, the top sbar, safe, owner R - 1) the f32 decode equals the JAX
    package's and the integer decode; above the bound (route words of the
    g2l row past 2^24, which f32 rounds) it still equals the JAX package's
    and parts from integer division, as the kernel's f32 arithmetic must."""
    R = 7
    S = 1
    while tmig.route_pack_bound_ok(S + 1, R):
        S += 1
    assert not tmig.route_pack_bound_ok(S + 1, R)
    E = 64
    rng = np.random.default_rng(5)
    safe = np.ones(E, bool)
    safe[::3] = False
    owner = np.arange(E, dtype=np.int32) % R
    sbar = (S - 1 - np.arange(E) % 5).astype(np.int32)
    route = tmig.pack_route(torch.as_tensor(safe), torch.as_tensor(owner),
                            torch.as_tensor(sbar), R)
    assert float(route.max()) < 2 ** 24 and float(route.max()) > 2 ** 24 - 16 * R
    elem = rng.integers(0, E, 400).astype(np.int32)
    active = np.ones(400, bool)
    for me in range(R):
        got = rt.route_packed(route, torch.as_tensor(elem), torch.as_tensor(active), me, R)
        want = jmig.route_particles(_jax_route(safe, owner, sbar, R), jnp.asarray(elem),
                                    jnp.asarray(active), jnp.int32(me), R)
        for g, w in zip((got.dest, got.sbar, got.noncore), want):
            _eq(g, w)
        v = route.numpy().astype(np.int64)[elem]
        own_i, t_i = v % R, v // R
        _eq(got.sbar, t_i // 2 - 2, "integer sbar")
        _eq(got.dest, np.where(t_i % 2 == 1, me, own_i), "integer dest")
    # above the bound: even words in [2^22·R, 2^25) with v mod R = R - 1
    # (exact in f32), whose quotient's ulp 0.5 rounds up past the integer
    v = np.arange(R * 2 ** 22, 2 ** 25, dtype=np.int64)
    v = v[(v % R == R - 1) & (v % 2 == 0)][::1009][:256]
    assert len(v) == 256
    tbl = np.stack([np.arange(len(v)), v], axis=1).astype(np.int32)
    e_gl = np.arange(len(v), dtype=np.int32)
    act = np.ones(len(v), bool)
    got = rt.route_g2l(torch.as_tensor(tbl), torch.as_tensor(e_gl), torch.as_tensor(act),
                       0, R)
    want = _jax_g2l(tbl, e_gl, act, 0, R)
    _eq(got.dest, want[2])
    _eq(got.sbar, want[3])
    _eq(got.noncore, want[4])
    t_f = np.floor(v.astype(np.float32) / np.float32(R))
    assert (t_f.astype(np.int64) != v // R).all()
    # v // R is even there (v = 14m + 6): the integer decode reads the
    # element unsafe and sends the particle to owner R - 1, the f32 one
    # reads it safe and keeps it home
    assert ((v // R) % 2 == 0).all()
    _eq(got.dest, np.zeros(len(v), np.int32))


# ---------------------------------------------------------------------------
# Y1, banded form
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=RANKS)
def banded(request):
    R = request.param
    Nr, Ns = 5, 8 * max(R, 2)
    coords, tris, cls = jgen.annulus_mesh(Nr, Ns, 0.3, 1.0)
    owners = jbr.sector_band_owners(Nr, Ns, R)
    jp = jpp.build_picparts(coords, tris, owners, R, jpp.PicPartsInput(), cls)
    tp = tpp.build_picparts(coords, tris, owners, R, tpp.PicPartsInput(), cls)
    ja = jdetect(coords, tris, cls=cls)
    ta = detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    out = {}
    for sbars in (True, False):
        jbt = jlb.build_balancer(jp, R) if sbars and R > 1 else None
        tbt = tlb.build_balancer(tp, R) if sbars and R > 1 else None
        jb = jbr.derive_banded_route(jp, owners, ja, jbt, R)
        tb = tbr.derive_banded_route(tp, owners, ta, tbt, R)
        assert jb is not None and tb is not None
        assert tb.sbar_runs == jb.sbar_runs
        out[sbars] = (jb, tb)
    return R, Nr, Ns, out


@pytest.mark.parametrize("sbars", [True, False])
def test_route_banded_matches_jax(banded, sbars):
    R, Nr, Ns, tabs = banded
    jb, tb = tabs[sbars]
    if sbars and R > 1:
        assert tb.sbar_runs
    rng = np.random.default_rng(300 + R)
    N = 6000
    e_gl = np.where(rng.random(N) < 0.9, rng.integers(0, 2 * Nr * Ns, N), -1).astype(np.int32)
    active = rng.random(N) < 0.9
    e = np.maximum(e_gl, 0)
    parts = [jnp.asarray(a.astype(np.float32)) for a in (e // (2 * Ns), (e // 2) % Ns, e % 2)]
    for me in sorted({0, R - 1, R // 2}):
        got = rt.route_banded(tb.params(me), torch.as_tensor(e_gl), torch.as_tensor(active))
        sc = [jnp.float32(v) for v in (jb.win_a[me], jb.win_w[me], jb.win_w0[me],
                                         jb.win_nsa[me], jb.safe_a[me], jb.safe_len[me])]
        lid, dest, sbar, nc = jbr.banded_decode(jb, *parts, jnp.asarray(e_gl >= 0),
                                                jnp.asarray(active), jnp.int32(me), *sc)
        _eq(got.elem, lid, "lid")
        _eq(got.dest, dest, "dest")
        _eq(got.sbar, sbar, "sbar")
        _eq(got.noncore, nc, "noncore")
        lid = np.asarray(lid)
        _eq(got.live, active & (lid >= 0), "live")
        _eq(got.gelem, np.where(lid >= 0, e_gl, -1), "gelem")
        # the port's banded_decode is the banded form on the element id
        tl = tbr.banded_decode(tb, *(torch.as_tensor(np.array(p)) for p in parts),
                               torch.as_tensor(e_gl >= 0), torch.as_tensor(active), me,
                               *tb.scalars(me))
        for g, w in zip(tl, (got.elem, got.dest, got.sbar, got.noncore)):
            _eq(g, w)


def test_route_banded_refuses_too_many_runs():
    p = rt.BandedParams(0, 2, 4, (0.0,) * 6,
                        tuple((i, i + 1, 0) for i in range(rt.Y1_MAX_RUNS + 1)))
    with pytest.raises(ValueError):
        rt.route_banded(p, torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Y2, the balancer's keys
# ---------------------------------------------------------------------------

def _balance_inputs(rng, N: int, R: int, S: int, me: int):
    dest = np.where(rng.random(N) < 0.7, me, rng.integers(0, R, N)).astype(np.int32)
    sbar = np.where(rng.random(N) < 0.75, rng.integers(0, S, N), -1).astype(np.int32)
    live = rng.random(N) < 0.85
    sbar = np.where(live, sbar, -1).astype(np.int32)
    noncore = live & (rng.random(N) < 0.3)
    return dest, sbar, live, noncore


@pytest.mark.parametrize("noncore", [True, False])
@pytest.mark.parametrize("R", [2, 4, 7])
def test_balance_keys_match_jax_weights(R, noncore):
    """Y2's keys, counted by X1, give repartition's movable and fixed
    weights (pumipic_tpu/parallel/balancer.py:375-393); its candidates'
    key ranks as select_particles' key does."""
    rng = np.random.default_rng(400 + R)
    N, S = 4000, 9
    for me in range(R):
        dest, sbar, live, nc = _balance_inputs(rng, N, R, S, me)
        k = rt.balance_keys(torch.as_tensor(dest), torch.as_tensor(sbar),
                            torch.as_tensor(live), torch.as_tensor(nc) if noncore else None,
                            me, S, R)
        staying = jnp.asarray(live & (dest == me))
        leaving = jnp.asarray(live & (dest != me))
        jsb = jnp.asarray(sbar)
        keys = jnp.where(staying & (jsb >= 0), jsb, S)
        w_local = jax.ops.segment_sum(jnp.ones_like(keys, jnp.float32), keys,
                                      num_segments=S + 1)[:S]
        forced = jax.ops.segment_sum(jnp.ones_like(keys, jnp.float32),
                                     jnp.where(leaving, jnp.asarray(dest), R),
                                     num_segments=R + 1)[:R]
        immovable = jnp.sum((staying & (jsb < 0)).astype(jnp.float32))
        _eq(ex.key_counts(k.weights, S).to(torch.float32), w_local, "w_local")
        _eq(ex.key_counts(k.forced, R).to(torch.float32), forced, "forced")
        assert k.immovable.dtype == torch.int32 and k.immovable.dim() == 0
        assert float(k.immovable) == float(immovable)
        cand = staying & (jsb >= 0)
        if noncore:
            jkey = jnp.where(cand, jsb * 2 + (~jnp.asarray(nc)).astype(jnp.int32), 2 * S)
            K = 2 * S
        else:
            jkey, K = jnp.where(cand, jsb, S), S
        _eq(k.candidates, jkey, "candidates' key")
        _eq(ex.rank_in_key(k.candidates, K)[0], jlb.rank_within_key(jkey, K), "ranks")


# ---------------------------------------------------------------------------
# Y3, the selection
# ---------------------------------------------------------------------------

MEMBERS = ((0, 1, 2), (0, 3), (1, 2, 3), (0, 1, 2, 3))   # sbar -> ranks


def _tables(mod):
    """Four sbars over 4 ranks: several edges of one sbar out of a rank."""
    R = 4
    edges = [(s, a, b) for s, mem in enumerate(MEMBERS) for a in mem for b in mem if a != b]
    edges.sort(key=lambda e: (e[1], e[0]))
    per = [[i for i, e in enumerate(edges) if e[1] == r] for r in range(R)]
    Pmax = max(len(p) for p in per)
    my = np.full((R, Pmax), -1, np.int64)
    for r, idx in enumerate(per):
        my[r, :len(idx)] = idx
    e = np.asarray(edges, np.int64)
    conv = (lambda a: jnp.asarray(a, jnp.int32)) if mod is jlb else (
        lambda a: np.asarray(a, np.int32))
    return mod.BalancerTables(conv(np.zeros((R, 4))), conv(e[:, 0]), conv(e[:, 1]),
                              conv(e[:, 2]), conv(my), len(MEMBERS), len(edges))


def _flows(kind: str, P: int, rng):
    if kind == "zero":
        return np.zeros(P, np.int32)
    if kind == "large":          # more than any sbar's candidates
        return rng.integers(500, 3000, P).astype(np.int32)
    f = rng.integers(0, 60, P).astype(np.int32)
    f[rng.random(P) < 0.4] = 0   # zero-flow edges among the others
    return f


@pytest.mark.parametrize("kind", ["mixed", "zero", "large"])
@pytest.mark.parametrize("noncore", [True, False])
def test_select_particles_matches_jax(noncore, kind):
    rng = np.random.default_rng(500)
    tb, jb = _tables(tlb), _tables(jlb)
    N, R, S = 3000, 4, len(MEMBERS)
    flows = _flows(kind, tb.num_edges, rng)
    for me in range(R):
        dest, sbar, live, nc = _balance_inputs(rng, N, R, S, me)
        cand = live & (dest == me)
        got = tlb.select_particles(tb, torch.as_tensor(flows), torch.as_tensor(sbar),
                                   torch.as_tensor(cand), torch.as_tensor(dest), me,
                                   torch.as_tensor(nc) if noncore else None)
        want = jlb.select_particles(jb, jnp.asarray(flows), jnp.asarray(sbar),
                                    jnp.asarray(cand), jnp.asarray(dest), jnp.int32(me),
                                    jnp.asarray(nc) if noncore else None)
        _eq(got, want, f"rank {me}")
        if kind != "zero":
            assert (got.numpy() != dest).any()


@pytest.mark.parametrize("kind", ["mixed", "zero", "large"])
@pytest.mark.parametrize("noncore", [True, False])
def test_balance_select_on_y2_keys_matches_jax(noncore, kind):
    """repartition's selection: Y2's candidates' key, X1's ranks, Y3."""
    rng = np.random.default_rng(600)
    tb, jb = _tables(tlb), _tables(jlb)
    N, R, S = 3000, 4, len(MEMBERS)
    flows = _flows(kind, tb.num_edges, rng)
    for me in range(R):
        dest, sbar, live, nc = _balance_inputs(rng, N, R, S, me)
        tnc = torch.as_tensor(nc) if noncore else None
        keys = rt.balance_keys(torch.as_tensor(dest), torch.as_tensor(sbar),
                               torch.as_tensor(live), tnc, me, S, R)
        e_dst, cumsum, base, total = tlb._edge_intervals(tb, torch.as_tensor(flows), me, "cpu")
        K = 2 * S if noncore else S
        rank, counts = ex.rank_in_key(keys.candidates, K)
        got = rt.balance_select(keys.candidates, rank, counts, torch.as_tensor(dest), e_dst,
                                cumsum, base, total, S, noncore)
        want = jlb.select_particles(jb, jnp.asarray(flows), jnp.asarray(sbar),
                                    jnp.asarray(live & (dest == me)), jnp.asarray(dest),
                                    jnp.int32(me), jnp.asarray(nc) if noncore else None)
        _eq(got, want, f"rank {me}")


# ---------------------------------------------------------------------------
# the steps call the wrappers
# ---------------------------------------------------------------------------

def test_picparts_steps_call_the_route_wrappers():
    """Every step of each picparts arm routes through one form of Y1 and,
    the balancer on, through Y2 and Y3 once (two gloo CPU ranks)."""
    steps = 2
    out = group.launch("torch_ranks:route_spy_rank", 2, {"steps": steps}, timeout=300,
                       backend="gloo", device="cpu", extra_paths=[HERE])
    forms = {"2d walk": "route_packed", "2d banded": "route_banded", "2d g2l": "route_g2l",
             "3d kuhn": "route_g2l", "3d walk": "route_packed"}
    for r, arms in enumerate(out):
        assert set(arms) == set(forms)
        for arm, calls in arms.items():
            want = {k: 0 for k in calls}
            want.update({forms[arm]: steps, "balance_keys": steps, "balance_select": steps})
            assert calls == want, (r, arm, calls)
