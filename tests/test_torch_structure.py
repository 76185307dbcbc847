"""Parity of the port's particle structures (pumipic_torch.particles) with
the JAX reference (pumipic_tpu.particles) in all four layouts.

Both packages are built from the same seeded numpy inputs (the reference's
test fixture: 25 elements, 200 particles) and driven through the same
rebuilds.  Tolerance: none.  Structures are integer and bit moves, so every
array (slot elements, mask, counts, flags, offsets, row maps, per-element
caps) and every field must be equal, slot for slot.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumipic_tpu import particles as J
from pumipic_tpu.particles import structure as JS
from pumipic_torch import interop
from pumipic_torch import particles as T
from pumipic_torch.particles import structure as TS

E = 25
N = 200


def _layouts(m, device_kw):
    return {
        "scs_c4": lambda e, f, **kw: m.SellCSigma(
            E, e, fields=f, scs_input=m.SCSInput(chunk_size=4, sigma=None),
            **device_kw, **kw),
        "scs_c8_s8": lambda e, f, **kw: m.SellCSigma(
            E, e, fields=f, scs_input=m.SCSInput(chunk_size=8, sigma=8),
            **device_kw, **kw),
        "scs_c3_s5": lambda e, f, **kw: m.SellCSigma(
            E, e, fields=f, scs_input=m.SCSInput(chunk_size=3, sigma=5),
            **device_kw, **kw),
        "csr": lambda e, f, **kw: m.CSR(E, e, fields=f, **device_kw, **kw),
        "cabm": lambda e, f, **kw: m.CabM(E, e, fields=f, **device_kw, **kw),
        "cabm_w16": lambda e, f, **kw: m.CabM(E, e, fields=f, soa_width=16,
                                              **device_kw, **kw),
        "dps": lambda e, f, **kw: m.DPS(E, e, fields=f, **device_kw, **kw),
    }


J_BUILD = _layouts(J, {})
T_BUILD = _layouts(T, {"device": "cpu"})


def _fixture(strategy="gaussian", seed=3):
    ppe, elems = J.distribute.distribute_particles(E, N, strategy, seed=seed)
    pos = np.random.default_rng(1).normal(size=(N, 3)).astype(np.float32)
    fields = {"pos": pos, "val": np.zeros((N, 3), np.float32),
              "pid": np.arange(N, dtype=np.int32)}
    return ppe, elems, fields


def _j(fields):
    return {k: jnp.asarray(v) for k, v in fields.items()}


def _t(fields):
    return {k: torch.as_tensor(v) for k, v in fields.items()}


def _pair(name, strategy="gaussian", **kw):
    ppe, elems, fields = _fixture(strategy)
    return J_BUILD[name](elems, _j(fields), **kw), T_BUILD[name](elems, _t(fields), **kw)


def assert_same(j, t, tag=""):
    """Every member of the JAX structure equals the port's."""
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "fields":
            assert sorted(a) == sorted(b), tag
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                              err_msg=f"{tag} field {k}")
        elif f.name in interop.STRUCTURE_STATIC:
            assert a == b, (tag, f.name)
        elif a is None or b is None:
            assert a is None and b is None, (tag, f.name)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{tag} {f.name}")


def _cur(j):
    return np.where(np.asarray(j.active), np.asarray(j.elem), -1).astype(np.int32)


def _churn(j, move_frac, seed=11, remove_frac=0.0, concentrate=None):
    r = np.random.default_rng(seed)
    cur = _cur(j)
    new = cur.copy()
    mv = (r.random(j.capacity) < move_frac) & (cur >= 0)
    new[mv] = concentrate if concentrate is not None else r.integers(0, E, mv.sum())
    if remove_frac:
        new[(r.random(j.capacity) < remove_frac) & (cur >= 0)] = -1
    return new


def _swap_churn(j, frac, seed=11):
    """Count-preserving churn: the reshuffle fits in any layout."""
    r = np.random.default_rng(seed)
    cur = _cur(j)
    new = cur.copy()
    live = np.flatnonzero(cur >= 0)
    k = max(2, int(len(live) * frac)) // 2 * 2
    sel = r.choice(live, size=k, replace=False)
    a, b = sel[:k // 2], sel[k // 2:]
    new[a], new[b] = cur[b], cur[a]
    return new


def _rebuild_both(j, t, new_elem, add=None, mode="sort"):
    if add is None:
        return (j.rebuild(jnp.asarray(new_elem), mode=mode),
                t.rebuild(torch.as_tensor(new_elem), mode=mode))
    ae, af = add
    return (j.rebuild(jnp.asarray(new_elem), jnp.asarray(ae), _j(af), mode=mode),
            t.rebuild(torch.as_tensor(new_elem), torch.as_tensor(ae), _t(af), mode=mode))


LAYOUTS = list(J_BUILD)


@pytest.mark.parametrize("strategy", ["gaussian", "exponential", "gitrm"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_build_equals_reference(name, strategy):
    j, t = _pair(name, strategy)
    assert_same(j, t, f"{name} {strategy}")
    assert t.n_ptcls() == N and t.num_rows() == j.num_rows()
    np.testing.assert_array_equal(t.ppe().numpy(), np.asarray(j.ppe()))


def _add_batch(n, first_pid, elems):
    return (np.asarray(elems, np.int32),
            {"pos": np.full((n, 3), 7.0, np.float32),
             "val": np.zeros((n, 3), np.float32),
             "pid": np.arange(first_pid, first_pid + n, dtype=np.int32)})


@pytest.mark.parametrize("variant", ["same", "shift", "remove_half", "out_of_range",
                                     "add", "empty_refill", "churn3"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_rebuild_equals_reference(name, variant):
    kw = {"capacity": 2 * N} if name in ("csr", "dps") else {}
    j, t = _pair(name, **kw)
    cur = _cur(j)
    pid = np.asarray(j.get("pid"))
    if variant == "same":
        steps = [(cur, None)]
    elif variant == "shift":
        steps = [(np.where(cur >= 0, (cur + 1) % E, -1).astype(np.int32), None)]
    elif variant == "remove_half":
        steps = [(np.where(pid % 2 == 0, cur, -1).astype(np.int32), None)]
    elif variant == "out_of_range":
        r = np.random.default_rng(4)
        bad = np.where(r.random(cur.shape) < 0.2, r.integers(E, E + 5, cur.shape), cur)
        steps = [(bad.astype(np.int32), None)]
    elif variant == "add":
        # additions include an out-of-range and a negative element
        steps = [(cur, _add_batch(16, N, list(np.arange(14) % E) + [E + 2, -1]))]
    elif variant == "empty_refill":
        empty = np.full_like(cur, -1)
        steps = [(empty, None), (empty, _add_batch(50, 0, np.arange(50) % E))]
    else:
        steps = [(None, None)] * 3
    for i, (ne, add) in enumerate(steps):
        if ne is None:
            ne = _churn(j, 0.2, seed=i, remove_frac=0.05)
        j, t = _rebuild_both(j, t, ne, add)
        assert_same(j, t, f"{name} {variant} step {i}")
    assert int(t.num_ptcls) == int(t.active.sum())


@pytest.mark.parametrize("strategy", ["evenly", "proportionally", "inversely"])
def test_scs_auto_reshuffle_and_fallback_equal_reference(strategy, monkeypatch):
    """mode="auto" on SCS with each pad strategy: a count-preserving churn
    (reshuffle), random churn, and a concentrated churn that cannot fit
    (fallback to the sort); each step equals the reference."""
    calls = []
    real = TS._reshuffle
    monkeypatch.setattr(TS, "_reshuffle", lambda *a: calls.append(1) or real(*a))
    scs = dict(chunk_size=8, sigma=8, extra_padding=0.4, pad_strategy=strategy)
    ppe, elems, fields = _fixture()
    j = J.SellCSigma(E, elems, fields=_j(fields), scs_input=J.SCSInput(**scs))
    t = T.SellCSigma(E, elems, fields=_t(fields), scs_input=T.SCSInput(**scs),
                     device="cpu")
    assert_same(j, t, "build")
    for i, ne in enumerate([_swap_churn(j, 0.12), None, None]):
        if ne is None:
            ne = _churn(j, 0.15, seed=i) if i == 1 else _churn(j, 0.8, concentrate=3)
        j, t = _rebuild_both(j, t, ne, mode="auto")
        assert_same(j, t, f"{strategy} step {i}")
    assert calls, "the reshuffle branch did not run"


def test_cabm_auto_reshuffle_and_fallback_equal_reference(monkeypatch):
    calls = []
    real = TS._reshuffle
    monkeypatch.setattr(TS, "_reshuffle", lambda *a: calls.append(1) or real(*a))
    ppe, elems, fields = _fixture()
    j = J.CabM(E, elems, fields=_j(fields), soa_width=16, extra_padding=0.3)
    t = T.CabM(E, elems, fields=_t(fields), soa_width=16, extra_padding=0.3,
               device="cpu")
    for i in range(4):
        ne = (_swap_churn(j, 0.1, seed=5) if i == 0 else
              _churn(j, 0.8, concentrate=2) if i == 3 else _churn(j, 0.1, seed=i))
        j, t = _rebuild_both(j, t, ne, mode="auto")
        assert_same(j, t, f"cabm auto step {i}")
    assert calls


def test_reshuffle_mover_budget_fallback_equals_reference(monkeypatch):
    monkeypatch.setattr(JS, "RESHUFFLE_MOVER_FRACTION", 1e-9)
    monkeypatch.setattr(TS, "RESHUFFLE_MOVER_FRACTION", 1e-9)
    ppe, elems, fields = _fixture()
    scs = dict(chunk_size=8, extra_padding=0.5)
    j = J.SellCSigma(E, elems, fields=_j(fields), scs_input=J.SCSInput(**scs))
    t = T.SellCSigma(E, elems, fields=_t(fields), scs_input=T.SCSInput(**scs),
                     device="cpu")
    ne = _churn(j, 0.3)
    j2, t2 = _rebuild_both(j, t, ne, mode="auto")
    assert_same(j2, t2, "budget fallback")


@pytest.mark.parametrize("name", LAYOUTS)
def test_get_pids_metrics_and_migrate_equal_reference(name):
    j, t = _pair(name)
    for a, b in zip(j.get_pids(), t.get_pids()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jm, tm = j.metrics(), t.metrics()
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    assert t.print_format(8) == j.print_format(8)
    t.print_metrics()
    procs = (np.asarray(j.get("pid")) % 2).astype(np.int32)
    cur = _cur(j)
    assert_same(j.migrate(jnp.asarray(cur), jnp.asarray(procs)),
                t.migrate(torch.as_tensor(cur), torch.as_tensor(procs)), "migrate")
    ht, hj = t.copy_to_host(), j.copy_to_host()
    assert ht.keys() == hj.keys()
    for k in hj:
        np.testing.assert_array_equal(ht[k], np.asarray(hj[k]), err_msg=k)


@pytest.mark.parametrize("name", ["csr", "dps", "cabm", "scs_c4"])
def test_overflow_sticky_checked_and_grow_equal_reference(name):
    kw = {"capacity": max(N + 8, 208)} if name in ("csr", "dps") else {}
    j, t = _pair(name, **kw)
    cur = _cur(j)
    add = _add_batch(64, N, np.zeros(64))
    j2, t2 = _rebuild_both(j, t, cur, add)
    assert bool(t2.overflowed)
    assert_same(j2, t2, "overflowed rebuild")
    # sticky through a fitting rebuild
    j3, t3 = _rebuild_both(j2, t2, _cur(j2))
    assert bool(t3.overflowed)
    assert_same(j3, t3, "sticky")
    # rebuild_checked retries from the pre-rebuild state on a grown structure
    j4 = JS.rebuild_checked(j, jnp.asarray(cur), jnp.asarray(add[0]), _j(add[1]))
    t4 = TS.rebuild_checked(t, torch.as_tensor(cur), torch.as_tensor(add[0]), _t(add[1]))
    assert not bool(t4.overflowed) and t4.n_ptcls() == N + 64
    assert_same(j4, t4, "rebuild_checked")
    # on the flagged structure THIS call is lossless: history kept
    j5 = JS.rebuild_checked(j3, j3.elem)
    t5 = TS.rebuild_checked(t3, t3.elem)
    assert bool(t5.overflowed)
    assert_same(j5, t5, "rebuild_checked, sticky")
    # grow_if_overflowed acknowledges the loss and clears the flag
    j6, t6 = JS.grow_if_overflowed(j3), TS.grow_if_overflowed(t3)
    assert not bool(t6.overflowed) and t6.capacity > t3.capacity
    assert_same(j6, t6, "grow")
    assert TS.grow_if_overflowed(t6) is t6


@pytest.mark.parametrize("name", LAYOUTS)
def test_empty_structure_equals_reference(name):
    fields = {"pos": np.zeros((0, 3), np.float32), "val": np.zeros((0, 3), np.float32),
              "pid": np.zeros(0, np.int32)}
    j = J_BUILD[name](np.zeros(0, np.int64), _j(fields))
    t = T_BUILD[name](np.zeros(0, np.int64), _t(fields))
    assert_same(j, t, name)
    assert t.n_ptcls() == 0 and int(t.metrics()["num_ptcls"]) == 0


def test_field_spec_and_reserved_names():
    spec_j = {"w": ((2,), jnp.float32), "tag": ((), jnp.int32)}
    spec_t = {"w": ((2,), torch.float32), "tag": ((), torch.int32)}
    elems = np.arange(40) % 7
    assert_same(J.CSR(7, elems, field_spec=spec_j),
                T.CSR(7, elems, field_spec=spec_t, device="cpu"), "field_spec")
    with pytest.raises(ValueError, match="reserved"):
        T.CSR(4, np.zeros(8, np.int64), field_spec={"elem": ((), torch.int32)},
              device="cpu")
    with pytest.raises(ValueError, match="reserved"):
        T.DPS(4, np.zeros(8, np.int64), fields={"active": torch.zeros(8)},
              device="cpu")


def test_bool_field_moves_outside_kernel_g_equal_reference():
    """A 1-byte field rides torch indexing (the JAX package gathers it per
    field, outside its 4-byte pack); the result is the same."""
    ppe, elems, fields = _fixture()
    flag = (np.arange(N) % 3 == 0)
    j = J.SellCSigma(E, elems, fields=dict(_j(fields), flag=jnp.asarray(flag)))
    t = T.SellCSigma(E, elems, fields=dict(_t(fields), flag=torch.as_tensor(flag)),
                     device="cpu")
    assert_same(j, t, "bool field")
    j2, t2 = _rebuild_both(j, t, _churn(j, 0.3))
    assert_same(j2, t2, "bool field rebuild")


@pytest.mark.parametrize("strategy", ["evenly", "proportionally", "inversely"])
def test_host_layout_sizing_equals_reference(strategy):
    ppe, _, _ = _fixture("exponential")
    for chunk, sigma in ((4, 2**30), (8, 8), (3, 5)):
        assert TS.scs_layout_size(ppe, chunk, sigma, 0.3, strategy) == \
            JS.scs_layout_size(ppe, chunk, sigma, 0.3, strategy)
    np.testing.assert_array_equal(
        TS._scs_pad_counts(ppe.astype(np.int64), 0.3, strategy),
        JS._scs_pad_counts(ppe.astype(np.int64), 0.3, strategy, np_mod=np))
    np.testing.assert_array_equal(
        TS._scs_pad_counts(torch.as_tensor(ppe.astype(np.int32)), 0.3, strategy).numpy(),
        np.asarray(JS._scs_pad_counts(jnp.asarray(ppe.astype(np.int32)), 0.3, strategy)))


def test_structure_interop_roundtrip():
    j, t = _pair("scs_c4")
    members = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    members = {k: (v if k in interop.STRUCTURE_STATIC else
                   {a: np.asarray(b) for a, b in v.items()} if k == "fields" else
                   None if v is None else np.asarray(v)) for k, v in members.items()}
    carried = interop.structure_from_numpy(members, device="cpu")
    assert_same(j, carried, "from_numpy")
    back = interop.structure_to_numpy(carried)
    assert_same(j, interop.structure_from_numpy(back, device="cpu"), "roundtrip")
