"""Rank-side halves of tests/test_torch_comm.py, test_torch_picparts.py and
test_torch_balancer.py.  Each ``*_rank`` function runs inside every rank
of a gloo CPU group started by ``pumipic_torch.parallel.group.launch`` and
returns plain data; the scenario builders are numpy and shared with the
JAX side of the tests.  Imports no JAX."""
import numpy as np
import torch

LAYOUTS = ("dps", "csr", "cabm", "scs")
REDUCE_OPS = ("SUM", "MAX", "MIN", "BCAST")


# ---------------------------------------------------------------------------
# scenario builders (numpy; the same inputs for both packages)
# ---------------------------------------------------------------------------

def synthetic_tables(R: int):
    """The JAX comm test's two-rank ownership embedded in R ranks: entity 0
    owned by rank 0 with a copy on rank 1, entity 1 the reverse; ranks 2..
    hold nothing.  (send_ids, recv_ids, field), each (R, ...)."""
    send = np.full((R, R, 1), -1, np.int32)
    recv = np.full((R, R, 1), -1, np.int32)
    send[0, 1, 0] = send[1, 0, 0] = 1
    recv[0, 1, 0] = recv[1, 0, 0] = 0
    field = np.zeros((R, 2), np.float32)
    field[0] = [10.0, 2.0]
    field[1] = [20.0, 5.0]
    return send, recv, field


def reduce_fields(counts, seed: int = 0):
    """Per dimension (0, 1, 2) a float field (R, N) of small integers plus
    halves and an int field; a (R, N, 3) vector field for vertices.
    ``counts[d]``: (R,) local entity counts; padding is 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for d, cnt in counts.items():
        n = int(max(cnt))
        f = (rng.integers(-40, 40, (len(cnt), n)) / 2.0).astype(np.float32)
        i = rng.integers(-1000, 1000, (len(cnt), n)).astype(np.int32)
        for r, c in enumerate(cnt):
            f[r, c:] = 0
            i[r, c:] = 0
        out[d] = (f, i)
    v = (rng.integers(-9, 9, (len(counts[0]), int(max(counts[0])), 3)) / 4.0
         ).astype(np.float32)
    for r, c in enumerate(counts[0]):
        v[r, c:] = 0
    out["vec"] = v
    return out


def migrate_inputs(elem_gid, elem_safe, elem_owner, n: int = 64, seed: int = 1,
                   illegal: bool = False):
    """Stacked (R, n) particle state (x f32, pid i32, J (2, 2) f32, flag
    bool, elem, active) and the post-search elements and destinations:
    ~80% of the slots active in random valid local elements (5% lost),
    each sent to its element's owner where the element is unsafe, and with
    ``illegal`` 5% sent to a random rank instead."""
    rng = np.random.default_rng(seed)
    R = elem_gid.shape[0]
    st = {"x": rng.normal(size=(R, n)).astype(np.float32),
          "pid": np.arange(R * n, dtype=np.int32).reshape(R, n),
          "J": rng.normal(size=(R, n, 2, 2)).astype(np.float32),
          "flag": rng.random((R, n)) < 0.5,
          "elem": np.full((R, n), -1, np.int32),
          "active": rng.random((R, n)) < 0.8}
    new_elem = np.full((R, n), -1, np.int32)
    dest = np.tile(np.arange(R, dtype=np.int32)[:, None], (1, n))
    for r in range(R):
        E = int((elem_gid[r] >= 0).sum())
        e = rng.integers(0, E, n).astype(np.int32)
        st["elem"][r] = np.where(st["active"][r], e, -1)
        ne = np.where(rng.random(n) < 0.05, -1, e)
        new_elem[r] = np.where(st["active"][r], ne, -1)
        ok = st["active"][r] & (new_elem[r] >= 0)
        go = ok & ~elem_safe[r][np.maximum(new_elem[r], 0)]
        dest[r] = np.where(go, elem_owner[r][np.maximum(new_elem[r], 0)], r)
        if illegal:
            flip = ok & (rng.random(n) < 0.05)
            dest[r] = np.where(flip, rng.integers(0, R, n), dest[r])
    return st, new_elem, dest


def structure_inputs(elem_gid, elem_safe, R: int):
    """Per rank: 8 particles in safe and 8 in unsafe elements (the JAX
    layout test's), with pos (n, 2) and pid."""
    out, pid = [], 0
    for r in range(R):
        safe_l = np.nonzero(elem_safe[r] & (elem_gid[r] >= 0))[0]
        unsafe_l = np.nonzero(~elem_safe[r] & (elem_gid[r] >= 0))[0]
        sl = np.concatenate([safe_l[:8], unsafe_l[:8]]).astype(np.int64)
        pids = np.arange(pid, pid + len(sl), dtype=np.int32)
        pos = np.stack([pids.astype(np.float32), pids.astype(np.float32) * 2 + 1], axis=1)
        out.append((sl, pos, pids))
        pid += len(sl)
    return out


STRUCT_CAP = {"dps": 64, "csr": 64, "cabm": 256, "scs": 64}


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def _me():
    from pumipic_torch.parallel import group

    return group.rank(), group.num_ranks()


def comm_rank() -> dict:
    """The collectives, and reduce_comm_array on the synthetic tables."""
    from pumipic_torch.parallel import group
    from pumipic_torch.parallel import reduce as red

    me, R = _me()
    out = {}
    rows = torch.arange(R * 3, dtype=torch.int32).reshape(R, 3) + 100 * me
    out["a2a"] = group.world_all_to_all(rows)
    out["gather"] = group.all_gather(torch.tensor([me, 2 * me], dtype=torch.int32))
    out["sum"] = group.all_sum(torch.tensor([float(me), 1.0]))
    nxt, prv = (me + 1) % R, (me - 1) % R
    send = torch.tensor([[me, nxt]], dtype=torch.int32)
    out["ragged"] = group.ragged_all_to_all(
        send, [1 if p == nxt else 0 for p in range(R)],
        [1 if p == prv else 0 for p in range(R)])
    s, r, f = synthetic_tables(R)
    for op in REDUCE_OPS:
        out[op] = red.reduce_comm_array(torch.as_tensor(s[me]), torch.as_tensor(r[me]),
                                        torch.as_tensor(f[me]), red.Op[op])
    return out


def _picparts(coords, tris, cls, R, dim=2):
    from pumipic_torch.parallel import picparts as ppm

    owners = ppm.partition_rcb(coords, tris, R)
    return owners, ppm.build_picparts(coords, tris, owners, R, ppm.PicPartsInput(),
                                      cls)


def _migrate_case(lpp, st, new_elem, dest, cap, plan, me, R):
    from pumipic_torch.parallel import migrate as mig

    state = {k: torch.as_tensor(v[me]) for k, v in st.items()}
    res = mig.migrate(state, torch.as_tensor(new_elem[me]), torch.as_tensor(dest[me]),
                      lpp.elem_gid, lpp.elem_gid_sorted, lpp.elem_gid_perm, me, R,
                      cap, plan=plan)
    return {"state": res.state, **{k: getattr(res, k) for k in res._fields if k != "state"}}


def picparts_rank(coords, tris, cls, fields, mig_cases, struct_layouts,
                  shrink_cap, step_cfgs, coords3, tets, cfg3s) -> dict:
    """Reductions on every dimension, migrations (world and neighbour,
    tight caps, illegal destinations, tensor fields), the structures'
    migration in each layout, the capacity shrink, and the 2D and 3D
    steps; every result of this rank."""
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.parallel import distributor as dstm
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import reduce as red
    from pumipic_torch.particles import CSR, DPS, CabM, SCSInput, SellCSigma
    from pumipic_torch.parallel.capacity import CapacityMonitor
    from pumipic_torch.models.pseudo_xgcm import shrink_picparts_capacity

    me, R = _me()
    owners, pp = _picparts(coords, tris, cls, R)
    lpp = pp.local_view(me, "cpu")
    plan = mig.build_neighbor_plan(dstm.from_picparts(pp))
    out = {"reduce": {}, "migrate": {}, "struct": {}, "step": [], "step3d": []}
    for d in (0, 1, 2):
        send, recv = lpp.comm_ids(d)
        n = lpp.comm_array_size(d)
        f, i = fields[d]
        for op in REDUCE_OPS:
            out["reduce"][(d, op)] = red.reduce_comm_array(
                send, recv, torch.as_tensor(f[me][:n]), red.Op[op])
        out["reduce"][(d, "MAXint")] = red.reduce_comm_array(
            send, recv, torch.as_tensor(i[me][:n]), red.Op.MAX)
    send, recv = lpp.comm_ids(0)
    out["reduce"][(0, "SUMvec")] = red.reduce_comm_array(
        send, recv, torch.as_tensor(fields["vec"][me][:lpp.comm_array_size(0)]),
        red.Op.SUM)

    for name, (st, ne, de, cap, neighbor) in mig_cases.items():
        out["migrate"][name] = _migrate_case(lpp, st, ne, de, cap,
                                             plan if neighbor else None, me, R)

    E_l = pp.nelems
    builders = {
        "dps": lambda e, f, c: DPS(E_l, e, fields=f, capacity=c, device="cpu"),
        "csr": lambda e, f, c: CSR(E_l, e, fields=f, capacity=c, device="cpu"),
        "cabm": lambda e, f, c: CabM(E_l, e, fields=f, capacity=c, soa_width=8,
                                     device="cpu"),
        "scs": lambda e, f, c: SellCSigma(E_l, e, fields=f, capacity=c,
                                          scs_input=SCSInput(chunk_size=4, sigma=8),
                                          device="cpu"),
    }
    sl, pos, pids = structure_inputs(pp.elem_gid, pp.elem_safe, R)[me]
    for layout in struct_layouts:
        for neighbor in (False, True):
            ps = builders[layout](sl, {"pos": torch.as_tensor(pos),
                                       "pid": torch.as_tensor(pids)}, STRUCT_CAP[layout])
            dest = mig.set_unsafe_procs(lpp.elem_safe, lpp.elem_owner, ps.elem,
                                        ps.active, me)
            ps2, res = mig.migrate_structure(ps, ps.elem, dest, lpp.elem_gid,
                                             lpp.elem_gid_sorted, lpp.elem_gid_perm,
                                             me, R, 32, plan=plan if neighbor else None)
            h = ps2.copy_to_host()
            h["elem_offsets"] = ps2.elem_offsets
            h["row_to_elem"] = ps2.row_to_elem
            h["overflowed"] = ps2.overflowed
            out["struct"][(layout, neighbor)] = (h, {k: getattr(res, k) for k in res._fields
                                                     if k != "state"})

    st, ne, de, cap, _ = mig_cases["world"]
    # the JAX package's resize takes (R, cap) fields only
    state = {k: torch.as_tensor(v[me]) for k, v in st.items() if v.ndim == 2}
    out["shrink"] = shrink_picparts_capacity(state, shrink_cap)
    out["grow"] = shrink_picparts_capacity(state, st["x"].shape[1] + 8)

    for kw in step_cfgs:
        cfg = px.XGCmConfig(**kw["cfg"], gyro=px.GyroConfig(**kw["gyro"]))
        lp, s, _, step = px.make_picparts_setup(coords, tris, cls, cfg, device="cpu",
                                                **kw["setup"])
        hist = []
        mon = CapacityMonitor()
        for _ in range(3):
            s, fwd, stats = step(s)
            mon.observe(stats)
            hist.append((stats, fwd))
        out["step"].append(dict(hist=hist, state=s, vert_gid=lp.vert_gid,
                                recommend=mon.recommend(s["active"].shape[0])))
    for kw in cfg3s:
        cfg3 = pps.PushSearchConfig(**kw["cfg"])
        _, ps3, step3 = pps.make_picparts_setup_3d(coords3, tets, cfg3, device="cpu",
                                                   **kw["setup"])
        hist = []
        for _ in range(3):
            ps3, stats = step3(ps3)
            hist.append(stats)
        out["step3d"].append(dict(hist=hist, h=ps3.copy_to_host()))
    return out


def balancer_rank(coords, tris, cls, new_elem, dest, ppe, num_ptcls) -> dict:
    """repartition (with and without the non-core priority), partition and
    ptcl_imbalance on this rank's picpart."""
    from pumipic_torch.parallel import balancer as lbm

    me, R = _me()
    owners, pp = _picparts(coords, tris, cls, R)
    lpp = pp.local_view(me, "cpu")
    bt = lbm.build_balancer(pp, R)
    E = lpp.mesh.nelems
    sbar = torch.as_tensor(bt.sbar_of_elem[me][:E])
    ne = torch.as_tensor(new_elem[me])
    act = ne >= 0
    d = torch.as_tensor(dest[me])
    out = {"repart": lbm.repartition(bt, sbar, ne, act, d, me),
           "repart_nc": lbm.repartition(bt, sbar, ne, act, d, me,
                                        elem_owner=lpp.elem_owner),
           "partition": lbm.partition(bt, sbar, torch.as_tensor(ppe[me][:E]),
                                      num_ptcls, me),
           "imb": lbm.ptcl_imbalance(act.sum(dtype=torch.int32))}
    return out


def fail_rank() -> None:
    from pumipic_torch.parallel import group

    if group.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")


def hang_rank() -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time

    from pumipic_torch.parallel import group

    if group.rank() == 0:
        group.all_sum(torch.ones(1))
    else:
        time.sleep(600)
