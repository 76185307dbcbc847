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


# ---------------------------------------------------------------------------
# the exchange kernels' inputs (X1, X2, X3, O): seeded, with the adversarial
# cases (one key, no leaver, every slot leaving, a ragged last tile,
# arrivals beyond the free slots, NaN, -0.0 and subnormal payloads)
# ---------------------------------------------------------------------------

RANK_CASES = ("random", "sorted", "one key", "ignored only", "ragged tile",
              "many keys", "single", "empty")


def rank_case(case: str, seed: int = 0):
    """(keys (N,) int32 in [0, num_keys], num_keys) of a rank_in_key case."""
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.integers(0, 5, 5000).astype(np.int32), 4
    if case == "sorted":
        return np.sort(rng.integers(0, 5, 5000)).astype(np.int32), 4
    if case == "one key":
        return np.zeros(3000, np.int32), 3
    if case == "ignored only":
        return np.full(2500, 3, np.int32), 3
    if case == "ragged tile":
        return rng.integers(0, 3, 3 * 1024 + 17).astype(np.int32), 2
    if case == "many keys":
        return rng.integers(0, 41, 9000).astype(np.int32), 40
    if case == "single":
        return np.asarray([1], np.int32), 1
    return np.zeros(0, np.int32), 2


def odd_floats(rng, n: int) -> np.ndarray:
    """n f32 values with NaNs (a payload among them), infinities, -0.0 and
    subnormals mixed into normal ones."""
    x = rng.normal(size=n).astype(np.float32)
    special = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-40, -3e-39],
                         np.float32)
    pick = rng.random(n) < 0.2
    x[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    bits = x.view(np.int32)
    bits[rng.random(n) < 0.02] = 0x7FA00001          # a signalling NaN payload
    return x


def exchange_state(n: int, rng):
    """A particle state of n slots with an f32, an i32, a bool and an
    (n, 2, 2) f32 field (odd floats among them), plus elem and active."""
    return {"x": odd_floats(rng, n),
            "pid": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "flag": rng.random(n) < 0.5,
            "J": odd_floats(rng, 4 * n).reshape(n, 2, 2),
            "elem": rng.integers(-1, 50, n).astype(np.int32),
            "active": rng.random(n) < 0.8}


SEND_CASES = ("random", "no leaver", "every slot leaving", "over cap", "ragged tile",
              "step layout")


def send_case(case: str, seed: int = 0):
    """Inputs of pack_send: (state, key (bucket, or D to stay), quota (D,),
    rows_of_bucket (host ints: the admitted counts), cap, new_elem,
    elem_gid).  Each quota is at most min(count, cap), as the negotiation
    grants; the ranks come from rank_in_key.  "step layout" is the
    picparts step's: the particles in a slot prefix in element order (as
    ``make_picparts_setup`` seeds them) and the leavers whole runs, every
    particle of an element owned elsewhere, bucketed by that owner, each
    admitted (the quota its count)."""
    rng = np.random.default_rng(seed)
    n = 3 * 1024 + 17 if case == "ragged tile" else 4000
    D, cap = 3, 1000
    E = 60
    elem = None
    if case == "no leaver":
        key = np.full(n, D, np.int32)
    elif case == "every slot leaving":
        key = rng.integers(0, D, n).astype(np.int32)
        cap = n
    elif case == "step layout":
        elem = np.repeat(np.arange(E), rng.integers(20, 70, E))[:n].astype(np.int32)
        owner = np.where(rng.random(E) < 0.3, rng.integers(0, D, E), D)
        key = np.full(n, D, np.int32)
        key[:len(elem)] = owner[elem]
    else:
        key = np.where(rng.random(n) < 0.3, rng.integers(0, D, n), D).astype(np.int32)
    if case == "over cap":
        cap = 200
    counts = np.bincount(key, minlength=D + 1)[:D]
    if case in ("every slot leaving", "step layout"):
        quota = counts.copy()
    else:
        quota = np.minimum(rng.integers(0, counts + 1), cap)
    new_elem = rng.integers(0, E, n).astype(np.int32)
    elem_gid = rng.permutation(10 * E)[:E].astype(np.int32)
    state = exchange_state(n, rng)
    if elem is not None:
        m = len(elem)
        state["active"] = np.arange(n) < m
        state["elem"] = np.full(n, -1, np.int32)
        state["elem"][:m] = new_elem[:m] = elem
    return (state, key, quota.astype(np.int32), [int(q) for q in quota], cap, new_elem,
            elem_gid)


PLACE_CASES = ("random", "beyond the free slots", "no arrival", "all unresolved",
               "every slot free", "ragged tile", "-1 padding rows")


def place_case(case: str, seed: int = 0):
    """Inputs of place_arrivals: (state, staying, new_elem, recv (M, F)
    int32 rows in the state's payload layout, gid_sorted, gid_perm).  Rows
    carry absent gids (-1) and gids the picpart lacks (unresolved)."""
    rng = np.random.default_rng(seed)
    n = 3 * 1024 + 17 if case == "ragged tile" else 4000
    st = exchange_state(n, rng)
    staying = st["active"] & (rng.random(n) < 0.7)
    if case == "every slot free":
        staying[:] = False
    E = 80
    gids = rng.permutation(1000)[:E].astype(np.int32)
    perm = np.argsort(gids, kind="stable").astype(np.int32)
    m = {"no arrival": 0, "beyond the free slots": 3 * n}.get(case, 900)
    src = exchange_state(m, rng)
    g = gids[rng.integers(0, E, m)]
    g = np.where(rng.random(m) < 0.05, -1, g)                   # absent
    g = np.where(rng.random(m) < 0.05, 1000 + rng.integers(0, 50, m), g)  # unresolved
    if case == "all unresolved":
        g = 2000 + np.arange(m, dtype=np.int32)
    lanes = [g.astype(np.int32)[:, None]]
    for name in sorted(src):
        if name in ("elem", "active"):
            continue
        v = src[name].reshape(m, int(np.prod(src[name].shape[1:])))
        lanes.append(v.view(np.int32) if v.dtype == np.float32 else v.astype(np.int32))
    recv = np.ascontiguousarray(np.concatenate(lanes, axis=1).astype(np.int32))
    if case == "-1 padding rows":       # a padded receive: whole rows of -1
        recv[rng.random(m) < 0.3] = -1
    new_elem = rng.integers(0, E, n).astype(np.int32)
    return st, staying, new_elem, recv, gids[perm], perm


OWNER_CASES = ("sum f32", "sum f32 vec", "sum i32", "max f32", "min f32", "max i32",
               "min i32", "sum f32 nan", "max f32 nan")


def owner_case(case: str, seed: int = 0, V: int = 700, R: int = 4, K: int = 90):
    """One rank's owner reduction inputs: (field (V[, 3]), recv_ids (R, K),
    recv_vals (R, K[, 3]), send_ids (R, K), back (R, K[, 3]), op).  Each
    source row names an owned entity at most once, each copy is named
    once in send_ids; values are small integers and halves (sums exact in
    any order), with -0.0 among them for SUM; ``nan`` cases add NaNs."""
    rng = np.random.default_rng(seed)
    op = case.split()[0]
    dt = np.int32 if "i32" in case else np.float32
    inner = (3,) if "vec" in case else ()
    recv_ids = np.full((R, K), -1, np.int32)
    owned = rng.permutation(V)[:V // 2]
    for s in range(R):
        k = int(rng.integers(0, K + 1))
        recv_ids[s, :k] = rng.choice(owned, k, replace=False)
    send_ids = np.full((R, K), -1, np.int32)
    copies = rng.permutation(np.setdiff1d(np.arange(V), owned))
    pos = rng.permutation(R * K)[:min(len(copies), R * K * 3 // 4)]
    send_ids.reshape(-1)[pos] = copies[:len(pos)]

    def vals(shape):
        if dt == np.int32:
            return rng.integers(-1000, 1000, shape).astype(np.int32)
        v = (rng.integers(-40, 40, shape) / 2.0).astype(np.float32)
        if op == "sum":        # max/min ties of +0.0 and -0.0 are not pinned
            v[rng.random(shape) < 0.1] = -0.0
        if "nan" in case:
            v[rng.random(shape) < 0.03] = np.nan
        return v

    return (vals((V,) + inner), recv_ids, vals((R, K) + inner), send_ids,
            vals((R, K) + inner), op)


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
    sid, rid = torch.as_tensor(s[me]), torch.as_tensor(r[me])
    out["untouched"] = {}
    for op in REDUCE_OPS:
        fld = torch.as_tensor(f[me])
        out[op] = red.reduce_comm_array(sid, rid, fld, red.Op[op])
        out["untouched"][op] = torch.equal(fld, torch.as_tensor(f[me])) and out[op] is not fld
    out["SUM_send_vals"] = reduce_with_send_rows(sid, rid, torch.as_tensor(f[me]), False)
    if R % 2 == 0 and R >= 4:
        out["hier"] = hier_cases(me, R)
    return out


def reduce_with_send_rows(sid, rid, fld, hier: bool):
    """The picparts step's SUM: the send rows written beside the field by
    kernel D's epilogue (its plain version on the CPU), then
    ``reduce_comm_array(..., send_vals=)``."""
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.parallel import reduce as red

    rows = red.sum_send_rows(sid, fld.shape[0])
    sc.write_send_rows(fld, rows)
    return red.reduce_comm_array(sid, rid, fld, red.Op.SUM, hier=hier, send_vals=rows[1])


def hier_rows(R: int):
    """The JAX hier test's payload: (R·R, 5) f32, rank r's rows [r·R, (r+1)·R)."""
    return np.random.default_rng(0).normal(size=(R * R, 5)).astype(np.float32)


def hier_tables(R: int, K: int = 3, V: int = 12):
    """The JAX hier reduction test's tables: entity g owned by rank g % R,
    copies on about half the other ranks; (send, recv, field) each (R, ...)."""
    rng = np.random.default_rng(1)
    send = np.full((R, R, K), -1, np.int32)
    recv = np.full((R, R, K), -1, np.int32)
    for r in range(R):
        for g in range(V):
            o = g % R
            if o != r and rng.random() < 0.5:
                k = int((send[r, o] >= 0).sum())
                if k < K:
                    send[r, o, k] = g
                    recv[o, r, int((recv[o, r] >= 0).sum())] = g
    return send, recv, rng.normal(size=(R, V)).astype(np.float32)


def hier_cases(me: int, R: int) -> dict:
    """Each exchange flat and over 2 slices of R/2 ranks: the fixed
    all_to_all (the JAX test's payload), a ragged one (random row counts,
    empty blocks among them), the owner reduction (every op, the JAX
    test's tables) and the migration of a picpart's particles (world and
    neighbour plan)."""
    from pumipic_torch.mesh.generate import annulus_mesh
    from pumipic_torch.parallel import distributor as dstm
    from pumipic_torch.parallel import group
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import reduce as red

    x = torch.as_tensor(hier_rows(R)[me * R:(me + 1) * R])
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4, (R, R))                 # rows[p, q]: p sends q
    rows[rng.random((R, R)) < 0.3] = 0
    send = torch.arange(int(rows[me].sum()) * 2, dtype=torch.int32).reshape(-1, 2) + 1000 * me
    send_rows, recv_rows = rows[me].tolist(), rows[:, me].tolist()
    s, r, f = hier_tables(R)
    sid, rid, fld = (torch.as_tensor(a[me]) for a in (s, r, f))
    coords, tris, cls = annulus_mesh(4, 8 * R, 0.3, 1.0)
    _, pp = _picparts(coords, tris, cls, R)
    lpp = pp.local_view(me, "cpu")
    plan = mig.build_neighbor_plan(dstm.from_picparts(pp))
    st, ne, de = migrate_inputs(pp.elem_gid, pp.elem_safe, pp.elem_owner, n=48, seed=3)
    out = {}
    for n_slices in (1, 2):
        group.set_slices(n_slices)
        hier = n_slices > 1
        o = {"a2a": group.hier_all_to_all(x),
             "ragged": group.hier_ragged_all_to_all(send, send_rows, recv_rows)}
        for op in REDUCE_OPS:
            o[op] = red.reduce_comm_array(sid, rid, fld, red.Op[op], hier=hier)
        o["SUM_send_vals"] = reduce_with_send_rows(sid, rid, fld, hier)
        for name, p in (("world", None), ("neighbor", plan)):
            res = mig.migrate({k: torch.tensor(v[me]) for k, v in st.items()},
                              torch.as_tensor(ne[me]), torch.as_tensor(de[me]), lpp.elem_gid,
                              lpp.elem_gid_sorted, lpp.elem_gid_perm, me, R, 16, plan=p,
                              hier=hier)
            o[f"migrate-{name}"] = {"state": res.state,
                                    **{k: getattr(res, k) for k in res._fields if k != "state"}}
        out["sliced" if hier else "flat"] = o
    group.set_slices(1)
    return out


def _picparts(coords, tris, cls, R, dim=2):
    from pumipic_torch.parallel import picparts as ppm

    owners = ppm.partition_rcb(coords, tris, R)
    return owners, ppm.build_picparts(coords, tris, owners, R, ppm.PicPartsInput(),
                                      cls)


def _migrate_case(lpp, st, new_elem, dest, cap, plan, me, R):
    from pumipic_torch.parallel import migrate as mig

    state = {k: torch.tensor(v[me]) for k, v in st.items()}   # migrate writes in place
    res = mig.migrate(state, torch.as_tensor(new_elem[me]), torch.as_tensor(dest[me]),
                      lpp.elem_gid, lpp.elem_gid_sorted, lpp.elem_gid_perm, me, R,
                      cap, plan=plan)
    return {"state": res.state, **{k: getattr(res, k) for k in res._fields if k != "state"}}


def picparts_rank(coords, tris, cls, fields, mig_cases, struct_layouts,
                  shrink_cap, step_cfgs, coords3, tets, cfg3s) -> dict:
    """Reductions on every dimension, migrations (world and neighbour,
    tight caps, illegal destinations, tensor fields), the structures'
    migration in each layout, the capacity shrink, and the 2D and 3D
    steps, each step also over the group split into 2 slices (the
    two-stage route); every result of this rank."""
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

    from pumipic_torch.parallel import group

    for n_slices, key2, key3 in ((1, "step", "step3d"), (2, "step_sliced", "step3d_sliced")):
        group.set_slices(n_slices)
        out[key2], out[key3] = [], []
        for kw in step_cfgs:
            cfg = px.XGCmConfig(**kw["cfg"], gyro=px.GyroConfig(**kw["gyro"]))
            lp, s, _, step = px.make_picparts_setup(coords, tris, cls, cfg, device="cpu",
                                                    **kw["setup"])
            hist, given_up, deposits = [], [], []
            mon = CapacityMonitor()
            for _ in range(3):
                prev = s
                s, fwd, stats = step(s)
                mon.observe(stats)
                hist.append((stats, fwd))
                deposits.append((step.last_deposit.clone(), step.last_deposit is not fwd))
                # the migrated member fields the step passed on: the input
                # state's own tensors, holding the new state's values
                given_up.append({k: (prev[k] is s[k], torch.equal(prev[k], s[k]))
                                 for k in ("b", "pid", "rg") if k in prev})
            out[key2].append(dict(hist=hist, state=s, vert_gid=lp.vert_gid,
                                  vert_owner=lp.vert_owner, deposits=deposits,
                                  recommend=mon.recommend(s["active"].shape[0]),
                                  given_up=given_up))
        for kw in cfg3s:
            cfg3 = pps.PushSearchConfig(**kw["cfg"])
            _, ps3, step3 = pps.make_picparts_setup_3d(coords3, tets, cfg3, device="cpu",
                                                       **kw["setup"])
            hist = []
            for _ in range(3):
                ps3, stats = step3(ps3)
                hist.append(stats)
            out[key3].append(dict(hist=hist, h=ps3.copy_to_host()))
    group.set_slices(1)
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


def route_spy_rank(steps: int = 2) -> dict:
    """The picparts steps' calls of the route and balancer wrappers
    (kernels Y1-Y3, ``pumipic_torch.ops.route``) on this rank: for each arm
    (2D walk, 2D analytic with the banded route and with the [g2l | route]
    row, 3D Kuhn, 3D walk), the calls of each wrapper in ``steps`` steps."""
    import dataclasses

    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import route as rt
    from pumipic_torch.parallel import dryrun

    names = ("route_packed", "route_g2l", "route_banded", "balance_keys", "balance_select")
    calls = {k: 0 for k in names}
    for name in names:
        def spy(*args, _fn=getattr(rt, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        setattr(rt, name, spy)
    _, R = _me()
    (coords, tris, cls), cfg, (c3, t3), cfg3 = dryrun._configs(R)
    arms = {"2d walk": lambda: px.make_picparts_setup(
                coords, tris, cls, dataclasses.replace(cfg, analytic_locate="off"),
                use_lb=True),
            "2d banded": lambda: px.make_picparts_setup(coords, tris, cls, cfg, use_lb=True),
            "2d g2l": lambda: px.make_picparts_setup(coords, tris, cls, cfg, use_lb=True,
                                                     banded_route="off"),
            "3d kuhn": lambda: pps.make_picparts_setup_3d(c3, t3, cfg3, use_lb=True),
            "3d walk": lambda: pps.make_picparts_setup_3d(
                c3, t3, dataclasses.replace(cfg3, kuhn="off"), use_lb=True)}
    out = {}
    for arm, setup in arms.items():
        built = setup()
        state, step = built[1], built[-1]
        for k in calls:
            calls[k] = 0
        for _ in range(steps):
            state = step(state)[0]
        out[arm] = dict(calls)
    return out


def library_rank() -> dict:
    """A Library in a rank of a group it did not make: it joins it, refuses
    another size, and leaves the group to its owner at finalize."""
    from pumipic_torch.library import Library
    from pumipic_torch.parallel import group

    lib = Library(num_ranks=group.num_ranks())
    out = {"world_size": lib.world_size, "rank": group.rank()}
    try:
        Library(num_ranks=group.num_ranks() + 1)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    lib.finalize()
    out["still_initialized"] = group.initialized()
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
