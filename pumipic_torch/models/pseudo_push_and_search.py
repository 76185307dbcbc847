"""pseudoPushAndSearch (port of ``pumipic_tpu.models.pseudo_push_and_search``):
the 3D straight-line push + tet search + structure rebuild mini-app.

Reference: ``test/pseudoPushAndSearch.cpp``.  Particles are seeded in the
tets of a mesh, pushed a fixed distance along a direction each step, located
in the tet mesh and rebuilt into their particle structure; a particle whose
destination leaves the domain is deleted (wall "remove"), or, with wall
"periodic", every pushed position is wrapped back into the mesh's box first.

Each step, on a mesh that :func:`~pumipic_torch.mesh.locator.detect_box_kuhn`
proves a structured Kuhn box (``kuhn="auto"`` or ``"force"``): kernel K
pushes, wraps and locates analytically in one launch (no walk; ``iters``
0).  Otherwise (``kuhn="off"`` or an unstructured mesh): the push and wrap
(K's push-only form), then kernel L3 (the 26-column peel of the locator grid
and the BCC walk; the plain walk with ``use_locator`` off).  With wall
"reflect" (specular, which the analytic locate cannot serve, so it always
walks) the walk is kernel M with :func:`~pumipic_torch.ops.search.reflect_on_exit_3d`
(M's peel form with the locator), and the particle moves to the mirrored
destination.  Then ``set("x")`` and the structure's
``rebuild`` (``rebuild_mode`` "sort" or "auto").

Host seeding makes the JAX package's numpy Generator calls in its order, so
particle elements, positions and pids are bit-identical.  Knobs that only
the TPU build needed are accepted and mapped onto the one GPU path:
``widths`` (the compaction pyramid) and every 3D ``peel`` (onto the
26-column rows).  :func:`make_picparts_setup_3d` is the distributed
version over 3D picparts.  Entry points run on the CUDA card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pumipic_torch.mesh.core import Mesh3D
from pumipic_torch.mesh.locator import (
    KNOWN_PEELS,
    build_locator_grid_3d,
    detect_box_kuhn,
)
from pumipic_torch.ops import counts as count_ops
from pumipic_torch.ops import locate as locate_ops
from pumipic_torch.ops import push as push_ops
from pumipic_torch.ops import route as route_ops
from pumipic_torch.ops import search as search_ops
from pumipic_torch.particles import CSR, DPS, CabM, SCSInput, SellCSigma
from pumipic_torch.utils.device import resolve_device

WALLS = ("remove", "periodic", "reflect")

_BUILDERS = {
    "scs": lambda E, elems, fields, device: SellCSigma(
        E, elems, fields=fields, scs_input=SCSInput(chunk_size=8, sigma=None),
        device=device),
    "csr": lambda E, elems, fields, device: CSR(E, elems, fields=fields,
                                                device=device),
    "cabm": lambda E, elems, fields, device: CabM(E, elems, fields=fields,
                                                  device=device),
    "dps": lambda E, elems, fields, device: DPS(E, elems, fields=fields,
                                                device=device),
}

# fixed capacity (the app never adds particles)
_BUILDERS_CAP = {
    "scs": lambda E, elems, fields, cap, device: SellCSigma(
        E, elems, fields=fields, capacity=cap,
        scs_input=SCSInput(chunk_size=8, sigma=None), device=device),
    "csr": lambda E, elems, fields, cap, device: CSR(
        E, elems, fields=fields, capacity=cap, device=device),
    "cabm": lambda E, elems, fields, cap, device: CabM(
        E, elems, fields=fields, capacity=cap, device=device),
    "dps": lambda E, elems, fields, cap, device: DPS(
        E, elems, fields=fields, capacity=cap, device=device),
}


@dataclass(frozen=True)
class PushSearchConfig:
    """Same fields and defaults as the JAX package's PushSearchConfig; see
    the module docstring for the knobs the port maps or refuses."""

    num_ptcls: int = 10_000
    num_iterations: int = 5
    push_dir: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    distance: float = 0.05       # reference: domain height / 20
    structure: str = "scs"
    max_search_iters: int = 100
    use_locator: bool = True
    wall: str = "remove"
    cells_per_elem: Optional[float] = None
    peel: str = "auto"
    widths: Optional[Tuple[int, ...]] = None
    rebuild_mode: str = "sort"
    extra_padding: float = 0.15
    kuhn: str = "auto"


def resolve_locator_policy_3d(cfg: PushSearchConfig, nelems: int,
                              num_ptcls: int):
    """(cells_per_elem, peel, widths) for a tet mesh, as the JAX package
    resolves them: cpe 16 while a 26-column rows table of 16 cells per tet
    stays under 48 MB, else cpe 4 with the "lines" peel (which the port maps
    onto rows); a wider first pyramid level above 64k particles (ignored by
    the port)."""
    cpe, peel, widths = cfg.cells_per_elem, cfg.peel, cfg.widths
    if cpe is None:
        if nelems * 16 * 26 * 4 <= 48e6:
            cpe = 16.0
        else:
            cpe = 4.0
            if peel == "auto":
                peel = "lines"
    if widths is None and num_ptcls >= 1 << 16:
        widths = (max(num_ptcls // 4, 2048), max(num_ptcls // 64, 2048), 2048)
    return cpe, peel, widths


def seed_particles(mesh: Mesh3D, num_ptcls: int, seed: int = 0):
    """(elems, pos): each particle's tet (uniform over the tets) and its
    position, a Dirichlet-weighted mix of the tet's vertices (f64), from
    the JAX package's Generator calls in its order."""
    rng = np.random.default_rng(seed)
    elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    ev = mesh.elem2verts.cpu().numpy()[elems]
    cz = mesh.coords.cpu().numpy()
    r = rng.dirichlet(np.ones(4), size=num_ptcls)
    return elems, np.einsum("nk,nkd->nd", r, cz[ev])


def check_config(cfg: PushSearchConfig) -> None:
    if cfg.structure not in _BUILDERS:
        raise ValueError(f"unknown structure {cfg.structure!r}")
    if cfg.wall not in WALLS:
        raise ValueError(f"unknown wall {cfg.wall!r}")
    if cfg.peel not in KNOWN_PEELS:
        raise ValueError(f"unknown peel {cfg.peel!r}")
    if cfg.kuhn == "force" and cfg.wall not in ("periodic", "remove"):
        raise ValueError(
            f"kuhn='force' is incompatible with wall={cfg.wall!r} "
            f"(the analytic locate supports 'periodic'/'remove' only)")


class PseudoPushAndSearch:
    """The single-device pseudoPushAndSearch app on a particle structure
    (``cfg.structure``: scs, csr, cabm or dps) with fields ``x`` (N, 3) f32
    and ``pid`` i32, seeded as the JAX package seeds them.  ``step_fn(ptcls)
    -> (ptcls, iters)``; see the module docstring for the step.

    ``device`` defaults to the CUDA card; ``locator``, if given, is a grid
    already built for this mesh and ``cfg`` (the walk arm's)."""

    def __init__(self, mesh: Mesh3D, cfg: PushSearchConfig, seed: int = 0,
                 device=None, locator=None):
        check_config(cfg)
        self.device = resolve_device(device)
        self.mesh = mesh = mesh.to(self.device)
        self.cfg = cfg
        self.setup_s = {}

        t0 = time.perf_counter()
        elems, pos = seed_particles(mesh, cfg.num_ptcls, seed)
        d = np.asarray(cfg.push_dir, np.float64)
        self.direction = (d / np.linalg.norm(d)).astype(np.float32)
        order = np.argsort(elems, kind="stable")
        fields = {"x": torch.as_tensor(pos.astype(np.float32)[order]),
                  "pid": torch.arange(cfg.num_ptcls, dtype=torch.int32)[order]}
        sorted_elems = np.sort(elems)
        E = mesh.nelems
        if cfg.rebuild_mode == "auto" and cfg.structure in ("scs", "cabm"):
            # per-segment headroom for the reshuffle path
            pad = cfg.extra_padding
            if cfg.structure == "scs":
                self.ptcls = SellCSigma(
                    E, sorted_elems, fields=fields,
                    scs_input=SCSInput(chunk_size=8, sigma=None, extra_padding=pad),
                    device=self.device)
            else:
                self.ptcls = CabM(E, sorted_elems, fields=fields,
                                  extra_padding=pad, device=self.device)
        elif cfg.structure in ("csr", "dps"):
            # the app never adds particles: capacity = num_ptcls exactly
            self.ptcls = _BUILDERS_CAP[cfg.structure](
                E, sorted_elems, fields, cfg.num_ptcls, self.device)
        else:
            self.ptcls = _BUILDERS[cfg.structure](E, sorted_elems, fields,
                                                  self.device)
        self.setup_s["particles"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        coords = mesh.coords.cpu().numpy()
        self.kuhn = None
        if cfg.kuhn in ("auto", "force") and cfg.wall in ("periodic", "remove"):
            self.kuhn = detect_box_kuhn(coords, mesh.elem2verts.cpu().numpy(),
                                        device=self.device)
            if self.kuhn is None and cfg.kuhn == "force":
                raise ValueError("kuhn='force' but the mesh is not a "
                                 "structured Kuhn box")
        self.locator = None
        if cfg.use_locator and self.kuhn is None:
            if locator is None:
                cpe, peel, _widths = resolve_locator_policy_3d(
                    cfg, mesh.nelems, cfg.num_ptcls)
                locator = build_locator_grid_3d(
                    coords, mesh.elem2verts.cpu().numpy(), cells_per_elem=cpe,
                    walk_geom=mesh.walk_geom.cpu(), peel=peel, device=self.device)
            self.locator = locator
        self.setup_s["locator"] = time.perf_counter() - t0
        self.step_vector = push_ops.step_vector(self.direction, cfg.distance)
        self.wrap = None
        if cfg.wall == "periodic":
            self.wrap = (coords.min(axis=0), coords.max(axis=0) - coords.min(axis=0))
        self.step_fn = self._make_step()

    def _make_step(self):
        mesh, cfg = self.mesh, self.cfg
        kuhn, locator, s, wrap = self.kuhn, self.locator, self.step_vector, self.wrap
        no_iters = torch.zeros((), dtype=torch.int32, device=self.device)
        reflect = cfg.wall == "reflect"
        handler = (search_ops.reflect_on_exit_3d if reflect
                   else search_ops.remove_on_exit)

        def step(ptcls):
            x = ptcls.get("x")
            if kuhn is not None:
                # kernel K: push, wrap, analytic tet, active mask
                xt, elem_ids = locate_ops.kuhn_push_locate(kuhn, x, ptcls.active,
                                                           s, wrap)
                iters = no_iters
            else:
                # K's push-only form, then kernel L3 (M for the reflect wall)
                xt = push_ops.push_and_wrap(x, s, wrap)
                if locator is not None:
                    res = search_ops.search_mesh_3d_accel(
                        mesh, locator, x, xt, ptcls.elem, ptcls.active,
                        cfg.max_search_iters, boundary_handler=handler)
                else:
                    res = search_ops.search_mesh_3d(
                        mesh, x, xt, ptcls.elem, ptcls.active,
                        cfg.max_search_iters, boundary_handler=handler)
                elem_ids, iters = res.elem_ids, res.iters
                if reflect:
                    xt = res.dest
            return ptcls.set("x", xt).rebuild(elem_ids, mode=cfg.rebuild_mode), iters

        return step

    def run(self, num_iterations: Optional[int] = None, verbose: bool = False):
        """Step loop; returns the particle count after each step (stops
        early when none is left)."""
        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        history = []
        for i in range(iters):
            self.ptcls, walk_iters = self.step_fn(self.ptcls)
            history.append(self.ptcls.n_ptcls())
            if verbose:
                from pumipic_torch.utils.plog import print_info

                print_info("iter %d: ptcls %d walk %d", i, history[-1], int(walk_iters))
            if history[-1] == 0:
                break
        return history


# ---------------------------------------------------------------------------
# distributed BFS-buffered 3D picparts (the reference runs this app at 2
# ranks with migrate_lb_ptcls, test/pseudoPushAndSearch.cpp:204-206, 524)
# ---------------------------------------------------------------------------

def make_picparts_setup_3d(coords: np.ndarray, tets: np.ndarray,
                           cfg: PushSearchConfig, inp=None,
                           migrate_cap: Optional[int] = None, seed: int = 0,
                           use_lb: bool = True, lb_tol: float = 1.05,
                           neighbor_migration: bool = True, device=None,
                           hier: Optional[bool] = None):
    """This rank's part of pseudoPushAndSearch over 3D picparts: per step
    the straight-line push, the tet search from the previous element (the
    walk, kernel L3's plain walk; on a proven Kuhn box with the remove wall
    the global analytic locate, kernel K, and one [g2l | route] row per
    particle), the safe-zone migration with the balancer where ``use_lb``,
    and the layout's rebuild on arrival (``migrate_structure``: scs, csr,
    cabm and dps all ride the exchange).  Every rank builds the same host
    picparts (RCB) and keeps its own on ``device`` (default: the group's).

    Returns (local picpart, structure, step) with ``step(ps) -> (ps,
    stats)`` (the step gives its input structure up, as the 2D step its
    state); ``stats`` as the 2D step's (overflow also covers the
    layout).  ``hier`` (default: whether the group has slices) routes the
    migration's payload through the two-stage exchange, equal bit for
    bit."""
    from pumipic_torch.models.pseudo_xgcm import step_stats
    from pumipic_torch.parallel import balancer as lbm
    from pumipic_torch.parallel import distributor as dstm
    from pumipic_torch.parallel import group
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import picparts as ppm

    check_config(cfg)
    if hier is None:
        hier = group.slices() > 1
    R, me = group.num_ranks(), group.rank()
    device = group.device() if device is None else resolve_device(device)
    inp = ppm.PicPartsInput() if inp is None else inp
    coords, tets = np.asarray(coords), np.asarray(tets)
    owners = ppm.partition_rcb(coords, tets, R)
    pp = ppm.build_picparts(coords, tets, owners, R, inp)
    bt = lbm.build_balancer(pp, R) if use_lb else None
    # the JAX package's multi-slice schedule colours the edges within a
    # slice first; the exchange reads only each rank's peers
    slice_of_rank = (np.repeat(np.arange(group.slices()), R // group.slices())
                     if hier else None)
    nplan = (mig.build_neighbor_plan(dstm.from_picparts(pp), slice_of_rank)
             if neighbor_migration else None)
    lpp = pp.local_view(me, device)
    lmesh = lpp.mesh

    gmesh = Mesh3D.from_numpy(ppm.mesh_arrays(3, coords, tets,
                                              np.ones(len(tets), np.int64)), "cpu")
    g_elems, pos = seed_particles(gmesh, cfg.num_ptcls, seed)
    own_of_ptcl = owners[g_elems]
    n_cap = max(int(np.bincount(own_of_ptcl, minlength=R).max() * 2.0) + 16, 64)
    E_l = pp.nelems

    kuhn = None
    if cfg.kuhn in ("auto", "force") and cfg.wall == "remove":
        kuhn = detect_box_kuhn(coords, tets, device=device)
        if kuhn is None and cfg.kuhn == "force":
            raise ValueError("kuhn='force' but the mesh is not a structured Kuhn box")
    eg = pp.elem_gid[me]
    g2l = np.full(gmesh.nelems, -1, np.int64)
    g2l[eg[eg >= 0]] = np.nonzero(eg >= 0)[0]
    sel = np.nonzero(own_of_ptcl == me)[0]
    fields = {"x": torch.as_tensor(pos[sel].astype(np.float32)),
              "pid": torch.as_tensor(sel.astype(np.int32))}
    ps = _BUILDERS[cfg.structure](E_l, g2l[g_elems[sel]], fields, device)
    cap = max(int(group.all_gather(torch.tensor(ps.capacity, device=device)).max()),
              n_cap)
    if ps.capacity != cap:
        h = ps.copy_to_host()
        ps = _BUILDERS_CAP[cfg.structure](
            E_l, np.where(h["active"], h["elem"], -1),
            {"x": torch.as_tensor(h["x"]), "pid": torch.as_tensor(h["pid"])},
            cap, device)

    E_r = lmesh.nelems
    sbar_local = (None if bt is None else
                  torch.as_tensor(bt.sbar_of_elem[me][:E_r], device=device))
    g2l_tbl = None
    # both arms route through kernel Y1: the Kuhn arm from the [g2l | route]
    # row at the global element, the walk arm from the packed route at the
    # local one (set_unsafe_procs' destinations, with the sbar and non-core
    # flag the balancer would gather)
    n_sbars = bt.num_sbars if bt is not None else 0
    if not mig.route_pack_bound_ok(n_sbars, R):
        raise ValueError(f"route pack exceeds f32 exactness: S={n_sbars} R={R}")
    route = mig.pack_route(lpp.elem_safe, lpp.elem_owner, sbar_local, R)
    if kuhn is not None:
        fused = np.zeros((gmesh.nelems, 2), np.int32)
        fused[:, 0] = g2l
        valid = g2l >= 0
        fused[valid, 1] = route.cpu().numpy().astype(np.int64)[g2l[valid]]
        g2l_tbl = torch.as_tensor(fused, device=device)
    d = np.asarray(cfg.push_dir, np.float64)
    svec = push_ops.step_vector((d / np.linalg.norm(d)).astype(np.float32),
                                cfg.distance)
    if migrate_cap is None:
        migrate_cap = max(cap // 4, 64)
    g_walk = gmesh.walk_geom.to(device) if kuhn is None else None

    def step(ps):
        x = ps.get("x")
        with group.split("compute"):
            if kuhn is not None:
                dest_x, e_gl = locate_ops.kuhn_push_locate(kuhn, x, ps.active, svec,
                                                          None)
            else:
                xt = push_ops.push_and_wrap(x, svec, None)
                res = search_ops.search_mesh_3d(lmesh, x, xt, ps.elem, ps.active,
                                                cfg.max_search_iters)
                elem_ids, dest_x = res.elem_ids, res.dest
                # as the 2D walk arm: the removed particles walked again on
                # the global mesh; found there, they are lost off the picpart
                removed = ps.active & (elem_ids < 0)
                g_start = lpp.elem_gid[torch.clamp(ps.elem, min=0).long()]
                g_ids, _, _, g_all, _ = search_ops.walk_locate_3d(
                    g_walk, dest_x, g_start, removed, gmesh.nelems)
        with group.split("glue"):
            if kuhn is not None:
                routed = route_ops.route_g2l(g2l_tbl, e_gl, ps.active, me, R, gelem=False)
                elem_ids = routed.elem
            else:
                routed = route_ops.route_packed(route, elem_ids, ps.active, me, R)
            ps1 = ps.set("x", dest_x)
            dest = routed.dest
        if bt is not None:
            dest = lbm.repartition(bt, sbar_local, elem_ids, routed.live, dest, me, lb_tol,
                                   sbar_of_ptcl=routed.sbar, noncore=routed.noncore,
                                   num_ranks=R)
        ps2, mres = mig.migrate_structure(ps1, elem_ids, dest, lpp.elem_gid,
                                          lpp.elem_gid_sorted, lpp.elem_gid_perm,
                                          me, R, migrate_cap, plan=nplan,
                                          hier=hier)
        with group.split("glue"):
            # kernel N: the alive count, the search's exits and the lost in
            # one launch (the walk arm's lost: the removed particles found
            # on the global mesh, and one more where that walk hit its limit)
            alive = [("set", ps2.active)]
            removed = [("set", ps.active), ("neg", elem_ids)]
            if kuhn is not None:
                nloc, lost, exits = count_ops.slot_counts(
                    [alive, removed + [("nonneg", e_gl)], removed + [("neg", e_gl)]])
            else:
                nloc, found, removed_n = count_ops.slot_counts(
                    [alive, [("nonneg", g_ids)], removed])
                lost = found + (~g_all).to(torch.int32)
                exits = removed_n - lost
        mres = mres._replace(overflow=mres.overflow | ps2.overflowed)
        return ps2, step_stats(nloc, mres, exits, lost)

    return lpp, ps, step
