"""pseudoXGCm (port of ``pumipic_tpu.models.pseudo_xgcm``): the FULL-mode
particle-parallel step (``make_dp_setup``) and the single-device app on a
particle structure (:class:`PseudoXGCm`, whose step is described there).

Reference: ``test/pseudoXGCm.cpp`` + ``ellipticalPush.hpp`` +
``gyroScatter.hpp``.  Per FULL-mode step:

1. trig-free elliptical push (kernel P): the class of a band-ordered
   classification from the band starts, else (and with ``rot_analytic``
   off, as the JAX package does) the per-element rotation table (P's
   table mode);
2. the search with remove-on-exit and the DPS rewrite of parent element
   and active mask, in one of three arms:
   - cartesian cell-row peel + guess-walk BCC search (kernel L);
   - ``band_locator="force"``: the flux-band cell of each destination
     (kernel B), then the same peel + walk on the band grid's rows
     (kernel L, "given cells");
   - a mesh proven a structured annulus (``analytic_locate="auto"`` or
     ``"force"``): analytic location, no walk (kernel A; ``iters`` 0);
3. the gyro-ring histogram, per element or, with
   ``GyroConfig(per_particle_radius=True)``, per (element, ring) of each
   particle's radius ``rg`` (kernel H), and the ring expansion plus the
   forward/backward mapped scatter (kernel D);
4. the field sum over ranks (the identity on one GPU).

Host setup draws from numpy Generators with the JAX package's seeds, so
particle counts, positions, initial elements and radii are bit-identical.

Knobs that only the TPU build needed are accepted and mapped onto the one
GPU path, whose results they do not change: ``peel`` variants, ``locator_cpe``
and ``search_widths`` (the compaction pyramid), ``rot_aux_capture`` (the
walk-captured rotation is the table's row of the final element: the
table push), the module's ``ROT_TABLE_1D`` (the 1-D sin Δ table, mapped
onto the (E, 2) table with the values it gives), and, on a
``ring_class``-proven annulus, ``rot_analytic`` (the analytic class equals
the band-ordered one, which setup checks).  ``rot_analytic=False`` takes
the rotation table, as in the JAX package.  ``band_locator="auto"``
resolves to the cartesian grid: the JAX package's TPU-measured cost gate
makes the same choice below ~460k elements, and a gate measured on the
GPU is later work.  Every classification is taken: a band-ordered one
through the band starts, any other through the per-element rotation
table.  Entry points run on the CUDA card unless ``device="cpu"`` is
passed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from pumipic_torch.mesh import generate as gen
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.locator import (
    KNOWN_PEELS,
    AnnulusLocator2D,
    BandGrid2D,
    LocatorGrid2D,
    build_locator_grid,
    detect_annulus_structured,
    detect_banded_locator,
)
from pumipic_torch.ops import counts as count_ops
from pumipic_torch.ops import locate as locate_ops
from pumipic_torch.ops import push as push_ops
from pumipic_torch.ops import route as route_ops
from pumipic_torch.ops import scatter as scatter_ops
from pumipic_torch.ops import search as search_ops
from pumipic_torch.parallel import full_mode
from pumipic_torch.particles import CSR, DPS, CabM, SCSInput, SellCSigma
from pumipic_torch.utils.device import resolve_device
from pumipic_torch.utils.types import LID_DTYPE

ELEMENT_SEED = 1024 * 1024
PARTICLE_SEED = 512 * 512
# the JAX package's TPU-only 1-D sin Δ rotation table; the table push maps
# it onto the (E, 2) table (push_ops.rot_table_2d)
ROT_TABLE_1D = False


@dataclass(frozen=True)
class GyroConfig:
    """setGyroConfig analog (gyroScatter.hpp:6-18)."""

    rmax: float = 0.038
    num_rings: int = 3
    points_per_ring: int = 8
    theta: float = 0.0
    per_particle_radius: bool = False


@dataclass(frozen=True)
class XGCmConfig:
    """Same fields and defaults as the JAX package's XGCmConfig; see the
    module docstring for the knobs the port maps or refuses."""

    num_ptcls: int = 100_000
    num_iterations: int = 10
    mdl_face: int = 2            # seed particles where class_id <= mdl_face
    deg_per_push: float = 30.0
    structure: str = "scs"
    max_search_iters: int = 128
    use_locator: bool = True
    peel: str = "auto"
    locator_cpe: Optional[float] = None
    search_widths: Optional[Tuple[int, ...]] = None
    rot_aux_capture: bool = False
    analytic_locate: str = "auto"
    band_locator: str = "auto"
    band_theta: Optional[int] = None
    rot_analytic: bool = True
    gyro: GyroConfig = GyroConfig()
    h: float = 0.0
    k: float = 0.0
    d: float = 0.9


def resolve_locator_policy(cfg: XGCmConfig, nelems: int, num_ptcls: int):
    """(cells_per_elem, peel, search_widths) for a mesh size, as the JAX
    package resolves them: cpe 16 while the cpe-16 rows table stays under
    32 MB, cpe 4 beyond (with a wider first pyramid level, which the port
    ignores)."""
    cpe, peel, widths = cfg.locator_cpe, cfg.peel, cfg.search_widths
    if cpe is None:
        if nelems * 16 * 14 * 4 <= 32e6:
            cpe = 16.0
        else:
            cpe = 4.0
            if widths is None and num_ptcls >= 1 << 16:
                widths = (max(num_ptcls // 8, 2048),
                          max(num_ptcls // 128, 2048), 2048)
    return cpe, peel, widths


def seed_particles_per_element(mesh: Mesh2D, cfg: XGCmConfig,
                               rng: np.random.Generator) -> np.ndarray:
    """setSourceElements analog: Gaussian-random particle counts on elements
    classified <= mdl_face, clipped to the total (vectorized sequential
    fill)."""
    cls = mesh.class_id.cpu().numpy()
    on = cls <= cfg.mdl_face
    num_marked = int(on.sum())
    if num_marked == 0:
        return np.zeros(mesh.nelems, np.int64)
    nppe = cfg.num_ptcls // num_marked
    ppe = np.zeros(mesh.nelems, np.int64)
    draws = rng.normal(nppe, max(nppe / 4, 1), size=mesh.nelems)
    midx = np.nonzero(on)[0]
    c = np.maximum(np.round(draws[midx]).astype(np.int64), 0)
    cum_before = np.cumsum(c) - c
    take = np.clip(cfg.num_ptcls - cum_before, 0, None)
    ppe[midx] = np.minimum(c, take)
    total = int(ppe.sum())
    open_budget = np.nonzero(cum_before < cfg.num_ptcls)[0]
    last = midx[open_budget[-1]] if len(open_budget) else -1
    if total < cfg.num_ptcls and last >= 0:
        ppe[last] += cfg.num_ptcls - total
    return ppe


def uniform_points_in_elements(mesh: Mesh2D, ptcl_elems: np.ndarray,
                               rng: np.random.Generator) -> np.ndarray:
    """setInitialPtclCoords analog: uniform position inside each particle's
    element via folded barycentric sampling (f64 from the f32 coords, as
    the JAX package computes it)."""
    ev = mesh.elem2verts.cpu().numpy()[ptcl_elems]
    cz = mesh.coords.cpu().numpy()
    r1 = rng.uniform(size=len(ptcl_elems))
    r2 = rng.uniform(size=len(ptcl_elems))
    over = r1 + r2 > 1
    r1[over] = 1 - r1[over]
    r2[over] = 1 - r2[over]
    a, b, c = cz[ev[:, 0]], cz[ev[:, 1]], cz[ev[:, 2]]
    return a + r1[:, None] * (b - a) + r2[:, None] * (c - a)


# ---------------------------------------------------------------------------
# gyro-ring mapping build (createGyroRingMappings, gyroScatter.hpp:96-166)
# ---------------------------------------------------------------------------

def gyro_ring_points(mesh: Mesh2D, gyro: GyroConfig):
    """Ring points (px, py) f32 on the CPU and each point's start element
    (the first element adjacent to its vertex), in the JAX package's f32
    expression order."""
    V = mesh.nverts
    R, P = gyro.num_rings, gyro.points_per_ring
    vid = torch.arange(V).repeat_interleave(R * P)
    ring = torch.arange(R).repeat_interleave(P).repeat(V)
    pt = torch.arange(P).repeat(V * R)
    radius = gyro.rmax * (ring + 1) / R
    deg = gyro.theta + pt / P * 360.0
    rad = deg * (np.pi / 180.0)
    coords = mesh.coords.cpu()
    px = coords[vid, 0] + radius * torch.cos(rad)
    py = coords[vid, 1] + radius * torch.sin(rad)
    start = mesh.vert2elem_vals.cpu()[mesh.vert2elem_offsets.cpu()[vid].long()]
    return px, py, start


def build_gyro_mapping(mesh: Mesh2D, gyro: GyroConfig, project=None
                       ) -> torch.Tensor:
    """For every (vertex, ring, point): the ring point, located by the plain
    walk (kernel L without the peel, 100 iterations) from the first element
    adjacent to its vertex; records the 3 vertices of that element, -1 where
    the point is outside the domain.  Returns (V·R·P·3,) int32 on the mesh's
    device.  ``project`` (the reference's identity placeholder) maps
    (px, py) to (px, py)."""
    px, py, start = gyro_ring_points(mesh, gyro)
    if project is not None:
        px, py = project(px, py)
    dev = mesh.device
    px, py, start = px.to(dev), py.to(dev), start.to(dev)
    active = torch.ones(px.shape[0], dtype=torch.bool, device=dev)
    parent, _, _, _ = search_ops.walk_locate(
        mesh.walk_geom, px, py, start, active, 100)
    verts = mesh.elem2verts[torch.clamp(parent, min=0).long()]
    verts = torch.where((parent >= 0)[:, None], verts, -1)
    return verts.reshape(-1).to(LID_DTYPE)


def build_gyro_mappings(mesh: Mesh2D, gyro: GyroConfig,
                        project_fwd=None, project_bwd=None):
    """Forward and backward maps; one search builds both when the
    projections coincide (both are the identity placeholder)."""
    fwd = build_gyro_mapping(mesh, gyro, project=project_fwd)
    if project_fwd is project_bwd:
        return fwd, fwd
    return fwd, build_gyro_mapping(mesh, gyro, project=project_bwd)


# ---------------------------------------------------------------------------
# FULL-buffer particle-parallel model
# ---------------------------------------------------------------------------

def make_default_mesh(nelems_target: int = 25_000, device=None) -> Mesh2D:
    """Tokamak-cross-section-like structured annulus of ~nelems_target
    elements, sectors ≈ 4× rings (the JAX package's bench annulus), on
    ``device`` (default: the CUDA card)."""
    n_rings = max(int(np.sqrt(nelems_target / 8)), 2)
    n_sectors = nelems_target // (2 * n_rings)
    coords, tris, cls = gen.annulus_mesh(n_rings, n_sectors, 0.3, 1.0)
    return Mesh2D.from_arrays(coords, tris, cls, device=device)


@dataclass(frozen=True)
class DPModel:
    """Everything the step reads besides the particle state.
    ``gyro_bwd is gyro_fwd`` when the maps coincide.  ``analytic`` set:
    the search is the annulus locate (``locator`` is then None).  ``rot``:
    the band rotation (kernel P) or the per-element table (P's table
    mode)."""

    mesh: Mesh2D
    locator: Optional[Union[LocatorGrid2D, BandGrid2D]]
    rot: Union[push_ops.BandRotation, push_ops.RotTable]
    gyro_fwd: scatter_ops.GyroMap
    gyro_bwd: scatter_ops.GyroMap
    analytic: Optional[AnnulusLocator2D] = None


def check_config(cfg: XGCmConfig) -> None:
    """Refuse unknown knob values, as the JAX package does."""
    if cfg.analytic_locate not in ("auto", "off", "force"):
        raise ValueError(f"unknown analytic_locate {cfg.analytic_locate!r}")
    if cfg.band_locator not in ("auto", "off", "force"):
        raise ValueError(f"unknown band_locator {cfg.band_locator!r}")
    if cfg.peel not in KNOWN_PEELS:
        raise ValueError(f"unknown peel {cfg.peel!r}")


def build_search(mesh: Mesh2D, cfg: XGCmConfig, num_ptcls: int,
                 locator: Optional[Union[LocatorGrid2D, BandGrid2D]] = None):
    """(analytic, locator) of the search on the mesh's device: the annulus
    locator where ``analytic_locate`` proves the mesh a structured annulus
    (then no grid), else the flux-band grid (``band_locator="force"``) or
    the cartesian grid at the resolved policy, or ``locator`` when one is
    given; no grid with ``use_locator`` off."""
    device = mesh.device
    coords = mesh.coords.cpu().numpy()
    ev = mesh.elem2verts.cpu().numpy()
    cls = mesh.class_id.cpu().numpy()
    analytic = None
    if cfg.analytic_locate in ("auto", "force"):
        analytic = detect_annulus_structured(coords, ev, cls=cls, device=device)
        if analytic is None and cfg.analytic_locate == "force":
            raise ValueError("analytic_locate='force' but the mesh is not "
                             "a structured annulus")
    if analytic is not None or not cfg.use_locator:
        return analytic, None
    if locator is None:
        if cfg.band_locator == "force":
            locator = detect_banded_locator(
                coords, ev, cls, mesh.walk_geom, n_theta=cfg.band_theta,
                device=device)
            if locator is None:
                raise ValueError("band_locator='force' but the mesh is not "
                                 "a stitched flux-band structure")
        else:
            cpe, peel, _widths = resolve_locator_policy(cfg, mesh.nelems,
                                                        num_ptcls)
            locator = build_locator_grid(
                coords, ev, cells_per_elem=cpe,
                walk_geom=mesh.walk_geom.cpu(), peel=peel, device=device)
    return analytic, locator


def gyro_maps(mesh: Mesh2D, gyro: GyroConfig):
    """(forward, backward) :class:`GyroMap` on the mesh's device; one object
    for both when the maps coincide."""
    fwd, bwd = build_gyro_mappings(mesh, gyro)
    R, P = gyro.num_rings, gyro.points_per_ring
    gyro_fwd = scatter_ops.GyroMap.from_flat(fwd, mesh.nverts, R, P, mesh.device)
    gyro_bwd = gyro_fwd if bwd is fwd else scatter_ops.GyroMap.from_flat(
        bwd, mesh.nverts, R, P, mesh.device)
    return gyro_fwd, gyro_bwd


def make_dp_step(model: DPModel, cfg: XGCmConfig):
    """The step ``state -> (state, fields)``; fields hold the summed
    ``fwd``/``bwd`` vertex fields and the search's ``iters``/``all_found``
    and the walkers it deleted at the limit, ``deleted``, as device scalars
    (no host synchronization; 0, True and 0 on the annulus arm, as the JAX
    package's analytic search reports).  ``step.model`` is
    ``model``."""
    mesh, gyro = model.mesh, cfg.gyro
    R, P = gyro.num_rings, gyro.points_per_ring
    no_iters = torch.zeros((), dtype=torch.int32, device=mesh.device)
    push = (push_ops.push_table if isinstance(model.rot, push_ops.RotTable)
            else push_ops.push_banded)

    def rank_step(s: Dict[str, torch.Tensor]):
        tx, ty, cphi, sphi = push(
            s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
            s["active"], model.rot, cfg.h, cfg.k, cfg.d)
        if model.analytic is not None:
            elem, active = locate_ops.annulus_locate(
                model.analytic, tx, ty, s["active"])
            iters, deleted = no_iters, no_iters
        else:
            elem, active, iters, deleted = search_ops.walk_locate_counted(
                mesh.walk_geom, tx, ty, s["elem"], s["active"],
                cfg.max_search_iters, grid=model.locator)
        new_state = {"x0": tx, "x1": ty, "cphi": cphi, "sphi": sphi,
                     "b": s["b"], "elem": elem, "active": active}
        if gyro.per_particle_radius:
            new_state["rg"] = s["rg"]
        ring_accum = scatter_ops.accumulate_to_rings(
            elem, active, mesh, R, gyro.rmax,
            ptcl_radius=s["rg"] if gyro.per_particle_radius else None)
        fwd = scatter_ops.scatter_to_mapped_verts(
            ring_accum, model.gyro_fwd, mesh.nverts, R, P)
        bwd = fwd if model.gyro_bwd is model.gyro_fwd else \
            scatter_ops.scatter_to_mapped_verts(
                ring_accum, model.gyro_bwd, mesh.nverts, R, P)
        return new_state, {"fwd": fwd, "bwd": bwd, "iters": iters,
                           "all_found": deleted == 0, "deleted": deleted}

    step = full_mode.make_dp_step(rank_step, keep=("iters", "all_found", "deleted"))
    step.model = model
    return step


def initial_state(mesh: Mesh2D, cfg: XGCmConfig, seed: int = ELEMENT_SEED,
                  device=None) -> Dict[str, torch.Tensor]:
    """Seeded particle state: flat (N,) tensors x0 x1 cphi sphi b (f32),
    elem (i32), active (bool), and with a per-particle gyro radius ``rg``
    (f32, uniform in [rmax/4, rmax) from its own seed), on ``device``
    (default: the CUDA card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ppe = seed_particles_per_element(mesh, cfg, rng)
    ptcl_elems = np.repeat(np.arange(mesh.nelems), ppe)
    prng = np.random.default_rng(PARTICLE_SEED)
    pos = torch.as_tensor(uniform_points_in_elements(mesh, ptcl_elems, prng),
                          dtype=torch.float32)
    x, y = pos[:, 0].contiguous(), pos[:, 1].contiguous()
    phi, b = push_ops.elliptical_setup(x, y, cfg.h, cfg.k, cfg.d)
    state = {
        "x0": x, "x1": y, "cphi": torch.cos(phi), "sphi": torch.sin(phi),
        "b": b, "elem": torch.as_tensor(ptcl_elems, dtype=LID_DTYPE),
        "active": torch.ones(len(ptcl_elems), dtype=torch.bool),
    }
    if cfg.gyro.per_particle_radius:
        rg = np.random.default_rng(PARTICLE_SEED + 1).uniform(
            0.25 * cfg.gyro.rmax, cfg.gyro.rmax, len(ptcl_elems))
        state["rg"] = torch.as_tensor(rg.astype(np.float32))
    return {k: v.to(device) for k, v in state.items()}


def make_dp_setup(mesh: Mesh2D, cfg: XGCmConfig, device=None,
                  seed: int = ELEMENT_SEED,
                  timings: Optional[Dict[str, float]] = None,
                  locator: Optional[Union[LocatorGrid2D, BandGrid2D]] = None):
    """Build the particle state and the step for Input::FULL mode on one
    device (mesh replicated, fields summed over ranks when
    ``torch.distributed`` is initialized).  Returns (state, step).

    ``timings``, if given, receives the host seconds of the setup phases
    ("particles", "gyro_map", "locator": the annulus proof and the band or
    cartesian grid build).  ``locator``, if given, is a grid already built
    for this mesh and ``cfg`` (e.g. by an earlier setup's
    ``step.model.locator``) and is used instead of building one."""
    check_config(cfg)
    device = resolve_device(device)
    mesh = mesh.to(device)
    timings = {} if timings is None else timings

    t0 = time.perf_counter()
    state = initial_state(mesh, cfg, seed, device)
    timings["particles"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    analytic, locator = build_search(mesh, cfg, state["elem"].shape[0], locator)
    # the JAX package's choice: the band starts where the classification
    # is band-ordered and rot_analytic is on (a ring_class annulus's
    # analytic class takes precedence there, and equals the band class),
    # else the rotation-table gather
    cls = mesh.class_id.cpu().numpy()
    banded = push_ops.detect_banded_class(cls) if cfg.rot_analytic else None
    if banded is not None and analytic is not None and analytic.ring_class:
        e = torch.arange(mesh.nelems, dtype=torch.int32)
        if not torch.equal(analytic.class_of(e),
                           push_ops.class_from_bands(e, banded)):
            raise RuntimeError("the annulus's analytic classification "
                               "differs from its band-ordered one")
    if banded is not None:
        rot = push_ops.BandRotation.build(banded, cfg.deg_per_push, device)
    else:
        rot = push_ops.RotTable.build(cls, cfg.deg_per_push, device,
                                      one_dim=ROT_TABLE_1D)
    timings["locator"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gyro_fwd, gyro_bwd = gyro_maps(mesh, cfg.gyro)
    timings["gyro_map"] = time.perf_counter() - t0

    state = full_mode.shard_particles(state)
    model = DPModel(mesh, locator, rot, gyro_fwd, gyro_bwd, analytic)
    return state, make_dp_step(model, cfg)


# ---------------------------------------------------------------------------
# the single-device app on a particle structure
# ---------------------------------------------------------------------------

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


class PseudoXGCm:
    """Single-device pseudoXGCm driver on a particle structure
    (``cfg.structure``: scs, csr, cabm or dps), with the JAX package's seeds,
    fields and shapes: ``x`` and ``xtgt`` (N, 2) f32, ``pid`` i32, ``b``,
    ``phi`` f32, and ``rg`` with a per-particle gyro radius.

    Each step: the angle-form push (kernel P, phi mode; the class from the
    band starts, or gathered from ``mesh.class_id`` where the
    classification is not band-ordered), the search (kernel L; kernel A on
    a proven annulus), ``set("x")`` and ``set("phi")``, the structure's
    ``rebuild`` (sorted SCS/CabM: kernels H, S and G; CSR and sorted DPS:
    H and G; DPS: in place), then the ring accumulation and the forward and
    backward mapped scatter (kernels H and D).

    ``device`` defaults to the CUDA card; ``locator``, if given, is a grid
    already built for this mesh and ``cfg``."""

    def __init__(self, mesh: Mesh2D, cfg: XGCmConfig, seed: int = ELEMENT_SEED,
                 device=None, locator=None):
        check_config(cfg)
        if cfg.structure not in _BUILDERS:
            raise ValueError(f"unknown structure {cfg.structure!r}")
        self.device = resolve_device(device)
        self.mesh = mesh = mesh.to(self.device)
        self.cfg = cfg

        rng = np.random.default_rng(seed)
        ppe = seed_particles_per_element(mesh, cfg, rng)
        ptcl_elems = np.repeat(np.arange(mesh.nelems), ppe)
        prng = np.random.default_rng(PARTICLE_SEED)
        pos = torch.as_tensor(uniform_points_in_elements(mesh, ptcl_elems, prng),
                              dtype=torch.float32)
        phi, b = push_ops.elliptical_setup(pos[:, 0], pos[:, 1], cfg.h, cfg.k,
                                           cfg.d)
        n = len(ptcl_elems)
        fields = {
            "x": pos,
            "xtgt": torch.zeros(n, 2, dtype=torch.float32),
            "pid": torch.arange(n, dtype=torch.int32),
            "b": b,
            "phi": phi,
        }
        if cfg.gyro.per_particle_radius:
            rg = np.random.default_rng(PARTICLE_SEED + 1).uniform(
                0.25 * cfg.gyro.rmax, cfg.gyro.rmax, n)
            fields["rg"] = torch.as_tensor(rg.astype(np.float32))
        self.ptcls = _BUILDERS[cfg.structure](mesh.nelems, ptcl_elems, fields,
                                              self.device)

        self.gyro_fwd, self.gyro_bwd = gyro_maps(mesh, cfg.gyro)
        self.analytic, self.locator = build_search(mesh, cfg, n, locator)
        banded = push_ops.detect_banded_class(mesh.class_id.cpu().numpy())
        self.bands = (None if banded is None
                      else push_ops.BandClasses.build(banded, self.device))
        self.step_fn = self._make_step()

    def _make_step(self):
        mesh, cfg, gyro = self.mesh, self.cfg, self.cfg.gyro
        R, P = gyro.num_rings, gyro.points_per_ring
        no_iters = torch.zeros((), dtype=torch.int32, device=self.device)

        def step(ptcls):
            elem, active = ptcls.elem, ptcls.active
            x = ptcls.get("x")
            if self.bands is not None:
                cls = elem
            else:
                cls = mesh.class_id[torch.clamp(elem, min=0).long()]
            tx, ty, xtgt, phi_new = push_ops.push_phi(
                x, ptcls.get("phi"), ptcls.get("b"), active, cls,
                cfg.deg_per_push, cfg.h, cfg.k, cfg.d, bands=self.bands)
            if self.analytic is not None:
                elem_ids, _ = locate_ops.annulus_locate(self.analytic, tx, ty,
                                                        active)
                iters = no_iters
            elif self.locator is not None:
                res = search_ops.search_mesh_2d_accel(
                    mesh, self.locator, x, (tx, ty), elem, active,
                    cfg.max_search_iters)
                elem_ids, iters = res.elem_ids, res.iters
            else:
                res = search_ops.search_mesh_2d(
                    mesh, x, (tx, ty), elem, active, cfg.max_search_iters)
                elem_ids, iters = res.elem_ids, res.iters

            ptcls2 = ptcls.set("x", xtgt).set("phi", phi_new).rebuild(elem_ids)
            ring_accum = scatter_ops.accumulate_to_rings(
                ptcls2.elem, ptcls2.active, mesh, R, gyro.rmax,
                ptcl_radius=(ptcls2.get("rg") if gyro.per_particle_radius
                             else None))
            fwd = scatter_ops.scatter_to_mapped_verts(
                ring_accum, self.gyro_fwd, mesh.nverts, R, P)
            bwd = fwd if self.gyro_bwd is self.gyro_fwd else \
                scatter_ops.scatter_to_mapped_verts(
                    ring_accum, self.gyro_bwd, mesh.nverts, R, P)
            return ptcls2, fwd, bwd, iters

        return step

    def run(self, num_iterations: Optional[int] = None, verbose: bool = True,
            render_prefix: Optional[str] = None):
        """Step loop with the reference's telemetry: per-step time into the
        timing registry as "xgcm step" (host clock around a step that ends
        in a device synchronize, with the prebarrier wait before it),
        particle and memory imbalance, and optional VTK rendering.  Returns
        the last step's (fwd, bwd)."""
        from pumipic_torch.utils.memory import memory_imbalance
        from pumipic_torch.utils.plog import print_info
        from pumipic_torch.utils.timing import (
            prebarrier,
            record_time,
            synchronize_all,
        )

        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        fwd = bwd = None
        for i in range(iters):
            pre = prebarrier()
            t0 = time.perf_counter()
            self.ptcls, fwd, bwd, walk_iters = self.step_fn(self.ptcls)
            synchronize_all()
            record_time("xgcm step", time.perf_counter() - t0, prebarrier=pre)
            if verbose:
                mem = memory_imbalance()
                print_info(
                    "iter %d: ptcls %d walk_iters %d fwd_sum %.1f mem_imb %.2f",
                    i, self.ptcls.n_ptcls(), int(walk_iters),
                    float(fwd.sum()), mem["imbalance"])
            if render_prefix is not None:
                self.render(f"{render_prefix}_t{i}", fwd, bwd)
        return fwd, bwd

    def render(self, path: str, fwd=None, bwd=None) -> None:
        """VTK dump of the mesh with particle counts and gyro tags."""
        from pumipic_torch.io.vtk import write_vtk

        elem_fields = {
            "class_id": self.mesh.class_id.cpu().numpy(),
            "has_particles": self.ptcls.ppe().cpu().numpy(),
        }
        vert_fields = {}
        if fwd is not None:
            vert_fields["gyro_fwd"] = fwd.cpu().numpy()
        if bwd is not None:
            vert_fields["gyro_bwd"] = bwd.cpu().numpy()
        write_vtk(path, self.mesh.coords.cpu().numpy(),
                  self.mesh.elem2verts.cpu().numpy(),
                  elem_fields=elem_fields, vert_fields=vert_fields)


# ---------------------------------------------------------------------------
# distributed BFS-buffered picparts (the full reference pipeline)
# ---------------------------------------------------------------------------

STAT_KEYS = ("alive", "sent", "kept_home", "overflow", "unresolved",
             "illegal_dest", "exits", "lost")


def step_stats(nloc, mres, exits, lost) -> Dict[str, torch.Tensor]:
    """The step's ``stats`` from one ``all_gather`` of this rank's
    [alive, sent, kept home, overflow, unresolved, illegal, exits, lost]
    counts: sums (overflow: the max) over ranks, the imbalance max/avg of
    the alive counts (f32; the total summed exactly, then rounded), and the
    per-rank alive and sent counts (kernel N's reduction on the card).  The
    port's own keys: ``exits``, particles the search removed whose
    destination lies outside the domain (they crossed a model-boundary
    face), and ``lost``, particles it removed whose destination lies in the
    domain but outside this rank's picpart (a buffer too thin for the
    step's push)."""
    from pumipic_torch.parallel import group

    mine = torch.stack([nloc, mres.num_sent, mres.num_kept_home,
                        mres.overflow.to(torch.int32), mres.num_recv_unresolved,
                        mres.num_illegal_dest, exits, lost]).to(torch.int32)
    g = group.all_gather(mine)
    with group.split("glue"):
        # kernel N: the sums over the ranks (overflow: the max) and the
        # imbalance, its total exact and rounded to f32 once
        red = count_ops.rank_stats(g, STAT_KEYS.index("overflow"))
        stats = {k: red[i] for i, k in enumerate(STAT_KEYS)}
        stats["imbalance"] = red[len(STAT_KEYS):].view(torch.float32)[0]
        stats["alive_per_rank"] = g[:, 0]
        stats["sent_per_rank"] = g[:, 1]
    return stats


def make_picparts_setup(coords: np.ndarray, elem2verts: np.ndarray,
                        class_id: np.ndarray, cfg: XGCmConfig, inp=None,
                        migrate_cap: Optional[int] = None,
                        seed: int = ELEMENT_SEED, use_lb: bool = False,
                        lb_tol: float = 1.05, neighbor_migration: bool = True,
                        cap_factor: float = 1.5, partition: str = "auto",
                        banded_route: str = "auto", device=None,
                        hier: Optional[bool] = None,
                        timings: Optional[Dict[str, float]] = None):
    """This rank's part of pseudoXGCm over BFS-buffered picparts: per step
    push → local search → safe-zone migration (with the balancer where
    ``use_lb``) → gyro scatter → owner SUM reduction of the field
    (pseudoXGCm.cpp:504-534).  Call it on every rank of the group (or in
    one process: one rank).

    Every rank builds the same host picparts and keeps its own view on
    ``device`` (default: the group's device).  Knobs as in the JAX
    package: ``partition`` ("auto": sector bands on a proven annulus in
    the generator's order, else RCB; "bands"; "rcb"), ``banded_route``
    ("auto"/"off"), ``neighbor_migration`` (the neighbour exchange; False:
    the world exchange, equal bit for bit), ``cap_factor`` (slots per rank
    over the largest initial share), ``migrate_cap`` (bucket rows per
    destination, default slots/8), and the config's ``analytic_locate``:
    on a proven annulus ("auto"/"force") the search is the global analytic
    locate (kernel A) with the banded route or one [g2l | route] row per
    particle; otherwise each rank's cartesian grid and walk (kernel L).
    ``hier`` (default: whether the group has slices, ``group.set_slices``)
    routes the migration's payload and the field's reduction through the
    two-stage exchange, equal bit for bit.

    Returns (local picpart, state, gyro map, step) with ``step(state) ->
    (state, fwd, stats)`` (the step gives its input state up: on the card
    the migration writes into its member fields in place); ``fwd`` is the
    (V_local,) reduced field and
    ``stats`` holds alive, sent, kept_home, overflow, unresolved,
    illegal_dest, imbalance, alive_per_rank, sent_per_rank and the
    port's ``exits`` and ``lost`` (device tensors, see :func:`step_stats`);
    ``step.last_deposit`` is the last step's field before the reduction.
    ``timings``, if given, receives host seconds by phase ("host build",
    "seeding", "locator", "gyro map")."""
    from pumipic_torch.parallel import balancer as lbm
    from pumipic_torch.parallel import banded_route as brm
    from pumipic_torch.parallel import distributor as dstm
    from pumipic_torch.parallel import group
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import picparts as ppm
    from pumipic_torch.parallel import reduce as red

    check_config(cfg)
    if hier is None:
        hier = group.slices() > 1
    if banded_route not in ("auto", "off"):
        raise ValueError(f"unknown banded_route {banded_route!r}")
    timings = {} if timings is None else timings
    R, me = group.num_ranks(), group.rank()
    device = group.device() if device is None else resolve_device(device)
    inp = ppm.PicPartsInput() if inp is None else inp
    coords = np.asarray(coords)
    elem2verts = np.asarray(elem2verts)
    class_id = np.asarray(class_id)

    t0 = time.perf_counter()
    detected = detect_annulus_structured(coords, elem2verts, cls=class_id,
                                         device=device)
    if partition == "auto":
        partition = "bands" if detected is not None and detected.perm is None else "rcb"
    if partition == "bands":
        if detected is None:
            raise ValueError("partition='bands' needs a detection-proven "
                             "structured annulus")
        owners = brm.sector_band_owners(detected.n_rings, detected.n_sectors, R)
    elif partition == "rcb":
        owners = ppm.partition_rcb(coords, elem2verts, R)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    pp = ppm.build_picparts(coords, elem2verts, owners, R, inp, class_id)
    bt = lbm.build_balancer(pp, R) if use_lb else None
    # the JAX package's multi-slice schedule colours the edges within a
    # slice first; the exchange reads only each rank's peers
    slice_of_rank = (np.repeat(np.arange(group.slices()), R // group.slices())
                     if hier else None)
    nplan = (mig.build_neighbor_plan(dstm.from_picparts(pp), slice_of_rank)
             if neighbor_migration else None)
    lpp = pp.local_view(me, device)
    lmesh = lpp.mesh
    timings["host build"] = time.perf_counter() - t0

    # --- seeding on the global mesh (every rank the same), kept by owner
    t0 = time.perf_counter()
    gmesh = Mesh2D.from_numpy(ppm.mesh_arrays(2, coords, elem2verts, class_id), "cpu")
    ppe = seed_particles_per_element(gmesh, cfg, np.random.default_rng(seed))
    g_elems = np.repeat(np.arange(gmesh.nelems), ppe)
    pos = uniform_points_in_elements(gmesh, g_elems, np.random.default_rng(PARTICLE_SEED))
    pos32 = torch.as_tensor(pos, dtype=torch.float32)
    phi, b = push_ops.elliptical_setup(pos32[:, 0].contiguous(),
                                       pos32[:, 1].contiguous(), cfg.h, cfg.k, cfg.d)
    phi, b = phi.numpy(), b.numpy()
    own_of_ptcl = owners[g_elems]
    n_cap = max(int(np.bincount(own_of_ptcl, minlength=R).max() * cap_factor) + 8, 64)

    analytic = None
    if cfg.analytic_locate in ("auto", "force"):
        analytic = detected
        if analytic is None and cfg.analytic_locate == "force":
            raise ValueError("analytic_locate='force' but the mesh is not "
                             "a structured annulus")
    br = None
    if analytic is not None and banded_route == "auto" and analytic.perm is None:
        br = brm.derive_banded_route(pp, owners, analytic, bt, R)
        # kernel Y1's banded form holds Y1_MAX_RUNS sbar runs; a map of
        # more keeps the [g2l | route] row (the same routes)
        if br is not None and len(br.sbar_runs) > route_ops.Y1_MAX_RUNS:
            br = None

    sel = np.nonzero(own_of_ptcl == me)[0]
    n = len(sel)
    eg = pp.elem_gid[me]
    g2l = np.full(gmesh.nelems, -1, np.int64)
    g2l[eg[eg >= 0]] = np.nonzero(eg >= 0)[0]

    def slots(vals, fill, dtype):
        out = np.full(n_cap, fill, dtype)
        out[:n] = vals
        return torch.as_tensor(out, device=device)

    state = {
        "x0": slots(pos[sel, 0], 0, np.float32),
        "x1": slots(pos[sel, 1], 0, np.float32),
        "cphi": slots(np.cos(phi[sel]), 0, np.float32),
        "sphi": slots(np.sin(phi[sel]), 0, np.float32),
        "b": slots(b[sel], 0, np.float32),
        "pid": slots(sel, -1, np.int32),
        "elem": slots(g2l[g_elems[sel]], -1, np.int32),
        "active": slots(True, False, bool),
    }
    if analytic is not None:
        state["gelem"] = slots(g_elems[sel], -1, np.int32)
    if cfg.gyro.per_particle_radius:
        rg_all = np.random.default_rng(PARTICLE_SEED + 1).uniform(
            0.25 * cfg.gyro.rmax, cfg.gyro.rmax, cfg.num_ptcls)
        state["rg"] = slots(rg_all[sel], 0, np.float32)
    timings["seeding"] = time.perf_counter() - t0

    # --- this rank's gyro map, rotation and locator
    t0 = time.perf_counter()
    gyro = cfg.gyro
    gmap = scatter_ops.GyroMap.from_flat(build_gyro_mapping(lmesh, gyro),
                                         lmesh.nverts, gyro.num_rings,
                                         gyro.points_per_ring, device)
    timings["gyro map"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # the port's rotation rule (as make_dp_setup's): a band-ordered local
    # classification through its band starts (kernel P), any other, or
    # rot_analytic off, through the per-element table (P's table mode)
    cls_local = lmesh.class_id.cpu().numpy()
    bands = push_ops.detect_banded_class(cls_local) if cfg.rot_analytic else None
    if bands is not None:
        rot = push_ops.BandRotation.build(bands, cfg.deg_per_push, device)
    else:
        rot = push_ops.RotTable.build(cls_local, cfg.deg_per_push, device)
    push = (push_ops.push_banded if bands is not None else push_ops.push_table)
    locator = None
    if cfg.use_locator and analytic is None:
        cpe, peel, _ = resolve_locator_policy(cfg, pp.nelems, n_cap)
        lc, lev = lmesh.coords.cpu().numpy(), lmesh.elem2verts.cpu().numpy()
        if cfg.band_locator == "force":
            locator = detect_banded_locator(lc, lev, cls_local, lmesh.walk_geom,
                                            n_theta=cfg.band_theta, device=device)
            ok = group.all_gather(torch.tensor(locator is not None, device=device))
            if not bool(ok.all()):
                raise ValueError("band_locator='force' but a picpart is not a "
                                 "stitched flux-band structure")
        else:
            locator = build_locator_grid(lc, lev, cells_per_elem=cpe,
                                         walk_geom=lmesh.walk_geom.cpu(), peel=peel,
                                         polar=False, device=device)
    if migrate_cap is None:
        migrate_cap = max(n_cap // 8, 64)
    n_sbars = bt.num_sbars if bt is not None else 0
    if not mig.route_pack_bound_ok(n_sbars, R):
        raise ValueError(f"route pack exceeds f32 exactness: S={n_sbars} R={R}")
    E_l = lmesh.nelems
    sbar_local = (None if bt is None else
                  torch.as_tensor(bt.sbar_of_elem[me][:E_l], device=device))
    route = mig.pack_route(lpp.elem_safe, lpp.elem_owner, sbar_local, R)
    g2l_tbl = None
    if analytic is not None and br is None:
        fused = np.zeros((gmesh.nelems, 2), np.int32)
        fused[:, 0] = g2l
        valid = g2l >= 0
        fused[valid, 1] = route.cpu().numpy().astype(np.int64)[g2l[valid]]
        g2l_tbl = torch.as_tensor(fused, device=device)
    br_params = br.params(me) if br is not None else None
    timings["locator"] = time.perf_counter() - t0

    R_g, P_g = gyro.num_rings, gyro.points_per_ring
    # the walk arm tells an exit from a particle lost off the picpart by a
    # plain walk on the global mesh (no walk this long is cut short unless
    # it cycles; a cut one counts as lost)
    g_walk = gmesh.walk_geom.to(device) if analytic is None else None
    g_walk_iters = gmesh.nelems
    # the owner SUM's send rows, written by the deposit as it writes the
    # field (its gather fused into kernel D): one buffer for every step
    send_rows = red.sum_send_rows(lpp.vert_send_ids, lmesh.nverts)

    def step(s: Dict[str, torch.Tensor]):
        elem, active = s["elem"], s["active"]
        with group.split("compute"):
            tx, ty, cphi, sphi = push(s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"],
                                      elem, active, rot, cfg.h, cfg.k, cfg.d)
            if analytic is not None:
                e_gl, _ = locate_ops.annulus_locate(analytic, tx, ty, active)
            else:
                elem_ids, _, _, _ = search_ops.walk_locate(
                    lmesh.walk_geom, tx, ty, elem, active, cfg.max_search_iters,
                    grid=locator)
                # the particles the local walk removed, walked again on the
                # global mesh from their previous element: found there, the
                # destination lies in the domain but off this picpart
                removed = active & (elem_ids < 0)
                g_start = lpp.elem_gid[torch.clamp(elem, min=0).long()]
                found, g_all = search_ops.walk_locate_count(
                    g_walk, tx, ty, g_start, removed, g_walk_iters)
                lost = found + (~g_all).to(torch.int32)
        with group.split("glue"):
            # kernel Y1: the route, the live mask and, on the analytic arms,
            # the local and global elements, in one pass
            if analytic is not None and br is not None:
                routed = route_ops.route_banded(br_params, e_gl, active)
            elif analytic is not None:
                routed = route_ops.route_g2l(g2l_tbl, e_gl, active, me, R)
            else:
                routed = route_ops.route_packed(route, elem_ids, active, me, R)
            if analytic is not None:
                elem_ids = routed.elem
            dest = routed.dest
            mid = {"x0": tx, "x1": ty, "cphi": cphi, "sphi": sphi, "b": s["b"],
                   "pid": s["pid"], "elem": elem_ids, "active": routed.live}
            if gyro.per_particle_radius:
                mid["rg"] = s["rg"]
            if analytic is not None:
                mid["gelem"] = routed.gelem
        if bt is not None:
            dest = lbm.repartition(bt, sbar_local, elem_ids, routed.live, dest, me,
                                   lb_tol, sbar_of_ptcl=routed.sbar,
                                   noncore=routed.noncore, num_ranks=R)
        mres = mig.migrate(mid, elem_ids, dest, lpp.elem_gid, lpp.elem_gid_sorted,
                           lpp.elem_gid_perm, me, R, migrate_cap, plan=nplan,
                           hier=hier)
        s2 = mres.state
        with group.split("compute"):
            if gyro.per_particle_radius:
                ring = scatter_ops.accumulate_to_rings(
                    s2["elem"], s2["active"], lmesh, R_g, gyro.rmax,
                    ptcl_radius=s2["rg"])
                fwd = scatter_ops.scatter_to_mapped_verts(ring, gmap, lmesh.nverts,
                                                          R_g, P_g, send_rows)
            else:
                fwd = scatter_ops.gyro_scatter(s2["elem"], s2["active"], lmesh, gmap,
                                               R_g, P_g, gyro.rmax, send_rows)
        step.last_deposit = fwd
        fwd = red.reduce_comm_array(lpp.vert_send_ids, lpp.vert_recv_ids, fwd,
                                    red.Op.SUM, hier=hier, send_vals=send_rows[1])
        with group.split("glue"):
            # kernel N: the alive count and the search's exits (and lost,
            # on the analytic arms) in one launch
            alive = [("set", s2["active"])]
            removed = [("set", active), ("neg", elem_ids)]
            if analytic is not None:
                nloc, lost, exits = count_ops.slot_counts(
                    [alive, removed + [("nonneg", e_gl)], removed + [("neg", e_gl)]])
            else:
                nloc, exits = count_ops.slot_counts([alive, removed], [None, lost])
        return s2, fwd, step_stats(nloc, mres, exits, lost)

    step.last_deposit = None    # the last step's field before the reduction
    return lpp, state, gmap, step


def shrink_picparts_capacity(state: Dict[str, torch.Tensor], new_cap: int):
    """This rank's picparts state at ``new_cap`` slots, live particles
    compacted to a slot prefix first (every rank calls it); prefer
    :class:`pumipic_torch.parallel.capacity.CapacityMonitor` in loops."""
    from pumipic_torch.parallel.capacity import resize_capacity

    return resize_capacity(state, new_cap)
