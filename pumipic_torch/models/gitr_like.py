"""GITR-style impurity transport (port of ``pumipic_tpu.models.gitr_like``):
the Boris push through a gridded E field, the 3D intersection walk with
wall interaction, and the wall-flux tally.

The reference's second flagship consumer is GITR(m): magnetized impurity
ions pushed with the Boris integrator through a tet mesh, fields
interpolated from grids, and wall interactions at exposed faces.  Each step
of :class:`GitrLike`:

1. kernel R (:func:`~pumipic_torch.ops.push.boris_push_grid`): E trilinear
   from the (nx, ny, nz, 3) grid at each position (read as the grid's
   corner rows, built once in ``__init__``), a uniform B, the Boris
   velocity update and the position step;
2. kernel M (:func:`~pumipic_torch.ops.search.search_mesh_3d` with
   ``method="intersection"`` and ``record_exit``): the Möller–Trumbore walk
   from each particle's tet to its new position, removing it at the wall
   (``wall="absorb"``) or mirroring it there (``wall="reflect"``);
3. kernel F (:func:`~pumipic_torch.ops.push.gitr_update`): with the
   reflecting wall the specular velocity, |v| along the last leg from the
   last hit point to the mirrored destination; the state update (a lost
   particle keeps its position) and the lost mask;
4. kernel W (:func:`~pumipic_torch.ops.scatter.wall_tally`): each lost
   particle counts once on its exit face (absorb), each reflecting particle
   its ``num_hits`` on its last face hit (reflect), added to ``wall_hits``
   as f32.

Seeding makes the JAX package's numpy Generator calls in its order, so the
initial state is bit-identical.  Entry points run on the CUDA card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pumipic_torch.mesh.core import Mesh3D
from pumipic_torch.ops import push as push_ops
from pumipic_torch.ops import scatter as scatter_ops
from pumipic_torch.ops import search as search_ops
from pumipic_torch.utils.device import resolve_device

WALLS = ("absorb", "reflect")


@dataclass(frozen=True)
class GitrConfig:
    """Same fields and defaults as the JAX package's GitrConfig."""

    num_ptcls: int = 10_000
    num_iterations: int = 10
    dt: float = 1e-8
    charge: float = 1.0
    amu: float = 10.0
    b_field: Tuple[float, float, float] = (0.0, 0.0, 1.0)  # uniform
    max_search_iters: int = 100
    # tally wall hits per boundary face (the reference's deposition)
    count_wall_hits: bool = True
    # wall interaction: "absorb" (remove + tally) or "reflect" (specular)
    wall: str = "absorb"


def seed_state(mesh: Mesh3D, num_ptcls: int, seed: int = 0):
    """(elems, pos, vel) as numpy arrays: each particle's tet (uniform over
    the tets), a Dirichlet-weighted mix of its vertices (f64 of the f32
    coordinates) and N(0, 1e3) m/s velocity components, from the JAX
    package's Generator calls in its order."""
    rng = np.random.default_rng(seed)
    elems = rng.integers(0, mesh.nelems, size=num_ptcls)
    ev = mesh.elem2verts.cpu().numpy()[elems]
    cz = mesh.coords.cpu().numpy()
    w = rng.dirichlet(np.ones(4), size=num_ptcls)
    pos = np.einsum("nk,nkd->nd", w, cz[ev])
    vel = rng.normal(scale=1e3, size=(num_ptcls, 3))
    return elems, pos, vel


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.array(a, np.float32), device=device)


class GitrLike:
    """E from a uniform 3D grid (trilinear), B uniform; Boris push;
    intersection walk; wall absorption or reflection; wall-flux tally.

    ``e_spacing`` is the grid's CELL spacing; without ``e_grid`` the field
    is zero on a 2x2x2 grid over the mesh's box.  ``state`` holds ``x``
    (N, 3) f32, ``v`` (N, 3) f32, ``elem`` (N,) i32 and ``active`` (N,)
    bool; ``wall_hits`` (n_faces,) f32 (or (1,) without the tally);
    ``field_host`` the grid's origin and spacing and B as host f32 arrays."""

    def __init__(self, mesh: Mesh3D, cfg: GitrConfig, e_grid=None, e_origin=None,
                 e_spacing=None, seed: int = 0, device=None):
        if cfg.wall not in WALLS:
            raise ValueError(f"unknown wall {cfg.wall!r}; expected one of {WALLS}")
        self.device = dev = resolve_device(device)
        self.mesh = mesh = mesh.to(dev)
        self.cfg = cfg
        elems, pos, vel = seed_state(mesh, cfg.num_ptcls, seed)
        self.state = {
            "x": torch.as_tensor(pos.astype(np.float32), device=dev),
            "v": torch.as_tensor(vel.astype(np.float32), device=dev),
            "elem": torch.as_tensor(elems.astype(np.int32), device=dev),
            "active": torch.ones(cfg.num_ptcls, dtype=torch.bool, device=dev),
        }
        if e_grid is None:
            cz = mesh.coords.cpu().numpy()
            e_grid = np.zeros((2, 2, 2, 3), np.float32)
            e_origin = cz.min(0)
            e_spacing = (cz.max(0) - cz.min(0)) / np.asarray(
                [max(s - 1, 1) for s in e_grid.shape[:3]])
        elif e_spacing is None:
            raise ValueError("e_grid without e_spacing (the cell spacing)")
        self.e_grid = _f32(e_grid, dev)
        # kernel R's corner table of the grid, built once
        self.e_corners = push_ops.grid_corner_rows(self.e_grid)
        self.e_origin = _f32(e_origin, dev)
        self.e_spacing = _f32(e_spacing, dev)
        self.b_field = _f32(cfg.b_field, dev)
        # the same three vectors on the host, for kernel R's launch
        # parameters (read from device tensors, each step would wait for
        # the card)
        self.field_host = tuple(t.cpu().numpy() for t in
                                 (self.e_origin, self.e_spacing, self.b_field))
        self.wall_hits = torch.zeros(mesh.nfaces if cfg.count_wall_hits else 1,
                                     dtype=torch.float32, device=dev)
        # the last step's walk iterations (a 0-d i32 tensor)
        self.iters = torch.zeros((), dtype=torch.int32, device=dev)

    def step(self, state, wall_hits):
        """One step; returns (state, wall_hits) (see the module docstring)."""
        mesh, cfg = self.mesh, self.cfg
        x, v, elem, active = state["x"], state["v"], state["elem"], state["active"]
        x_new, v_new = push_ops.boris_push_grid(
            x, v, self.e_grid, *self.field_host, cfg.dt, cfg.charge, cfg.amu,
            corners=self.e_corners)
        reflect = cfg.wall == "reflect"
        res = search_ops.search_mesh_3d(
            mesh, x, x_new, elem, active, cfg.max_search_iters,
            boundary_handler=(search_ops.reflect_on_exit_3d if reflect
                              else search_ops.remove_on_exit),
            method="intersection", record_exit=cfg.count_wall_hits or reflect)
        self.iters = res.iters
        # kernel F: the specular velocity (reflect), the lost mask and the
        # state update; on the card dest and hit are kernel M's own (N, 3)
        # outputs
        x, v, active_new, lost = push_ops.gitr_update(
            x, v, v_new, res.dest, res.hit, res.elem_ids, res.num_hits, active, reflect)
        state = {"x": x, "v": v, "elem": res.elem_ids, "active": active_new}
        if cfg.count_wall_hits:
            if reflect:
                counts = scatter_ops.wall_tally(res.exit_side, active, res.num_hits,
                                                mesh.nfaces)
            else:
                counts = scatter_ops.wall_tally(res.exit_side, lost, None, mesh.nfaces)
            wall_hits = wall_hits + counts.to(torch.float32)
        return state, wall_hits

    def run(self, num_iterations: Optional[int] = None):
        """Step loop; returns the alive count after each step."""
        iters = (num_iterations if num_iterations is not None
                 else self.cfg.num_iterations)
        history = []
        for _ in range(iters):
            self.state, self.wall_hits = self.step(self.state, self.wall_hits)
            history.append(int(self.state["active"].sum()))
        return history

