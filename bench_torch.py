"""Benchmark of the PyTorch/CUDA port on one GPU: pseudoXGCm FULL-mode step
throughput (``BENCH_MODE=dp``, the default), pseudoPushAndSearch's 3D
step (``BENCH_MODE=pps3d``), the GITR-style impurity-transport step
(``BENCH_MODE=gitr``) and pseudoXGCm over BFS-buffered picparts as ranks of
a ``torch.distributed`` group (``BENCH_MODE=picparts``).

``picparts`` is ``bench.py``'s picparts mode (:func:`setup_picparts`): the
generated annulus (or ``BENCH_MESH``), 10M particles in all, the balancer,
safe-zone migration and the owner reduction of the field each step.  Ranks
come from ``torchrun --nproc-per-node N`` (``BENCH_BACKEND``, default
nccl) or from ``BENCH_RANKS=N`` processes started on this machine
(``BENCH_BACKEND``, default gloo, so that several ranks may share one
card); rank 0 prints the record, whose ``detail`` adds the ranks, the
backend and the per-step split of rank 0's CUDA stream into compute,
collectives and the exchange's torch glue (``split_ms_per_step``).

``dp`` is the port's counterpart of ``bench.py``'s default mode, at the same
settings: the imported 120k-element gmsh tokamak mesh
(``data/xgc_like_120k.msh.gz``), 10M particles, ``mdl_face`` = max class // 2,
15 degrees per push, 64 search iterations, the default gyro configuration.
Each step is push (kernel P) -> peel + walk + DPS rewrite (kernel L) ->
histogram (kernel H) -> gyro deposit (kernel D).

``pps3d`` is ``bench.py``'s pps3d mode: ``box_tet_mesh(n, n, n)`` with n =
round((BENCH_ELEMS / 6)^(1/3)) (16 for the default 24,000: 24,576 tets),
10M particles, a periodic wall, 64 search iterations.  Each step is push +
wrap + analytic Kuhn locate (kernel K) or, with ``BENCH_KUHN=off``, push +
wrap + peel + BCC walk (kernel L3), then the structure's rebuild (DPS:
kernel Q; a sorted layout: kernels C, H, S, G and Q, Sell-C-σ's row
order kernel C over kernel Z's key; ``BENCH_REBUILD=auto`` on scs or
cabm: kernel U1, then the reshuffle, kernels C, G and U2, where the
movers fit the padding, else the sort rebuild); with
``BENCH_WALL=reflect`` push (K's push-only form) + peel + BCC walk with the
reflecting wall (kernel M), then the rebuild.

``gitr`` is the port's own mode (``bench.py`` has none): the GITR-style app
on ``box_tet_mesh(n, n, n)`` with n = round((BENCH_ELEMS / 6)^(1/3)) (32
for the default 196,608 tets), 10M particles seeded by the app, amu 10,
charge 1, dt = 2e-5 s, B = (0, 0, 1.3e-3) T, an (n+1, n+1, n+1, 3) E grid
of N(0, 0.2) V/m components over the unit box (numpy seed 0), 100 search
iterations and the wall tally.  Each step is kernel R (grid E + Boris
push), kernel M (intersection walk, ``record_exit``, remove or reflect),
kernel F (the specular velocity with the reflecting wall, the state
update) and kernel W (wall tally).

Environment knobs, as in ``bench.py`` (each also a keyword of :func:`main`,
which wins over the environment):

- ``BENCH_MODE`` (``mode``): ``dp``, ``pps3d``, ``gitr`` or ``picparts``;
- ``BENCH_PTCLS`` (particles, default 10M), ``BENCH_ITERS`` (timed steps,
  default 20);
- ``BENCH_MESH``: a .msh or .msh.gz path, or ``annulus`` for the generated
  structured annulus of ``BENCH_ELEMS`` elements (default 24,000; 23,976
  triangles), whose proven analytic locate is kernel A;
  ``chip_tree/xgc_like_1M.msh.gz`` is the production-class mesh (981,178
  triangles, :func:`production_mesh`), generated there at first use;
- ``BENCH_ANALYTIC`` (``analytic_locate``, default ``auto``; ``off`` walks
  even on the annulus);
- ``BENCH_BANDLOC`` (``band_locator``, default ``auto``; ``force`` takes
  the flux-band locator, kernels B + L) and ``BENCH_BANDT`` (its θ-bins
  per band, default: the JAX package's sizing rule);
- ``BENCH_GYRO_PPR=1``: per-particle gyro radius (kernel H's key mode);
- ``BENCH_ROT_ANALYTIC=0`` (``rot_analytic``): the per-element rotation
  table push (kernel P's table mode) instead of the band classes;
- ``BENCH_LOCATOR=off`` (``use_locator=False``): no locator grid, the
  search is the plain walk from each particle's previous element (kernel
  L's dense plain walk), as the reference PUMI-PIC's adjacency search;
- pps3d: ``BENCH_ELEMS``, ``BENCH_STRUCT`` (``structure``, default
  ``dps``), ``BENCH_KUHN`` (``kuhn``, default ``auto``; ``off`` walks),
  ``BENCH_DIST`` (``distance``, default 0.05), ``BENCH_REBUILD``
  (``rebuild``, default ``sort``) and ``BENCH_WALL`` (``wall``, default
  ``periodic``; ``reflect`` walks with the reflecting wall);
- gitr: ``BENCH_ELEMS`` (default 196,608) and ``BENCH_WALL`` (``wall``,
  ``reflect`` by default, or ``absorb``).

Prints ONE JSON line with bench.py's keys plus ``"impl": "torch"``, the GPU's
name and bench.py's row ``tag`` (e.g. ``dp-xgc_like_120k-bandloc``, ``dp``,
``dp-xgc_like_120k-rotgather``, the port's ``dp-xgc_like_120k-nolocator``,
``pps3d-dps``, ``pps3d-dps-walk``; the
port's own ``pps3d-dps-reflect``, ``gitr-reflect`` and ``gitr-absorb``) in
``detail``.  It writes no file.

    python3 bench_torch.py

Measures on a CUDA device and fails without one.  ``main(device="cpu")`` runs
the same path on the CPU, with the kernels' plain versions, for rehearsals;
its JSON then names the CPU and no GPU.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

PROXY_BASELINE_PTCLS_PER_SEC = 2.0e7
ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_MESH = os.path.join(ROOT, "data", "xgc_like_120k.msh.gz")
GENERATED_MESHES = ("annulus", "gen", "none")
# the production-class tokamak mesh: scripts/make_xgc_mesh.py's 120k
# generator arguments (120, 620) scaled by ~sqrt(8), 981,178 triangles;
# written at first use into the git-ignored chip_tree/, never committed
PRODUCTION_MESH = os.path.join(ROOT, "chip_tree", "xgc_like_1M.msh.gz")
PRODUCTION_SHAPE = (340, 1750)


def production_mesh(path: Optional[str] = None) -> str:
    """The path of the ~1M-element tokamak mesh (``path``, by default
    :data:`PRODUCTION_MESH`), a gzip'd gmsh file written with the port's
    ``tokamak_mesh(*PRODUCTION_SHAPE)`` and ``write_msh2`` when it does not
    exist yet (into a temporary name first, so an
    interrupted write leaves no partial file); an existing file is reused.
    Readers take it through ``read_msh`` like any imported mesh."""
    path = path or PRODUCTION_MESH
    if not os.path.exists(path):
        from pumipic_torch.mesh.generate import tokamak_mesh
        from pumipic_torch.mesh.gmsh import write_msh2

        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.gz"
        write_msh2(tmp, *tokamak_mesh(*PRODUCTION_SHAPE))
        os.replace(tmp, path)
    return path


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_tag(num_ptcls: int, mesh_path: str, analytic_locate: str,
              band_locator: str, gyro_ppr: bool, rot_analytic: bool = True,
              use_locator: bool = True) -> str:
    """``bench.py``'s row tag for its ``dp`` mode (``-nolocator`` for the
    plain walk without a locator grid is the port's own)."""
    tag = "dp"
    if mesh_path not in GENERATED_MESHES:
        tag += "-" + os.path.basename(mesh_path).split(".")[0]
    if not use_locator:
        tag += "-nolocator"
    if gyro_ppr:
        tag += "-pprad"
    if analytic_locate == "off":
        tag += "-walk"
    if not rot_analytic:
        tag += "-rotgather"
    if band_locator == "force":
        tag += "-bandloc"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    return tag


def pps3d_tag(num_ptcls: int, structure: str, rebuild: str, kuhn: str,
              wall: str = "periodic") -> str:
    """``bench.py``'s row tag for its ``pps3d`` mode (``-reflect`` for the
    reflecting wall, which always walks, is the port's own)."""
    tag = f"pps3d-{structure}"
    if rebuild != "sort":
        tag += "-" + rebuild
    if wall == "reflect":
        tag += "-reflect"
    elif kuhn == "off":
        tag += "-walk"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    return tag


def setup_pps3d(device, num_ptcls=None, mesh_elems=None, structure=None,
                kuhn=None, distance=None, rebuild=None, locator=None, wall=None):
    """Resolve the pps3d knobs (a keyword, else its environment variable,
    else ``bench.py``'s default) and build the app on ``device``.  Returns
    (mesh, state, step, info) as :func:`setup`; the state is the particle
    structure and ``step`` returns (structure, {"iters": ...}).  ``locator``:
    a 3D grid already built for this mesh (the walk arm skips the build)."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models.pseudo_push_and_search import (
        PseudoPushAndSearch, PushSearchConfig)

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 24_000))
    structure = structure or env("BENCH_STRUCT", "dps")
    kuhn = kuhn or env("BENCH_KUHN", "auto")
    distance = float(distance or env("BENCH_DIST", 0.05))
    rebuild = rebuild or env("BENCH_REBUILD", "sort")
    wall = wall or env("BENCH_WALL", "periodic")

    seconds = {}
    t0 = time.perf_counter()
    n_side = max(int(round((mesh_elems / 6) ** (1.0 / 3.0))), 2)
    mesh = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=device)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = PushSearchConfig(num_ptcls=num_ptcls, structure=structure,
                           wall=wall, distance=distance,
                           max_search_iters=64, rebuild_mode=rebuild, kuhn=kuhn)
    app = PseudoPushAndSearch(mesh, cfg, device=device, locator=locator)
    seconds.update(app.setup_s)

    def step(ptcls):
        ptcls, iters = app.step_fn(ptcls)
        return ptcls, {"iters": iters}

    info = {"num_ptcls": num_ptcls, "setup_s": seconds,
            "tag": pps3d_tag(num_ptcls, structure, rebuild, kuhn, wall)}
    return mesh, app.ptcls, step, info


GITR_DT = 2e-5                    # s: the mean step is about one tet edge
GITR_B = (0.0, 0.0, 1.3e-3)       # T: q'|B| = 0.125, 0.25 rad of gyration a step
GITR_E_SIGMA = 0.2                # V/m per E component


def gitr_field(n_side: int, seed: int = 0):
    """The gitr mode's E grid over the unit box: (n+1, n+1, n+1, 3) f32 of
    N(0, GITR_E_SIGMA) components from numpy's Generator, with its origin
    and cell spacing."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(0.0, GITR_E_SIGMA, (n_side + 1,) * 3 + (3,)).astype(np.float32)
    return grid, np.zeros(3, np.float32), np.full(3, 1.0 / n_side, np.float32)


def setup_gitr(device, num_ptcls=None, mesh_elems=None, wall=None, mesh=None):
    """Resolve the gitr knobs and build the GITR-style app on ``device``;
    returns (mesh, state, step, info) as :func:`setup`.  The state is the
    app's state dict; ``step`` returns (state, {"iters", "wall_hits"}).
    ``mesh``: the box already built on ``device`` (its build is skipped)."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models.gitr_like import GitrConfig, GitrLike

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 196_608))
    wall = wall or env("BENCH_WALL", "reflect")
    n_side = max(int(round((mesh_elems / 6) ** (1.0 / 3.0))), 2)

    seconds = {}
    t0 = time.perf_counter()
    if mesh is None:
        mesh = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=device)
    seconds["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid, origin, spacing = gitr_field(n_side)
    cfg = GitrConfig(num_ptcls=num_ptcls, dt=GITR_DT, b_field=GITR_B, wall=wall,
                     count_wall_hits=True, max_search_iters=100)
    app = GitrLike(mesh, cfg, grid, origin, spacing, seed=0, device=device)
    seconds["app"] = time.perf_counter() - t0

    def step(state):
        state, app.wall_hits = app.step(state, app.wall_hits)
        return state, {"iters": app.iters, "wall_hits": app.wall_hits}

    tag = f"gitr-{wall}"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    info = {"num_ptcls": num_ptcls, "setup_s": seconds, "tag": tag}
    return mesh, app.state, step, info


def setup(device, num_ptcls=None, mesh_path=None, mesh_elems=None,
          analytic_locate=None, band_locator=None, band_theta=None,
          gyro_ppr=None, locator=None, rot_analytic=None, use_locator=None,
          mesh=None):
    """Resolve the knobs (a keyword, else its environment variable, else
    ``bench.py``'s default) and build the run on ``device``.  Returns
    (mesh, state, step, info): ``info`` holds ``num_ptcls``, the row
    ``tag`` and the setup seconds by phase (``setup_s``).  ``locator``: a
    grid already built for this mesh and configuration, passed on to
    ``make_dp_setup`` (it skips the build); ``mesh``: the ``Mesh2D`` of
    ``mesh_path`` already read onto ``device`` (the read is skipped).  The
    production mesh's path (:data:`PRODUCTION_MESH`) is generated at first
    use."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_default_mesh, make_dp_setup)

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_path = mesh_path or env("BENCH_MESH") or DEFAULT_MESH
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 24_000))
    analytic_locate = analytic_locate or env("BENCH_ANALYTIC", "auto")
    band_locator = band_locator or env("BENCH_BANDLOC", "auto")
    if band_theta is None and env("BENCH_BANDT"):
        band_theta = int(env("BENCH_BANDT"))
    if gyro_ppr is None:
        gyro_ppr = bool(int(env("BENCH_GYRO_PPR", "0")))
    if rot_analytic is None:
        rot_analytic = bool(int(env("BENCH_ROT_ANALYTIC", "1")))
    if use_locator is None:
        use_locator = env("BENCH_LOCATOR", "on") != "off"

    seconds = {}
    t0 = time.perf_counter()
    if mesh is None and mesh_path in GENERATED_MESHES:
        mesh = make_default_mesh(mesh_elems, device=device)
    elif mesh is None:
        if os.path.abspath(mesh_path) == PRODUCTION_MESH:
            production_mesh()
            seconds["mesh file"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        coords, tris, cls = read_msh(mesh_path)
        mesh = Mesh2D.from_arrays(coords, tris, cls, device=device)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = XGCmConfig(
        num_ptcls=num_ptcls,
        mdl_face=max(int(mesh.class_id.max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(per_particle_radius=gyro_ppr),
        analytic_locate=analytic_locate,
        band_locator=band_locator,
        band_theta=band_theta,
        rot_analytic=rot_analytic,
        use_locator=use_locator,
    )
    state, step = make_dp_setup(mesh, cfg, device, timings=seconds,
                                locator=locator)
    info = {"num_ptcls": num_ptcls, "setup_s": seconds,
            "tag": bench_tag(num_ptcls, mesh_path, analytic_locate,
                             band_locator, gyro_ppr, rot_analytic, use_locator)}
    return mesh, state, step, info


def picparts_tag(num_ptcls: int, mesh_path: str, cap_factor: float, adapt: bool,
                 analytic_locate: str, route: str, buffer_layers: int = 3,
                 slices: int = 1) -> str:
    """``bench.py``'s row tag for its ``picparts`` mode (the port's
    ``-buf<N>`` where the BFS buffer is not the default 3 layers, and
    ``-<S>slices`` over a group of S slices)."""
    tag = "picparts"
    if mesh_path not in GENERATED_MESHES:
        tag += "-" + os.path.basename(mesh_path).split(".")[0]
    tag += f"-capf{cap_factor:g}"
    if adapt:
        tag += "-adapt"
    if analytic_locate == "off":
        tag += "-walk"
    if route == "gather":
        tag += "-gatherroute"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    if buffer_layers != 3:
        tag += f"-buf{buffer_layers}"
    if slices != 1:
        tag += f"-{slices}slices"
    return tag


def setup_picparts(device, num_ptcls=None, mesh_path=None, mesh_elems=None,
                   analytic_locate=None, cap_factor=None, route=None, adapt=None,
                   neighbor_migration=True, buffer_layers=None, slices=None):
    """Resolve the picparts knobs (a keyword, else its environment variable,
    else ``bench.py``'s default) and build this rank's part of the run on
    ``device``.  Returns (mesh info, state, step, info) as :func:`setup`;
    ``step`` returns (state, {"fwd", "stats"}).  ``bench.py``'s picparts
    knobs: ``BENCH_MESH`` (default: the generated annulus of
    ``BENCH_ELEMS`` elements), ``BENCH_CAPF`` (``cap_factor``, default
    1.05), ``BENCH_ROUTE`` (``route``: ``gather`` keeps the [g2l | route]
    row where the banded route holds), ``BENCH_ANALYTIC`` and
    ``BENCH_ADAPT=1`` (3 observed steps, then the capacity monitor's
    resize); the port's ``BENCH_BUFFER`` (``buffer_layers``: the BFS
    buffer's vertex layers, default 3 as ``bench.py``'s; a push that
    outruns the buffer loses particles off the picparts, ``stats["lost"]``)
    and ``BENCH_SLICES`` (``slices``: the group split into that many
    slices, the exchanges on the two-stage route; default 1).  The balancer
    is on."""
    from pumipic_torch.mesh.generate import annulus_mesh
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_picparts_setup)
    from pumipic_torch.parallel.capacity import CapacityMonitor
    from pumipic_torch.parallel.picparts import PicPartsInput

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_path = mesh_path or env("BENCH_MESH") or "annulus"
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 24_000))
    analytic_locate = analytic_locate or env("BENCH_ANALYTIC", "auto")
    cap_factor = float(cap_factor or env("BENCH_CAPF", 1.05))
    route = route or env("BENCH_ROUTE", "auto")
    buffer_layers = int(buffer_layers or env("BENCH_BUFFER", 3))
    slices = int(slices or env("BENCH_SLICES", 1))
    if adapt is None:
        adapt = env("BENCH_ADAPT", "0") != "0"
    seconds = {}
    t0 = time.perf_counter()
    if mesh_path in GENERATED_MESHES:
        n_rings = max(int(np.sqrt(mesh_elems / 8)), 2)
        coords, tris, cls = annulus_mesh(n_rings, mesh_elems // (2 * n_rings), 0.3, 1.0)
    else:
        coords, tris, cls = read_msh(mesh_path)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = XGCmConfig(num_ptcls=num_ptcls, mdl_face=max(int(cls.max()) // 2, 2),
                     deg_per_push=15.0, max_search_iters=64, gyro=GyroConfig(),
                     analytic_locate=analytic_locate)
    from pumipic_torch.parallel import group

    group.set_slices(slices)
    lpp, state, _, pstep = make_picparts_setup(
        coords, tris, cls, cfg, PicPartsInput(buffer_layers=buffer_layers),
        use_lb=True, cap_factor=cap_factor,
        banded_route="off" if route == "gather" else "auto",
        neighbor_migration=neighbor_migration, device=device, timings=seconds)

    def step(s):
        s, fwd, stats = pstep(s)
        return s, {"fwd": fwd, "stats": stats}

    if adapt:
        mon = CapacityMonitor()
        for _ in range(3):
            state, f = step(state)
            mon.observe(f["stats"])
        state = mon.apply(state)
    info = {"num_ptcls": num_ptcls, "setup_s": seconds, "picpart": lpp,
            "step": pstep, "mesh_elems": len(tris), "mesh_verts": len(coords),
            "tag": picparts_tag(num_ptcls, mesh_path, cap_factor, adapt,
                                analytic_locate, route, buffer_layers, slices)}
    return None, state, step, info


def picparts_rank(**knobs) -> dict:
    """One rank of ``BENCH_MODE=picparts`` (run by :func:`pumipic_torch.
    parallel.group.launch` or under ``torchrun``): the record, this rank's
    kernel launches (counted from the setup on), the warm-up step's and
    each timed step's stats, reduced field and deposit before the
    reduction (``history``), and the picpart's vertex gids and owners."""
    from pumipic_torch import kernels, native
    from pumipic_torch.parallel import group

    kernels.reset_launches()
    record, state, fields = main(device=group.device(), mode="picparts",
                                 verbose=False, **knobs)
    lpp = fields.pop("picpart")
    return {"record": record, "launches": dict(kernels.LAUNCHES),
            "history": fields["history"], "vert_gid": lpp.vert_gid,
            "vert_owner": lpp.vert_owner, "native": native.path(),
            "alive_local": int(state["active"].sum())}


def picparts_runs(runs) -> list:
    """One rank's :func:`picparts_rank` for each knob dict of ``runs``, in
    order (the launch counts reset before each)."""
    return [picparts_rank(**knobs) for knobs in runs]


def dp_rank(locator=None, steps: int = 1, **knobs) -> dict:
    """One rank of the FULL mode over the group: :func:`setup` (``locator``:
    a grid built elsewhere for this mesh, moved to the rank's device), then
    ``steps`` steps; returns the summed fields, the rank's kernel launches
    (from the setup on) and its active count."""
    import dataclasses

    from pumipic_torch import kernels
    from pumipic_torch.parallel import group

    kernels.reset_launches()
    dev = group.device()
    if locator is not None:
        locator = dataclasses.replace(locator, **{
            f.name: getattr(locator, f.name).to(dev)
            for f in dataclasses.fields(locator)
            if isinstance(getattr(locator, f.name), torch.Tensor)})
    _, state, step, info = setup(dev, locator=locator, **knobs)
    for _ in range(steps):
        state, fields = step(state)
    _sync(dev)
    return {"fwd": fields["fwd"], "bwd": fields["bwd"],
            "alive_local": int(state["active"].sum()),
            "launches": dict(kernels.LAUNCHES), "setup_s": info["setup_s"]}


def main(device=None, num_ptcls=None, iters=None, verbose: bool = True,
         mode=None, **knobs):
    """Run the benchmark; returns (record, state, fields): the JSON record
    (printed when ``verbose``), the final particle state (a structure in
    pps3d mode, the app's state dict in gitr mode) and the last step's
    fields.  ``knobs`` are :func:`setup`'s (dp), :func:`setup_pps3d`'s
    (pps3d) or :func:`setup_gitr`'s (gitr) keywords.  ``detail`` also holds
    the setup seconds by phase, the last step's ``iters`` (and, in dp mode,
    ``all_found`` and ``deleted_per_step``: the walkers the warm-up and
    each timed step deleted at the walk limit), and the row ``tag``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch measures on a CUDA device and "
                               "none is available")
        device = "cuda"
    device = torch.device(device)
    iters = int(iters or os.environ.get("BENCH_ITERS", 20))
    mode = mode or os.environ.get("BENCH_MODE", "dp")
    setups = {"dp": setup, "pps3d": setup_pps3d, "gitr": setup_gitr,
              "picparts": setup_picparts}
    if mode not in setups:
        raise ValueError(f"unknown BENCH_MODE {mode!r}: dp, pps3d, gitr or picparts")
    pps3d, picparts = mode == "pps3d", mode == "picparts"
    mesh, state, step, info = setups[mode](device, num_ptcls, **knobs)
    num_ptcls = info["num_ptcls"]
    _sync(device)

    # warm-up step
    t0 = time.perf_counter()
    state, fields = step(state)
    _sync(device)
    if picparts:
        info["setup_s"]["first step"] = time.perf_counter() - t0

    history, timer, marks = [], None, []
    # dp: the walkers each step's search deleted at the walk limit, kept on
    # the device until the timed steps are done
    deleted = [fields["deleted"]] if mode == "dp" else []
    if picparts:
        history.append((fields["stats"], fields["fwd"], info["step"].last_deposit))
    if picparts and device.type == "cuda":
        from pumipic_torch.parallel import group

        timer = group.SplitTimer()
        group.set_split_timer(timer)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
        marks[0].record()
    t0 = time.perf_counter()
    for i in range(iters):
        state, fields = step(state)
        if picparts:
            history.append((fields["stats"], fields["fwd"],
                            info["step"].last_deposit))
        if deleted:
            deleted.append(fields["deleted"])
        if marks:
            marks[i + 1].record()
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    if timer is not None:
        group.set_split_timer(None)

    rate = num_ptcls / dt
    detail = {
        "num_ptcls": num_ptcls,
        "mesh_elems": info["mesh_elems"] if picparts else mesh.nelems,
        "mesh_verts": info["mesh_verts"] if picparts else mesh.nverts,
        "ms_per_step": dt * 1e3,
        "chips": 1,
        "alive": int(state.active.sum() if pps3d else
                     fields["stats"]["alive"] if picparts else state["active"].sum()),
        "impl": "torch",
        "device": device.type,
        "gpu": (torch.cuda.get_device_name(device) if device.type == "cuda"
                else None),
        "iters": 0 if picparts else int(fields["iters"]),
        "setup_s": info["setup_s"],
        "tag": info["tag"],
    }
    if picparts:
        from pumipic_torch.parallel import group

        detail["ranks"] = group.num_ranks()
        detail["slices"] = group.slices()
        detail["backend"] = (torch.distributed.get_backend()
                             if group.initialized() else None)
        if device.type == "cuda":
            detail["chips"] = min(group.num_ranks(), torch.cuda.device_count())
        detail["split_ms_per_step"] = (None if timer is None else
                                       {k: v / iters for k, v in timer.totals().items()})
        detail["step_ms"] = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        fields["history"] = [({k: v.cpu() for k, v in st.items()}, f.cpu(), d.cpu())
                             for st, f, d in history]
        fields["picpart"] = info["picpart"]
    if mode == "dp":
        detail["all_found"] = bool(fields["all_found"])
        detail["deleted_per_step"] = [int(d) for d in deleted]
    if mode == "gitr":
        detail["wall_hits_total"] = float(fields["wall_hits"].sum())
    metrics = {
        "dp": "pseudoXGCm push+search+rebuild+gyroScatter throughput",
        "pps3d": "pseudoPushAndSearch 3D push+search+rebuild throughput",
        "gitr": "GITR-style Boris push+intersection walk+wall tally throughput",
        "picparts": "pseudoXGCm picparts push+search+migrate+gyroScatter+"
                    "reduce throughput",
    }
    out = {
        "metric": metrics[mode],
        "value": rate,
        "unit": "particle-steps/s/chip",
        "vs_baseline": rate / PROXY_BASELINE_PTCLS_PER_SEC,
        "detail": detail,
    }
    if verbose:
        print(json.dumps(out), flush=True)
    return out, state, fields


def _picparts_cli() -> None:
    """``BENCH_MODE=picparts``: under ``torchrun`` every process is a rank
    (``BENCH_BACKEND``, default nccl); otherwise ``BENCH_RANKS`` (default
    1) rank processes are started on this machine (``BENCH_BACKEND``,
    default gloo: several ranks may share one card).  Rank 0's record is
    printed."""
    from pumipic_torch.parallel import group

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        group.init(os.environ.get("BENCH_BACKEND", "nccl"))
        try:
            out = picparts_rank()
        finally:
            group.finalize()
        if int(os.environ["RANK"]) == 0:
            print(json.dumps(out["record"]), flush=True)
        return
    n = int(os.environ.get("BENCH_RANKS", 1))
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch measures on a CUDA device and none is "
                           "available")
    from pumipic_torch.kernels import _build

    _build.build()
    ranks = group.launch("bench_torch:picparts_rank", n, {},
                         backend=os.environ.get("BENCH_BACKEND", "gloo"),
                         device="cuda", timeout=3000)
    print(json.dumps(ranks[0]["record"]), flush=True)


if __name__ == "__main__":
    if os.environ.get("BENCH_MODE") == "picparts":
        _picparts_cli()
    else:
        main()
