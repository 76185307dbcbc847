"""The distributed dry run over ranks (port of
``__graft_entry__.dryrun_multichip``):

    python -m pumipic_torch.parallel.dryrun --ranks 8 --device cpu --backend gloo

Runs the whole distributed pipeline at tiny shapes as ``n`` rank
processes of one group and prints one line per mode, in the JAX dry run's
format:

1. BFS-buffered picparts with the balancer and the neighbour exchange on a
   structured annulus (the analytic locate), 3 steps: no overflow, no
   unresolved arrival, no illegal destination, particles migrated, and the
   owner-reduced field equal on every copy of each vertex;
1b. the same step with ``analytic_locate="off"`` (each rank's walk):
   alive and migrated equal to mode 1;
2. FULL-mode particle parallelism (``make_dp_setup`` with its particles
   shared out over the group, fields summed), 1 step;
3. 3D picparts (pseudoPushAndSearch, CSR, the balancer), 3 steps;
4. mode 1 again over a ``("slice", "ranks")`` group of ``slices`` slices
   (by default 2 where the ranks are 4 or more and even, as the JAX dry run
   runs it): the migration's payload and the reduction take the two-stage
   route, and alive, migrated and every rank's field equal mode 1's bit
   for bit.

With ``--device cuda`` the kernels are built once before the ranks start,
and rank r takes card ``r % cards``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch


def _configs(n: int):
    from pumipic_torch.mesh import generate as gen
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.models import pseudo_xgcm as px

    coords, tris, cls = gen.annulus_mesh(4, 8 * max(n, 2), 0.3, 1.0)
    cfg = px.XGCmConfig(num_ptcls=64 * n, mdl_face=4, deg_per_push=40.0,
                        gyro=px.GyroConfig(rmax=0.05, num_rings=2, points_per_ring=4))
    cfg3 = pps.PushSearchConfig(num_ptcls=32 * n, distance=0.15,
                                push_dir=(1.0, 0.7, 0.4), structure="csr",
                                use_locator=False)
    return (coords, tris, cls), cfg, gen.box_tet_mesh(4, 4, 4), cfg3


def _launches() -> Dict[str, int]:
    from pumipic_torch import kernels

    out = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    return out


def default_slices(n: int) -> int:
    """Mode 4's slices: 2 where the JAX dry run runs its mode 4, else none."""
    return 2 if n >= 4 and n % 2 == 0 else 1


def _rank(n: int, slices: int = 1) -> dict:
    """One rank's share of the dry run: each mode's stats, fields and
    kernel launches."""
    from pumipic_torch import kernels
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.parallel import group

    (coords, tris, cls), cfg, (c3, t3), cfg3 = _configs(n)
    out = {}
    for mode, c in (("picparts", cfg),
                    ("picparts-walk", dataclasses.replace(cfg, analytic_locate="off"))):
        kernels.reset_launches()
        lpp, state, _, step = px.make_picparts_setup(coords, tris, cls, c, use_lb=True)
        stats = []
        for _ in range(3):
            state, fwd, st = step(state)
            stats.append({k: v.cpu() for k, v in st.items()})
        out[mode] = dict(stats=stats, fwd=fwd, vert_gid=lpp.vert_gid,
                         has_gelem="gelem" in state, launches=_launches())
    mesh = Mesh2D.from_arrays(coords, tris, cls, device=group.device())
    dstate, dstep = px.make_dp_setup(mesh, cfg, device=group.device())
    kernels.reset_launches()
    dstate, fields = dstep(dstate)
    out["full-dp"] = dict(alive=int(group.all_sum(dstate["active"].sum())),
                          fwd=fields["fwd"], launches=_launches())
    lpp3, ps3, step3 = pps.make_picparts_setup_3d(c3, t3, cfg3, use_lb=True)
    kernels.reset_launches()
    stats3 = []
    for _ in range(3):
        ps3, st3 = step3(ps3)
        stats3.append({k: v.cpu() for k, v in st3.items()})
    out["picparts-3d"] = dict(stats=stats3, launches=_launches())
    if slices > 1:
        group.set_slices(slices)
        _, state, _, step = px.make_picparts_setup(coords, tris, cls, cfg, use_lb=True)
        stats = []
        for _ in range(3):
            state, fwd, st = step(state)
            stats.append({k: v.cpu() for k, v in st.items()})
        group.set_slices(1)
        out["picparts-slices"] = dict(stats=stats, fwd=fwd, launches=_launches())
    return out


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(f"{name}: {msg}")


def summarize(n: int, ranks: list, slices: int = 1) -> dict:
    """Check the ranks' results as the JAX dry run does, print its lines
    and return the counts.  Beyond the JAX dry run's checks: every step's
    alive is the previous alive less its boundary exits and its particles
    lost off the picparts, the walk arm loses and exits the same particles
    as the analytic arm, and the 3D mode loses none.  The 2D modes' 40°
    push outruns the default 3-layer BFS buffer, so they lose particles off
    the picparts, as the JAX dry run does (its counts include them): the
    count is printed, not gated."""
    _, cfg, _, cfg3 = _configs(n)
    counts, removed = {}, {}
    for mode in ("picparts", "picparts-walk"):
        stats = ranks[0][mode]["stats"]
        prev = cfg.num_ptcls
        for st in stats:
            for k in ("overflow", "unresolved", "illegal_dest"):
                _check(mode, int(st[k]) == 0, f"{k} = {int(st[k])}")
            _check(mode, int(st["alive"]) == prev - int(st["exits"]) - int(st["lost"]),
                   f"alive {int(st['alive'])} != {prev} - exits - lost")
            prev = int(st["alive"])
        removed[mode] = [(int(st["exits"]), int(st["lost"])) for st in stats]
        sent = sum(int(st["sent"]) for st in stats)
        alive = int(stats[-1]["alive"])
        _check(mode, alive > 0, "all particles lost")
        _check(mode, sent > 0, "no particle ever migrated")
        counts[mode] = dict(alive=alive, migrated=sent)
    _check("modes", ranks[0]["picparts"]["has_gelem"]
           and not ranks[0]["picparts-walk"]["has_gelem"],
           "the dry run must cover both the analytic and the walk arm")
    _check("picparts-walk", counts["picparts-walk"] == counts["picparts"]
           and removed["picparts-walk"] == removed["picparts"],
           "the walk arm diverged from the analytic arm")
    print(f"dryrun_multirank({n}) picparts (boundary exits, lost off the "
          f"picparts) per step: {removed['picparts']}")
    seen: Dict[int, float] = {}
    fwd_sum = 0.0
    for r in ranks:
        vg, f = r["picparts"]["vert_gid"].numpy(), r["picparts"]["fwd"].numpy()
        fwd_sum += float(f.astype(np.float64).sum())
        for g, v in zip(vg, f):
            if g in seen:
                _check("picparts", seen[g] == v, f"sync mismatch at vertex {g}")
            else:
                seen[g] = v
    counts["picparts"].update(sync_verified=len(seen), fwd_sum=fwd_sum)
    c = counts["picparts"]
    print(f"dryrun_multirank({n}) picparts: alive={c['alive']}, "
          f"migrated={c['migrated']}, sync_verified={c['sync_verified']} verts, "
          f"fwd_sum={c['fwd_sum']:.1f} OK")
    c = counts["picparts-walk"]
    print(f"dryrun_multirank({n}) picparts-walk: alive={c['alive']}, "
          f"migrated={c['migrated']} OK")
    dp = ranks[0]["full-dp"]
    total = float(dp["fwd"].sum())
    _check("full-dp", dp["alive"] > 0 and total > 0, "nothing alive or deposited")
    counts["full-dp"] = dict(alive=dp["alive"], fwd_sum=total)
    print(f"dryrun_multirank({n}) full-dp: alive={dp['alive']}, fwd_sum={total:.1f} OK")
    stats3 = ranks[0]["picparts-3d"]["stats"]
    prev = cfg3.num_ptcls
    for st in stats3:
        for k in ("overflow", "unresolved", "illegal_dest", "lost"):
            _check("picparts-3d", int(st[k]) == 0, f"{k} = {int(st[k])}")
        _check("picparts-3d", int(st["alive"]) == prev - int(st["exits"]),
               f"alive {int(st['alive'])} != {prev} - exits")
        prev = int(st["alive"])
    sent3 = sum(int(st["sent"]) for st in stats3)
    alive3 = int(stats3[-1]["alive"])
    _check("picparts-3d", alive3 > 0 and sent3 > 0, "nothing alive or migrated")
    counts["picparts-3d"] = dict(alive=alive3, migrated=sent3)
    print(f"dryrun_multirank({n}) picparts-3d: alive={alive3}, migrated={sent3} OK")
    if "picparts-slices" in ranks[0]:
        mode = f"picparts-{slices}x{n // slices}-slices"
        stats = ranks[0]["picparts-slices"]["stats"]
        for st in stats:
            for k in ("overflow", "unresolved", "illegal_dest"):
                _check(mode, int(st[k]) == 0, f"{k} = {int(st[k])}")
        alive = int(stats[-1]["alive"])
        sent = sum(int(st["sent"]) for st in stats)
        _check(mode, (alive, sent) == (counts["picparts"]["alive"],
                                        counts["picparts"]["migrated"]),
               "alive or migrated diverged from the flat group")
        for r, out in enumerate(ranks):
            _check(mode, torch.equal(out["picparts-slices"]["fwd"], out["picparts"]["fwd"]),
                   f"rank {r}'s field diverged from the flat group")
        counts[mode] = dict(alive=alive, migrated=sent)
        print(f"dryrun_multirank({n}) {mode}: alive={alive}, migrated={sent}, "
              f"bit-identical to flat OK")
    return counts


def dryrun_multirank(n: int, device: str = "cuda", backend: str = "nccl",
                     timeout: float = 900.0, workdir=None,
                     slices: Optional[int] = None) -> dict:
    """Run the dry run as ``n`` rank processes; returns the counts of each
    mode and, under ``"ranks"``, each rank's results (its kernel launches
    per mode under ``[mode]["launches"]``).  ``slices``: mode 4's
    (:func:`default_slices` by default; 1 skips it).  Raises when a rank
    fails, a check fails or the run passes ``timeout`` seconds."""
    from pumipic_torch.parallel import group

    if device == "cuda":
        from pumipic_torch.kernels import _build

        _build.build()
    t0 = time.perf_counter()
    slices = default_slices(n) if slices is None else slices
    ranks = group.launch("pumipic_torch.parallel.dryrun:_rank", n,
                         {"n": n, "slices": slices}, backend=backend, device=device,
                         timeout=timeout, workdir=workdir)
    counts = summarize(n, ranks, slices)
    counts["seconds"] = time.perf_counter() - t0
    counts["ranks"] = ranks
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    counts = dryrun_multirank(a.ranks, a.device, a.backend, a.timeout)
    print(f"dryrun_multirank({a.ranks}) {a.device}/{a.backend}: "
          f"{counts['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
