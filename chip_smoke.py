"""On-card smoke test of the PyTorch/CUDA port (``pumipic_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); builds the kernels from the
sources in this checkout.  Phases, each raising on failure:

(a) require a CUDA device; print its name and power limit (nvidia-smi) and
    the torch / CUDA versions;
(b) build the kernels of the twenty-two sources (P push and its table mode
    ``push_table``, B band cell, A annulus locate, L locate, H histogram and
    its weighted mode W ``wall_tally``, D deposit, G row gather, S slot map,
    K Kuhn push + locate and its push-only form ``push_wrap``, L3 tet
    locate, R ``boris`` grid field + Boris push, M ``trace3d`` 3D walk
    modes, M2 ``trace2d`` 2D walk modes, V ``vdeposit`` deterministic
    weighted deposit, F ``gitr_update`` the GITR step's specular velocity
    and state update, Q ``rebuild_mask`` the rebuild's mask rewrite and
    count, C ``key_sort`` the rebuild's stable element sort, the
    reshuffle-or-rebuild's U1 ``reshuffle_count`` and U2
    ``reshuffle_place`` and U3 ``reshuffle_order`` (the movers' order), the
    Sell-C-σ row order's Z ``scs_row_order``, the distributed step's X1
    ``rank_in_key``, X2
    ``pack_send``, X3 ``place_arrivals`` and O ``owner_reduce``, the
    Y1-Y3 route and balancer kernels and N ``slot_counts``, the picparts
    step's counts), one nvcc per source, all at once, and keep
    ptxas's registers, shared memory and spills of each source's entry
    functions for the kernels' JSON line;
(c) run each kernel and its plain PyTorch version on the card on the same
    inputs at the shapes the main paths give it, require equal outputs, and
    time both on the device (CUDA events around runs enqueued while the
    card sleeps, so a wrapper's host time is not in them, ``device_ms``);
    give each kernel its bound (bytes over 3.35 TB/s or f32
    operations over 67 TFLOP/s, whichever is larger; B also the floor of
    its uncontracted instruction stream, one FMUL or FADD per operation at
    the card's maximum SM clock) and, where one PyTorch call computes the
    same function, that call's time (``torch.bincount`` for H, of the two
    key streams in key mode; ``torch.index_select`` for G's rows form,
    per-array indexing for its columns form; ``torch.mv`` of a CSR matrix
    for D: the composite gyro map for both passes, the ring incidence for
    pass 1 from (E, R); ``torch.sort(key, stable=True)`` for C).  On the
    120k-element gmsh mesh at 10M particles: P, L (peel + walk), H in the
    main path's order and in a random order of the same keys, D, L's dense
    plain walk over the 1.48M gyro ring points and at the locator-less
    step (the 10M particles pushed once, each walked from its element;
    every walker found), H's (element, ring) key mode and
    D's pass 1 from (E, R) counts; G's rows form at the TPU row gather
    probe's shape (24,576 x 14 f32 table, 10M indices); on a Sell-C-σ
    structure of the 10M located particles, P's phi mode (band and class
    forms), S in the scs and cabm modes and G's columns form at the sorted
    rebuild's shapes, at one step's locality and at a random order of the
    slots, Q's three modes (the destinations' check, the scs epilogue on
    S's outputs, the csr prefix) and C on the rebuild's keys (one step's
    order, a random order, K = 2 and the 0/1 partition; its fused mode on
    the rebuild's (elem, active, E) keeping the key and on the 0/1
    partition's mask; keys outside [0, K]: 100 among the app's, keys in
    [-K, K], every int32; each bit-equal to ``torch.sort(stable=True)``,
    with its design floor beside its bound); Z, the row order in one
    launch (against its plain version, the torch code it replaced and one
    ``torch.sort(-win, dim=1, stable=True)``) on the located particles'
    counts (122,603 elements); B and L's
    given-cells mode on the flux-band grid; A on the 23,976-element annulus at 10M, in the
    generator's element order and through a random element permutation;
    P's table mode at 10M over the (122,603, 2) rotation table; on
    pseudoPushAndSearch's 16^3 Kuhn box (24,576 tets) at 10M particles, K
    (push + wrap + locate), Q's DPS mode on K's ids, its push-only form
    (equal to K's positions too)
    and L3 (peel + walk over the cpe-16 grid's
    candidate id pair, and the plain walk) on one step's targets, on those
    particles in a random order and on the step-20 targets (L3's bound
    counted for the id pair it reads and, beside it, for the 26-column
    rows the first L3 read; its resident blocks per SM), and the walk
    arm's ids held against the Kuhn arm's (ties on shared faces counted);
    on the auto rebuild's Sell-C-σ and CabM structures of those particles
    (extra padding 0.15), U1 after one push of the auto arms' 0.001 (2.7%
    movers) and of the default 0.05 (the fallback), U2 after pushes of
    0.002, 0.004 and 0.001 (5.4%, 10.7%, 2.7%), each in both layouts (U2
    writes the fields in place: it and its plain version each get their
    own copy), U3 at 2.7%, 5.4% and 10.7% (beside kernel C's payload form,
    which it replaced, at 2.7%, and ``torch.sort``), each call's and the
    whole reshuffle's device work counted from a captured CUDA graph, and
    Z on the padded counts (24,576 tets); M's peel form (BCC core, reflecting wall) on the pps3d-dps-reflect
    arm's first-step targets.  On the GITR-style app's 32^3 box (196,608
    tets) at 10M particles: R on the seeded state, M on R's targets in each
    core with remove and reflect and record_exit, on far targets (random
    points of the box: walks of many hops), at a budget of 2 that leaves
    survivors to recover, F after the reflect and the absorb walks, and W
    on the reflect walk's hit counts and the absorb walk's lost particles
    (``torch.bincount`` with weights as W's
    yardstick; R and M have none).  On the 120k mesh's 10M located
    particles (each pushed 3 element sizes, 5% of them beyond the wall), M2
    with reflect and record_exit from the plain start and through the
    cartesian peel, remove and record_exit, a budget of 2 with recovery,
    far targets, and ``trace_particle_through_mesh`` with 1% wrong parents
    repaired; V as ``scatter_to_verts_bcc`` (barycentric weights in each
    final parent, a random charge) and as the weighted
    ``particles_per_element`` (an f32 ``index_add_`` as its yardstick),
    each in the particles' own order and in a random order of them, run
    twice for equal bits, and with non-finite charges among them (the
    reference's NaN and inf pattern, every other output the deposit
    without the bad particles); require 2-10% of the walkers to hit the wall,
    no walker lost with reflect but at the loop limit (counted), the
    removed walkers to be those with a real hit, the deposit to conserve
    the charge within V's bound and H's count to equal the active
    particles.  Then drive the 2D path end to end five times through its
    entry points (``trace_particle_through_mesh`` with parent repair,
    reflect and record, ``search_mesh_2d_accel`` with recovery, the
    deposits), each call from the last one's end, with the counts reset
    (kernels G, L, M2, V and H, and no other).  Then run a
    small slice of each FULL-mode arm (and the table push on a permuted
    mesh), of the PseudoXGCm app in each layout (scs, csr, cabm, dps) and
    of pseudoPushAndSearch (Kuhn, walk and reflect arms) and of the
    GITR-style app (absorb and reflect) on the card and on the CPU for 3
    steps and require equal states, structures and fields.  Last, at one
    rank's size of the 4-rank 120k picparts arm (3.75M slots), X1-X3, O,
    Y1-Y3 and N (``check_exchange``; N at the picparts step's own inputs,
    with the kernels a step's counts launch from captured CUDA graphs, the
    torch code's against N's).  Then, on the ~1M-element production mesh
    (``bench_torch.production_mesh``: ``tokamak_mesh(340, 1750)``, 981,178
    triangles, written at first use into the git-ignored ``chip_tree/``
    and read through ``read_msh``) with its cartesian cpe-4 grid (3.9M
    cells, ~220 MB of cell rows) and 10M seeded particles: L's peel + walk,
    L's dense plain walk at the locator-less step (its longest walk and
    the walkers deleted at the limit counted), H into 981,178 counters, D
    over its gyro map, Z on the located particles' 981,178 counts, and on
    their Sell-C-σ
    structure C on the rebuild's 20-bit keys, S and G's columns form, each
    with its working set against the L2 (``check_production``).  Every
    cartesian grid is built on the card (its cells' flood fill and its cell
    rows' calibration walk as torch ops there); at 120k it is held against
    the host build, bit for bit (``check_calibration``);
(d) run the six FULL-mode arms through their entry point,
    ``bench_torch.main()``, at 10M particles, 1 warm-up + 20 timed steps
    each, with the launch counters reset just before each: the cartesian
    main path, the flux-band arm (``band_locator="force"``, reusing phase
    c's band grid), the annulus arm, the per-particle gyro radius arm and
    the rotation-table arm (``rot_analytic=False``, P's table mode and
    not its band mode) and the locator-less arm (``use_locator=False``:
    L's dense plain walk from each particle's element, every particle
    found in every step); the cartesian, pprad and rotation-table arms
    reuse phase c's cartesian grid; then the cartesian and locator-less
    arms on the 1M mesh, reusing phase c's read of it and its grid.
    Require each arm's kernels launched (and the annulus arm's steps
    launching no L: its only L launch is the setup's gyro-map walk), finite
    positive fields and > 90% of the particles alive, the walkers each
    step deleted at the walk limit counted and logged (no particle both
    alive and counted).  Then
    pseudoPushAndSearch through ``bench_torch.main(mode="pps3d")`` at 10M
    particles on the Kuhn box: the Kuhn arm (``pps3d-dps``, K and Q and no
    L3 or P) and the walk arm (``pps3d-dps-walk``, K's push-only form, L3
    and Q, no K locate) with 1 + 20
    steps, then ``pps3d-scs`` with 1 + 3 (C, Q, Z, S and G on tets),
    ``pps3d-dps-reflect`` with 1 + 3 (K's push-only form, M and Q, no L3)
    and the reshuffle-or-rebuild (``rebuild="auto"``) with 1 + 3:
    ``pps3d-scs-auto`` and ``pps3d-cabm-auto`` at a push of 0.001 (every
    step a reshuffle: U1, U3, G and U2 and no slot map or C) and
    ``pps3d-scs-auto-fallback`` at the default push (every step U1, then
    the sort rebuild, no U2), each step's rebuild checked on the device
    (its launch set; num_ptcls the active count, no overflow; the pids'
    count and sum kept; every stayer in its slot; every particle's element
    its destination, matched by pid; every active slot in its element's
    segment) and its mover share logged; require ``num_ptcls`` equal to
    the active count, no overflow, and all 10M alive in the Kuhn arms.  Then the GITR-style app through
    ``bench_torch.main(mode="gitr")`` at 10M particles on the 196,608-tet
    box: ``gitr-reflect`` with 1 + 20 steps (all 10M alive throughout) and
    ``gitr-absorb`` with 1 + 3 (``wall_hits`` summing to the particles
    lost), each launching R, M, F and W and nothing else.  Then the PseudoXGCm
    app through its entry points (construction with phase c's cartesian
    grid, then ``run``) at 10M particles on the 120k mesh: Sell-C-σ with 1
    warm-up + 20 timed steps (ms per step from the port's timing registry),
    then CSR, CabM and DPS with 1 + 3, then Sell-C-σ on the 1M mesh with
    phase c's grid and 1 + 20; require each layout's launch set
    (the sorted layouts C, Q and G, SCS and CabM S too, SCS Z; DPS steps Q alone
    of them), ``num_ptcls`` equal to the active
    count, no overflow, every active element in range and the active pids
    equal to those the last search kept.  After the Sell-C-σ run, G's
    columns form is checked and timed as in (c) on the columns and source
    rows its 20th timed step's rebuild gathered, C on the keys it sorted,
    and after the Sell-C-σ and CabM runs S on the arguments of their last
    timed step's slot map;
(e) the distributed runtime as ranks of ``torch.distributed`` groups on
    this card (``pumipic_torch.parallel.group.launch``; the kernels and
    ``libmeshcore`` built here first; every rank's failure or a passed
    deadline fails the phase): (1) ``bench_torch``'s picparts mode on the
    120k mesh at 10M particles over 4 gloo ranks (RCB, the balancer, the
    neighbour exchange, cap factor 1.5, a 12-layer BFS buffer, 1 + 5
    steps), then rank 0 of it profiled (5 steps more: device busy ms and
    the stream's split beside the torch-op exchange's); (2) the same on 1
    NCCL rank; (3) the 23,976-triangle annulus at 10M over 4 gloo ranks:
    the analytic locate with the banded route and the neighbour exchange,
    the same with the world exchange and over 2 slices of 2 ranks
    (``BENCH_SLICES=2``: the two-stage route; both equal bit for bit:
    alive, sent and every rank's field) and with the walk (alive and sent
    within 1e-5 of the particles each step: the two locates part at ulp
    ties, as the JAX package's do); (4) FULL mode over 4 gloo ranks
    against one process (``bench_torch.setup``, one step: fwd and bwd bit
    for bit); (5) ``dryrun_multirank(4, "cuda", "gloo")``, 3D mode and
    mode 4 (2 x 2 slices) included (its 3D picparts launch C and Q on every
    rank: the CSR rebuild on arrival).  Each rank reports its kernel launches
    (checked by name, and L's count: on a walk arm each rank launches L in
    every step, on an analytic arm only in the setup's gyro-map walk; X1 4
    times a step, X2 and X3 once, O twice (fan-in, fan-out: D writes the
    fan-in's send rows) and N 4 times (migrate's free slots, its sent,
    kept-home and illegal counts, the step's alive and exits, step_stats'
    reduction) on every rank of a 4-rank arm, O and N's last two on the
    1-rank arm), every step's stats, reduced field and
    deposit: on every step no overflow, unresolved arrival, illegal
    destination or particle lost off its picpart (stats ``lost``), alive =
    the previous alive less the step's boundary exits, the field equal on
    every copy of each vertex and its owned-vertex sum equal to the
    deposited charge.  Printed per arm: setup seconds by phase, the median
    ms/step and rank 0's per-step split (CUDA events: compute, collectives,
    the exchange's torch glue), labelled "4 processes sharing one H100
    over gloo (host-staged)";
(f) print the kernels' JSON line (each kernel's first case, and every case
    under ``cases``), the card's line, and the contract line
    ``{"ok": true, "device": {...}}`` last.

Tolerance: every comparison is exact (max |kernel - plain| must be 0, no
mismatch).  The kernels are built with -fmad=false and follow the plain
versions' operation order; where a plain version calls libm (A's atan2,
cos and sin) it runs torch's CUDA ops, which call the same CUDA libm
functions as the kernel (A reads its cos/sin from a per-sector table that
the same torch ops fill on the card).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(HERE, "data", "xgc_like_120k.msh.gz")
NUM_PTCLS = 10_000_000
TIMED_STEPS = 20
ANNULUS_ELEMS = 24_000

KERNELS = {  # name -> (route, source, replaces)
    "push": ("cuda", "pumipic_torch/kernels/csrc/push.cu",
             "pumipic_tpu/ops/push.py:82"),
    "push_table": ("cuda", "pumipic_torch/kernels/csrc/push.cu",
                   "pumipic_tpu/ops/push.py:166"),
    "band_cell": ("cuda", "pumipic_torch/kernels/csrc/band.cu",
                  "perf/pallas_smoke.py:98"),
    "annulus_locate": ("cuda", "pumipic_torch/kernels/csrc/annulus.cu",
                       "pumipic_tpu/mesh/locator.py:379"),
    "locate": ("cuda", "pumipic_torch/kernels/csrc/locate.cu",
               "pumipic_tpu/ops/search.py:1049"),
    "histogram": ("cuda", "pumipic_torch/kernels/csrc/histogram.cu",
                  "pumipic_tpu/ops/scatter.py:65"),
    "deposit": ("cuda", "pumipic_torch/kernels/csrc/deposit.cu",
                "pumipic_tpu/ops/scatter.py:224"),
    "row_gather": ("cuda", "pumipic_torch/kernels/csrc/gather.cu",
                   "perf/pallas_gather_ab.py:72"),
    "slot_map": ("cuda", "pumipic_torch/kernels/csrc/slotmap.cu",
                 "pumipic_tpu/particles/structure.py:563"),
    "kuhn_locate": ("cuda", "pumipic_torch/kernels/csrc/kuhn.cu",
                    "pumipic_tpu/mesh/locator.py:190"),
    "push_wrap": ("cuda", "pumipic_torch/kernels/csrc/kuhn.cu",
                  "pumipic_tpu/ops/push.py:244"),
    "locate3d": ("cuda", "pumipic_torch/kernels/csrc/locate3d.cu",
                 "pumipic_tpu/ops/search.py:1268"),
    "boris": ("cuda", "pumipic_torch/kernels/csrc/boris.cu",
              "pumipic_tpu/ops/push.py:213"),
    "trace3d": ("cuda", "pumipic_torch/kernels/csrc/trace3d.cu",
                "pumipic_tpu/ops/search.py:1006"),
    "wall_tally": ("cuda", "pumipic_torch/kernels/csrc/histogram.cu",
                   "pumipic_tpu/models/gitr_like.py:147"),
    "trace2d": ("cuda", "pumipic_torch/kernels/csrc/trace2d.cu",
                "pumipic_tpu/ops/search.py:967"),
    "vdeposit": ("cuda", "pumipic_torch/kernels/csrc/vdeposit.cu",
                 "pumipic_tpu/ops/scatter.py:278"),
    "rank_in_key": ("cuda", "pumipic_torch/kernels/csrc/exchange.cu",
                    "pumipic_tpu/parallel/migrate.py:302"),
    "pack_send": ("cuda", "pumipic_torch/kernels/csrc/exchange.cu",
                  "pumipic_tpu/parallel/migrate.py:319"),
    "place_arrivals": ("cuda", "pumipic_torch/kernels/csrc/exchange.cu",
                       "pumipic_tpu/parallel/migrate.py:386"),
    "owner_reduce": ("cuda", "pumipic_torch/kernels/csrc/owner.cu",
                     "pumipic_tpu/parallel/reduce.py:52"),
    "gitr_update": ("cuda", "pumipic_torch/kernels/csrc/gitr.cu",
                    "pumipic_tpu/models/gitr_like.py:119"),
    "rebuild_mask": ("cuda", "pumipic_torch/kernels/csrc/rebuild.cu",
                     "pumipic_tpu/particles/structure.py:436"),
    "key_sort": ("cuda", "pumipic_torch/kernels/csrc/rebuild.cu",
                 "pumipic_tpu/particles/structure.py:557"),
    "check_parents": ("cuda", "pumipic_torch/kernels/csrc/parents.cu",
                      "pumipic_tpu/ops/search.py:1527"),
    "reshuffle_count": ("cuda", "pumipic_torch/kernels/csrc/reshuffle.cu",
                        "pumipic_tpu/particles/structure.py:702"),
    "reshuffle_place": ("cuda", "pumipic_torch/kernels/csrc/reshuffle.cu",
                        "pumipic_tpu/particles/structure.py:733"),
    "reshuffle_order": ("cuda", "pumipic_torch/kernels/csrc/reshuffle.cu",
                        "pumipic_tpu/particles/structure.py:765"),
    "scs_row_order": ("cuda", "pumipic_torch/kernels/csrc/reshuffle.cu",
                      "pumipic_tpu/particles/structure.py:312"),
    "route_packed": ("cuda", "pumipic_torch/kernels/csrc/route.cu",
                     "pumipic_tpu/parallel/migrate.py:115"),
    "route_g2l": ("cuda", "pumipic_torch/kernels/csrc/route.cu",
                  "pumipic_tpu/parallel/migrate.py:132"),
    "route_banded": ("cuda", "pumipic_torch/kernels/csrc/route.cu",
                     "pumipic_tpu/parallel/banded_route.py:73"),
    "balance_keys": ("cuda", "pumipic_torch/kernels/csrc/route.cu",
                     "pumipic_tpu/parallel/balancer.py:334"),
    "balance_select": ("cuda", "pumipic_torch/kernels/csrc/route.cu",
                       "pumipic_tpu/parallel/balancer.py:283"),
    "slot_counts": ("cuda", "pumipic_torch/kernels/csrc/counts.cu",
                    "pumipic_tpu/models/pseudo_xgcm.py:1202"),
}

# the card's peaks for the bound of each kernel (H100 SXM data sheet):
# device-memory bytes/s and f32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# the app arms of phase d: structure -> kernels each run's steps must launch
_SORTED = ("key_sort", "rebuild_mask", "row_gather")
_SCS_ROWS = ("scs_row_order",)
APP_ARMS = {
    "scs": ("push", "locate", "histogram", "deposit", "slot_map") + _SORTED + _SCS_ROWS,
    "csr": ("push", "locate", "histogram", "deposit") + _SORTED,
    "cabm": ("push", "locate", "histogram", "deposit", "slot_map") + _SORTED,
    "dps": ("push", "locate", "histogram", "deposit", "rebuild_mask"),
}
APP_STEPS = {"scs": TIMED_STEPS, "csr": 3, "cabm": 3, "dps": 3}

# the arms of phase d: bench_torch.main keywords, and the kernels each
# arm's run must launch (every other kernel must stay at 0)
ARMS = {
    "cartesian": ({}, ("push", "locate", "histogram", "deposit")),
    "band": ({"band_locator": "force"},
             ("push", "band_cell", "locate", "histogram", "deposit")),
    "annulus": ({"mesh_path": "annulus", "mesh_elems": ANNULUS_ELEMS},
                ("push", "annulus_locate", "locate", "histogram", "deposit")),
    "pprad": ({"gyro_ppr": True}, ("push", "locate", "histogram", "deposit")),
    "rotgather": ({"rot_analytic": False},
                  ("push_table", "locate", "histogram", "deposit")),
    # no locator grid: the search is L's dense plain walk from each
    # particle's previous element; every step must find every particle
    "nolocator": ({"use_locator": False}, ("push", "locate", "histogram", "deposit")),
}

# the arms of phase d on the ~1M-element production mesh (phase c's mesh
# read and grid), and the Sell-C-σ app's timed steps there
PRODUCTION_ARMS = ("cartesian", "nolocator")
PRODUCTION_APP_STEPS = TIMED_STEPS

# pseudoPushAndSearch's arms of phase d: bench_torch.main keywords, steps,
# the kernels each run must launch and those it must not
PPS3D_ELEMS = 24_000              # box_tet_mesh(16, 16, 16): 24,576 tets
# the auto arms' push: 2.7% of the particles change tet a step at 10M
# (scripts/reshuffle_share.py), inside the reshuffle's padding for the
# arms' 4 steps and more; phase c's U2 cases push 2 and 4 times as far
# from the built structure (5.4%, 10.7% of the particles)
AUTO_DIST = 0.001
_PUSHES_2D = ("push", "push_table")
PPS3D_ARMS = {
    "pps3d-dps": ({"kuhn": "auto"}, TIMED_STEPS, ("kuhn_locate", "rebuild_mask"),
                  ("locate3d", "push_wrap") + _PUSHES_2D),
    "pps3d-dps-walk": ({"kuhn": "off"}, TIMED_STEPS,
                       ("push_wrap", "locate3d", "rebuild_mask"),
                       ("kuhn_locate",) + _PUSHES_2D),
    "pps3d-scs": ({"kuhn": "auto", "structure": "scs"}, 3,
                  ("kuhn_locate", "slot_map", "row_gather", "key_sort", "rebuild_mask")
                  + _SCS_ROWS, ("locate3d", "push_wrap") + _PUSHES_2D),
    # the reshuffle-or-rebuild (rebuild="auto", extra padding 0.15): a short
    # push takes the reshuffle every step (U1, U3, G, U2; no slot map), the
    # default push falls back to the sort every step (U1, then the sort
    # rebuild; no U2); the set-up's sorted build launches S, H and Z, so
    # each step's launches are checked with its rebuild (check_auto_step)
    "pps3d-scs-auto": ({"kuhn": "auto", "structure": "scs", "rebuild": "auto",
                        "distance": AUTO_DIST}, 3,
                       ("kuhn_locate", "reshuffle_count", "reshuffle_order", "row_gather",
                        "reshuffle_place", "rebuild_mask"),
                       ("locate3d", "push_wrap") + _PUSHES_2D),
    "pps3d-cabm-auto": ({"kuhn": "auto", "structure": "cabm", "rebuild": "auto",
                         "distance": AUTO_DIST}, 3,
                        ("kuhn_locate", "reshuffle_count", "reshuffle_order", "row_gather",
                         "reshuffle_place", "rebuild_mask"),
                        ("locate3d", "push_wrap") + _PUSHES_2D),
    "pps3d-scs-auto-fallback": ({"kuhn": "auto", "structure": "scs", "rebuild": "auto"}, 3,
                                ("kuhn_locate", "reshuffle_count", "key_sort", "slot_map",
                                 "row_gather", "rebuild_mask", "histogram") + _SCS_ROWS,
                                ("reshuffle_place", "reshuffle_order", "locate3d", "push_wrap")
                                + _PUSHES_2D),
    "pps3d-dps-reflect": ({"kuhn": "off", "wall": "reflect"}, 3,
                          ("push_wrap", "trace3d", "rebuild_mask"),
                          ("kuhn_locate", "locate3d") + _PUSHES_2D),
}

# the GITR-style app's arms of phase d: bench_torch.main keywords and steps;
# each run launches exactly R, M, F and W
GITR_ELEMS = 196_608              # box_tet_mesh(32, 32, 32)
GITR_ARMS = {"gitr-reflect": ("reflect", TIMED_STEPS), "gitr-absorb": ("absorb", 3)}
GITR_KERNELS = ("boris", "trace3d", "gitr_update", "wall_tally")

# the 2D walk modes' and the deposit's cases (phase c) and path (its end):
# the near targets' budget (no walker comes near it), the far targets',
# the share of particles pushed beyond the wall, the path's calls and the
# kernels each path call launches
TRACE2D_ITERS = 1000
TRACE2D_FAR_ITERS = 200
WALL_SHARE = 0.05
PATH_CALLS = 5
# (G: the harness's barycentric_2d; L: the parent repair's walk, in place)
PATH_KERNELS = ("check_parents", "row_gather", "locate", "trace2d", "vdeposit",
                "histogram")
# the record_function ranges of one path call (trace2d_path_call); the
# profile also ranges check_initial_parents inside the first entry point
PATH_RANGES = ("harness:walker_targets", "port:trace_particle_through_mesh",
               "harness:d2_noise", "port:search_mesh_2d_accel", "harness:barycentric_2d",
               "port:scatter_to_verts_bcc", "port:particles_per_element, weighted",
               "port:particles_per_element")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events from the first run's enqueue: the host's share
    where the host enqueues slower than the device runs."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, without the host's share: the card sleeps while the host
    enqueues the runs, so the CUDA events time them back to back on the
    device (a call that waits for the device adds its wait)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    """max |a - b| over tensors (or tuples of tensors) of any dtype."""
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).sum() > 0)
    return float((a.double() - b.double()).abs().max())


def mismatches(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return sum(mismatches(x, y) for x, y in zip(a, b))
    return int((a != b).sum())


def compare(kernel: str, what: str, got, want, results: dict) -> None:
    err, nmis = max_err(got, want), mismatches(got, want)
    log(f"[c] {kernel} {what}: max |kernel - plain| = {err}, mismatches = {nmis}")
    if err != 0.0 or nmis != 0:
        raise AssertionError(f"{kernel} {what}: kernel disagrees with its "
                             f"plain version")
    results[kernel]["max_abs_err"] = max(results[kernel].get("max_abs_err", 0.0), err)


def case_of(kernel: str, what: str, results: dict) -> dict:
    """The record of one timed case of a kernel (listed under ``cases`` on
    the kernels' JSON line)."""
    return results[kernel].setdefault("cases", {}).setdefault(what, {})


def time_pair(kernel: str, what: str, fn, plain, results: dict, reps: int = 20,
              plain_reps: int = 5, record: bool = True) -> None:
    """Time a kernel and its plain version; the first timing of a kernel
    is the one its JSON entry carries."""
    ms, pms = device_ms(fn, reps), device_ms(plain, plain_reps)
    log(f"[c] {kernel} {what}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    case_of(kernel, what, results).update(ms=ms, plain_ms=pms)
    if record and "ms" not in results[kernel]:
        results[kernel].update(ms=ms, plain_ms=pms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def record_bound(kernel: str, what: str, results: dict, bytes_moved: int,
                 ops: float = 0.0) -> None:
    """The least time the card could take for a timed call: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its f32 operations over the f32 peak.  Logged for every
    mode; the first is the kernel's JSON entry (the call its ``ms`` is)."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[c] {' '.join(filter(None, (kernel, what)))} bound: "
        f"{bytes_moved / 1e6:.1f} MB, {ops:.3g} f32 ops "
        f"-> {bound_ms:.4f} ms ({bound_by})")
    case_of(kernel, what, results).update(bound_ms=bound_ms, bound_by=bound_by)
    results[kernel].setdefault("bound_ms", bound_ms)
    results[kernel].setdefault("bound_by", bound_by)


def record_library(kernel: str, what: str, call: str, fn, results: dict,
                   reps: int = 20, entry: bool = True) -> None:
    """Time one PyTorch call (``call``) computing the kernel's function in
    case ``what`` (its yardstick; the port never calls it); ``entry``: the
    kernel's JSON entry takes it (a case of another function than the
    entry's: not)."""
    ms = device_ms(fn, reps)
    log(f"[c] {kernel} {what} library yardstick {call}: {ms:.4f} ms")
    case_of(kernel, what, results).update(library=call, library_ms=ms)
    if entry:
        results[kernel].setdefault("library_ms", ms)


# libcuda's CUgraphNodeType values of the nodes a captured call can hold
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
                    5: "empty", 6: "wait_event", 7: "event_record", 10: "mem_alloc",
                    11: "mem_free"}


def graph_nodes(fn) -> dict:
    """The device work one call of ``fn`` enqueues, by kind ({"kernel": n,
    "memset": m, ...}): the nodes of a CUDA graph captured from the call
    (never replayed), typed by libcuda.  Exact, where a profiler trace
    can miss events."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    fn()                              # launchers' one-time queries outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {}
    for node in nodes[:count.value]:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kind = GRAPH_NODE_KINDS.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    g.reset()
    torch.cuda.synchronize()
    return kinds


def record_launches(kernel: str, what: str, fn, results: dict,
                    expected: Optional[dict] = None) -> None:
    """The device work (kernels, memsets, copies) one call of ``fn``
    enqueues (:func:`graph_nodes`), in case ``what``'s record; raises where
    ``expected`` ({kind: count}) is given and differs."""
    kinds = graph_nodes(fn)
    log(f"[c] {kernel} {what}: {sum(kinds.values())} CUDA launches a call {kinds}")
    if expected is not None and kinds != expected:
        raise AssertionError(f"{kernel} {what}: launched {kinds}, expected {expected}")
    case_of(kernel, what, results).update(cuda_launches=sum(kinds.values()),
                                          cuda_launch_kinds=kinds)


def check_repair_launches(what: str, fn, walk: str, results: dict) -> None:
    """The parent repair is a memset, kernel J and one walk (``walk``: L in
    2D, L3 in 3D) and nothing else: by the wrappers' counts, J and the walk
    once each; by the captured call's nodes, one memset and two kernels."""
    from pumipic_torch import kernels

    before = dict(kernels.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    grown = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    if grown != {"check_parents": 1, walk: 1}:
        raise AssertionError(f"check_initial_parents {what} launched {grown}, expected "
                             f"J and {walk} once each")
    record_launches("check_parents", what, fn, results, {"memset": 1, "kernel": 2})


def ring_key_streams(elem, active, rg, E: int, R: int, rmax: float):
    """H key mode's two key streams as one (2N,) int64 tensor, E·R where a
    particle deposits nothing (``torch.bincount``'s input)."""
    from pumipic_torch.ops import scatter as sc

    rdf = sc.ring_of_radius(rg, rmax, R)
    ok = active & (elem >= 0) & (elem < E) & ~torch.isnan(rdf)
    base = elem.to(torch.int64) * R + torch.where(ok, rdf, 0.0).to(torch.int64)
    return torch.cat([torch.where(ok, base, E * R), torch.where(ok, base + 1, E * R)])


def gyro_composite(mesh, gyro_map, R: int, P: int, dev):
    """D's yardstick for both passes from (E,) counts: the composite
    (V x E) map M2·M1 / P as a CSR matrix on ``dev`` (built on the host),
    where M1 (V·R x E) expands each element's count to the uniform
    radius's ring pair at its three vertices and M2 (V x V·R) is the gyro
    map.  With integer counts and P = 8 every entry, product and partial
    sum is a multiple of 1/8 far below 2^24, so ``torch.mv`` with it gives
    D's bits."""
    from pumipic_torch.ops import scatter as sc

    V, E = mesh.nverts, mesh.nelems
    e = torch.arange(E).repeat_interleave(3)
    v = mesh.elem2verts.cpu().to(torch.int64).reshape(-1)
    rings = sorted(set(sc.ring_pair(R)))
    m1 = torch.sparse_coo_tensor(
        torch.stack([torch.cat([v * R + r for r in rings]), e.repeat(len(rings))]),
        torch.ones(v.numel() * len(rings)), (V * R, E))
    flat = gyro_map.flat.cpu().to(torch.int64)
    ok = flat >= 0
    slot = torch.arange(flat.numel()) // (P * 3)
    m2 = torch.sparse_coo_tensor(torch.stack([flat[ok], slot[ok]]),
                                 torch.ones(int(ok.sum())), (V, V * R))
    return (torch.sparse.mm(m2, m1).coalesce() / P).to_sparse_csr().to(dev)


def ring_incidence(mesh, R: int, dev):
    """D's yardstick for pass 1 from (E, R) counts: the (V·R x E·R)
    incidence of each (vertex, ring) on its elements' same ring, as a CSR
    matrix on ``dev`` (integer sums: exact)."""
    V, E = mesh.nverts, mesh.nelems
    e = torch.arange(E).repeat_interleave(3)[:, None] * R + torch.arange(R)
    v = mesh.elem2verts.cpu().to(torch.int64).reshape(-1)[:, None] * R + torch.arange(R)
    return torch.sparse_coo_tensor(torch.stack([v.reshape(-1), e.reshape(-1)]),
                                   torch.ones(v.numel()), (V * R, E * R)
                                   ).coalesce().to_sparse_csr().to(dev)


@contextlib.contextmanager
def calls_at(module, name: str, calls: dict, keep):
    """Inside the block, capture ``keep(*args)`` of the calls of
    ``module.name`` whose numbers, counted from 1, are keys of ``calls``;
    yields {calls[k]: what keep returned}.  Captures launch nothing."""
    captured, count = {}, [0]
    fn = getattr(module, name)

    def spy(*args, **kw):
        count[0] += 1
        if count[0] in calls:
            captured[calls[count[0]]] = keep(*args, **kw)
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield captured
    finally:
        setattr(module, name, fn)


def gathers_at(calls: dict):
    """Inside the block, capture the rebuild gathers
    (``particles.structure._gather_fields``) whose call numbers, counted
    from 1, are keys of ``calls``; yields {calls[k]: (columns, source
    rows)}, the arrays kernel G moves."""
    from pumipic_torch.ops import rows
    from pumipic_torch.particles import structure as st

    return calls_at(st, "_gather_fields", calls, lambda fields, take, extra=(): (
        [c.contiguous() for c in [*fields.values(), *extra] if rows.lanes_of(c) > 0],
        take.to(torch.int32)))


def slot_maps_at(calls: dict):
    """Inside the block, capture the arguments of the rebuilds' slot maps
    (``ops.rows.slot_map``, kernel S) whose call numbers, counted from 1,
    are keys of ``calls``; yields {calls[k]: the call's arguments}."""
    from pumipic_torch.ops import rows

    return calls_at(rows, "slot_map", calls, lambda *args: args)


def key_sorts_at(calls: dict):
    """Inside the block, capture the rebuilds' sorts (``ops.rebuild.
    masked_key_sort``, kernel C's fused mode) whose call numbers, counted
    from 1, are keys of ``calls``; yields {calls[k]: (elem, active,
    fill)}."""
    from pumipic_torch.ops import rebuild as rb

    return calls_at(rb, "masked_key_sort", calls,
                    lambda elem, active, fill, keep_key=False: (elem, active, fill))


def smi_query(fields: str, units: bool = True) -> str:
    """The first card's ``nvidia-smi --query-gpu=fields`` as one line."""
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", fmt],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def phase_a() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = smi_query("name,power.limit")
    log(f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[a] card: {smi}; max SM clock {smi_query('clocks.max.sm')}")
    return smi


def ptxas_functions(report: str) -> list:
    """Each entry function of a ``ptxas -v`` report: its (mangled) name,
    registers, stack frame, shared memory and spilled bytes."""
    funcs = []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            funcs.append({"function": m.group(1)})
        elif funcs and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                       line)):
            funcs[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            if st := re.search(r"(\d+) bytes stack frame", line):
                funcs[-1]["stack_bytes"] = int(st.group(1))
        elif funcs and (m := re.search(r"Used (\d+) registers", line)):
            s = re.search(r"(\d+) bytes smem", line)
            funcs[-1].update(registers=int(m.group(1)), smem_bytes=int(s.group(1)) if s else 0)
    return funcs


def phase_b(results: dict) -> None:
    """Build the library; each kernel's record gets ptxas's report of its
    source's entry functions (registers, shared memory, spills)."""
    from pumipic_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    log(f"[b] kernels built in {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(path, HERE)}")
    for name, (_, src, _) in KERNELS.items():
        report = _build.REPORTS.get(os.path.basename(src))
        results[name].setdefault("extra", {})["ptxas"] = (
            ptxas_functions(report) if report is not None else "not reported (cached build)")


def _cfg(px, mesh, **kw):
    """bench_torch's configuration for ``mesh``."""
    return px.XGCmConfig(num_ptcls=NUM_PTCLS,
                         mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                         deg_per_push=15.0, max_search_iters=64, **kw)


def _push(push_ops, s, model, cfg):
    return push_ops.push_banded(s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"],
                                s["elem"], s["active"], model.rot, cfg.h,
                                cfg.k, cfg.d)


def check_cartesian(results: dict, dev, mesh):
    """P, L, H, D at the main path's shapes; returns (elem, active) of the
    located 10M particles."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    cfg = _cfg(px, mesh)
    timings = {}
    s, step = px.make_dp_setup(mesh, cfg, dev, timings=timings)
    model = step.model
    n = s["x0"].shape[0]
    R, P = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    log(f"[c] 120k mesh: E={mesh.nelems} V={mesh.nverts}, N={n}, "
        f"cells={model.locator.nx * model.locator.ny}, bands={model.rot.cd.shape[0]}")
    check_calibration(model.locator, mesh, timings["locator"])

    # P: push at 10M
    pargs = (s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
             s["active"], model.rot, cfg.h, cfg.k, cfg.d)
    got = push_ops.push_banded(*pargs)
    compare("push", f"({n} particles)", got, push_ops.push_banded_plain(*pargs), results)
    time_pair("push", "", lambda: push_ops.push_banded(*pargs),
              lambda: push_ops.push_banded_plain(*pargs), results)
    tx, ty = got[0], got[1]
    # the function reads the old position only of an inactive particle (it
    # is kept): 25 bytes in a particle, less those 8 where it is active
    kept_bytes = 8 * int((~s["active"]).sum())
    # ~20 f32 operations per particle (rotation, Newton step, target)
    record_bound("push", "", results, nbytes(*pargs[2:7], model.rot.starts, model.rot.cd,
                                         model.rot.sd, *got) + kept_bytes, 20.0 * n)

    # P, table mode: the same particles over the per-element rotation table
    rot_t = push_ops.RotTable.build(mesh.class_id.cpu().numpy(), cfg.deg_per_push, dev)
    targs = pargs[:7] + (rot_t, cfg.h, cfg.k, cfg.d)
    got_t = push_ops.push_table(*targs)
    compare("push_table", f"({n} particles, {tuple(rot_t.table.shape)} table)", got_t,
            push_ops.push_table_plain(*targs), results)
    log(f"[c] push_table vs push (band mode): max |diff| = {max_err(got_t, got)} (the "
        f"table's cos/sin are f64-rounded, the band rotation's f32)")
    time_pair("push_table", "", lambda: push_ops.push_table(*targs),
              lambda: push_ops.push_table_plain(*targs), results)
    # 17 bytes in where active (the table counted once), 16 out a particle
    record_bound("push_table", "", results,
                 nbytes(*pargs[2:7], rot_t.table, *got_t) + kept_bytes, 20.0 * n)
    del got_t, rot_t, targs

    # L: peel + guess walk at 10M
    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    grid = model.locator
    got = se.walk_locate(*largs, grid=grid)
    compare("locate", f"peel+walk ({n} particles)", got,
            se.walk_locate_plain(*largs, grid=grid), results)
    log(f"[c] locate: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    time_pair("locate", "peel+walk", lambda: se.walk_locate(*largs, grid=grid),
              lambda: se.walk_locate_plain(*largs, grid=grid), results,
              plain_reps=3)
    elem, active = got[0], got[1]
    # the peel's two containment tests (~40 f32 operations per particle);
    # the few walk steps after it are not counted
    record_bound("locate", "peel+walk", results, nbytes(*largs[:5], grid.cell_rows, elem, active),
                 40.0 * n)

    # L: plain walk over the gyro ring points (the setup's gyro map search)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, cfg.gyro))
    gact = torch.ones(gpx.shape[0], dtype=torch.bool, device=dev)
    gargs = (mesh.walk_geom, gpx, gpy, gstart, gact, 100)
    got = se.walk_locate(*gargs)
    compare("locate", f"plain walk ({gpx.shape[0]} ring points)", got,
            se.walk_locate_plain(*gargs), results)
    log(f"[c] ring-point walk: iters={int(got[2])} all_found={bool(got[3])}")
    time_pair("locate", "plain walk", lambda: se.walk_locate(*gargs),
              lambda: se.walk_locate_plain(*gargs), results, reps=5,
              plain_reps=2)
    # the ring points, the outputs and the rows the walk reads
    record_bound("locate", "plain walk", results,
                 nbytes(*gargs[1:5], *got[:2]) + walk_rows("plain walk", gargs, results))
    del gpx, gpy, gstart, gact, gargs

    # L: dense plain walk at the locator-less step (use_locator=False: the
    # same seeded particles, pushed once, each walked from its element)
    what = "plain walk, the locator-less step"
    dargs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    got = se.walk_locate(*dargs)
    compare("locate", f"{what} ({n} particles)", got, se.walk_locate_plain(*dargs), results)
    log(f"[c] locator-less walk: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    if not bool(got[3]):
        raise AssertionError("the locator-less step's walk deleted a walker at the limit")
    time_pair("locate", what, lambda: se.walk_locate(*dargs),
              lambda: se.walk_locate_plain(*dargs), results, plain_reps=2, record=False)
    record_bound("locate", what, results,
                 nbytes(*dargs[1:5], *got[:2]) + walk_rows(what, dargs, results))
    del dargs

    # H: histogram of 10M keys into E bins, in the main path's order (the
    # particles' own, seeded element by element) and in a random order
    E = mesh.nelems
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    for what, e, a in (("main-path order", elem, active),
                       ("random order", elem[perm], active[perm])):
        got = sc.histogram(e, a, E)
        compare("histogram", f"{what} ({n} keys, {E} bins)", got,
                sc.histogram_plain(e, a, E), results)
        time_pair("histogram", what, lambda: sc.histogram(e, a, E),
                  lambda: sc.histogram_plain(e, a, E), results)
        record_bound("histogram", what, results, nbytes(e, a, got))
        key = torch.where(a, e, E)
        record_library("histogram", what, "torch.bincount",
                       lambda: torch.bincount(key, minlength=E + 1), results)
        if what == "main-path order":
            counts = got
    del perm, key, e, a

    # D: ring expansion + mapped scatter at V, R, P
    check_deposit(results, "both passes", dev, mesh, model.gyro_fwd, counts, R, P)
    return s, model, elem, active, torch.stack([tx, ty], 1)


def check_deposit(results: dict, what: str, dev, mesh, gyro, counts, R: int, P: int):
    """D's two passes (the ring expansion of ``counts`` and the mapped
    scatter over ``gyro``): equal to their plain versions, timed beside
    them, their bound (each table read once) and the composite CSR map's
    ``torch.mv``.  Returns the bytes of the tables its gathers read."""
    from pumipic_torch.ops import scatter as sc

    got_r = sc.deposit_rings(counts, mesh, R)
    want_r = sc.ring_accum_plain(counts, mesh, R)
    got_f = sc.scatter_to_mapped_verts(got_r, gyro, mesh.nverts, R, P)
    want_f = sc.mapped_plain(want_r, gyro, mesh.nverts, R, P)
    compare("deposit", f"{what} (V={mesh.nverts}, R={R}, P={P})", (got_r, got_f),
            (want_r, want_f), results)

    def dep():
        r = sc.deposit_rings(counts, mesh, R)
        return sc.scatter_to_mapped_verts(r, gyro, mesh.nverts, R, P)

    def dep_plain():
        r = sc.ring_accum_plain(counts, mesh, R)
        return sc.mapped_plain(r, gyro, mesh.nverts, R, P)

    time_pair("deposit", what, dep, dep_plain, results, plain_reps=20)
    tables = nbytes(counts, mesh.vert2elem_offsets, mesh.vert2elem_vals, gyro.offsets,
                    gyro.src, got_r)
    record_bound("deposit", what, results, tables + nbytes(got_f))
    m = gyro_composite(mesh, gyro, R, P, dev)
    cf = counts.to(torch.float32)
    log(f"[c] deposit {what} yardstick: composite map {tuple(m.shape)}, "
        f"{m.values().numel()} entries; max |mv - kernel| = {max_err(torch.mv(m, cf), got_f)}")
    record_library("deposit", what, "torch.mv of the composite CSR map M2·M1/P",
                   lambda: torch.mv(m, cf), results)
    return tables


def check_calibration(grid, mesh, device_s: float) -> None:
    """The cartesian grid built on the card (the cells' flood fill and the
    cell rows' calibration walk as torch ops there: the setup's search
    build, ``device_s`` seconds) equals the host build's (the flood fill
    on the CPU, the numpy calibration walk) bit for bit: ``cell_elem`` and
    ``cell_rows``."""
    from pumipic_torch.mesh import locator as loc
    from pumipic_torch.models import pseudo_xgcm as px

    cpe = px.resolve_locator_policy(px.XGCmConfig(), mesh.nelems, NUM_PTCLS)[0]
    t0 = time.perf_counter()
    host = loc.build_locator_grid(mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy(),
                                  cells_per_elem=cpe, walk_geom=mesh.walk_geom.cpu(),
                                  device="cpu")
    host_s = time.perf_counter() - t0
    if not (torch.equal(host.cell_elem, grid.cell_elem.cpu())
            and torch.equal(host.cell_rows, grid.cell_rows.cpu())):
        raise AssertionError("the grid built on the card differs from the host build's")
    log(f"[c] cartesian grid ({grid.nx} x {grid.ny} cells, cpe {cpe}) built on the card "
        f"equals the host build bit for bit (the search build on the card {device_s:.2f} s, "
        f"the host build {host_s:.2f} s)")


def plain_walk_rows(walk_geom, dest_x, dest_y, start, walkers,
                    max_iters: int, grid=None):
    """Each slot's steps in kernel L's plain walk (with ``grid``: its walk
    after the peel), the walk_geom rows it reads (0 where no walker), and
    the number of distinct rows the walk reads, counted on the plain
    version's batch walk."""
    from pumipic_torch.ops import search as se

    steps = torch.zeros(walkers.shape[0], dtype=torch.int64, device=walkers.device)
    read = torch.zeros(walk_geom.shape[0], dtype=torch.bool, device=walkers.device)
    se._walk_batch(walk_geom, dest_x, dest_y, start, walkers, max_iters, grid,
                   steps_of=steps, rows_read=read)
    return steps, int(read.sum())


def walk_rows(what: str, args, results: dict) -> int:
    """Kernel L's rows in a plain-walk case (its walkers, the rows they
    read and the distinct rows among them, in the case's record); returns
    the distinct rows' bytes, the table's part of the case's bound."""
    steps, distinct = plain_walk_rows(*args)
    rows, w = int(steps.sum()), int(args[4].sum())
    log(f"[c] locate {what}: {w} walkers, {rows} rows ({rows / max(w, 1):.2f} a walker), "
        f"{distinct} distinct")
    case_of("locate", what, results).update(walkers=w, rows=rows, distinct_rows=distinct)
    return distinct * args[0].shape[1] * args[0].element_size()


def parent_claims(mesh, x, elem, gen):
    """Phase c's wrong parents: 1% of the claims random elements, the first
    100 at E + 3 (out of range), and a copy of the origins whose next 100
    are NaN."""
    n = elem.shape[0]
    claim = elem.clone()
    bad = torch.rand(n, generator=gen, device=elem.device) < 0.01
    claim[bad] = torch.randint(0, mesh.nelems, (int(bad.sum()),), generator=gen,
                               device=elem.device, dtype=torch.int32)
    claim[:100] = mesh.nelems + 3
    xb = x.clone()
    xb[100:200] = float("nan")
    return claim, xb


def parent_check_bytes(mesh, claim, active):
    """(bytes, f32 operations) kernel J's function needs: claim, active and
    elem per slot; the origin and the row's affine part where active; ~12
    f32 operations a dimension and active particle."""
    n, act, dim = claim.shape[0], int(active.sum()), mesh.dim
    return (n * 9 + act * 4 * dim + mesh.nelems * 4 * dim * (dim + 1),
            12.0 * dim * act)


def parent_sectors(claim, active, n_elems: int, row_bytes: int, affine_bytes: int):
    """The 32-byte L2 sectors kernel J's row loads touch at this order, for
    rows of ``row_bytes`` whose first ``affine_bytes`` the test reads:
    (sectors a particle, distinct sectors a particle within each warp's
    32 consecutive slots).  Every active slot reads its clamped parent's
    row."""
    idx = torch.nonzero(active).flatten()
    e = torch.clamp(claim[idx].long(), 0, n_elems - 1)
    first, last = e * row_bytes // 32, (e * row_bytes + affine_bytes - 1) // 32
    per = int((last - first + 1).sum())
    span = n_elems * row_bytes // 32 + 2
    group = (idx // 32) * span
    warp = int(torch.unique(torch.cat([group + first, group + last])).numel())
    m = max(idx.numel(), 1)
    return per / m, warp / m


def check_parents_case(results: dict, mesh, x, claim, active, what: str) -> None:
    """Kernel J (with L's or L3's repair walk) against its plain version in
    both modes; J alone ("delete": no other launch) timed with its bound
    and the L2 sectors its row loads touch."""
    from pumipic_torch.ops import search as se

    for mode in ("delete", "repair"):
        got = se.check_initial_parents(mesh, x, claim, active, mode)
        compare("check_parents", f"{mode}, {what}", got,
                se.check_parents_plain(mesh, x, claim, active, mode), results)
        log(f"[c] check_parents {mode}, {what}: {int(got[1])} bad, {int(got[2])} repaired")
    time_pair("check_parents", what, lambda: se.check_initial_parents(mesh, x, claim, active,
                                                                       "delete"),
              lambda: se.check_parents_plain(mesh, x, claim, active, "delete"), results,
              plain_reps=3)
    record_bound("check_parents", what, results, *parent_check_bytes(mesh, claim, active))
    rows = se.parent_rows(mesh) if mesh.dim == 2 else mesh.walk_geom
    per, warp = parent_sectors(claim, active, mesh.nelems, rows.shape[1] * 4,
                               4 * mesh.dim * (mesh.dim + 1))
    log(f"[c] check_parents {what}: {per:.3f} L2 sectors a particle, {warp:.3f} distinct "
        f"in its warp's slots")
    case_of("check_parents", what, results).update(
        l2_sectors_per_particle=per, l2_warp_sectors_per_particle=warp)


def check_parents_and_walk(results: dict, dev, mesh, x, elem, active) -> None:
    """Kernel J at the 2D path's full width (the 120k mesh, phase c's 10M
    located particles): 0% bad (the path's steady state) and 1% bad with
    ids out of range and NaN origins, against its plain version; the repair
    walk alone over J's bad parents (kernel L's plain walk in place, case
    (a)) at both shares."""
    from pumipic_torch.ops import search as se

    gen = torch.Generator(dev).manual_seed(19)
    claim, xb = parent_claims(mesh, x, elem, gen)
    check_parents_case(results, mesh, x, elem, active, f"2D, 0% bad ({x.shape[0]} particles)")
    check_parents_case(results, mesh, xb, claim, active,
                       f"2D, 1% bad, ids out of range, NaN origins ({x.shape[0]} particles)")
    # the repair: a memset, J and L's walk
    repair = lambda: se.check_initial_parents(mesh, x, elem, active)  # noqa: E731
    check_repair_launches(f"2D, 0% bad ({x.shape[0]} particles)", repair, "locate", results)
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        _, bad, _ = se.check_parents(mesh, xx, c, active, True)
        what = f"repair walk in place, {share} bad ({x.shape[0]} slots)"
        wargs = (mesh.walk_geom, *xx.unbind(1), c, bad, 32)
        base = torch.where(bad, -1, c)
        e_k, s_k = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        e_p, s_p = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        se.walk_locate_into(*wargs, e_k, s_k)
        se.walk_locate_into_plain(*wargs, e_p, s_p)
        compare("locate", what, (e_k, s_k), (e_p, s_p), results)
        time_pair("locate", what, lambda: se.walk_locate_into(*wargs, e_k, s_k),
                  lambda: se.walk_locate_into_plain(*wargs, e_p, s_p), results, plain_reps=2)
        # the mask; a walker's destination, start and result; the rows it reads
        record_bound("locate", what, results,
                     nbytes(bad) + int(bad.sum()) * 16 + walk_rows(what, wargs, results))
    del claim, xb


def check_parents_3d(results: dict, dev, mesh, seeded) -> None:
    """Kernel J in 3D and its repair (L3's plain walk in place) on the 16^3
    box's seeded particles: 0% bad and 1% bad with ids out of range and NaN
    origins, against the plain version; the repair's launches (a memset, J
    and the walk); the walk alone over J's bad parents."""
    from pumipic_torch.ops import search as se

    x, elem = seeded
    active = elem >= 0
    n = x.shape[0]
    gen = torch.Generator(dev).manual_seed(23)
    claim, xb = parent_claims(mesh, x, elem, gen)
    check_parents_case(results, mesh, x, elem, active, f"3D, 0% bad ({n} particles)")
    check_parents_case(results, mesh, xb, claim, active,
                       f"3D, 1% bad, ids out of range, NaN origins ({n} particles)")
    # the repair: a memset, J and L3's walk
    repair = lambda: se.check_initial_parents(mesh, xb, claim, active)  # noqa: E731
    check_repair_launches(f"3D, 1% bad, ids out of range, NaN origins ({n} particles)",
                          repair, "locate3d", results)
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        _, bad, _ = se.check_parents(mesh, xx, c, active, True)
        what = f"repair walk in place, {share} bad ({n} slots)"
        wargs = (mesh.walk_geom, *xx.unbind(1), c, bad, 32)
        base = torch.where(bad, -1, c)
        e_k, s_k = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        e_p, s_p = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        se.walk_locate_3d_into(*wargs, e_k, s_k)
        se.walk_locate_3d_into_plain(*wargs, e_p, s_p)
        compare("locate3d", what, (e_k, s_k), (e_p, s_p), results)
        read = torch.zeros(mesh.nelems, dtype=torch.bool, device=dev)
        se._walk_batch_3d(*wargs, rows_read=read)
        w, distinct = int(bad.sum()), int(read.sum())
        log(f"[c] locate3d {what}: {w} walkers, {int(s_p[2])} found, at most "
            f"{int(s_p[0])} steps, {distinct} distinct rows")
        case_of("locate3d", what, results).update(walkers=w, distinct_rows=distinct)
        time_pair("locate3d", what, lambda: se.walk_locate_3d_into(*wargs, e_k, s_k),
                  lambda: se.walk_locate_3d_into_plain(*wargs, e_p, s_p), results,
                  plain_reps=2, record=False)
        # the mask; a walker's destination, start and result; the distinct
        # 64-byte rows the walk reads
        record_bound("locate3d", what, results, nbytes(bad) + w * 20 + distinct * 64)
    del claim, xb


def check_parents_at_path(results: dict, mesh, x, elem, active) -> None:
    """Kernel J at the 2D path's own order: the parents and origins one
    path call leaves (the next call's inputs), against its plain version
    in both modes, J alone timed with its bound and its L2 sectors; the
    same sectors in walk_geom's 48-byte rows for comparison."""
    what = f"2D, the 2d path's order ({x.shape[0]} particles)"
    check_parents_case(results, mesh, x, elem, active, what)
    per, warp = parent_sectors(elem, active, mesh.nelems, 48, 24)
    log(f"[d] check_parents {what} in walk_geom's 48-byte rows: {per:.3f} L2 sectors "
        f"a particle, {warp:.3f} distinct in its warp's slots")
    case_of("check_parents", what, results).update(
        walk_geom_l2_sectors_per_particle=per, walk_geom_l2_warp_sectors_per_particle=warp)


def check_lost_walk(results: dict, dev, lpp, mesh, step) -> None:
    """Kernel L's plain walk at the picparts step's lost check (rank 0 of
    the 4-rank 120k arm, after the push and the local walk of
    :func:`x2_step_case`): the particles the local walk removed, walked on
    the global mesh from their previous element, budget its element count,
    for the counts alone as the step runs it (and once every slot
    written)."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.ops import search as se
    from pumipic_torch.parallel import picparts as ppm

    state, _, new_elem, prev_elem, prev_active = step
    coords, tris, cls, _ = mesh
    gmesh = Mesh2D.from_numpy(ppm.mesh_arrays(2, coords, tris, cls), "cpu").to(dev)
    removed = prev_active & (new_elem < 0)
    g_start = lpp.elem_gid[torch.clamp(prev_elem, min=0).long()].to(torch.int32)
    largs = (gmesh.walk_geom, state["x0"], state["x1"], g_start, removed, gmesh.nelems)
    what = f"picparts lost check, counts only ({removed.shape[0]} slots)"
    got = se.walk_locate_count(*largs)
    want = se.walk_locate_plain(*largs)
    compare("locate", what, got, ((want[0] >= 0).sum(dtype=torch.int32), want[3]), results)
    compare("locate", f"picparts lost check, every slot ({removed.shape[0]} slots)",
            se.walk_locate(*largs), want, results)
    time_pair("locate", what, lambda: se.walk_locate_count(*largs),
              lambda: se.walk_locate_plain(*largs), results, plain_reps=2)
    # the mask; a walker's destination and start; the rows it reads
    record_bound("locate", what, results, nbytes(removed) + int(removed.sum()) * 12
                 + walk_rows(what, largs, results))


def walker_targets(mesh, x, gen):
    """The 2D phase's destinations: each position plus a normal displacement
    of 3 element sizes a component, and for WALL_SHARE of the particles,
    chosen at random, a radial push to 1.2 times the largest elliptic
    radius sqrt((x/a)^2 + (y/b)^2) of the mesh's vertices (a, b its
    half-widths): beyond the outer wall, which lies inside that radius (the
    particles sit in the inner half of the flux bands, where the model
    seeds them, so the short pushes alone reach no wall)."""
    h = float(mesh.elem_area.abs().sqrt().mean())
    d = x + 3.0 * h * torch.randn(x.shape, generator=gen, device=x.device)
    pick = torch.rand(x.shape[0], generator=gen, device=x.device) < WALL_SHARE
    half = mesh.coords.abs().amax(0)
    rho_max = (mesh.coords / half).norm(dim=1).max()
    rho = torch.clamp((d / half).norm(dim=1, keepdim=True), min=1e-6)
    return torch.where(pick[:, None], d * (1.2 * rho_max / rho), d).contiguous()


def barycentric_2d(mesh, elem, x):
    """(N, 3) f32 barycentric weights of the points ``x`` in the triangles
    ``elem`` (clamped), in elem2verts order, from walk_geom's affine rows
    (gathered by kernel G)."""
    from pumipic_torch.ops.rows import row_gather

    g = row_gather(mesh.walk_geom, torch.clamp(elem, min=0))
    l1 = g[:, 0] * x[:, 0] + g[:, 1] * x[:, 1] + g[:, 2]
    l2 = g[:, 3] * x[:, 0] + g[:, 4] * x[:, 1] + g[:, 5]
    return torch.stack([1.0 - l1 - l2, l1, l2], 1).contiguous()


def trace2d_bytes(mesh, handler, record, recover, grid, n_act, n) -> int:
    """The bytes M2's function needs: each table it reads once (walk_geom;
    the edges and coordinates the reflect handler reads; the vertices
    recovery reads; the peel's cell rows), each active particle's
    destination (and origin where the crossing point is needed) and start
    triangle, every particle's mask, and the outputs written once."""
    from pumipic_torch.ops import search as se

    reflect = handler is se.reflect_on_exit_2d
    tables = [mesh.walk_geom]
    if reflect:
        tables += [mesh.edge2verts, mesh.coords]
    if recover == "project":
        tables += [mesh.elem2verts, mesh.coords]
    if grid is not None:
        tables.append(grid.cell_rows)
    uniq = {t.data_ptr(): t for t in tables}
    per_act = 8 + (8 if reflect or record else 0) + 4
    per_out = 5 + (8 if reflect or recover == "project" else 0) + (16 if record else 0)
    return nbytes(*uniq.values()) + n_act * per_act + n * (1 + per_out)


def check_trace2d_case(results: dict, mesh, args, what: str, plain_reps: int = 2):
    """M2 on ``args`` (trace_2d's positional arguments after the mesh):
    exact against its plain version, timed, with its bound.  Returns the
    kernel's result."""
    from pumipic_torch.ops import search as se

    got = se.trace_2d(mesh, *args)
    n = args[1].shape[0]
    compare("trace2d", f"{what} ({n} particles)", trace_fields(got),
            trace_fields(se.trace_2d_plain(mesh, *args)), results)
    extra = "" if got.num_hits is None else \
        f", walkers that hit the wall {int((got.num_hits > 0).sum())}"
    if got.num_recovered is not None:
        extra += f", recovered {int(got.num_recovered)}"
    log(f"[c] trace2d {what}: iters={int(got.iters)} all_found={bool(got.all_found)} "
        f"alive {int(got.active.sum())}{extra}")
    time_pair("trace2d", what, lambda: se.trace_2d(mesh, *args),
              lambda: se.trace_2d_plain(mesh, *args), results, plain_reps=plain_reps)
    handler, record, recover, grid = args[5:9]
    record_bound("trace2d", what, results, trace2d_bytes(
        mesh, handler, record, recover, grid, int(args[3].sum()), n))
    return got


def check_vdeposit_case(results: dict, what: str, fn, plain, inputs, out, terms,
                        keys, n_out: int) -> None:
    """V through ``fn`` against ``plain`` (bit for bit), timed, its bound
    (``inputs`` read once, ``out`` written once) and its yardstick, an f32
    ``index_add_`` of the same ``terms`` at ``keys`` (n_out where dropped)."""
    got = fn()
    compare("vdeposit", what, got.view(torch.int32), plain().view(torch.int32), results)
    if not torch.equal(fn().view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"vdeposit {what}: a second run gave other bits")
    time_pair("vdeposit", what, fn, plain, results, plain_reps=3)
    record_bound("vdeposit", what, results, nbytes(*inputs, out))
    record_library("vdeposit", what, "torch.Tensor.index_add_ (f32)",
                   lambda: torch.zeros(n_out + 1, device=terms.device).index_add_(
                       0, keys, terms), results)


def check_vdeposit_non_finite(results: dict, mesh, e1, a1, bcc, q) -> None:
    """V with non-finite charges among the path's particles (a NaN, a
    +inf, a -inf, a +inf and a -inf in one element, an inactive NaN):
    equal to the plain version bit for bit (NaN only where an active term
    is NaN or both infinities meet, the infinity where only it does), and
    every other output the finite deposit of the same particles with the
    bad ones dropped, bit for bit."""
    from pumipic_torch.ops import scatter as sc

    act = torch.nonzero(a1).flatten()
    k = act.shape[0]
    pair = act[e1[act] == e1[act[0]]][:2]       # two in one element, then three apart
    bad = torch.cat([act[[k // 4, k // 2, 3 * k // 4]], pair])
    bq = q.clone()
    bq[bad] = torch.tensor([math.nan, math.inf, -math.inf, math.inf, -math.inf],
                           device=q.device)
    inact = torch.nonzero(~a1).flatten()[:1]
    bq[inact] = math.nan
    kept = a1.clone()
    kept[bad] = False
    V, E = mesh.nverts, mesh.nelems
    for what, fn, plain in (
            ("scatter_to_verts_bcc",
             lambda a, c: sc.scatter_to_verts_bcc(e1, a, bcc, mesh.elem2verts, V, c),
             lambda a, c: sc.vertex_deposit_plain(bcc, c, e1, a, mesh.elem2verts, V)),
            ("weighted particles_per_element",
             lambda a, c: sc.particles_per_element(e1, a, E, c),
             lambda a, c: sc.vertex_deposit_plain(c, None, e1, a, None, E))):
        got = fn(a1, bq)
        compare("vdeposit", f"{what}, non-finite charges", got.view(torch.int32),
                plain(a1, bq).view(torch.int32), results)
        ok = torch.isfinite(got)
        if not torch.equal(got[ok].view(torch.int32), fn(kept, q)[ok].view(torch.int32)):
            raise AssertionError(f"vdeposit {what}: a finite output moved with the "
                                 f"non-finite terms")
        nan, pos, neg = (int(t.sum()) for t in (torch.isnan(got), torch.isposinf(got),
                                                torch.isneginf(got)))
        log(f"[c] vdeposit {what}, non-finite charges: {nan} NaN, {pos} +inf, {neg} -inf "
            f"outputs of {got.numel()}, the other {int(ok.sum())} equal to the deposit "
            f"without the bad particles")
        if not (nan and pos and neg):
            raise AssertionError(f"vdeposit {what}: the non-finite pattern is missing")


def check_trace2d(results: dict, dev, mesh, grid, x, elem, active) -> None:
    """M2 and V at the 2D path's full width: the 120k mesh, its cartesian
    grid and phase c's 10M located particles (``x``, ``elem``, ``active``),
    each case exact against its plain version on the card, timed, with its
    bound; then the path's surface checks."""
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    gen = torch.Generator(dev).manual_seed(7)
    n = x.shape[0]
    dest = walker_targets(mesh, x, gen)
    n_act = int(active.sum())
    reflect, remove = se.reflect_on_exit_2d, se.remove_on_exit
    it = TRACE2D_ITERS
    # 1, 2: reflect + record_exit, from the plain start and through the peel
    r1 = check_trace2d_case(results, mesh, (x, dest, elem, active, it, reflect, True,
                                            "off", None), "reflect+record, plain start")
    share = int((r1.num_hits > 0).sum()) / n_act
    log(f"[c] trace2d: share of walkers that cross the outer wall {share:.4f} "
        f"(target {WALL_SHARE} pushed beyond it)")
    if not 0.02 <= share <= 0.10:
        raise AssertionError(f"trace2d: {share:.4f} of the walkers hit the wall, "
                             f"not 2-10%")
    lost = int((active & ~r1.active).sum())
    log(f"[c] trace2d reflect: {lost} walkers lost (all_found {bool(r1.all_found)})")
    if lost and bool(r1.all_found):
        raise AssertionError("trace2d reflect: walkers lost but none at the limit")
    if lost > n // 100_000:
        raise AssertionError(f"trace2d reflect: {lost} walkers lost at the loop limit")
    rp = check_trace2d_case(results, mesh, (x, dest, elem, active, it, reflect, True,
                                            "off", grid), "reflect+record, peel")
    if int((active & ~rp.active).sum()) > n // 100_000:
        raise AssertionError("trace2d reflect (peel): walkers lost")
    del rp
    # 3: remove + record_exit: the lost walkers are those with a real hit
    rr = check_trace2d_case(results, mesh, (x, dest, elem, active, it, remove, True,
                                            "off", None), "remove+record, plain start")
    if not torch.equal(active & ~rr.active, rr.num_hits >= 1) or not bool(rr.all_found):
        raise AssertionError("trace2d remove: lost walkers != walkers with a real hit")
    del rr
    # 4: reflect with a budget of 2 and recovery
    check_trace2d_case(results, mesh, (x, dest, elem, active, 2, reflect, False,
                                       "project", None), "reflect, budget 2 + recover")
    # 5: far targets, random points of the mesh's box
    lo, hi = mesh.coords.amin(0), mesh.coords.amax(0)
    far = (lo + (hi - lo) * torch.rand(x.shape, generator=gen, device=dev)).contiguous()
    check_trace2d_case(results, mesh, (x, far, elem, active, TRACE2D_FAR_ITERS, reflect,
                                       True, "off", None), "far targets, reflect+record",
                       plain_reps=1)
    del far
    # 6: the unified driver with parent repair, 1% of the claimed parents wrong
    claim = elem.clone()
    bad = torch.rand(n, generator=gen, device=dev) < 0.01
    claim[bad] = torch.randint(0, mesh.nelems, (int(bad.sum()),), generator=gen,
                               device=dev, dtype=torch.int32)
    got = se.trace_particle_through_mesh(mesh, x, dest, claim, active, it, reflect,
                                         record_exit=True, validate_parents="repair")
    fixed, n_bad, n_rep = se.check_initial_parents(mesh, x, claim, active)
    want = se.trace_2d_plain(mesh, x, dest, fixed, active & (fixed >= 0), it, reflect, True)
    compare("trace2d", f"trace_particle_through_mesh, repair + reflect + record ({n} "
            f"particles, {int(n_bad)} bad parents, {int(n_rep)} repaired)",
            trace_fields(got), trace_fields(want), results)
    del got, want, claim, bad, fixed
    # 7, 8: V as the charge deposit and as the weighted count
    q = (0.5 + torch.rand(n, generator=gen, device=dev)).contiguous()
    e1, a1 = r1.elem_ids, r1.active
    bcc = barycentric_2d(mesh, e1, r1.dest)
    V, E = mesh.nverts, mesh.nelems
    terms = (bcc * q[:, None]).reshape(-1)
    keys = torch.where(a1[:, None], mesh.elem2verts[torch.clamp(e1, min=0).long()],
                       V).reshape(-1).long()
    fn = lambda: sc.scatter_to_verts_bcc(e1, a1, bcc, mesh.elem2verts, V, q)  # noqa: E731
    rho = fn()
    check_vdeposit_case(results, f"scatter_to_verts_bcc ({n} particles, V={V})", fn,
                        lambda: sc.vertex_deposit_plain(bcc, q, e1, a1, mesh.elem2verts, V),
                        (e1, a1, bcc, q, mesh.elem2verts), rho, terms, keys, V)
    # the deposit conserves charge: each output is within half an ulp (and
    # the fixed point's 2^-(K+1) per term) of its exact sum
    exact = torch.zeros(V + 1, dtype=torch.float64, device=dev).index_add_(
        0, keys, terms.double())[:V]
    m = torch.bincount(keys, minlength=V + 1)[:V].double()
    L = max(terms.numel() - 1, 0).bit_length()
    e_max = max((int(terms.abs().max().view(torch.int32)) >> 23), 1) - 126
    step = 2.0 ** (L + e_max - sc.FIXED_BITS)
    err = float((rho.double() - exact).abs().sum())
    bound = float((torch.finfo(torch.float32).eps * rho.double().abs() + m * step).sum())
    tot_q = float(q.double()[a1].sum())
    log(f"[c] vdeposit: sum of the deposit {float(rho.double().sum()):.9g}, of its "
        f"terms {float(exact.sum()):.9g}, of the active charge {tot_q:.9g}; "
        f"sum |deposit - exact| {err:.3g} <= {bound:.3g}")
    if not err <= bound or not abs(float(exact.sum()) - tot_q) <= 1e-5 * tot_q:
        raise AssertionError("vdeposit: the deposit does not conserve the charge")
    del terms, keys, exact, m, rho
    keys_e = torch.where(a1 & (e1 >= 0), e1, E).long()
    fn = lambda: sc.particles_per_element(e1, a1, E, q)  # noqa: E731
    check_vdeposit_case(results, f"weighted particles_per_element ({n} particles, E={E})",
                        fn, lambda: sc.vertex_deposit_plain(q, None, e1, a1, None, E),
                        (e1, a1, q), fn(), q, keys_e, E)
    # 9, 10: both in a random order of the same particles (the path's own
    # order groups them by element: V sums a block tile's equal keys first)
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    pe, pa, pq, pb = (t[perm].contiguous() for t in (e1, a1, q, bcc))
    keys = torch.where(pa[:, None], mesh.elem2verts[torch.clamp(pe, min=0).long()],
                       V).reshape(-1).long()
    fn = lambda: sc.scatter_to_verts_bcc(pe, pa, pb, mesh.elem2verts, V, pq)  # noqa: E731
    check_vdeposit_case(results, f"scatter_to_verts_bcc, random order ({n} particles, "
                        f"V={V})", fn,
                        lambda: sc.vertex_deposit_plain(pb, pq, pe, pa, mesh.elem2verts, V),
                        (pe, pa, pb, pq, mesh.elem2verts), fn(),
                        (pb * pq[:, None]).reshape(-1), keys, V)
    keys_e = torch.where(pa & (pe >= 0), pe, E).long()
    fn = lambda: sc.particles_per_element(pe, pa, E, pq)  # noqa: E731
    check_vdeposit_case(results, f"weighted particles_per_element, random order ({n} "
                        f"particles, E={E})", fn,
                        lambda: sc.vertex_deposit_plain(pq, None, pe, pa, None, E),
                        (pe, pa, pq), fn(), pq, keys_e, E)
    del perm, pe, pa, pq, pb, keys, keys_e
    check_vdeposit_non_finite(results, mesh, e1, a1, bcc, q)
    cnt = sc.particles_per_element(e1, a1, E)
    if int(cnt.sum()) != int(a1.sum()):
        raise AssertionError("particles_per_element (H): counts != active particles")
    log(f"[c] unweighted particles_per_element (H): {int(cnt.sum())} == active")


def trace2d_path_call(mesh, grid, x, elem, active, q, gen):
    """One call of the 2D path through its entry points:
    trace_particle_through_mesh (parent repair, reflecting wall, exit
    record) from ``x`` to :func:`walker_targets`, search_mesh_2d_accel
    (reflect, record, recovery) one more push of 3 element sizes on, then
    the charge deposit at the final positions (scatter_to_verts_bcc with
    the charge ``q``), the weighted and the unweighted
    particles_per_element.  Each part runs in a ``record_function`` range
    (PATH_RANGES: ``harness:`` the harness's own inputs, ``port:`` the
    port's entry points) that a profile attributes device time to.
    Returns (first walk, second walk, deposit, weighted count, count)."""
    from torch.profiler import record_function

    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    h = float(mesh.elem_area.abs().sqrt().mean())
    reflect = se.reflect_on_exit_2d
    with record_function("harness:walker_targets"):
        d1 = walker_targets(mesh, x, gen)
    with record_function("port:trace_particle_through_mesh"):
        r1 = se.trace_particle_through_mesh(mesh, x, d1, elem, active, TRACE2D_ITERS,
                                            reflect, record_exit=True,
                                            validate_parents="repair")
    with record_function("harness:d2_noise"):
        d2 = r1.dest + 3.0 * h * torch.randn(x.shape, generator=gen, device=x.device)
    with record_function("port:search_mesh_2d_accel"):
        r2 = se.search_mesh_2d_accel(mesh, grid, r1.dest, d2, r1.elem_ids, r1.active,
                                     TRACE2D_ITERS, reflect, record_exit=True,
                                     recover="project")
    with record_function("harness:barycentric_2d"):
        bcc = barycentric_2d(mesh, r2.elem_ids, r2.dest)
    with record_function("port:scatter_to_verts_bcc"):
        rho = sc.scatter_to_verts_bcc(r2.elem_ids, r2.active, bcc, mesh.elem2verts,
                                      mesh.nverts, q)
    with record_function("port:particles_per_element, weighted"):
        w = sc.particles_per_element(r2.elem_ids, r2.active, mesh.nelems, q)
    with record_function("port:particles_per_element"):
        cnt = sc.particles_per_element(r2.elem_ids, r2.active, mesh.nelems)
    return r1, r2, rho, w, cnt


def run_trace2d_path(results: dict, dev, mesh, grid, x, elem, active, smi: str) -> None:
    """The 2D path end to end (:func:`trace2d_path_call`), PATH_CALLS
    times, each call starting where the last ended.  The counts are reset
    just before and read just after; every kernel of PATH_KERNELS must
    have launched, and no other."""
    from pumipic_torch import kernels

    gen = torch.Generator(dev).manual_seed(17)
    n = x.shape[0]
    q = (0.5 + torch.rand(n, generator=gen, device=dev)).contiguous()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times = []
    for k in range(PATH_CALLS):
        t0 = time.perf_counter()
        r1, r2, rho, w, cnt = trace2d_path_call(mesh, grid, x, elem, active, q, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        x, elem, active = r2.dest.contiguous(), r2.elem_ids, r2.active
        hits = int(((r1.num_hits > 0) | (r2.num_hits > 0)).sum())
        log(f"[d] 2d path call {k}: {times[-1]:.3f} ms, alive {int(active.sum())}, "
            f"walkers that hit the wall {hits}, iters {int(r1.iters)}/{int(r2.iters)}, "
            f"recovered {int(r2.num_recovered)}")
        if not (bool(torch.isfinite(rho).all()) and bool(torch.isfinite(w).all())
                and int(cnt.sum()) == int(active.sum())):
            raise AssertionError("2d path: deposit not finite or counts off")
    counts = dict(kernels.LAUNCHES)
    log(f"[d] 2d path ({n} particles, {PATH_CALLS} calls): ms per call "
        + ", ".join(f"{t:.3f}" for t in times) + f" ({smi})")
    log(f"[d] 2d path kernel launches: {counts}")
    launched = {k for k, v in counts.items() if v > 0}
    if launched != set(PATH_KERNELS):
        raise AssertionError(f"2d path launched {sorted(launched)}, expected "
                             f"{sorted(PATH_KERNELS)}")
    for k, v in counts.items():
        results[k]["launches"] = results[k].get("launches", 0) + v
    check_parents_at_path(results, mesh, x, elem, active)


def check_band(results: dict, dev, mesh):
    """B and L's given-cells mode at 10M on the 120k mesh's flux-band
    grid; returns the grid and its build seconds."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    cfg = _cfg(px, mesh, band_locator="force")
    setup = {}
    s, step = px.make_dp_setup(mesh, cfg, dev, timings=setup)
    grid = step.model.locator
    log(f"[c] band grid: K={grid.n_bands} T={grid.n_theta} J={grid.n_harm} "
        f"P={grid.n_cheb} rank={grid.rank} seed terms={grid.inv_coef.shape[0]}, "
        f"rows {tuple(grid.cell_rows.shape)}, built in {setup['locator']:.2f} s")
    tx, ty, _, _ = _push(push_ops, s, step.model, cfg)
    n = tx.shape[0]
    got = lo.band_cell_of(grid, tx, ty)
    compare("band_cell", f"({n} pushed targets)", got,
            lo.band_cell_of_plain(grid, tx, ty), results)
    time_pair("band_cell", "", lambda: lo.band_cell_of(grid, tx, ty),
              lambda: lo.band_cell_of_plain(grid, tx, ty), results, plain_reps=3)
    # ~1,450 f32 operations per point (harmonics, Chebyshev Newton, θ-bin)
    record_bound("band_cell", "", results, nbytes(tx, ty, grid.coef_u, grid.coef_v,
                                              grid.inv_coef, got), 1450.0 * n)
    # the floor of B's uncontracted stream (-fmad=false): one FMUL or FADD
    # per operation, one warp instruction per clock on each of an SM's 128
    # f32 lanes, at the card's maximum SM clock
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi_query("clocks.max.sm", units=False))
    floor_ms = 1450.0 * n / (sms * 128 * mhz * 1e6) * 1e3
    log(f"[c] band_cell uncontracted floor: 1450 x {n} instructions over {sms} SMs "
        f"x 128 lanes x {mhz:.0f} MHz -> {floor_ms:.4f} ms")
    case_of("band_cell", "", results)["uncontracted_floor_ms"] = floor_ms
    results["band_cell"]["extra"]["uncontracted_floor_ms"] = floor_ms

    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    got = se.walk_locate(*largs, grid=grid)
    compare("locate", f"given cells, band grid ({n} particles)", got,
            se.walk_locate_plain(*largs, grid=grid), results)
    log(f"[c] band locate: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    time_pair("locate", "B + given cells", lambda: se.walk_locate(*largs, grid=grid),
              lambda: se.walk_locate_plain(*largs, grid=grid), results,
              plain_reps=3, record=False)
    record_bound("locate", "B + given cells (L's part)", results,
                 nbytes(*largs[:5], grid.cell_rows, *got[:2]) + 4 * n)
    return grid, setup["locator"]


def check_pprad(results: dict, dev, mesh, elem, active) -> None:
    """H's (element, ring) key mode at 10M and D's pass 1 from (E, R)."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import scatter as sc

    cfg = _cfg(px, mesh, gyro=px.GyroConfig(per_particle_radius=True))
    rg = px.initial_state(mesh, cfg, device=dev)["rg"]
    E, R, rmax = mesh.nelems, cfg.gyro.num_rings, cfg.gyro.rmax
    args = (elem, active, E, rg, R, rmax)
    got = sc.histogram(*args)
    compare("histogram", f"key mode ({elem.shape[0]} particles -> {E * R} keys)",
            got, sc.histogram_plain(*args), results)
    time_pair("histogram", "key mode", lambda: sc.histogram(*args),
              lambda: sc.histogram_plain(*args), results, record=False)
    record_bound("histogram", "key mode", results, nbytes(elem, active, rg, got))
    # the yardstick: torch.bincount of the two key streams, made beforehand
    keys = ring_key_streams(elem, active, rg, E, R, rmax)
    record_library("histogram", "key mode", "torch.bincount of the two key streams",
                   lambda: torch.bincount(keys, minlength=E * R + 1), results)
    del keys
    counts = got.view(E, R)
    compare("deposit", f"pass 1 from (E, R) = ({E}, {R}) counts",
            sc.deposit_rings(counts, mesh, R), sc.ring_accum_plain(counts, mesh, R),
            results)
    time_pair("deposit", "pass 1 from (E, R)", lambda: sc.deposit_rings(counts, mesh, R),
              lambda: sc.ring_accum_plain(counts, mesh, R), results, record=False)
    record_bound("deposit", "pass 1 from (E, R)", results,
                 nbytes(counts, mesh.vert2elem_offsets, mesh.vert2elem_vals) +
                 4 * mesh.nverts * R)
    m = ring_incidence(mesh, R, dev)
    cf = counts.reshape(-1).to(torch.float32)
    log(f"[c] deposit pass 1 yardstick: max |mv - kernel| = "
        f"{max_err(torch.mv(m, cf), sc.deposit_rings(counts, mesh, R).reshape(-1))}")
    record_library("deposit", "pass 1 from (E, R)", "torch.mv of the CSR ring incidence",
                   lambda: torch.mv(m, cf), results)


def annulus_targets(dev):
    """The annulus arm's locator and pushed targets at 10M: (loc, tx, ty,
    active) of ``make_dp_setup`` on ``make_default_mesh(ANNULUS_ELEMS)``."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops

    mesh = px.make_default_mesh(ANNULUS_ELEMS, device=dev)
    cfg = _cfg(px, mesh)
    s, step = px.make_dp_setup(mesh, cfg, dev)
    loc = step.model.analytic
    if loc is None or not loc.ring_class:
        raise AssertionError("the bench annulus was not proven ring_class")
    tx, ty, _, _ = _push(push_ops, s, step.model, cfg)
    return loc, tx, ty, s["active"]


def check_annulus(results: dict, dev) -> None:
    """A at 10M on the annulus setup's pushed targets, in the generator's
    element order (the arm's) and through a random element permutation
    (an imported annulus's)."""
    import dataclasses

    from pumipic_torch.ops import locate as lo

    loc, tx, ty, active = annulus_targets(dev)
    n, E = tx.shape[0], 2 * loc.n_rings * loc.n_sectors
    perm = torch.randperm(E, device=dev, generator=torch.Generator(dev).manual_seed(2))
    for what, lc in (("", loc), ("permuted ids", dataclasses.replace(
            loc, perm=perm.to(torch.int32)))):
        args = (lc, tx, ty, active)
        got = lo.annulus_locate(*args)
        ids = what or "generator ids"
        compare("annulus_locate", f"{ids} ({n} particles, E={E}, {loc.n_sectors} sectors)",
                got, lo.annulus_locate_plain(*args), results)
        log(f"[c] annulus locate, {ids}: alive={int(got[1].sum())} of {n}")
        time_pair("annulus_locate", what, lambda: lo.annulus_locate(*args),
                  lambda: lo.annulus_locate_plain(*args), results)
        # the function's work: one atan2, three divisions and ~25 products,
        # sums and tests per particle (~40 f32 operations), and the sector
        # table's six cos/sin once per sector (~20 each)
        record_bound("annulus_locate", what, results,
                     nbytes(tx, ty, active, lc.sector_table(dev), lc.perm, *got),
                     40.0 * n + 120.0 * loc.n_sectors)


def scs_of_located(dev, E: int, s: dict, elem, active):
    """Phase c's Sell-C-σ structure (chunks of 8 rows, no sorting window)
    of the FULL-mode state ``s``'s particles in the located elements
    ``elem``: fields x, xtgt, pid, b and phi, as the app carries them."""
    from pumipic_torch.particles import SCSInput, SellCSigma

    n = s["x0"].shape[0]
    x = torch.stack([s["x0"], s["x1"]], 1)
    fields = {"x": x, "xtgt": torch.zeros_like(x),
              "pid": torch.arange(n, dtype=torch.int32, device=dev), "b": s["b"],
              "phi": torch.atan2(s["sphi"], s["cphi"])}
    return SellCSigma(E, torch.where(active, elem, -1), fields=fields,
                      scs_input=SCSInput(chunk_size=8, sigma=None), device=dev)


def located_after_push(mesh, ps, cfg, locator, bands):
    """The elements of ``ps``'s particles after one phi-mode push from
    their positions: the new elements a rebuild of ``ps`` takes."""
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    tx, ty, _, _ = push_ops.push_phi(ps.get("x"), ps.get("phi"), ps.get("b"), ps.active,
                                     ps.elem, cfg.deg_per_push, cfg.h, cfg.k, cfg.d,
                                     bands=bands)
    return se.walk_locate(mesh.walk_geom, tx, ty, ps.elem, ps.active,
                          cfg.max_search_iters, grid=locator)[0]


def check_rows(results: dict, dev, mesh, s, model, elem, active) -> None:
    """G's rows form at T2's probe shape; then, on a Sell-C-σ structure of
    the 10M located particles, P's phi mode (band and class forms), S in the
    scs and cabm modes and G's columns form at the sorted rebuild's shapes.
    The structure's construction runs the rebuild too (not the main path)."""
    import numpy as np

    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import rows

    # G, rows form: perf/pallas_gather_ab.py's probe (C 24,576 x W 14 f32,
    # N 10M indices, from default_rng(0) in its order)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(size=(24_576, 14)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 24_576, NUM_PTCLS).astype(np.int32), device=dev)
    got = rows.row_gather(table, idx)
    compare("row_gather", f"rows form, T2 probe ({tuple(table.shape)} table, "
            f"{idx.shape[0]} indices)", got.view(torch.int32),
            rows.row_gather_plain(table, idx).view(torch.int32), results)
    time_pair("row_gather", "rows form (T2 probe)", lambda: rows.row_gather(table, idx),
              lambda: rows.row_gather_plain(table, idx), results)
    record_bound("row_gather", "rows form (T2 probe)", results, nbytes(table, idx, got))
    record_library("row_gather", "rows form (T2 probe)", "torch.index_select",
                   lambda: torch.index_select(table, 0, idx), results)
    del table, idx, got

    cfg = _cfg(px, mesh)
    E = mesh.nelems
    t0 = time.perf_counter()
    ps = scs_of_located(dev, E, s, elem, active)
    torch.cuda.synchronize()
    log(f"[c] SCS structure of {int(ps.num_ptcls)} particles: capacity {ps.capacity}, "
        f"built in {time.perf_counter() - t0:.2f} s")

    # P, phi mode, both class forms, over the C slots
    bands = push_ops.BandClasses.build(
        push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), dev)
    cls = mesh.class_id[torch.clamp(ps.elem, min=0).long()]
    base = (ps.get("x"), ps.get("phi"), ps.get("b"), ps.active)
    tail = (cfg.deg_per_push, cfg.h, cfg.k, cfg.d)
    for form, c, b in (("band form", ps.elem, bands), ("class form", cls, None)):
        got = push_ops.push_phi(*base, c, *tail, bands=b)
        compare("push", f"phi mode, {form} ({ps.capacity} slots)", got,
                push_ops.push_phi_plain(*base, c, *tail, bands=b), results)
        time_pair("push", f"phi mode, {form}",
                  lambda: push_ops.push_phi(*base, c, *tail, bands=b),
                  lambda: push_ops.push_phi_plain(*base, c, *tail, bands=b),
                  results, record=False)
        # ~25 f32 operations and two f64 libm calls per slot
        record_bound("push", f"phi mode, {form}", results,
                     nbytes(*base, c, *got, None if b is None else b.starts),
                     25.0 * ps.capacity)
    new_elem = located_after_push(mesh, ps, cfg, model.locator, bands)
    C = ps.capacity
    # Q's DPS mode: the rebuild's destination check
    check_rebuild_mask(results, f"dps mode, the rebuild's destinations ({C} slots)",
                       "rebuild_mask_dps", (new_elem, ps.active, E))
    modes, key = slot_map_inputs(ps, new_elem, E)
    # C: the rebuild's element sort, at one step's order, in a random
    # order, with 3 keys and as the DPS add path's 0/1 partition; its fused
    # mode on the rebuild's (elem, active, E) and the 0/1 partition's
    # (active, 1); keys outside [0, K] (a few among the app's, negative
    # ones, every int32) through the high passes
    check_key_sort(results, "app step-1 order", key, E)
    g = torch.Generator(dev).manual_seed(1)
    check_key_sort(results, "random order", key[torch.randperm(C, device=dev, generator=g)], E)
    check_key_sort(results, "K = 2", torch.randint(0, 3, (C,), device=dev, generator=g,
                                                   dtype=torch.int32), 2)
    check_key_sort(results, "0/1 partition (K = 1)", (key == E).to(torch.int32), 1)
    act = key < E
    check_masked_key_sort(results, "fused mode, app step-1 order",
                          torch.where(act, key, -1), act, E)
    check_masked_key_sort(results, "fused mode, 0/1 partition (K = 1)", None, act, 1)
    few = key.clone()
    few[torch.randperm(C, device=dev, generator=g)[:100]] = torch.randint(
        -2**31, 2**31 - 1, (100,), device=dev, generator=g, dtype=torch.int32)
    check_key_sort(results, "app step-1 order, 100 keys outside [0, K]", few, E)
    check_key_sort(results, "keys in [-K, K]", torch.randint(
        -E, E + 1, (C,), device=dev, generator=g, dtype=torch.int32), E)
    check_key_sort(results, "every int32", torch.randint(
        -2**31, 2**31 - 1, (C,), device=dev, generator=g, dtype=torch.int32), E)
    del few, act
    for layout, sargs in modes.items():
        got = check_slot_map(results, layout, sargs)
        if layout == "scs":
            src = got[0]
            # Q's epilogue mode on the scs slot map and the gathered keys
            # (each read where its slot is pre-valid)
            check_rebuild_mask(results, f"epilogue mode, scs ({C} slots)",
                               "rebuild_mask_epilogue", (got[2], key[src.long()], got[1]),
                               skip=4 * int((~got[2]).sum()))
    # Q's prefix mode: a CSR rebuild's first `needed` slots
    order, start = modes["scs"][1], modes["scs"][2]
    check_rebuild_mask(results, f"prefix mode, csr ({C} slots)", "rebuild_mask_prefix",
                       (key[order[:C].long()], start[E]))
    results["rebuild_mask"]["extra"]["library"] = "none: no one PyTorch call makes the mask"

    # G, columns form: the rebuild's fields in place plus the key lane, at
    # one step's locality and at a random permutation of the slots (the
    # app's own order after 20 steps follows run_app)
    cols = [ps.fields[k] for k in ("x", "xtgt", "pid", "b", "phi")] + [key]
    check_columns(results, "columns form, step-1 locality", cols, src)
    perm = torch.randperm(C, device=dev, generator=torch.Generator(dev).manual_seed(0)
                          ).to(torch.int32)
    check_columns(results, "columns form, random order", cols, perm)
    del perm


def slot_map_inputs(ps, new_elem, E: int):
    """Kernel S's arguments for a sorted rebuild of ``ps`` into
    ``new_elem``, as ``_rebuild`` / ``_rebuild_sorted`` make them, in the
    scs mode (``ps``'s chunks) and the cabm mode (segments of 8): {layout:
    args of ``rows.slot_map``}, and the rebuild's key lane."""
    from pumipic_torch.ops.scatter import histogram
    from pumipic_torch.particles import structure as st

    el = torch.where(ps.active & (new_elem >= 0) & (new_elem < E), new_elem, -1)
    act = el >= 0
    key = torch.where(act, el, E)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = histogram(el, act, E)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    r2e, _, cw = st._scs_row_order(counts, ps.sigma, ps.chunk_size, E)
    chunk_off = torch.cat([cw.new_zeros(1), torch.cumsum(ps.chunk_size * cw, 0,
                                                         dtype=torch.int32)])
    C, M = ps.capacity, el.shape[0]
    seg = ((counts + 7) // 8) * 8
    cabm_off = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0, dtype=torch.int32)])
    return {"scs": ("scs", order, start, chunk_off, r2e, ps.chunk_size, C, M),
            "cabm": ("cabm", order, start, cabm_off, None, 1, C, M)}, key


def check_slot_map(results: dict, what: str, sargs):
    """S on ``sargs`` (the arguments of ``rows.slot_map``): equal to the
    plain version on every slot, timed beside it, and its bound (each
    input read once, each output written once).  Returns its outputs."""
    from pumipic_torch.ops import rows

    _, order, start, offsets, row_order, _, C, M = sargs
    got = rows.slot_map(*sargs)
    compare("slot_map", f"{what} ({C} slots, {M} rows, layout {int(offsets[-1])} slots)",
            got, rows.slot_map_plain(*sargs), results)
    time_pair("slot_map", what, lambda: rows.slot_map(*sargs),
              lambda: rows.slot_map_plain(*sargs), results)
    record_bound("slot_map", what, results, nbytes(order, start, offsets, row_order, *got))
    return got


def key_sort_floor(results: dict, what: str, n: int, passes: int, fused: bool,
                   keep_key: bool) -> None:
    """C's design floor for a timed case, beside its bound: the bytes its
    launches must move (the histogram reads the keys, or elem and active,
    and writes the kept key; the first pass reads them again, each low pass
    writes a key and an index, each later one reads them, the last writes
    the order alone) over the memory rate."""
    src = 5 * n if fused else 4 * n
    b = 2 * src + 4 * n * keep_key + 8 * n * (passes - 1) * 2 + 4 * n
    floor_ms = b / PEAK_BYTES_PER_S * 1e3
    log(f"[c] key_sort {what} design floor: {b / 1e6:.1f} MB -> {floor_ms:.4f} ms")
    case_of("key_sort", what, results).update(floor_ms=floor_ms)


def check_key_sort(results: dict, what: str, key, max_key: int) -> None:
    """C on ``key``: equal to the plain version (the stable order), timed
    beside it and beside torch's stable sort, and its bound (the keys read
    once, the order written once) and design floor."""
    from pumipic_torch.ops import rebuild as rb

    got = rb.key_sort(key, max_key)
    passes = rb.key_sort_passes(max_key)
    outside = int(((key < 0) | (key > max_key)).sum())
    high = rb.key_sort_high_passes(max_key) if outside else []
    compare("key_sort", f"{what} ({key.shape[0]} keys, K {max_key}, {outside} outside "
            f"[0, K]; passes of {[w for _, w in passes + high]} bits)", got,
            rb.key_sort_plain(key, max_key), results)
    time_pair("key_sort", what, lambda: rb.key_sort(key, max_key),
              lambda: rb.key_sort_plain(key, max_key), results)
    record_bound("key_sort", what, results, nbytes(key, got))
    key_sort_floor(results, what, key.shape[0], len(passes), False, False)
    record_library("key_sort", what, "torch.sort(key, stable=True)",
                   lambda: torch.sort(key, stable=True), results)


def check_masked_key_sort(results: dict, what: str, elem, active, fill: int) -> None:
    """C's fused mode on (elem, active, fill), keeping the key as the
    rebuilds do: order and key equal to the plain version's where and
    stable sort, timed beside it and beside torch's stable sort of the
    formed key (the where not counted), its bound (elem and active read
    once, the order and the key written once) and design floor."""
    from pumipic_torch.ops import rebuild as rb

    got = rb.masked_key_sort(elem, active, fill, keep_key=True)
    want = rb.masked_key_sort_plain(elem, active, fill)
    compare("key_sort", f"{what} ({active.shape[0]} keys, fill {fill})", got, want, results)
    time_pair("key_sort", what, lambda: rb.masked_key_sort(elem, active, fill, keep_key=True),
              lambda: rb.masked_key_sort_plain(elem, active, fill), results)
    record_bound("key_sort", what, results, nbytes(elem, active, *got))
    key_sort_floor(results, what, active.shape[0], len(rb.key_sort_passes(fill)),
                   elem is not None, True)
    key = want[1]
    record_library("key_sort", what, "torch.sort(key, stable=True) of the formed key",
                   lambda: torch.sort(key, stable=True), results)


def check_rebuild_mask(results: dict, what: str, wrapper: str, args, skip: int = 0) -> None:
    """Q's mode ``wrapper`` (an ``ops.rebuild`` function) on ``args``: equal
    to its plain version, timed beside it, and its bound (each input read
    once, each output written once, less the ``skip`` bytes this data does
    not need)."""
    from pumipic_torch.ops import rebuild as rb

    fn, plain = getattr(rb, wrapper), getattr(rb, wrapper + "_plain")
    got = fn(*args)
    compare("rebuild_mask", what, got, plain(*args), results)
    log(f"[c] rebuild_mask {what}: {int(got[2])} slots hold a particle")
    time_pair("rebuild_mask", what, lambda: fn(*args), lambda: plain(*args), results)
    record_bound("rebuild_mask", what, results,
                 nbytes(*(a for a in args if isinstance(a, torch.Tensor)), *got) - skip)


def check_columns(results: dict, what: str, cols, src) -> None:
    """G's columns form on ``cols`` at source rows ``src``: equal to the
    plain version bit for bit, timed beside it, its bound, the 32-byte
    sectors it would read without reuse, and torch's per-array indexing."""
    from pumipic_torch.ops import rows

    def bits(ts):
        return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in ts]

    got = rows.row_gather(cols, src)
    lanes = sum(rows.lanes_of(c) for c in cols)
    compare("row_gather", f"{what} ({len(cols)} arrays, {lanes} lanes; "
            f"{src.shape[0]} slots)", bits(got), bits(rows.row_gather_plain(cols, src)),
            results)
    time_pair("row_gather", what, lambda: rows.row_gather(cols, src),
              lambda: rows.row_gather_plain(cols, src), results, record=False)
    record_bound("row_gather", what, results, nbytes(src, *cols, *got))
    sectors = 32 * src.shape[0] * len(cols) + nbytes(src, *got)
    log(f"[c] row_gather {what}: one 32-byte sector per array and slot, "
        f"{sectors / 1e6:.1f} MB -> {sectors / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    record_library("row_gather", what, "per-array indexing [c[idx.long()] for c in cols]",
                   lambda: [c[src.long()] for c in cols], results)


# ---------------------------------------------------------------------------
# U1, U2, U3, Z: the reshuffle-or-rebuild and the Sell-C-σ row order
# ---------------------------------------------------------------------------

# a reshuffle's device work besides Q (before it): U1 (a memset, one
# kernel); then U3 (one kernel), G and U2 (a memset of its count and flag,
# one kernel that writes every slot's element and mask and the fields in
# place: no copy); Z is one kernel
U1_NODES = {"memset": 1, "kernel": 1}
RESHUFFLE_NODES = {"memset": 1, "kernel": 3}
U2_NODES = {"memset": 1, "kernel": 1}
U3_NODES = {"kernel": 1}
Z_NODES = {"kernel": 1}


def auto_structure(dev, layout: str, E: int, x, elem):
    """pps3d's auto-rebuild structure (extra padding 0.15; Sell-C-σ chunks
    of 8, one window, or CabM) of the particles at ``x`` in tets ``elem``
    (element-sorted), pids in slot order."""
    from pumipic_torch.particles import structure as st

    fields = {"x": x, "pid": torch.arange(x.shape[0], dtype=torch.int32, device=dev)}
    e = elem.cpu().numpy()
    if layout == "scs":
        return st.SellCSigma(E, e, fields=fields, device=dev, scs_input=st.SCSInput(
            chunk_size=8, sigma=None, extra_padding=0.15))
    return st.CabM(E, e, fields=fields, extra_padding=0.15, device=dev)


def pushed_elem(kuhn, ps, direction, wrap, distance: float):
    """Kernel Q's destinations for one Kuhn push of ``ps`` by ``distance``."""
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import rebuild as rb

    _, tgt = lo.kuhn_push_locate(kuhn, ps.get("x"), ps.active,
                                 push_ops.step_vector(direction, distance), wrap)
    return rb.rebuild_mask_dps(tgt, ps.active, ps.num_elems)[0]


def check_reshuffle_count(results: dict, ps, elem, what: str):
    """U1 on a rebuild's destinations: equal to its plain version (fits,
    n_mov, the count and the list's first min(n_mov, MB) always; the
    stayers' and movers' counts and first places where n_mov fits the
    budget: past it U1 counts alone),
    timed beside it, its bound and its device work.  Returns its outputs
    and the budget."""
    from pumipic_torch.ops import rebuild as rb
    from pumipic_torch.particles import structure as st

    MB = st._reshuffle_mover_budget(ps.capacity)
    args = (elem, ps.elem, ps.seg_cap, MB)
    got, want = rb.reshuffle_count(*args), rb.reshuffle_count_plain(*args)
    fits, n_mov = want.info.tolist()
    k = min(n_mov, MB)
    pairs = [(got.info, want.info), (got.num, want.num),
             (got.msrc[:k], want.msrc[:k]), (got.mkey[:k], want.mkey[:k])]
    if n_mov <= MB:
        pairs += [(got.stay_cnt, want.stay_cnt), (got.mov_cnt, want.mov_cnt),
                  (got.mov_start, want.mov_start)]
    C, E = ps.capacity, ps.num_elems
    log(f"[c] reshuffle_count {what}: {n_mov} movers ({n_mov / int(ps.num_ptcls):.4f} of "
        f"the particles), budget {MB}, fits {bool(fits)}")
    compare("reshuffle_count", f"{what} ({C} slots, {E} tets)",
            tuple(a for a, _ in pairs), tuple(b for _, b in pairs), results)
    time_pair("reshuffle_count", what, lambda: rb.reshuffle_count(*args),
              lambda: rb.reshuffle_count_plain(*args), results)
    record_bound("reshuffle_count", what, results,
                 nbytes(elem, ps.elem, ps.seg_cap, got.mov_start, got.info)
                 + 8 * E + 8 * k)
    record_launches("reshuffle_count", what, lambda: rb.reshuffle_count(*args), results,
                    U1_NODES)
    if fits:
        check_reshuffle_order(results, got, n_mov, E, what)
        # C with a payload: the mover sort that U3 replaced (the movers'
        # slots in destination order), beside torch.sort of the same keys
        key, vals = want.mkey[:n_mov], want.msrc[:n_mov]
        c_what = f"with a payload, the movers of {what} ({n_mov} keys)"
        compare("key_sort", c_what, rb.key_sort(key, E - 1, values=vals),
                rb.key_sort_plain(key, E - 1, values=vals), results)
        time_pair("key_sort", c_what, lambda: rb.key_sort(key, E - 1, values=vals),
                  lambda: rb.key_sort_plain(key, E - 1, values=vals), results, record=False)
        # the keys and the payload read, the payload in order written
        record_bound("key_sort", c_what, results, 3 * nbytes(key))
        record_library("key_sort", c_what, "torch.sort(key, stable=True)",
                       lambda: torch.sort(key, stable=True), results, entry=False)
    return got, MB


def check_reshuffle_order(results: dict, counted, n_mov: int, E: int, what: str) -> None:
    """U3 on U1's movers (their keys, slots and the destinations' first
    places): equal to its plain version (kernel C's, the stable sort with a
    payload), timed beside it and beside ``torch.sort(key, stable=True)``,
    its bound (each mover's key and slot read, its slot written, the
    starts read) and its device work (one kernel)."""
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import rebuild as rb

    args = (counted.mkey[:n_mov], counted.msrc[:n_mov], counted.mov_start)
    u_what = f"the movers of {what} ({n_mov} movers, {E} tets)"
    compare("reshuffle_order", u_what, rb.reshuffle_order(*args),
            rb.reshuffle_order_plain(*args), results)
    time_pair("reshuffle_order", what, lambda: rb.reshuffle_order(*args),
              lambda: rb.reshuffle_order_plain(*args), results)
    record_bound("reshuffle_order", what, results, 3 * nbytes(args[0]) + nbytes(args[2]))
    record_library("reshuffle_order", what, "torch.sort(key, stable=True)",
                   lambda: torch.sort(args[0], stable=True), results)
    record_launches("reshuffle_order", what, lambda: rb.reshuffle_order(*args), results,
                    U3_NODES)
    case_of("reshuffle_order", what, results)["grid_blocks"] = \
        _build.lib().pp_reshuffle_order_grid(E)


def check_reshuffle_place(results: dict, ps, elem, what: str, order: bool = False) -> None:
    """U2 at a reshuffle of ``ps`` into ``elem``, on its own inputs (U1's
    counts, U3's mover slots in destination order, G's staged rows), with
    ``order`` U3 there too (:func:`check_reshuffle_order`), the
    kernel and its plain version each writing into its own copy of the
    fields (U2 writes them in place; the copies are made once, outside the
    timing, and a repeated call writes the same rows): equal on every slot
    and field, timed beside it, its bound (each segment slot's two ids
    read, the per-element arrays and the row order read, the staged rows
    read and written into their slots, each slot's id and mask written)
    and its device work; and the whole reshuffle after the host's read, on
    a structure with its own copy of the fields."""
    import dataclasses

    from pumipic_torch.ops import rebuild as rb
    from pumipic_torch.particles import structure as st

    counted = rb.reshuffle_count(elem, ps.elem, ps.seg_cap,
                                 st._reshuffle_mover_budget(ps.capacity))
    stride = ps.chunk_size if ps.layout == "scs" else 1
    fits, n_mov = counted.info.tolist()
    if not fits:
        raise AssertionError(f"reshuffle_place {what}: the reshuffle does not fit")
    if order:
        check_reshuffle_order(results, counted, n_mov, ps.num_elems, what)
    take = rb.reshuffle_order(counted.mkey[:n_mov], counted.msrc[:n_mov], counted.mov_start)
    staged, _ = st._gather_fields(ps.fields, take)

    def args(fields):
        return (elem, ps.elem, ps.elem_offsets, ps.seg_cap, counted.mov_cnt,
                counted.mov_start, fields, staged, stride, ps.overflowed, ps.row_to_elem)

    kargs = args({k: v.clone() for k, v in ps.fields.items()})
    pargs = args({k: v.clone() for k, v in ps.fields.items()})
    got, want = rb.reshuffle_place(*kargs), rb.reshuffle_place_plain(*pargs)

    def flat(out):
        return (out[0], out[1], *(f.view(torch.int32) if f.dtype == torch.float32 else f
                                  for f in out[2].values()), out[3], out[4])

    C, E = ps.capacity, ps.num_elems
    log(f"[c] reshuffle_place {what}: {n_mov} movers ({n_mov / int(ps.num_ptcls):.4f}), "
        f"{int(got[3])} particles held")
    compare("reshuffle_place", f"{what} ({C} slots, {E} tets, {ps.layout})", flat(got),
            flat(want), results)
    if int(got[3]) != int((elem >= 0).sum()) or bool(got[4]):
        raise AssertionError(f"reshuffle_place {what}: a particle lost")
    if any(got[2][k] is not kargs[6][k] for k in got[2]):
        raise AssertionError(f"reshuffle_place {what}: the fields were not written in place")
    time_pair("reshuffle_place", what, lambda: rb.reshuffle_place(*kargs),
              lambda: rb.reshuffle_place_plain(*pargs), results, plain_reps=2)
    seg_slots = int(ps.seg_cap.sum())
    rows = nbytes(*staged.values())
    record_bound("reshuffle_place", what, results,
                 8 * seg_slots + 16 * E + nbytes(ps.row_to_elem) + 2 * rows
                 + nbytes(got[0], got[1]))
    # the out-of-place function: + the fields cloned, read and written
    field_bytes = sum(nbytes(f) for f in ps.fields.values())
    case_of("reshuffle_place", what, results)["bound_out_of_place_ms"] = (
        (8 * seg_slots + 16 * E + rows + 2 * field_bytes + nbytes(got[0], got[1]))
        / PEAK_BYTES_PER_S * 1e3)
    record_launches("reshuffle_place", what, lambda: rb.reshuffle_place(*kargs), results,
                    U2_NODES)
    active = elem >= 0
    own = dataclasses.replace(ps, fields={k: v.clone() for k, v in ps.fields.items()})
    record_launches("reshuffle_place", f"{what}, the reshuffle (U3, G, U2)",
                    lambda: st._reshuffle(own, elem, active, counted, n_mov), results,
                    RESHUFFLE_NODES)


def scs_row_order_torch(counts, sigma: int, chunk: int, E: int):
    """The row order as the port computed it before kernel Z: torch's
    stable sort of the negated counts in σ windows, a scatter for the
    element -> row map and an amax over each chunk (the yardstick of Z's
    row order; the port never calls it)."""
    R = -(-max(E, 1) // chunk) * chunk
    sigma = min(sigma, R)
    nwin = -(-R // sigma)
    cpad = torch.full((nwin * sigma,), -1, dtype=counts.dtype, device=counts.device)
    cpad[:E] = counts
    order = torch.sort(-cpad.reshape(nwin, sigma), dim=1, stable=True).indices
    base = (torch.arange(nwin, device=counts.device) * sigma)[:, None]
    r2e = (order + base).reshape(-1)[:R].to(torch.int32)
    e2r = torch.zeros(R, dtype=torch.int32, device=counts.device)
    e2r[r2e.long()] = torch.arange(R, dtype=torch.int32, device=counts.device)
    rc = cpad[r2e.long()]
    return r2e, e2r[:E], torch.amax(torch.where(rc > 0, rc, 0).reshape(R // chunk, chunk),
                                    dim=1)


def check_scs_row_order(results: dict, counts, num_ptcls: int, what: str) -> None:
    """Z on a rebuild's padded counts: equal to its plain version (the key,
    the stable sort, the maps) and to the torch row order it replaced;
    timed beside its plain version, that torch code and one
    ``torch.sort(-win, dim=1, stable=True)`` (the sort alone); its bound
    (the counts read, the three maps written) and its device work (one
    kernel, no memset, through ``_scs_row_order``)."""
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import rebuild as rb
    from pumipic_torch.particles import structure as st

    E, chunk = counts.shape[0], 8
    R = -(-E // chunk) * chunk
    bits = st._scs_key_bits(1, E, num_ptcls, 0.0)
    args = (counts, R, 2**30, chunk, bits)
    got = rb.scs_row_order(*args)
    compare("scs_row_order", f"{what} ({E} counts, {R} rows)", got,
            rb.scs_row_order_plain(*args), results)
    compare("scs_row_order", f"{what}, against the torch code Z replaced", got,
            scs_row_order_torch(counts, 2**30, chunk, E), results)
    time_pair("scs_row_order", what, lambda: rb.scs_row_order(*args),
              lambda: rb.scs_row_order_plain(*args), results)
    record_bound("scs_row_order", what, results, nbytes(counts, *got))
    win = torch.full((R,), -1, dtype=counts.dtype, device=counts.device)
    win[:E] = counts
    win = win.reshape(1, R)
    record_library("scs_row_order", what, "torch.sort(-win, dim=1, stable=True)",
                   lambda: torch.sort(-win, dim=1, stable=True), results)
    row = f"{what}, beside the torch code Z replaced"
    time_pair("scs_row_order", row, lambda: rb.scs_row_order(*args),
              lambda: scs_row_order_torch(counts, 2**30, chunk, E), results, record=False)
    record_launches("scs_row_order", what,
                    lambda: st._scs_row_order(counts, 2**30, chunk, E, num_ptcls=num_ptcls),
                    results, Z_NODES)
    case_of("scs_row_order", what, results)["cluster_blocks"] = \
        _build.lib().pp_scs_row_order_cluster_blocks()


def check_reshuffle(results: dict, dev, mesh, seeded) -> None:
    """U1, U2, U3 and Z at pseudoPushAndSearch's shapes: the auto rebuild's
    Sell-C-σ and CabM structures (extra padding 0.15) of phase c's 10M
    seeded particles on the Kuhn box; U1 after one push of the auto arms'
    distance (every mover fits) and of the default (the fallback); U2
    after pushes of 2, 4 and 1 times the arms' (5.4%, 10.7% and 2.7% of
    the particles move), U3 at each of those pushes; each in both layouts;
    Z on the Sell-C-σ
    structure's padded counts (24,576 tets)."""
    import numpy as np

    from pumipic_torch.mesh.locator import detect_box_kuhn
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops.scatter import histogram
    from pumipic_torch.particles import structure as st

    kuhn = detect_box_kuhn(mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy(),
                           device=dev)
    d = np.asarray(pps.PushSearchConfig().push_dir, np.float64)
    direction = (d / np.linalg.norm(d)).astype(np.float32)
    coords = mesh.coords.cpu().numpy()
    wrap = (coords.min(axis=0), coords.max(axis=0) - coords.min(axis=0))
    x, elem0 = seeded
    E = mesh.nelems
    for layout in ("scs", "cabm"):
        ps = auto_structure(dev, layout, E, x, elem0)
        for dist, what in ((AUTO_DIST, f"pps3d-{layout}-auto"),
                           (pps.PushSearchConfig().distance, f"pps3d-{layout}-auto-fallback")):
            check_reshuffle_count(results, ps, pushed_elem(kuhn, ps, direction, wrap, dist),
                                  f"{what}, one push of {dist}")
        if layout == "scs":
            counts = st._scs_pad_counts(histogram(ps.elem, ps.active, E), 0.15,
                                        "proportionally")
            check_scs_row_order(results, counts, ps.capacity, f"pps3d-scs-auto, {E} tets")
        for dist in (2 * AUTO_DIST, 4 * AUTO_DIST, AUTO_DIST):
            check_reshuffle_place(results, ps, pushed_elem(kuhn, ps, direction, wrap, dist),
                                  f"pps3d-{layout}-auto, one push of {dist}",
                                  order=dist != AUTO_DIST)
        del ps
        torch.cuda.empty_cache()


def check_app_slices(dev) -> None:
    """The PseudoXGCm app in each layout at a small size, 3 steps on the
    card and on the CPU: every structure array and field, fwd, bwd and
    iters equal bit for bit."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.generate import tokamak_mesh
    from pumipic_torch.models import pseudo_xgcm as px

    arrays = tokamak_mesh(16, 96)
    for structure in APP_ARMS:
        cfg = px.XGCmConfig(num_ptcls=20_000, mdl_face=max(int(arrays[2].max()) // 2, 2),
                            deg_per_push=15.0, max_search_iters=64, structure=structure)
        ag = px.PseudoXGCm(Mesh2D.from_arrays(*arrays, device=dev), cfg, device=dev)
        ac = px.PseudoXGCm(Mesh2D.from_arrays(*arrays, device="cpu"), cfg, device="cpu")
        for i in range(3):
            pg, fg, bg, ig = ag.step_fn(ag.ptcls)
            pc, fc, bc, ic = ac.step_fn(ac.ptcls)
            ag.ptcls, ac.ptcls = pg, pc
            for key in ("elem", "active", "num_ptcls", "overflowed", "elem_offsets",
                        "row_to_elem", "elem_to_row", "seg_cap"):
                a, c = getattr(pg, key), getattr(pc, key)
                if (a is None) != (c is None) or (a is not None and max_err(a.cpu(), c)):
                    raise AssertionError(f"app {structure} slice step {i}: {key} "
                                         f"differs GPU vs CPU")
            for key in pc.fields:
                if max_err(pg.fields[key].cpu().view(torch.int32),
                           pc.fields[key].view(torch.int32)):
                    raise AssertionError(f"app {structure} slice step {i}: field "
                                         f"{key} differs GPU vs CPU")
            for key, a, c in (("fwd", fg, fc), ("bwd", bg, bc), ("iters", ig, ic)):
                if max_err(a.cpu(), c):
                    raise AssertionError(f"app {structure} slice step {i}: {key} "
                                         f"differs GPU vs CPU")
        log(f"[c] app {structure} slice (E={ac.mesh.nelems}, 20k particles, 3 steps, "
            f"capacity {pc.capacity}, alive {int(pc.num_ptcls)}): card == CPU, bit for bit")


def permuted_tokamak(n_surfaces: int, base_points: int):
    """tokamak_mesh with a seeded element permutation: its classification
    is not band-ordered, so the FULL-mode step takes the rotation table."""
    import numpy as np

    from pumipic_torch.mesh.generate import tokamak_mesh

    coords, tris, cls = tokamak_mesh(n_surfaces, base_points)
    perm = np.random.default_rng(5).permutation(len(tris))
    return coords, tris[perm], cls[perm]


def check_slices(dev) -> None:
    """Each arm at a small size, 3 steps on the card and on the CPU (plain
    versions): states and fields must be equal bit for bit."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.generate import annulus_mesh, tokamak_mesh
    from pumipic_torch.models import pseudo_xgcm as px

    slices = {
        "cartesian": (tokamak_mesh(16, 96), {}),
        "band": (tokamak_mesh(24, 120), {"band_locator": "force"}),
        "annulus": (annulus_mesh(8, 48, 0.3, 1.0), {}),
        "pprad": (tokamak_mesh(16, 96),
                  {"gyro": px.GyroConfig(per_particle_radius=True)}),
        "rotgather (permuted elements)": (permuted_tokamak(16, 96), {}),
    }
    for name, (arrays, kw) in slices.items():
        mdl_face = max(int(arrays[2].max()) // 2, 2)
        cfg = px.XGCmConfig(num_ptcls=20_000, mdl_face=mdl_face,
                            deg_per_push=15.0, max_search_iters=64, **kw)
        sg, stg = px.make_dp_setup(Mesh2D.from_arrays(*arrays, device=dev), cfg, dev)
        sc_, stc = px.make_dp_setup(Mesh2D.from_arrays(*arrays, device="cpu"), cfg,
                                    "cpu")
        for i in range(3):
            sg, fg = stg(sg)
            sc_, fc = stc(sc_)
            for key in sg:
                if max_err(sg[key].cpu(), sc_[key]) != 0.0:
                    raise AssertionError(f"{name} slice step {i}: state {key} "
                                         f"differs GPU vs CPU")
            for key in ("fwd", "bwd", "iters", "all_found"):
                if max_err(fg[key].cpu(), fc[key]) != 0.0:
                    raise AssertionError(f"{name} slice step {i}: field {key} "
                                         f"differs GPU vs CPU")
        log(f"[c] {name} slice (E={stc.model.mesh.nelems}, 20k particles, 3 "
            f"steps, alive {int(sc_['active'].sum())}): card == CPU, bit for bit")


def pps3d_mesh(dev):
    """pseudoPushAndSearch's bench mesh: box_tet_mesh(n, n, n) with
    bench_torch's n for PPS3D_ELEMS (16: 24,576 tets)."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh

    n = max(int(round((PPS3D_ELEMS / 6) ** (1.0 / 3.0))), 2)
    return Mesh3D.from_arrays(*box_tet_mesh(n, n, n), device=dev)


def check_pps3d(results: dict, dev):
    """K and L3 at pseudoPushAndSearch's shapes: the walk arm's app (DPS, 10M
    particles, periodic wall) on the Kuhn box; K on one step's push + wrap
    + locate, L3 (peel + walk, and the plain walk) on the same targets, and
    the two arms' ids compared.  Returns the mesh, the cpe-16 grid (phase
    d's walk arm reuses it) and the seeded positions and tets (M's peel
    form starts from them)."""
    from pumipic_torch.mesh.locator import detect_box_kuhn
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    mesh = pps3d_mesh(dev)
    cfg = pps.PushSearchConfig(num_ptcls=NUM_PTCLS, structure="dps", wall="periodic",
                               max_search_iters=64, kuhn="off")
    t0 = time.perf_counter()
    app = pps.PseudoPushAndSearch(mesh, cfg, device=dev)
    torch.cuda.synchronize()
    grid = app.locator
    kuhn = detect_box_kuhn(mesh.coords.cpu().numpy(), mesh.elem2verts.cpu().numpy(),
                           device=dev)
    ps = app.ptcls
    n = ps.capacity
    seeded = (ps.get("x").clone(), ps.elem.clone())
    log(f"[c] pps3d: {mesh.nelems} tets, {n} particles, grid {grid.nx}x{grid.ny}x{grid.nz}"
        f" = {grid.cell_rows.shape[0]} cells, rows {grid.cell_rows.numel() * 4 / 1e6:.1f} MB;"
        f" app built in {time.perf_counter() - t0:.2f} s (setup {app.setup_s})")

    # K: push + wrap + analytic locate + mask, one step from the seeded state
    kargs = (kuhn, ps.get("x"), ps.active, app.step_vector, app.wrap)
    got_k = lo.kuhn_push_locate(*kargs)
    compare("kuhn_locate", f"push + wrap + locate ({n} particles, {mesh.nelems} tets)",
            got_k, lo.kuhn_push_locate_plain(*kargs), results)
    time_pair("kuhn_locate", "", lambda: lo.kuhn_push_locate(*kargs),
              lambda: lo.kuhn_push_locate_plain(*kargs), results)
    # ~30 f32 operations per particle (push, three fmods, floors, id)
    record_bound("kuhn_locate", "", results, nbytes(kargs[1], kargs[2], *got_k), 30.0 * n)
    # Q's DPS mode: the DPS arm's rebuild of K's ids
    check_rebuild_mask(results, f"dps mode, pps3d-dps step ({n} slots, {mesh.nelems} tets)",
                       "rebuild_mask_dps", (got_k[1], ps.active, mesh.nelems))

    # K's push-only form (the walk arm's push) on the same positions: equal
    # to its plain version and to K's pushed positions
    wargs = (ps.get("x"), app.step_vector, app.wrap)
    got_w = push_ops.push_and_wrap(*wargs)
    compare("push_wrap", f"push + wrap ({n} particles)", got_w,
            push_ops.push_and_wrap_plain(*wargs), results)
    if not torch.equal(got_w, got_k[0]):
        raise AssertionError("push_wrap's positions differ from kernel K's")
    time_pair("push_wrap", "", lambda: push_ops.push_and_wrap(*wargs),
              lambda: push_ops.push_and_wrap_plain(*wargs), results)
    # 12 bytes in and 12 out a particle; an add, an fmod, the sign fix and
    # an add per coordinate (~12 f32 operations a particle)
    record_bound("push_wrap", "", results, nbytes(wargs[0], got_w), 12.0 * n)
    del got_w, wargs

    # L3 on the same targets: peel + walk (the walk arm's step), plain walk
    dest = got_k[0]
    largs = (mesh.walk_geom, dest, ps.elem, ps.active, cfg.max_search_iters)
    from pumipic_torch.kernels import _build

    blocks = _build.lib().pp_walk_locate_3d_blocks_per_sm()
    results["locate3d"]["extra"]["resident_blocks_per_sm"] = blocks
    log(f"[c] locate3d: {blocks} resident blocks of 256 threads per SM")
    walk = check_locate3d(results, grid, largs, "")
    # the walk arm's ids against the Kuhn arm's: equal but where the
    # destination lies in both tets within the walk's BCC tolerance
    ek, ew = got_k[1], walk[0]
    bad = torch.nonzero(ek != ew).flatten()
    d = dest[bad]
    ties = torch.ones(bad.shape[0], dtype=torch.bool, device=dev)
    for e in (ek[bad], ew[bad]):
        rows_ = mesh.walk_geom[torch.clamp(e, min=0).long()]
        ties &= (e >= 0) & se.bary_inside_3d(rows_[:, :12].unbind(1), *d.unbind(1))[4]
    log(f"[c] pps3d walk arm vs Kuhn arm, one step: {int(bad.shape[0])} ids differ, "
        f"{int(ties.sum())} of them on a face both tets contain within the BCC "
        f"tolerance")
    if not bool(ties.all()):
        raise AssertionError("the walk arm's ids differ from the Kuhn arm's away "
                             "from shared faces")
    del kargs, got_k, walk
    # L3 where the cells and tets lose their locality: step 1's particles
    # in a random order
    perm = torch.randperm(n, device=dev, generator=torch.Generator(dev).manual_seed(3))
    check_locate3d(results, grid, (largs[0], *(a[perm].contiguous() for a in largs[1:4]),
                                   largs[4]), ", random order")
    del perm, largs, dest
    # and at the walk arm's step-20 targets, from their step-19 tets
    for _ in range(19):
        app.ptcls, _ = app.step_fn(app.ptcls)
    ps = app.ptcls
    check_locate3d(results, grid, (mesh.walk_geom,
                                   push_ops.push_and_wrap(ps.get("x"), app.step_vector,
                                                          app.wrap),
                                   ps.elem, ps.active, cfg.max_search_iters), ", step 20")
    del app, ps
    return mesh, grid, seeded


def locate3d_bytes(walk_geom, dest, elem_start, active, out, grid=None,
                   table=None) -> int:
    """The bytes L3's function needs on these inputs: the outputs ``out``
    written once, ``walk_geom``, the active mask and ``table`` (the grid's
    cell table) read once, and each active particle's destination.  The
    previous tet is read for every active particle in the plain walk, and
    behind the peel only for the active particles that it misses, whose
    walk retries from it."""
    from pumipic_torch.ops import search as se

    starts = active if grid is None else active & ~se._peel_3d(grid, *dest.unbind(1))[1]
    n_act = int(active.sum())
    return (nbytes(walk_geom, active, table, *out) + n_act * 3 * dest.element_size()
            + int(starts.sum()) * elem_start.element_size())


def check_locate3d(results: dict, grid, largs, where: str):
    """L3 peel + walk (over ``grid``) and plain walk on ``largs`` (walk_geom,
    dest, previous tets, active, max_iters): exact against the plain
    version, timed, with its bound counted for what the kernel reads (the
    (n_cells, 2) id pair) and, beside it, for the 26-column rows the first
    L3 read (:func:`locate3d_bytes`).  Returns the peel + walk's
    outputs."""
    from pumipic_torch.ops import search as se

    n = largs[1].shape[0]
    for what, g in (("peel+walk", grid), ("plain walk", None)):
        what = what + where
        got = se.walk_locate_3d(*largs, grid=g)
        compare("locate3d", f"{what} ({n} particles)", got,
                se.walk_locate_3d_plain(*largs, grid=g), results)
        log(f"[c] locate3d {what}: iters={int(got[2])} all_found={bool(got[3])} "
            f"deleted at the 64-iteration limit: {int(got[4])}, alive {int(got[1].sum())}")
        time_pair("locate3d", what, lambda: se.walk_locate_3d(*largs, grid=g),
                  lambda: se.walk_locate_3d_plain(*largs, grid=g), results, plain_reps=3)
        # the peel's two containment tests (~90 f32 operations per particle)
        table = None if g is None else g.candidate_ids(largs[0])
        record_bound("locate3d", what, results,
                     locate3d_bytes(*largs[:4], got[:2], g, table),
                     90.0 * n if g is not None else 0.0)
        if g is not None:
            rows_ms = locate3d_bytes(*largs[:4], got[:2], g, g.cell_rows) \
                / PEAK_BYTES_PER_S * 1e3
            log(f"[c] locate3d {what} bound with the 26-column rows in place of the "
                f"id pair: {rows_ms:.4f} ms")
            case_of("locate3d", what, results)["bound_ms_rows"] = rows_ms
            walk = got
    return walk


def check_pps3d_slices(dev) -> None:
    """pseudoPushAndSearch at a small size, the Kuhn and walk arms, on the
    card and on the CPU for 3 steps: structures and fields equal."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models import pseudo_push_and_search as pps

    raw = box_tet_mesh(6, 6, 6)
    for kuhn in ("auto", "off"):
        cfg = pps.PushSearchConfig(num_ptcls=50_000, structure="cabm", wall="periodic",
                                   kuhn=kuhn, max_search_iters=64)
        ag = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device=dev), cfg, device=dev)
        ac = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device="cpu"), cfg,
                                     device="cpu")
        for i in range(3):
            ag.ptcls, ig = ag.step_fn(ag.ptcls)
            ac.ptcls, ic = ac.step_fn(ac.ptcls)
            for key in ("elem", "active", "num_ptcls", "elem_offsets", "overflowed"):
                if max_err(getattr(ag.ptcls, key).cpu(), getattr(ac.ptcls, key)):
                    raise AssertionError(f"pps3d {kuhn} slice step {i}: {key} differs")
            for key in ("x", "pid"):
                if max_err(ag.ptcls.fields[key].cpu(), ac.ptcls.fields[key]):
                    raise AssertionError(f"pps3d {kuhn} slice step {i}: {key} differs")
            if int(ig) != int(ic):
                raise AssertionError(f"pps3d {kuhn} slice step {i}: iters differ")
        log(f"[c] pps3d kuhn={kuhn} slice (216 cells x 6 tets, 50k particles, 3 steps, "
            f"alive {int(ac.ptcls.num_ptcls)}): card == CPU, bit for bit")


def trace_fields(res) -> tuple:
    """A kernel M result's tensors in field order (None fields left out),
    for :func:`compare`."""
    out = []
    for v in res:
        if isinstance(v, tuple):
            out.extend(v)
        elif v is not None:
            out.append(v)
    return tuple(out)


def trace3d_bytes(mesh, method, handler, record, recover, grid, n_act, n) -> int:
    """The bytes M's function needs: each table it reads once (the walk
    table; the faces and coordinates the reflect handler and the exit
    record read; the vertices recovery reads; the peel's walk_geom and
    candidate pair), each active particle's destination (and origin where
    the core or the crossing point reads it) and start tet, every
    particle's mask, and the outputs written once."""
    from pumipic_torch.ops import search as se

    reflect = handler is se.reflect_on_exit_3d
    core = se.core_of(method)
    tables = [mesh.walk_planes if core == "intersection" else mesh.walk_geom]
    if reflect or record:
        tables.append(mesh.elem2faces)
    if reflect:
        tables += [mesh.face2verts, mesh.coords]
    if recover == "project":
        tables += [mesh.elem2verts, mesh.coords]
    if grid is not None:
        tables += [mesh.walk_geom, grid.candidate_ids(mesh.walk_geom)]
    uniq = {t.data_ptr(): t for t in tables}
    orig = core != "bcc" or reflect or record
    per_act = 12 + (12 if orig else 0) + 4
    per_out = 5 + (12 if reflect or recover == "project" else 0) + (20 if record else 0)
    return nbytes(*uniq.values()) + n_act * per_act + n * (1 + per_out)


def check_trace3d(results: dict, mesh, args, what: str, grid=None, plain_reps: int = 2):
    """M on ``args`` (trace_3d's positional arguments after the mesh):
    exact against its plain version, timed, with its bound.  Returns the
    kernel's result."""
    from pumipic_torch.ops import search as se

    got = se.trace_3d(mesh, *args, grid=grid)
    n = args[1].shape[0]
    compare("trace3d", f"{what} ({n} particles)", trace_fields(got),
            trace_fields(se.trace_3d_plain(mesh, *args, grid=grid)), results)
    extra = "" if got.num_hits is None else \
        f", walkers that hit the wall {int((got.num_hits > 0).sum())}"
    if got.num_recovered is not None:
        extra += f", recovered {int(got.num_recovered)}"
    log(f"[c] trace3d {what}: iters={int(got.iters)} all_found={bool(got.all_found)} "
        f"alive {int(got.active.sum())}{extra}")
    time_pair("trace3d", what, lambda: se.trace_3d(mesh, *args, grid=grid),
              lambda: se.trace_3d_plain(mesh, *args, grid=grid), results,
              plain_reps=plain_reps)
    method, handler, record, recover = args[5:9]
    record_bound("trace3d", what, results, trace3d_bytes(
        mesh, method, handler, record, recover, grid, int(args[3].sum()), n))
    return got


def check_trace3d_peel(results: dict, dev, mesh, grid, seeded) -> None:
    """M's peel form (BCC core, reflecting wall) on pseudoPushAndSearch's
    reflect arm: the 10M seeded particles' first pushed targets (no wrap)
    from their tets (``seeded``, as the app seeds them), over phase c's
    cpe-16 grid of the 16^3 box."""
    import numpy as np

    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    cfg = pps.PushSearchConfig(num_ptcls=NUM_PTCLS, wall="reflect", max_search_iters=64)
    x, e0 = seeded
    d = np.asarray(cfg.push_dir, np.float64)
    step = push_ops.step_vector((d / np.linalg.norm(d)).astype(np.float32), cfg.distance)
    xt = push_ops.push_and_wrap(x, step)
    act = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    args = (x, xt, e0, act, cfg.max_search_iters, "bcc", se.reflect_on_exit_3d, False, "off")
    check_trace3d(results, mesh, args, "peel + bcc reflect (pps3d-dps-reflect step 1)", grid)


def check_gitr(results: dict, dev):
    """R, M and W at the GITR-style app's full width: the 32^3 box, 10M
    particles as the gitr arm seeds them, its E grid.  Returns the mesh
    (phase d's gitr arms reuse it)."""
    import bench_torch
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models.gitr_like import GitrConfig, GitrLike
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    n_side = int(round((GITR_ELEMS / 6) ** (1.0 / 3.0)))
    t0 = time.perf_counter()
    mesh = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=dev)
    mesh_s = time.perf_counter() - t0
    grid, o, h = bench_torch.gitr_field(n_side)
    cfg = GitrConfig(num_ptcls=NUM_PTCLS, dt=bench_torch.GITR_DT, b_field=bench_torch.GITR_B,
                     wall="reflect", max_search_iters=100)
    t0 = time.perf_counter()
    app = GitrLike(mesh, cfg, grid, o, h, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[c] gitr: {mesh.nelems} tets, {mesh.nfaces} faces, {mesh.nverts} verts "
        f"(walk_planes {mesh.walk_planes.numel() * 4 / 1e6:.1f} MB, walk_geom "
        f"{mesh.walk_geom.numel() * 4 / 1e6:.1f} MB), E grid {tuple(grid.shape)}; mesh "
        f"{mesh_s:.2f} s, app (seeding {NUM_PTCLS}) {time.perf_counter() - t0:.2f} s")
    s = app.state
    n = s["x"].shape[0]

    # R: the step's field and push, as the app's step calls it (the corner
    # rows it built, the field's vectors on the host)
    rargs = (s["x"], s["v"], app.e_grid, *app.field_host, cfg.dt, cfg.charge, cfg.amu)
    got_r = push_ops.boris_push_grid(*rargs, corners=app.e_corners)
    compare("boris", f"grid E + Boris push ({n} particles, {tuple(grid.shape)} grid)",
            got_r, push_ops.boris_push_grid_plain(*rargs), results)
    time_pair("boris", "", lambda: push_ops.boris_push_grid(*rargs, corners=app.e_corners),
              lambda: push_ops.boris_push_grid_plain(*rargs), results)
    # 24 bytes in and 24 out a particle, the grid once; ~120 f32 operations
    record_bound("boris", "", results, nbytes(s["x"], s["v"], app.e_grid, *got_r),
                 120.0 * n)
    x_new = got_r[0]

    # M: the step's walk (intersection, reflect, record_exit) first, then
    # the other cores and handlers; each template's resident blocks per SM
    from pumipic_torch.kernels import _build

    results["trace3d"].setdefault("extra", {})["resident_blocks_per_sm"] = {
        f"{method} {'reflect' if r else 'remove'}{' record' if d else ''}":
            _build.lib().pp_trace_3d_blocks_per_sm(se.CORES[method], r, d)
        for method in ("intersection", "bcc", "hybrid") for r in (1, 0) for d in (1, 0)}
    res = {}
    for method in ("intersection", "bcc", "hybrid"):
        for hname, handler in (("reflect", se.reflect_on_exit_3d),
                               ("remove", se.remove_on_exit)):
            args = (s["x"], x_new, s["elem"], s["active"], cfg.max_search_iters,
                    method, handler, True, "off")
            res[method, hname] = check_trace3d(
                results, mesh, args, f"{method} {hname} record_exit (gitr step 1)")
    # far targets: random points of the box from the seeded tets
    g = torch.Generator(device=dev).manual_seed(5)
    far = torch.rand(n, 3, device=dev, generator=g)
    check_trace3d(results, mesh, (s["x"], far, s["elem"], s["active"], 200,
                                  "intersection", se.reflect_on_exit_3d, True, "off"),
                  "intersection reflect record_exit, far targets", plain_reps=1)
    del far
    # a budget of 2 leaves survivors to recover
    check_trace3d(results, mesh, (s["x"], x_new, s["elem"], s["active"], 2,
                                  "intersection", se.reflect_on_exit_3d, True, "project"),
                  "intersection reflect record_exit recover, budget 2")

    # F: the step's update after the walk, with the reflecting wall (the
    # specular velocity) and the absorbing one
    rr, ra = res["intersection", "reflect"], res["intersection", "remove"]
    for what, r, reflect in (("reflect (gitr step 1)", rr, True), ("absorb", ra, False)):
        fargs = (s["x"], s["v"], got_r[1], r.dest, r.hit, r.elem_ids, r.num_hits,
                 s["active"], reflect)
        got = push_ops.gitr_update(*fargs)
        compare_bits("gitr_update", f"{what} ({n} particles)", got,
                     push_ops.gitr_update_plain(*fargs), results)
        moved = int((got[1] != got_r[1]).any(1)[s["active"]].sum())
        # the rows this data needs: x where lost, v where inactive, the hit
        # count where kept and the hit point where it is positive (the
        # kernel reads no other), v' and dest everywhere
        n_lost, n_idle = int(got[3].sum()), int((~s["active"]).sum())
        n_kept = int(got[2].sum()) if reflect else 0
        n_hit = int((got[2] & (r.num_hits > 0)).sum()) if reflect else 0
        log(f"[c] gitr_update {what}: {moved} active particles took the specular "
            f"velocity, {n_lost} lost, {n_idle} inactive, {n_hit} with a hit")
        time_pair("gitr_update", what, lambda: push_ops.gitr_update(*fargs),
                  lambda: push_ops.gitr_update_plain(*fargs), results)
        # ~25 f32 operations a particle
        record_bound("gitr_update", what, results, nbytes(
            got_r[1], r.dest, r.elem_ids, s["active"], *got)
            + 12 * (n_lost + n_idle + n_hit) + 4 * n_kept, 25.0 * n)
        del got
    results["gitr_update"].setdefault("extra", {})["library"] = \
        "none: no one PyTorch call makes the update"

    # W: the reflect step's hit counts, the absorb step's lost particles
    F = mesh.nfaces
    lost = s["active"] & (ra.elem_ids < 0)
    for what, wargs in (("reflect: num_hits on the last face", (rr.exit_side, s["active"],
                                                                 rr.num_hits, F)),
                        ("absorb: lost particles on their exit face",
                         (ra.exit_side, lost, None, F))):
        got = sc.wall_tally(*wargs)
        compare("wall_tally", f"{what} ({n} particles, {F} faces)", got,
                sc.wall_tally_plain(*wargs), results)
        log(f"[c] wall_tally {what}: total {int(got.sum())}, faces hit "
            f"{int((got > 0).sum())}")
        time_pair("wall_tally", what, lambda: sc.wall_tally(*wargs),
                  lambda: sc.wall_tally_plain(*wargs), results)
        record_bound("wall_tally", what, results,
                     nbytes(*(t for t in wargs[:3] if t is not None), got))
        side, mask, w = wargs[:3]
        ok = mask & (side >= 0)
        if w is not None:
            ok &= w > 0
        keys = torch.where(ok, side.to(torch.int64), F)
        wf = torch.ones(n, device=dev) if w is None else w.float()
        record_library("wall_tally", what, "torch.bincount(keys, weights)",
                       lambda: torch.bincount(keys, weights=wf, minlength=F + 1), results)
        del keys, wf
    if int(sc.wall_tally(ra.exit_side, lost, None, F).sum()) != int(lost.sum()):
        raise AssertionError("gitr absorb: the wall tally does not count every lost particle")
    del res, rr, ra, lost, got_r, x_new, app, s
    return mesh


def check_gitr_slices(dev) -> None:
    """The GITR-style app (absorb and reflect) and pseudoPushAndSearch's
    reflecting wall at a small size, on the card and on the CPU for 3
    steps: states, wall tallies and structures equal bit for bit."""
    import bench_torch
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models import gitr_like as gl
    from pumipic_torch.models import pseudo_push_and_search as pps

    raw = box_tet_mesh(6, 6, 6)
    grid, o, h = bench_torch.gitr_field(6)
    for wall in ("absorb", "reflect"):
        cfg = gl.GitrConfig(num_ptcls=50_000, dt=bench_torch.GITR_DT,
                            b_field=bench_torch.GITR_B, wall=wall)
        apps = [gl.GitrLike(Mesh3D.from_arrays(*raw, device=d), cfg, grid, o, h, device=d)
                for d in (dev, "cpu")]
        for i in range(3):
            hist = [a.run(1) for a in apps]
            if hist[0] != hist[1]:
                raise AssertionError(f"gitr {wall} slice step {i}: alive differs")
            for key in ("x", "v", "elem", "active"):
                if max_err(apps[0].state[key].cpu(), apps[1].state[key]):
                    raise AssertionError(f"gitr {wall} slice step {i}: {key} differs")
            if max_err(apps[0].wall_hits.cpu(), apps[1].wall_hits):
                raise AssertionError(f"gitr {wall} slice step {i}: wall_hits differ")
        log(f"[c] gitr {wall} slice (216 cells x 6 tets, 50k particles, 3 steps, alive "
            f"{hist[1][0]}, wall hits {float(apps[1].wall_hits.sum())}): card == CPU, "
            f"bit for bit")
    cfg = pps.PushSearchConfig(num_ptcls=50_000, structure="cabm", wall="reflect",
                               kuhn="off", max_search_iters=64)
    ag = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device=dev), cfg, device=dev)
    ac = pps.PseudoPushAndSearch(Mesh3D.from_arrays(*raw, device="cpu"), cfg, device="cpu")
    for i in range(3):
        ag.ptcls, ig = ag.step_fn(ag.ptcls)
        ac.ptcls, ic = ac.step_fn(ac.ptcls)
        for key in ("elem", "active", "num_ptcls", "elem_offsets", "overflowed"):
            if max_err(getattr(ag.ptcls, key).cpu(), getattr(ac.ptcls, key)):
                raise AssertionError(f"pps3d reflect slice step {i}: {key} differs")
        for key in ("x", "pid"):
            if max_err(ag.ptcls.fields[key].cpu(), ac.ptcls.fields[key]):
                raise AssertionError(f"pps3d reflect slice step {i}: {key} differs")
        if int(ig) != int(ic):
            raise AssertionError(f"pps3d reflect slice step {i}: iters differ")
    log(f"[c] pps3d reflect slice (50k particles, 3 steps, alive "
        f"{int(ac.ptcls.num_ptcls)}): card == CPU, bit for bit")


# ---------------------------------------------------------------------------
# phase c: the distributed step's exchange (X1, X2, X3) and owner reduction
# (O) at the 4-rank 120k arm's per-rank size
# ---------------------------------------------------------------------------

X_RANKS = 4
X_SLOTS = 3_750_000      # one rank's slots: 10M / 4 ranks x cap factor 1.5
X_ACTIVE = 2 / 3         # 2.5M of them hold a particle
# leavers per active particle and step: phase e's arm 1 sends 587,255
# particles over its 6 steps of 10M (PERF.md §6)
X_LEAVER_SHARE = 587_255 / 6 / 10_000_000
X_SEED = 11


def compare_bits(kernel: str, what: str, got, want, results: dict,
                 nan_positions: bool = False) -> None:
    """compare() on the bits: f32 tensors as int32 (NaN payloads, -0.0 and
    subnormals count); with ``nan_positions`` a NaN is compared by position
    only (the card's adds return one NaN pattern, torch's max keeps the
    input's)."""
    def bits(t):
        if isinstance(t, dict):
            return tuple(bits(t[k]) for k in sorted(t))
        if isinstance(t, (tuple, list)):
            return tuple(bits(x) for x in t)
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        return t

    if nan_positions:
        def strip(a, b):
            if isinstance(a, (tuple, list)):
                return tuple(zip(*(strip(x, y) for x, y in zip(a, b))))
            if a.dtype == torch.float32:
                if not torch.equal(torch.isnan(a), torch.isnan(b)):
                    raise AssertionError(f"{kernel} {what}: NaN positions differ")
                return torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
            return a, b
        got, want = strip(got, want)
    compare(kernel, what, bits(got), bits(want), results)


def exchange_mesh():
    """The 120k mesh's host arrays and its RCB owners over the 4 ranks."""
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.parallel import picparts as ppm

    coords, tris, cls = read_msh(MESH)
    return coords, tris, cls, ppm.partition_rcb(coords, tris, X_RANKS)


def exchange_picpart(dev, mesh=None):
    """Rank 0's picpart of the 120k arm (RCB over 4 ranks, the 12-layer
    buffer of phase e); ``mesh``: :func:`exchange_mesh`'s arrays, if read."""
    from pumipic_torch.parallel import picparts as ppm

    coords, tris, cls, owners = exchange_mesh() if mesh is None else mesh
    pp = ppm.build_picparts(coords, tris, owners, X_RANKS,
                            ppm.PicPartsInput(buffer_layers=E_BUFFER), cls)
    return pp.local_view(0, dev)


def x2_step_case(dev, lpp, mesh=None, prev: bool = False):
    """Kernel X2's inputs at the picparts step's own leaver layout, rank 0
    of the 4-rank 120k arm at 10M particles, from ``X_SEED`` alone: rank
    0's particles seeded as ``make_picparts_setup`` seeds them (its
    elements' Gaussian counts, uniform points) in a prefix of the
    ``X_SLOTS`` slots in global element order, pushed once (15°, kernel P)
    and located on the picpart (kernel L's walk from the previous
    element); a particle whose new element lies outside the safe zone
    leaves for the element's owner (``set_unsafe_procs``), bucket owner -
    1.  Returns (state after the push, bucket keys, new elements), and with
    ``prev`` the elements and active mask before the walk too."""
    import numpy as np

    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as search_ops
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import picparts as ppm

    coords, tris, cls, owners = exchange_mesh() if mesh is None else mesh
    cfg = px.XGCmConfig(num_ptcls=NUM_PTCLS, mdl_face=max(int(cls.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64, gyro=px.GyroConfig())
    gmesh = Mesh2D.from_numpy(ppm.mesh_arrays(2, coords, tris, cls), "cpu")
    rng = np.random.default_rng(X_SEED)
    ppe = np.where(owners == 0, px.seed_particles_per_element(gmesh, cfg, rng), 0)
    g_elems = np.repeat(np.arange(gmesh.nelems), ppe)
    m, n = len(g_elems), X_SLOTS
    if m > n:
        raise AssertionError(f"rank 0 seeds {m} particles, more than its {n} slots")
    pos = torch.as_tensor(px.uniform_points_in_elements(gmesh, g_elems, rng),
                          dtype=torch.float32)
    phi, b = push_ops.elliptical_setup(pos[:, 0].contiguous(), pos[:, 1].contiguous(),
                                       cfg.h, cfg.k, cfg.d)
    eg = lpp.elem_gid.cpu().numpy()
    g2l = np.full(gmesh.nelems, -1, np.int64)
    g2l[eg[eg >= 0]] = np.nonzero(eg >= 0)[0]

    def slots(vals, fill, dtype):
        out = np.full(n, fill, dtype)
        out[:m] = vals
        return torch.as_tensor(out, device=dev)

    phi = phi.numpy()
    s = {"x0": slots(pos[:, 0].numpy(), 0, np.float32),
         "x1": slots(pos[:, 1].numpy(), 0, np.float32),
         "cphi": slots(np.cos(phi), 0, np.float32), "sphi": slots(np.sin(phi), 0, np.float32),
         "b": slots(b.numpy(), 0, np.float32), "pid": slots(np.arange(m), -1, np.int32),
         "elem": slots(g2l[g_elems], -1, np.int32), "active": slots(True, False, bool)}
    lmesh = lpp.mesh
    cls_local = lmesh.class_id.cpu().numpy()
    bands = push_ops.detect_banded_class(cls_local)
    if bands is not None:
        rot, push = push_ops.BandRotation.build(bands, cfg.deg_per_push, dev), \
            push_ops.push_banded
    else:
        rot, push = push_ops.RotTable.build(cls_local, cfg.deg_per_push, dev), \
            push_ops.push_table
    tx, ty, cphi, sphi = push(s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
                              s["active"], rot, cfg.h, cfg.k, cfg.d)
    new_elem, _, _, _ = search_ops.walk_locate(lmesh.walk_geom, tx, ty, s["elem"],
                                               s["active"], lmesh.nelems)
    active = s["active"] & (new_elem >= 0)
    dest = mig.set_unsafe_procs(lpp.elem_safe, lpp.elem_owner, new_elem, active, 0)
    D = X_RANKS - 1
    key = torch.where(active & (dest != 0), dest - 1, D).to(torch.int32)
    state = {"x0": tx, "x1": ty, "cphi": cphi, "sphi": sphi, "b": s["b"], "pid": s["pid"],
             "elem": new_elem, "active": active}
    if prev:
        return state, key, new_elem, s["elem"], s["active"]
    return state, key, new_elem


def leaver_layout(leaving) -> dict:
    """How the admitted leavers lie in the slots: their count, the share
    of warps (32 consecutive slots) holding one, and the mean length of a
    run of consecutive leavers."""
    n = leaving.shape[0]
    pad = torch.zeros((-n) % 32, dtype=torch.bool, device=leaving.device)
    warps = torch.cat([leaving, pad]).view(-1, 32).any(1)
    starts = leaving & ~torch.cat([leaving.new_zeros(1), leaving[:-1]])
    n_leave, n_runs = int(leaving.sum()), int(starts.sum())
    return {"leavers": n_leave, "warp_share": float(warps.float().mean()),
            "mean_run": n_leave / max(n_runs, 1)}


def x2_launcher(lib, ex, state, key, rank, counts, quota, rows, cap, new_elem, elem_gid,
                fill: bool = False):
    """A function launching kernel X2 on buffers allocated once (the
    wrapper's host work out of the timing; its -1 fill of the buffer in it
    with ``fill``, else out: every row of the cases timed holds an admitted
    leaver); returns (send, kept, leaving, overflow).  ``lib``: a library
    with the package's ``pp_pack_send``."""
    import numpy as np

    dev = key.device
    n, D = key.shape[0], len(rows)
    fs, width = ex.payload_layout(state)
    offsets = torch.as_tensor(np.cumsum([0] + list(rows[:-1])), device=dev)
    send = torch.empty((sum(rows), width), dtype=torch.int32, device=dev)
    kept, leaving = (torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2))
    over = torch.empty((), dtype=torch.bool, device=dev)
    m, srcs, _, lanes, is_bool, _ = ex._fields(state, fs)
    q = quota.to(torch.int32).contiguous()

    send.fill_(ex.INVALID)

    def run():
        if fill:
            send.fill_(ex.INVALID)
        err = lib.pp_pack_send(
            ex._ptr(key), ex._ptr(rank), n, D, ex._ptr(q), cap, ex._ptr(offsets),
            ex._ptr(new_elem), ex._ptr(elem_gid), m, srcs, lanes, is_bool, width,
            ex._ptr(send), ex._ptr(kept), ex._ptr(leaving), ex._ptr(counts), ex._ptr(over),
            ex._stream())
        if err:
            raise RuntimeError(f"pp_pack_send: cudaError {err}")
        return send, kept, leaving, over
    return run


def x2_bound_bytes(key, kept, leaving, send, D: int) -> int:
    """X2's bytes: the keys read, kept and leaving written; the ranks of
    the bucket keys alone read (the others decide nothing); each admitted
    leaver's element, gid and fields read and its row written (the row's
    width in words)."""
    L, width = send.shape
    n_bucket = int((key < D).sum())
    return (nbytes(key, kept, leaving) + 4 * n_bucket + L * (4 + 4 + 4 * (width - 1))
            + nbytes(send))


def odd_floats(n: int, gen, dev):
    """n f32 values: normal ones with NaNs (a signalling payload among
    them), infinities, -0.0 and subnormals mixed in."""
    x = torch.randn(n, generator=gen, device=dev)
    special = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), float("-inf"),
                            1e-40, -3e-39], device=dev)
    pick = torch.rand(n, generator=gen, device=dev) < 0.2
    x = torch.where(pick, special[torch.randint(0, 7, (n,), generator=gen, device=dev)], x)
    bits = x.view(torch.int32)
    snan = torch.rand(n, generator=gen, device=dev) < 0.02
    return torch.where(snan, torch.full_like(bits, 0x7FA00001), bits).view(torch.float32)


def exchange_state(n: int, gen, dev, E: int, odd: bool = False):
    """The 120k arm's particle state (x0 x1 cphi sphi b f32, pid i32, elem,
    active) of n slots, 2/3 of them active; ``odd``: the floats carry
    NaN, -0.0, infinities and subnormals."""
    f = (lambda: odd_floats(n, gen, dev)) if odd else \
        (lambda: torch.rand(n, generator=gen, device=dev))
    active = torch.rand(n, generator=gen, device=dev) < X_ACTIVE
    elem = torch.randint(0, E, (n,), generator=gen, device=dev, dtype=torch.int32)
    return {"x0": f(), "x1": f(), "cphi": f(), "sphi": f(), "b": f(),
            "pid": torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                                 dtype=torch.int32),
            "elem": torch.where(active, elem, -1), "active": active}


def exchange_keys(state, share: float, D: int, gen):
    """Bucket keys: each active particle leaves with probability ``share``
    for one of D destinations; D for the others."""
    dev = state["active"].device
    n = state["active"].shape[0]
    go = state["active"] & (torch.rand(n, generator=gen, device=dev) < share)
    b = torch.randint(0, D, (n,), generator=gen, device=dev, dtype=torch.int32)
    return torch.where(go, b, D).to(torch.int32)


def check_rank_in_key(results: dict, dev, gen, D: int) -> None:
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import exchange as ex

    n = X_SLOTS
    st = exchange_state(n, gen, dev, 10)
    cases = [
        ("buckets, 3.75M slots (main)", exchange_keys(st, X_LEAVER_SHARE, D, gen), D),
        ("free slots (2 keys)", st["active"].to(torch.int32), 1),
        ("balancer candidates, 33 keys (2S+1, S=16 at 8 ranks)",
         torch.randint(0, 34, (n,), generator=gen, device=dev, dtype=torch.int32), 33),
        ("buckets at 101 ranks, 101 keys (the wide mode)",
         torch.randint(0, 101, (n,), generator=gen, device=dev, dtype=torch.int32), 100),
        ("all one key", torch.zeros(n, dtype=torch.int32, device=dev), 3),
        ("no leaver", torch.full((n,), D, dtype=torch.int32, device=dev), D),
        ("every slot leaving",
         torch.randint(0, D, (n,), generator=gen, device=dev, dtype=torch.int32), D),
        ("N = 1", torch.zeros(1, dtype=torch.int32, device=dev), 1),
        ("N = 1023 (one ragged tile)",
         torch.randint(0, 3, (1023,), generator=gen, device=dev, dtype=torch.int32), 2),
    ]
    for what, key, K in cases:
        compare_bits("rank_in_key", what, ex.rank_in_key(key, K),
                     ex.rank_in_key_plain(key, K), results)
        compare_bits("rank_in_key", what + ", counts only",
                     ex.rank_in_key(key, K, ranks=False)[1],
                     ex.rank_in_key_plain(key, K, ranks=False)[1], results)
    for bad in (torch.tensor([0, D + 1], dtype=torch.int32, device=dev),
                torch.tensor([-1], dtype=torch.int32, device=dev)):
        try:
            ex.rank_in_key(bad, D)
        except ValueError as e:
            log(f"[c] rank_in_key refuses a key outside [0, {D}]: {e}")
        else:
            raise AssertionError("rank_in_key took a key outside its range")
    lib = _build.lib()
    max_k = ex.X1_MAX_KEYS - 1
    wide = torch.randint(0, max_k + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    what = f"K + 1 = X1_MAX_KEYS ({max_k + 1} keys: four warps a tile)"
    compare_bits("rank_in_key", what, ex.rank_in_key(wide, max_k),
                 ex.rank_in_key_plain(wide, max_k), results)
    for what, key, K in cases[:4]:
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        counts = torch.empty(K + 2, dtype=torch.int32, device=dev)
        scratch = [torch.empty(lib.pp_rank_in_key_scratch(n, K + 1, r), dtype=torch.int32,
                               device=dev) for r in (0, 1)]     # counts only, ranked

        def ranked(key=key, K=K, rank=rank, counts=counts, scratch=scratch[1]):
            return lib.pp_rank_in_key(ex._ptr(key), n, K + 1, ex._ptr(rank), ex._ptr(counts),
                                      ex._ptr(scratch), ex._stream())

        def counts_only(key=key, K=K, counts=counts, scratch=scratch[0]):
            return lib.pp_rank_in_key(ex._ptr(key), n, K + 1, None, ex._ptr(counts),
                                      ex._ptr(scratch), ex._stream())

        time_pair("rank_in_key", what, ranked, lambda: ex.rank_in_key_plain(key, K), results)
        record_launches("rank_in_key", what, ranked, results)
        # the keys read, the ranks and counts written
        record_bound("rank_in_key", what, results, nbytes(key, rank, counts))
        only = what + ", counts only"
        time_pair("rank_in_key", only, counts_only,
                  lambda: ex.rank_in_key_plain(key, K, ranks=False), results)
        record_launches("rank_in_key", only, counts_only, results)
        record_bound("rank_in_key", only, results, nbytes(key, counts))
        record_library("rank_in_key", only, "torch.bincount(key, minlength=K + 1)",
                       lambda: torch.bincount(key, minlength=K + 1), results, entry=False)
    results["rank_in_key"]["extra"]["library"] = (
        "none for the ranks (no one PyTorch call ranks within a key); the counts only: "
        "torch.bincount, in their cases")


def check_pack_send(results: dict, dev, gen, lpp, D: int, cap: int, mesh=None,
                    step=None) -> None:
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import exchange as ex

    E = int(lpp.elem_gid.shape[0])
    lib = _build.lib()
    cases = []
    t0 = time.perf_counter()
    step_state, step_key, step_elem = (x2_step_case(dev, lpp, mesh) if step is None
                                       else step[:3])
    log(f"[c] pack_send: the step's layout built in {time.perf_counter() - t0:.2f} s")
    cases.append(("the picparts step's leaver layout (main)", step_state, step_key, cap,
                  step_elem))
    st = exchange_state(X_SLOTS, gen, dev, E)
    cases.append(("leavers of the 120k arm's step at random", st,
                  exchange_keys(st, X_LEAVER_SHARE, D, gen), cap, None))
    odd = exchange_state(X_SLOTS, gen, dev, E, odd=True)
    cases.append(("NaN, -0.0, subnormal payloads", odd,
                  exchange_keys(odd, X_LEAVER_SHARE, D, gen), cap, None))
    cases.append(("no leaver", st, torch.full((X_SLOTS,), D, dtype=torch.int32, device=dev),
                  cap, None))
    cases.append(("every slot leaving", st, torch.randint(
        0, D, (X_SLOTS,), generator=gen, device=dev, dtype=torch.int32), X_SLOTS, None))
    cases.append(("a bucket over cap", st, exchange_keys(st, 0.5, D, gen), cap, None))
    for what, s, key, c, ne in cases:
        rank, counts = ex.rank_in_key(key, D)
        quota = torch.clamp(counts[:D], max=c)
        rows = quota.tolist()
        new_elem = torch.where(s["active"], s["elem"], -1) if ne is None else ne
        args = (s, key, rank, counts, quota, rows, c, new_elem, lpp.elem_gid)
        got, want = ex.pack_send(*args), ex.pack_send_plain(*args)
        compare_bits("pack_send", what, got[:4], want[:4], results)
        if ne is not None or what.endswith("at random"):
            run = x2_launcher(lib, ex, *args)
            compare_bits("pack_send", what + ", launched alone", run(), want[:4], results)
            time_pair("pack_send", what, run, lambda: ex.pack_send_plain(*args), results)
            record_launches("pack_send", what, run, results)
            record_bound("pack_send", what, results,
                         x2_bound_bytes(key, want[1], want[2], want[0], D))
            lay = leaver_layout(want[2])
            case_of("pack_send", what, results).update(layout=lay)
            log(f"[c] pack_send {what}: {lay['leavers']} admitted leavers of {X_SLOTS} "
                f"slots, {want[0].shape[1]} lanes a row; warps holding a leaver "
                f"{lay['warp_share']:.4f}, mean run {lay['mean_run']:.2f} slots")
    results["pack_send"]["extra"]["library"] = "none: no one PyTorch call packs the rows"


def check_place_arrivals(results: dict, dev, gen, lpp, D: int, cap: int) -> None:
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import exchange as ex

    E = int(lpp.elem_gid.shape[0])
    lib = _build.lib()
    gs, gp = lpp.elem_gid_sorted, lpp.elem_gid_perm

    def arrivals(s, share):
        key = exchange_keys(s, share, D, gen)
        rank, counts = ex.rank_in_key(key, D)
        quota = torch.clamp(counts[:D], max=cap)
        new_elem = torch.where(s["active"], s["elem"], -1)
        send, _, leaving, _, fs = ex.pack_send(s, key, rank, counts, quota, quota.tolist(),
                                               cap, new_elem, lpp.elem_gid)
        return send, leaving, new_elem, fs

    st = exchange_state(X_SLOTS, gen, dev, E)
    recv, leaving, new_elem, fs = arrivals(st, X_LEAVER_SHARE)
    staying = st["active"] & ~leaving
    odd = exchange_state(X_SLOTS, gen, dev, E, odd=True)
    orecv, oleaving, onew, _ = arrivals(odd, X_LEAVER_SHARE)
    n_free = int((~staying).sum())
    over = recv[torch.randint(0, recv.shape[0], (n_free + n_free // 3,), generator=gen,
                              device=dev)]
    unres = recv.clone()
    unres[:, 0] = 10**9 + torch.arange(recv.shape[0], dtype=torch.int32, device=dev)
    mixed = recv.clone()
    pick = torch.rand(recv.shape[0], generator=gen, device=dev)
    mixed[:, 0] = torch.where(pick < 0.02, -1, torch.where(pick < 0.04, 10**9, recv[:, 0]))
    # the arm's own layout: the particles in a prefix of the slots (the
    # arrivals fill the leavers' holes first, in ascending slot order), so
    # the free slots are those holes and the tail
    tail = exchange_state(X_SLOTS, gen, dev, E)
    tail["active"] = torch.arange(X_SLOTS, device=dev) < int(X_ACTIVE * X_SLOTS)
    tail["elem"] = torch.where(tail["active"], tail["elem"].clamp(min=0), -1)
    trecv, tleaving, tnew, _ = arrivals(tail, X_LEAVER_SHARE)
    cases = [("the 120k arm's arrivals (main)", st, staying, new_elem, recv),
             ("the arm's layout: particles in a slot prefix", tail,
              tail["active"] & ~tleaving, tnew, trecv),
             ("NaN, -0.0, subnormal payloads", odd, odd["active"] & ~oleaving, onew, orecv),
             ("arrivals beyond the free slots", st, staying, new_elem, over),
             ("absent and unresolved gids among them", st, staying, new_elem, mixed),
             ("all unresolved", st, staying, new_elem, unres),
             ("no arrival", st, staying, new_elem, recv[:0]),
             ("every slot free", st, torch.zeros_like(staying), new_elem, recv)]
    for what, s, stay, ne, rv in cases:
        args = (s, stay, ne, rv, fs, gs, gp)
        before = {f: s[f].clone() for f in fs}
        got, want = ex.place_arrivals(*args), ex.place_arrivals_plain(*args)
        compare_bits("place_arrivals", what, got, want, results)
        for f in fs:        # in place: the state's own tensors, stayers untouched
            keep = stay.reshape((-1,) + (1,) * (s[f].dim() - 1))
            if got[0][f].data_ptr() != s[f].data_ptr() or not torch.equal(
                    torch.where(keep, s[f], before[f]).view(torch.int8),
                    before[f].view(torch.int8)):
                raise AssertionError(f"place_arrivals {what}: field {f} not written in "
                                     f"place at the free slots alone")
        del before
        log(f"[c] place_arrivals {what}: {rv.shape[0]} rows, num_recv {int(got[1])}, "
            f"unresolved {int(got[2])}, recv overflow {bool(got[3])}")
        if what.endswith("(main)") or what.startswith("the arm's layout"):
            m, width = rv.shape
            elem = torch.empty(X_SLOTS, dtype=torch.int32, device=dev)
            active = torch.empty(X_SLOTS, dtype=torch.bool, device=dev)
            stats = torch.empty(2, dtype=torch.int32, device=dev)
            ovf = torch.empty((), dtype=torch.bool, device=dev)
            scratch = torch.empty(lib.pp_place_arrivals_scratch(X_SLOTS, m),
                                  dtype=torch.int32, device=dev)
            # in place, as the wrapper: the state's own fields (the free
            # slots rewritten each run, the same bits)
            k, _, dsts, lanes, is_bool, offs = ex._fields(s, fs, s)
            time_pair("place_arrivals", what, lambda: lib.pp_place_arrivals(
                ex._ptr(stay), ex._ptr(ne), X_SLOTS, ex._ptr(rv), m, width, ex._ptr(gs),
                ex._ptr(gp), gs.shape[0], k, dsts, lanes, is_bool, offs, ex._ptr(scratch),
                ex._ptr(stats), ex._ptr(ovf), ex._ptr(elem), ex._ptr(active),
                ex._stream()), lambda: ex.place_arrivals_plain(*args), results,
                record=what.endswith("(main)"))
            n_stay, n_free = int(stay.sum()), X_SLOTS - int(stay.sum())
            slot_bytes = sum(nbytes(s[f]) for f in fs) // X_SLOTS
            # the function in place: the mask read, the stayers' new
            # elements, every slot's elem and active written, the free
            # slots' fields written, the arrival rows and the gid table read
            record_bound("place_arrivals", what, results,
                         nbytes(stay, rv, gs, gp, elem, active) + 4 * n_stay
                         + n_free * slot_bytes)
            # out of place, as the first X3: every slot's fields read (the
            # stayers') or written
            out_ms = (nbytes(stay, ne, rv, gs, gp, elem, active) + n_stay * slot_bytes
                      + X_SLOTS * slot_bytes) / PEAK_BYTES_PER_S * 1e3
            slots = torch.nonzero(~stay).flatten()[:m]
            buf = torch.zeros((X_SLOTS, width), dtype=torch.int32, device=dev)
            copy_ms = device_ms(lambda: buf.index_copy_(0, slots, rv[:slots.shape[0]]), 20)
            log(f"[c] place_arrivals {what}: {n_free} free slots, {slot_bytes} field bytes "
                f"a slot; the out-of-place bound {out_ms:.4f} ms; index_copy_ of the "
                f"arrival rows alone {copy_ms:.4f} ms (a part of the function, no "
                f"yardstick)")
            case_of("place_arrivals", what, results).update(
                out_of_place_bound_ms=out_ms, index_copy_ms=copy_ms)
            del buf
    results["place_arrivals"]["extra"]["library"] = (
        "none: no one PyTorch call places the arrivals (index_copy_ of the arrival rows "
        "is a part of it, timed as a note)")


def check_owner_reduce(results: dict, dev, gen, lpp) -> None:
    from pumipic_torch.kernels import _build
    from pumipic_torch.ops import exchange as ex

    send_ids, recv_ids = lpp.vert_send_ids, lpp.vert_recv_ids
    V = int(lpp.vert_gid.shape[0])
    R, K = send_ids.shape
    lib = _build.lib()

    def halves(shape, nan=False, negzero=False):
        v = torch.randint(-40, 40, shape, generator=gen, device=dev).to(torch.float32) / 2
        if negzero:
            v = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.1, -0.0, v)
        if nan:
            v = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.03,
                            float("nan"), v)
        return v

    def ints(shape):
        return torch.randint(-1000, 1000, shape, generator=gen, device=dev, dtype=torch.int32)

    cases = [("sum, the field of the 120k arm (main)", "sum", halves((V,), negzero=True),
              halves((R, K), negzero=True)),
             ("sum with NaN", "sum", halves((V,), nan=True), halves((R, K), nan=True)),
             ("max with NaN", "max", halves((V,), nan=True), halves((R, K), nan=True)),
             ("min", "min", halves((V,)), halves((R, K))),
             ("sum i32", "sum", ints((V,)), ints((R, K))),
             ("max i32", "max", ints((V,)), ints((R, K))),
             ("sum (V, 3)", "sum", halves((V, 3), negzero=True), halves((R, K, 3),
                                                                         negzero=True))]
    for what, op, f, rv in cases:
        nan = "NaN" in what
        fill = ex.neutral(op, f.dtype)
        compare_bits("owner_reduce", "gather, " + what, ex.owner_gather(f, send_ids, fill),
                     ex.owner_gather_plain(f, send_ids, fill), results, nan)
        compare_bits("owner_reduce", "fan-in, " + what, ex.owner_fan_in(f, rv, recv_ids, op),
                     ex.owner_fan_in_plain(f, rv, recv_ids, op), results, nan)
        before = f.clone()
        compare_bits("owner_reduce", "fan-out, " + what, ex.owner_fan_out(f, rv, send_ids),
                     ex.owner_fan_out_plain(f, rv, send_ids), results, nan)
        mine = f.clone()
        got = ex.owner_fan_out_(mine, rv, send_ids)
        if got.data_ptr() != mine.data_ptr():
            raise AssertionError(f"owner_reduce {what}: the fan-out did not write in place")
        compare_bits("owner_reduce", "fan-out in place, " + what, mine,
                     ex.owner_fan_out_plain(f, rv, send_ids), results, nan)
        compare_bits("owner_reduce", "fan-out's input untouched, " + what, f, before,
                     results, nan)
    _, _, f, rv = cases[0]
    offsets, rows = ex._cached_map(recv_ids, V, ex.fan_in_csr)
    out, back = torch.empty_like(f), torch.zeros_like(rv)
    what = cases[0][0]
    time_pair("owner_reduce", "fan-in, " + what, lambda: lib.pp_owner_fan_in(
        ex._ptr(f), ex._ptr(rv), 1, V, ex._ptr(offsets), ex._ptr(rows), 0, 0, 0,
        ex._ptr(out), ex._ptr(back), ex._stream()),
        lambda: ex.owner_fan_in_plain(f, rv, recv_ids, "sum"), results)
    # the received rows, the field and the CSR read; the field and the
    # rows sent back written
    record_bound("owner_reduce", "fan-in, " + what, results,
                 nbytes(rv, f, offsets, rows, out, back))
    keys = torch.where(recv_ids >= 0, recv_ids, V).reshape(-1).long()
    contrib = torch.zeros(V + 1, device=dev)
    record_library("owner_reduce", "fan-in, " + what, "index_add_ of the R·K rows",
                   lambda: contrib.index_add_(0, keys, rv.reshape(-1)), results)
    gathered = torch.empty((R, K), device=dev)
    time_pair("owner_reduce", "gather (off the picparts step), " + what,
              lambda: lib.pp_owner_gather(ex._ptr(f), 1, ex._ptr(send_ids), R * K, 0,
                                          ex._ptr(gathered), ex._stream()),
              lambda: ex.owner_gather_plain(f, send_ids, 0.0), results)
    n_sent = int((send_ids >= 0).sum())
    record_bound("owner_reduce", "gather (off the picparts step), " + what, results,
                 nbytes(send_ids, gathered) + n_sent * 4)
    # in place over the R·K rows, as the step runs it (each run writes the
    # same rows over the same copies)
    fout = f.clone()
    time_pair("owner_reduce", "fan-out in place, " + what, lambda: lib.pp_owner_fan_out(
        ex._ptr(rv), 1, ex._ptr(send_ids), R * K, ex._ptr(fout), ex._stream()),
        lambda: ex.owner_fan_out_plain(f, rv, send_ids), results)
    # the rows' ids read, the named rows read and their copies written
    record_bound("owner_reduce", "fan-out in place, " + what, results,
                 nbytes(send_ids) + 2 * 4 * n_sent)
    log(f"[c] owner_reduce: V {V}, (R, K) = ({R}, {K}), {int((recv_ids >= 0).sum())} "
        f"received and {n_sent} sent rows")
    check_deposit_send_rows(results, dev, gen, lpp)


def check_deposit_send_rows(results: dict, dev, gen, lpp) -> None:
    """Kernel D's pass 2 with the owner SUM's send rows (the picparts
    step's) against D alone followed by O's gather, on rank 0's picpart and
    its gyro map: the field and the rows bit for bit; D's time with and
    without the rows."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import exchange as ex
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.parallel import reduce as red

    lmesh = lpp.mesh
    gyro = px.GyroConfig()
    R, P, V = gyro.num_rings, gyro.points_per_ring, lmesh.nverts
    gmap = sc.GyroMap.from_flat(px.build_gyro_mapping(lmesh, gyro), V, R, P, dev)
    ring = torch.randint(0, 50, (V, R), generator=gen, device=dev).to(torch.float32)
    row_of, send = red.sum_send_rows(lpp.vert_send_ids, V)
    got = sc.scatter_to_mapped_verts(ring, gmap, V, R, P, (row_of, send))
    alone = sc.scatter_to_mapped_verts(ring, gmap, V, R, P)
    what = f"with the send rows (rank 0's picpart, V={V}, R={R}, P={P})"
    compare_bits("deposit", what + ": the field", got, alone, results)
    compare_bits("deposit", what + ": the rows against O's gather", send,
                 ex.owner_gather(alone, lpp.vert_send_ids, 0.0), results)
    plain_send = torch.zeros_like(send)
    want = sc.mapped_plain(ring, gmap, V, R, P)
    sc.write_send_rows(want, (row_of, plain_send))
    compare_bits("deposit", what + ": against the plain version", (got, send),
                 (want, plain_send), results)
    time_pair("deposit", "pass 2 " + what,
              lambda: sc.scatter_to_mapped_verts(ring, gmap, V, R, P, (row_of, send)),
              lambda: sc.mapped_plain(ring, gmap, V, R, P), results, reps=50)
    time_pair("deposit", f"pass 2 alone (rank 0's picpart, V={V}, R={R}, P={P})",
              lambda: sc.scatter_to_mapped_verts(ring, gmap, V, R, P),
              lambda: sc.mapped_plain(ring, gmap, V, R, P), results, reps=50)
    n_rows = int((row_of >= 0).sum())
    record_bound("deposit", "pass 2 " + what, results,
                 nbytes(ring, gmap.offsets, gmap.src, got, row_of) + 4 * n_rows)
    log(f"[c] deposit {what}: {n_rows} send rows written by D")


Y_KERNELS = ("route_packed", "route_g2l", "route_banded", "balance_keys", "balance_select")


def present(t) -> tuple:
    """A kernel's outputs without the absent (None) ones."""
    return tuple(x for x in t if x is not None)


def route_case(results: dict, kernel: str, what: str, fn, plain, bytes_moved: int,
               nodes: dict):
    """One case of Y1-Y3 at rank 0's size: the kernel against its plain
    version bit for bit, both timed, the captured call's launches and the
    bound; returns the plain outputs."""
    want = plain()
    compare_bits(kernel, what, present(fn()), present(want), results)
    time_pair(kernel, what, fn, plain, results)
    record_launches(kernel, what, fn, results, nodes)
    record_bound(kernel, what, results, bytes_moved)
    return want


def annulus_route_case(dev, n: int, gen):
    """Rank 0 of the 4-rank annulus arm (bench_torch's 23,976-triangle
    annulus, sector bands, the 12-layer buffer, the balancer): its banded
    route's constants, and ``n`` slots whose first ``X_ACTIVE`` share hold
    particles on the picpart's elements (uniform), the rest inactive with
    no element, as the analytic locate leaves them."""
    from pumipic_torch.mesh.generate import annulus_mesh
    from pumipic_torch.mesh.locator import detect_annulus_structured
    from pumipic_torch.parallel import balancer as lbm
    from pumipic_torch.parallel import banded_route as brm
    from pumipic_torch.parallel import picparts as ppm

    n_rings = max(int((ANNULUS_ELEMS / 8) ** 0.5), 2)
    Ns = ANNULUS_ELEMS // (2 * n_rings)
    coords, tris, cls = annulus_mesh(n_rings, Ns, 0.3, 1.0)
    owners = brm.sector_band_owners(n_rings, Ns, X_RANKS)
    pp = ppm.build_picparts(coords, tris, owners, X_RANKS,
                            ppm.PicPartsInput(buffer_layers=E_BUFFER), cls)
    ann = detect_annulus_structured(coords, tris, cls=cls, device="cpu")
    br = brm.derive_banded_route(pp, owners, ann, lbm.build_balancer(pp, X_RANKS), X_RANKS)
    if br is None:
        raise AssertionError("the annulus arm's partition is not banded")
    eg = torch.as_tensor(pp.elem_gid[0], device=dev)
    eg = eg[eg >= 0]
    m = int(n * X_ACTIVE)
    e_gl = torch.full((n,), -1, dtype=torch.int32, device=dev)
    e_gl[:m] = eg[torch.randint(0, eg.shape[0], (m,), generator=gen, device=dev)]
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[:m] = True
    return br, e_gl, active


def check_route(results: dict, dev, mesh, lpp, step) -> None:
    """Kernels Y1 (each form), Y2 and Y3 against their plain versions at
    rank 0's size of the 4-rank arms (``X_SLOTS`` slots), bit for bit, then
    timed on the device, each call's launches counted from a captured
    graph.  Y1's packed form on the 120k arm's step layout
    (:func:`x2_step_case`: the walk's elements, rank 0's packed route with
    the balancer's sbars); its g2l form on the same particles through rank
    0's [g2l | route] row of the global mesh; its banded form on the
    annulus arm's rank 0 (:func:`annulus_route_case`); Y2 on the packed
    form's outputs, with and without the non-core flag; Y3 on Y2's keys
    and X1's ranks, the flows planned as if the other ranks held 0.6 of
    rank 0's movable weight."""
    import numpy as np

    from pumipic_torch.ops import exchange as ex
    from pumipic_torch.ops import route as rt
    from pumipic_torch.parallel import balancer as lbm
    from pumipic_torch.parallel import migrate as mig
    from pumipic_torch.parallel import picparts as ppm

    t0 = time.perf_counter()
    coords, tris, cls, owners = mesh
    pp = ppm.build_picparts(coords, tris, owners, X_RANKS,
                            ppm.PicPartsInput(buffer_layers=E_BUFFER), cls)
    bt = lbm.build_balancer(pp, X_RANKS)
    R, S, me = X_RANKS, bt.num_sbars, 0
    E = lpp.mesh.nelems
    sbar_local = torch.as_tensor(bt.sbar_of_elem[me][:E], device=dev)
    route = mig.pack_route(lpp.elem_safe, lpp.elem_owner, sbar_local, R)
    new_elem, active = step[2], step[4]
    n = new_elem.shape[0]
    log(f"[c] route: rank 0's balancer tables ({S} sbars, "
        f"{bt.my_edge_idx.shape[1]} edges of rank 0) in {time.perf_counter() - t0:.2f} s")
    per_step = "1 a step on each rank of the picparts arms that take this form"
    one = {"kernel": 1}

    # Y1, packed: the 120k walk arms (and the one-rank arm)
    what = "packed form, the 120k arm's step layout (main)"
    got = route_case(results, "route_packed", what,
                     lambda: rt.route_packed(route, new_elem, active, me, R),
                     lambda: rt.route_packed_plain(route, new_elem, active, me, R),
                     nbytes(new_elem, active, route) + n * (4 + 4 + 1 + 1), one)
    dest, sbar, noncore, live = got[:4]
    log(f"[c] route_packed: {int(live.sum())} live of {n} slots, "
        f"{int((live & (dest != me)).sum())} leaving, {int(noncore.sum())} non-core")

    # Y1, g2l: the same particles through rank 0's row of the global mesh
    eg = lpp.elem_gid.long()
    E_g = int(eg.max()) + 1
    tbl = torch.zeros((E_g, 2), dtype=torch.int32, device=dev)
    held = eg >= 0
    tbl[:, 0] = -1
    tbl[eg[held], 0] = torch.nonzero(held)[:, 0].to(torch.int32)
    tbl[eg[held], 1] = route[held].to(torch.int32)
    e_gl = torch.where(new_elem >= 0, lpp.elem_gid[torch.clamp(new_elem, min=0).long()],
                       -1).to(torch.int32)
    what = "g2l form, the 120k arm's particles by global element"
    got = route_case(results, "route_g2l", what,
                     lambda: rt.route_g2l(tbl, e_gl, active, me, R),
                     lambda: rt.route_g2l_plain(tbl, e_gl, active, me, R),
                     nbytes(e_gl, active, tbl) + n * (4 + 4 + 1 + 1 + 4 + 4), one)
    if not (torch.equal(got.dest, dest) and torch.equal(got.sbar, sbar)
            and torch.equal(got.live, live)):
        raise AssertionError("route_g2l: the g2l row routes otherwise than the packed route")

    # Y1, banded: the annulus arm's rank 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(X_SEED)
    br, b_gl, b_act = annulus_route_case(dev, n, gen)
    bp = br.params(me)
    what = f"banded form, the annulus arm's rank 0 ({len(bp.sbar_runs)} sbar runs)"
    route_case(results, "route_banded", what,
               lambda: rt.route_banded(bp, b_gl, b_act),
               lambda: rt.route_banded_plain(bp, b_gl, b_act),
               nbytes(b_gl, b_act) + n * (4 + 4 + 1 + 1 + 4 + 4), one)
    del b_gl, b_act

    # Y2 on the packed form's outputs
    y2_bytes = nbytes(dest, sbar, live, noncore) + 3 * 4 * n + 4
    keys = route_case(results, "balance_keys", "with the non-core flag (main)",
                      lambda: rt.balance_keys(dest, sbar, live, noncore, me, S, R),
                      lambda: rt.balance_keys_plain(dest, sbar, live, noncore, me, S, R),
                      y2_bytes, {"memset": 1, "kernel": 1})
    keys_nc = route_case(results, "balance_keys", "without the non-core flag",
                         lambda: rt.balance_keys(dest, sbar, live, None, me, S, R),
                         lambda: rt.balance_keys_plain(dest, sbar, live, None, me, S, R),
                         y2_bytes - nbytes(noncore), {"memset": 1, "kernel": 1})

    # Y3 on Y2's keys, X1's ranks and a plan
    w_local = ex.key_counts(keys.weights, S).to(torch.float32).cpu()
    w_sr = torch.stack([w_local] + [torch.floor(w_local * 0.6)] * (R - 1))
    w_fixed = torch.zeros(R, dtype=torch.float32)
    flows = lbm.plan_flows(bt, w_sr, w_fixed)
    tabs = lbm._edge_intervals(bt, flows, me, dev)
    for what, k, nc_form in (("with the non-core flag (main)", keys, True),
                             ("without the non-core flag", keys_nc, False)):
        rank, counts = ex.rank_in_key(k.candidates, 2 * S if nc_form else S)
        args = (k.candidates, rank, counts, dest, *tabs, S, nc_form)
        n_cand = int((k.candidates < (2 * S if nc_form else S)).sum())
        out = route_case(results, "balance_select", what,
                         lambda: (rt.balance_select(*args),),
                         lambda: (rt.balance_select_plain(*args),),
                         nbytes(k.candidates, dest, *tabs) + 4 * n_cand + 4 * n, one)[0]
        moved = int((out != dest).sum())
        log(f"[c] balance_select {what}: {n_cand} candidates, {moved} relabelled "
            f"(flows {flows.tolist()})")
        if moved == 0:
            raise AssertionError("balance_select: the plan moved no particle")
    for name in Y_KERNELS:
        results[name]["extra"].update(
            library="none: no one PyTorch call computes the function",
            per_step=per_step if name.startswith("route") else
            "1 a step on each rank of every balancer arm (4 ranks)")
    log(f"[c] route kernels checked in {time.perf_counter() - t0:.2f} s")


def former_step_counts(leaving, kept, wants, bucket, active_mid, s2_active, prev_active,
                       new_elem, lost, g):
    """The picparts step's counts as torch ops (the code kernel N replaced,
    rank 0 of a 4-rank walk arm): migrate's free slots, illegal, sent and
    kept home, the step's alive and exits, and step_stats' reduction over
    the ranks; returns the migrate part's and the rest's outputs."""
    n_free = active_mid.shape[0] - active_mid.sum(dtype=torch.int32)
    illegal = wants & (bucket < 0)
    mig = (n_free, leaving.sum(dtype=torch.int32), illegal.sum(dtype=torch.int32),
           kept.sum(dtype=torch.int32))
    return mig, former_end_counts(s2_active, prev_active, new_elem, lost, g)


def former_end_counts(s2_active, prev_active, new_elem, lost, g):
    """The step's end-of-step counts and step_stats' reduction as torch ops
    (the one-rank arm's part of :func:`former_step_counts`)."""
    nloc = s2_active.sum(dtype=torch.int32)
    exits = (prev_active & (new_elem < 0)).sum(dtype=torch.int32) - lost
    stats = [g[:, i].sum(dtype=torch.int32) for i in range(g.shape[1])]
    stats[3] = g[:, 3].max()
    n = g[:, 0].to(torch.float32)
    mx, total = n.max(), n.sum()
    avg = total / total.new_full((), float(g.shape[0]))
    return nloc, exits, stats, torch.where(avg > 0, mx / avg, total.new_full((), 1.0))


def check_slot_counts(results: dict, dev, lpp, step, D: int, cap: int) -> None:
    """Kernel N at the picparts step's own inputs (rank 0 of the 4-rank 120k
    arm after one push and the local walk, :func:`x2_step_case`; X1 and X2
    on its leavers): migrate's free-slot count, its sent, kept-home and
    illegal counts, the step's alive and exits less the lost, and
    step_stats' reduction of 4 ranks' counts, each against its plain
    version, timed beside the torch sums it replaced, with one launch a
    call; then the kernels a step's counts launch, from captured CUDA
    graphs: the former torch code's against N's, on a rank of a 4-rank arm
    and on the one-rank arm."""
    from pumipic_torch.ops import counts as cn
    from pumipic_torch.ops import exchange as ex

    state, key, new_elem, _, prev_active = step
    results["slot_counts"].setdefault("extra", {})
    rank, counts = ex.rank_in_key(key, D)
    quota = torch.clamp(counts[:D], max=cap)
    _, kept, leaving, _, _ = ex.pack_send(state, key, rank, counts, quota, quota.tolist(),
                                          cap, new_elem, lpp.elem_gid)
    wants = key < D
    bucket = torch.where(wants, key, -1).to(torch.int32)
    active = state["active"]
    lost = torch.zeros((), dtype=torch.int32, device=dev)
    n = active.shape[0]
    mine = cn.slot_counts([[("set", active)], [("set", prev_active), ("neg", new_elem)]],
                          [None, lost])
    row = torch.stack([mine[0], leaving.sum(dtype=torch.int32), kept.sum(dtype=torch.int32),
                       lost, lost, lost, mine[1], lost])
    g = (row[None, :] + torch.arange(X_RANKS, device=dev, dtype=torch.int32)[:, None]
         * torch.tensor([1, 1, 1, 0, 0, 0, 1, 0], dtype=torch.int32, device=dev))
    g[1, 3] = 1                                  # one rank overflowed
    cases = (
        (f"the step's end: alive, exits less the lost ({n} slots)",
         [[("set", active)], [("set", prev_active), ("neg", new_elem)]], [None, lost],
         lambda: (active.sum(dtype=torch.int32),
                  (prev_active & (new_elem < 0)).sum(dtype=torch.int32) - lost)),
        (f"migrate's free slots ({n} slots)", [[("clear", active)]], [None],
         lambda: active.shape[0] - active.sum(dtype=torch.int32)),
        (f"migrate's sent, kept home, illegal ({n} slots)",
         [[("set", leaving)], [("set", kept)], [("set", wants), ("neg", bucket)]],
         [None] * 3,
         lambda: (leaving.sum(dtype=torch.int32), kept.sum(dtype=torch.int32),
                  (wants & (bucket < 0)).sum(dtype=torch.int32))),
    )
    for what, cnts, subs, former in cases:
        got = cn.slot_counts(cnts, subs)
        compare("slot_counts", what, got, cn.slot_counts_plain(cnts, subs), results)
        log(f"[c] slot_counts {what}: {got.tolist()}")
        time_pair("slot_counts", what, lambda: cn.slot_counts(cnts, subs),
                  lambda: cn.slot_counts_plain(cnts, subs), results)
        read = {id(t): t for terms in cnts for _, t in terms}
        record_bound("slot_counts", what, results, nbytes(*read.values()) + 4 * len(cnts))
        record_library("slot_counts", what, "the torch sums it replaced", former, results)
        record_launches("slot_counts", what, lambda: cn.slot_counts(cnts, subs), results,
                        {"kernel": 1})
    what = f"step_stats' reduction ({X_RANKS} ranks)"
    got = cn.rank_stats(g, 3)
    compare("slot_counts", what, got, cn.rank_stats_plain(g, 3), results)
    time_pair("slot_counts", what, lambda: cn.rank_stats(g, 3),
              lambda: cn.rank_stats_plain(g, 3), results)
    record_bound("slot_counts", what, results, nbytes(g, got))
    record_library("slot_counts", what, "the torch reduction it replaced",
                   lambda: former_end_counts(active, prev_active, new_elem, lost, g)[2:],
                   results)
    record_launches("slot_counts", what, lambda: cn.rank_stats(g, 3), results, {"kernel": 1})

    # the kernels of a step's counts, the former torch code's against N's
    def n_step():
        cn.slot_counts([[("clear", active)]])
        cn.slot_counts(cases[2][1])
        return n_end()

    def n_end():
        cn.slot_counts(cases[0][1], cases[0][2])
        return cn.rank_stats(g, 3)

    arms = {   # arm: (the former code, N's, N's launches a step there)
        f"a rank of a {X_RANKS}-rank arm": (
            lambda: former_step_counts(leaving, kept, wants, bucket, active, active,
                                       prev_active, new_elem, lost, g), n_step, 4),
        "the one-rank arm": (
            lambda: former_end_counts(active, prev_active, new_elem, lost, g), n_end, 2)}
    for arm, (old, new, launches) in arms.items():
        k_old, k_new = graph_nodes(old), graph_nodes(new)
        log(f"[c] slot_counts, the counts of a step on {arm}: the torch code {k_old}, "
            f"kernel N {k_new} (captured CUDA graphs)")
        results["slot_counts"]["extra"][f"step launches, {arm}"] = {
            "torch": k_old, "kernel_n": k_new}
        if k_new != {"kernel": launches}:
            raise AssertionError(f"slot_counts: a step's counts on {arm} launched {k_new}")


def check_exchange(results: dict, dev) -> None:
    """X1, X2, X3 and O against their plain versions at the 4-rank 120k
    arm's per-rank size (3.75M slots, 2.5M particles, its leaver share; rank
    0's picpart, its gid table and vertex exchange tables, 12-layer
    buffer) and on the adversarial inputs, then timed on the device alone
    (the launchers called directly: the wrappers' checks read the device).
    X2's main case is the picparts step's own leaver layout
    (:func:`x2_step_case`), its second timed case leavers at random; each
    prints its leavers, the share of warps holding one and the mean run.
    X3 writes the member fields in place: each case also checks that the
    state's own tensors hold the result and the staying slots their bits.
    O's fan-out in place against its plain version, its input untouched;
    D's pass 2 with the send rows against D followed by O's gather.  Y1
    (each form), Y2 and Y3 at the same size (:func:`check_route`)."""
    t0 = time.perf_counter()
    mesh = exchange_mesh()
    lpp = exchange_picpart(dev, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(X_SEED)
    D, cap = X_RANKS - 1, X_SLOTS // 8
    for name in ("rank_in_key", "pack_send", "place_arrivals", "owner_reduce") + Y_KERNELS:
        results[name].setdefault("extra", {})
    check_rank_in_key(results, dev, gen, D)
    step = x2_step_case(dev, lpp, mesh, prev=True)
    check_lost_walk(results, dev, lpp, mesh, step)
    check_pack_send(results, dev, gen, lpp, D, cap, mesh, step)
    check_route(results, dev, mesh, lpp, step)
    check_slot_counts(results, dev, lpp, step, D, cap)
    del step
    check_place_arrivals(results, dev, gen, lpp, D, cap)
    check_owner_reduce(results, dev, gen, lpp)
    log(f"[c] exchange kernels checked in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()


L2_BYTES = 50 * 2**20              # the H100 SXM's L2 cache


def l2_fit(kernel: str, what: str, results: dict, working_set: int) -> None:
    """Whether case ``what``'s working set (the tables its gathers read,
    counted by the rows this data touches) fits the card's L2."""
    fits = working_set <= L2_BYTES
    log(f"[c] {kernel} {what}: working set {working_set / 1e6:.1f} MB, "
        f"{'fits' if fits else 'exceeds'} the {L2_BYTES / 2**20:.0f} MiB L2")
    case_of(kernel, what, results).update(working_set_mb=working_set / 1e6, fits_l2=fits)


def check_production(results: dict, dev):
    """The kernels at the production mesh's shapes: the ~1M-element tokamak
    mesh (``bench_torch.production_mesh``, written at first use and read
    through ``read_msh``), its cartesian cpe-4 grid calibrated on the card
    and the seeded 10M particles: L's peel + walk over the ~220 MB cell-row
    table, L's dense plain walk at the locator-less step, H into 981,178
    counters, D over the mesh's gyro map (491,770 vertices), Z's row order
    on the located particles' 981,178 counts, then on a Sell-C-σ structure
    of them (the app's layout) C on the rebuild's
    20-bit keys, S and G at the sorted rebuild's shapes.  Each case equal to
    its plain version, timed beside its bound (bytes: the rows this data
    reads) and the library call; its working set against the L2.  Returns
    the mesh and the grid (phase d's 1M arms reuse them) and the setup's
    seconds by phase."""
    import bench_torch
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    seconds = {}
    t0 = time.perf_counter()
    path = bench_torch.production_mesh()
    seconds["mesh file"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = Mesh2D.from_arrays(*read_msh(path), device=dev)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = _cfg(px, mesh)
    s, step = px.make_dp_setup(mesh, cfg, dev, timings=seconds)
    torch.cuda.synchronize()
    model = step.model
    grid = model.locator
    E, n = mesh.nelems, s["x0"].shape[0]
    log(f"[c] 1M mesh: E={E} V={mesh.nverts}, N={n}, cells={grid.nx * grid.ny} "
        f"({nbytes(grid.cell_rows) / 1e6:.1f} MB of cell rows, walk_geom "
        f"{nbytes(mesh.walk_geom) / 1e6:.1f} MB); setup seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))

    tx, ty = _push(push_ops, s, model, cfg)[:2]
    # L: peel + guess walk over the 1M grid's table
    what = "peel+walk, 1M mesh"
    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    got = se.walk_locate(*largs, grid=grid)
    compare("locate", f"{what} ({n} particles, {grid.nx * grid.ny} cells)", got,
            se.walk_locate_plain(*largs, grid=grid), results)
    log(f"[c] locate {what}: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    time_pair("locate", what, lambda: se.walk_locate(*largs, grid=grid),
              lambda: se.walk_locate_plain(*largs, grid=grid), results, plain_reps=3,
              record=False)
    cells = int(torch.unique(grid.cell_of(tx, ty)[s["active"]]).numel())
    steps, distinct = plain_walk_rows(*largs, grid=grid)
    rows = nbytes(grid.cell_rows) // grid.cell_rows.shape[0] * cells
    walk_rows_b = distinct * mesh.walk_geom.shape[1] * mesh.walk_geom.element_size()
    log(f"[c] locate {what}: {cells} distinct cells read ({rows / 1e6:.1f} MB of "
        f"{nbytes(grid.cell_rows) / 1e6:.1f}), {int((steps > 0).sum())} walkers past the "
        f"peel, {int(steps.sum())} walk rows, {distinct} distinct")
    case_of("locate", what, results).update(cells_read=cells, walk_rows=int(steps.sum()),
                                             distinct_rows=distinct)
    record_bound("locate", what, results, nbytes(*largs[1:5], *got[:2]) + rows + walk_rows_b,
                 40.0 * n)
    l2_fit("locate", what, results, rows + walk_rows_b)
    elem, active = got[0], got[1]

    # L: the dense plain walk at the locator-less step (the same particles,
    # each walked from its element)
    what = "plain walk, the locator-less step, 1M mesh"
    got = se.walk_locate_counted(*largs)
    e, iters, unfinished = se._walk_batch(*largs)
    compare("locate", f"{what} ({n} particles)", got,
            (e, e >= 0, torch.tensor(iters, dtype=torch.int32, device=dev),
             torch.tensor(unfinished, dtype=torch.int32, device=dev)), results)
    del e
    longest = int(got[2])
    log(f"[c] locate {what}: longest walk {longest}, {int(got[3])} deleted at the limit "
        f"{cfg.max_search_iters}, alive={int(got[1].sum())}")
    time_pair("locate", what, lambda: se.walk_locate(*largs),
              lambda: se.walk_locate_plain(*largs), results, plain_reps=2, record=False)
    walk_b = walk_rows(what, largs, results)
    case_of("locate", what, results).update(longest_walk=longest, deleted=int(got[3]))
    record_bound("locate", what, results, nbytes(*largs[1:5], *got[:2]) + walk_b)
    l2_fit("locate", what, results, walk_b)
    del got, steps

    # H: 10M keys into the 1M mesh's counters
    what = "main-path order, 1M mesh"
    counts = sc.histogram(elem, active, E)
    compare("histogram", f"{what} ({n} keys, {E} bins)", counts,
            sc.histogram_plain(elem, active, E), results)
    time_pair("histogram", what, lambda: sc.histogram(elem, active, E),
              lambda: sc.histogram_plain(elem, active, E), results, record=False)
    record_bound("histogram", what, results, nbytes(elem, active, counts))
    key = torch.where(active, elem, E)
    record_library("histogram", what, "torch.bincount",
                   lambda: torch.bincount(key, minlength=E + 1), results, entry=False)
    l2_fit("histogram", what, results, nbytes(counts))
    del key

    # D: the ring expansion and the mapped scatter over the 1M mesh's map
    what = "both passes, 1M mesh"
    R, P = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    l2_fit("deposit", what, results,
           check_deposit(results, what, dev, mesh, model.gyro_fwd, counts, R, P))

    # Z: the app's row order on the located particles' counts
    what = f"app scs, {E} triangles"
    check_scs_row_order(results, counts, n, what)
    l2_fit("scs_row_order", what, results, nbytes(counts) * 4)

    # C, S, G on a Sell-C-σ structure of the located particles
    ps = scs_of_located(dev, E, s, elem, active)
    torch.cuda.synchronize()
    del s
    bands = push_ops.BandClasses.build(
        push_ops.detect_banded_class(mesh.class_id.cpu().numpy()), dev)
    new_elem = located_after_push(mesh, ps, cfg, grid, bands)
    modes, key = slot_map_inputs(ps, new_elem, E)
    what = "app step-1 order, 1M mesh"
    check_key_sort(results, what, key, E)
    l2_fit("key_sort", what, results, 4 * nbytes(key))     # a pass's keys and order in and out
    what = "scs, 1M mesh"
    got = check_slot_map(results, what, modes["scs"])
    l2_fit("slot_map", what, results, nbytes(*modes["scs"][2:5]))
    what = "columns form, step-1 locality, 1M mesh"
    cols = [ps.fields[k] for k in ("x", "xtgt", "pid", "b", "phi")] + [key]
    check_columns(results, what, cols, got[0])
    l2_fit("row_gather", what, results, nbytes(*cols))
    del ps, new_elem, modes, key, got, cols, counts
    torch.cuda.empty_cache()
    return mesh, grid, seconds


def phase_c(results: dict, dev, smi: str):
    """Returns the 120k mesh, its cartesian grid and the band grid built
    here (phase d reuses them), and the band grid's build seconds."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.ops.scatter import histogram

    mesh = Mesh2D.from_arrays(*read_msh(MESH), device=dev)
    s, model, elem, active, x = check_cartesian(results, dev, mesh)
    check_pprad(results, dev, mesh, elem, active)
    check_rows(results, dev, mesh, s, model, elem, active)
    check_scs_row_order(results, histogram(elem, active, mesh.nelems), elem.shape[0],
                        f"app scs, {mesh.nelems} triangles")
    grid = model.locator
    del s, model
    torch.cuda.empty_cache()
    check_trace2d(results, dev, mesh, grid, x, elem, active)
    torch.cuda.empty_cache()
    check_parents_and_walk(results, dev, mesh, x, elem, active)
    torch.cuda.empty_cache()
    run_trace2d_path(results, dev, mesh, grid, x, elem, active, smi)
    del x, elem, active
    torch.cuda.empty_cache()
    band_grid, band_s = check_band(results, dev, mesh)
    check_annulus(results, dev)
    mesh3d, grid3d, seeded = check_pps3d(results, dev)
    check_parents_3d(results, dev, mesh3d, seeded)
    torch.cuda.empty_cache()
    check_reshuffle(results, dev, mesh3d, seeded)
    torch.cuda.empty_cache()
    gitr_mesh = check_gitr(results, dev)
    torch.cuda.empty_cache()
    check_trace3d_peel(results, dev, mesh3d, grid3d, seeded)
    del seeded
    torch.cuda.empty_cache()
    check_slices(dev)
    check_app_slices(dev)
    check_pps3d_slices(dev)
    check_gitr_slices(dev)
    torch.cuda.empty_cache()
    check_exchange(results, dev)
    production = check_production(results, dev)
    return mesh, grid, band_grid, band_s, grid3d, gitr_mesh, production


def phase_d(results: dict, dev, grid, band_grid, band_s: float, smi: str) -> None:
    alive = {}
    for name, (kw, expected) in ARMS.items():
        kw = dict({"mesh_path": MESH}, **kw)
        extra = {}
        if name == "band":
            kw["locator"] = band_grid
            extra["band grid build (phase c)"] = band_s
        if name in ("cartesian", "pprad", "rotgather"):
            kw["locator"] = grid          # phase c's cartesian grid of this mesh
        det, counts = dp_arm(results, dev, name, kw, expected, smi, extra)
        alive[name] = det["alive"]
        if name == "rotgather":
            log(f"[d] rotgather arm: alive "
                f"{det['alive']} against the cartesian arm's {alive['cartesian']} "
                f"(difference {det['alive'] - alive['cartesian']}: the table's f64-rounded "
                f"cos/sin against the band rotation's f32 ones move positions by an ulp)")
        if name == "annulus" and counts["locate"] != 1:
            raise AssertionError(f"annulus arm: {counts['locate']} L launches; only the "
                                 f"setup's gyro-map walk may launch L")
        if name == "nolocator" and not det["all_found"]:
            raise AssertionError("nolocator arm: a walker was deleted at the loop limit")


def dp_arm(results: dict, dev, name: str, kw: dict, expected, smi: str,
           extra_setup: Optional[dict] = None) -> dict:
    """One FULL-mode arm through ``bench_torch.main`` at 10M particles, 1
    warm-up + TIMED_STEPS steps, with the launch counts reset just before:
    its setup seconds, ms/step and the walkers each step deleted at the
    walk limit logged, its launch set required to be ``expected`` (every
    other kernel at 0), finite positive fields and > 90% of the particles
    alive, no particle both alive and counted deleted.  Returns the
    record's ``detail`` and the launch counts."""
    import bench_torch
    from pumipic_torch import kernels

    torch.cuda.empty_cache()
    kernels.reset_launches()
    record, state, fields = bench_torch.main(
        device=dev, num_ptcls=NUM_PTCLS, iters=TIMED_STEPS, **kw)
    counts = dict(kernels.LAUNCHES)
    det = record["detail"]
    setup = dict(det["setup_s"], **(extra_setup or {}))
    deleted = det["deleted_per_step"]
    log(f"[d] {name} arm, tag {det['tag']}, E={det['mesh_elems']}")
    log(f"[d] {name} setup seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
    log(f"[d] {name}: {det['ms_per_step']:.4f} ms/step, {record['value']:.6g} "
        f"particle-steps/s, alive {det['alive']} of {det['num_ptcls']}, "
        f"iters {det['iters']}, all_found {det['all_found']} ({smi})")
    log(f"[d] {name}: walkers deleted at the walk limit, the warm-up and each timed "
        f"step: {deleted} (total {sum(deleted)}); boundary exits "
        f"{det['num_ptcls'] - det['alive'] - sum(deleted)}")
    log(f"[d] {name} kernel launches: {counts}")
    launched = {k for k, v in counts.items() if v > 0}
    if launched != set(expected):
        raise AssertionError(f"{name} arm launched {sorted(launched)}, "
                             f"expected {sorted(expected)}")
    for k, v in counts.items():
        results[k]["launches"] = results[k].get("launches", 0) + v
    for key in ("fwd", "bwd"):
        f = fields[key]
        if f.shape != (det["mesh_verts"],) or not bool(torch.isfinite(f).all()) \
                or not float(f.sum()) > 0:
            raise AssertionError(f"{name} field {key}: shape {tuple(f.shape)}, "
                                 f"want ({det['mesh_verts']},), finite and "
                                 f"positive")
    if not det["alive"] > 0.9 * NUM_PTCLS:
        raise AssertionError(f"{name}: only {det['alive']} of {NUM_PTCLS} "
                             f"particles alive")
    if det["alive"] + sum(deleted) > det["num_ptcls"]:
        raise AssertionError(f"{name}: {det['alive']} alive and {sum(deleted)} deleted "
                             f"of {det['num_ptcls']} particles")
    del state, fields
    return det, counts


def phase_d_production(results: dict, dev, mesh, grid, seconds: dict, smi: str) -> None:
    """The 1M mesh's arms at 10M particles, on phase c's read of the mesh
    and its grid: the cartesian main path and the locator-less arm through
    ``bench_torch.main`` (:func:`dp_arm`; every particle found or counted
    deleted at the walk limit), then the Sell-C-σ app through its entry
    points (:func:`run_app`)."""
    import bench_torch

    built = {"mesh file (phase c)": seconds["mesh file"], "mesh (phase c)": seconds["mesh"]}
    for name in PRODUCTION_ARMS:
        kw, expected = ARMS[name]
        kw = dict(kw, mesh_path=bench_torch.PRODUCTION_MESH, mesh=mesh)
        extra = dict(built)
        if name == "cartesian":
            kw["locator"] = grid
            extra["grid build (phase c's search build)"] = seconds["locator"]
        dp_arm(results, dev, f"{name} 1M", kw, expected, smi, extra)
    run_app(results, dev, mesh, grid, "scs", steps=PRODUCTION_APP_STEPS, label="scs 1M")


# the kernels an auto rebuild launches after Q: the reshuffle; the fallback
# (U1, then the sort rebuild: C, H, Z for SCS, S, G, Q's epilogue)
AUTO_RESHUFFLE = {"reshuffle_count": 1, "reshuffle_order": 1, "row_gather": 1,
                  "reshuffle_place": 1}
AUTO_FALLBACK = {
    "scs": {"reshuffle_count": 1, "key_sort": 1, "histogram": 1, "scs_row_order": 1,
            "slot_map": 1, "row_gather": 1, "rebuild_mask": 1},
    "cabm": {"reshuffle_count": 1, "key_sort": 1, "histogram": 1, "slot_map": 1,
             "row_gather": 1, "rebuild_mask": 1}}


def check_auto_step(ps, elem, out, grown: dict, pid0) -> dict:
    """One auto rebuild of ``ps`` into ``elem`` (kernel Q's destinations)
    giving ``out``, ``grown`` the launches it added, ``pid0`` a copy of
    ``ps``'s pids taken before it (a reshuffle writes the fields in
    place): the branch's launch
    set; num_ptcls equal to the active slots and no overflow; the pids kept
    (count and sum); every stayer in its slot (a reshuffle); every active
    particle's element its destination, matched by pid; every active slot
    inside its element's segment.  Returns the step's mover share and
    branch."""
    reshuffled = grown.get("reshuffle_place", 0) > 0
    want = AUTO_RESHUFFLE if reshuffled else AUTO_FALLBACK[ps.layout]
    if grown != want:
        raise AssertionError(f"auto rebuild launched {grown}, expected {want}")
    stay = (elem >= 0) & (elem == ps.elem)
    n_mov = int(((elem >= 0) & ~stay).sum())
    act, keep = out.active, elem >= 0
    n = int(out.num_ptcls)
    if n != int(act.sum()) or n != int(keep.sum()) or bool(out.overflowed):
        raise AssertionError(f"auto rebuild: num_ptcls {n}, active {int(act.sum())}, "
                             f"destinations {int(keep.sum())}, overflowed "
                             f"{bool(out.overflowed)}")
    pid1 = out.fields["pid"]
    if int(pid0[keep].sum(dtype=torch.int64)) != int(pid1[act].sum(dtype=torch.int64)):
        raise AssertionError("auto rebuild: the pids' sum changed")
    if reshuffled and not (torch.equal(pid1[stay], pid0[stay]) and bool(act[stay].all())):
        raise AssertionError("auto rebuild: a stayer left its slot")
    tgt = torch.full((ps.capacity,), -2, dtype=torch.int32, device=elem.device)
    tgt[pid0[keep].long()] = elem[keep]
    if not torch.equal(tgt[pid1[act].long()], out.elem[act]):
        raise AssertionError("auto rebuild: a particle's element is not its destination")
    slot = torch.nonzero(act).flatten()
    e = out.elem[slot].long()
    stride = out.chunk_size if out.layout == "scs" else 1
    off = slot - out.elem_offsets[e]
    if not bool(((off >= 0) & (off % stride == 0) & (off // stride < out.seg_cap[e])).all()):
        raise AssertionError("auto rebuild: an active slot outside its element's segment")
    return {"share": n_mov / int(ps.num_ptcls), "branch": "reshuffle" if reshuffled else "sort"}


@contextlib.contextmanager
def auto_steps():
    """Inside the block, every ``rebuild(mode="auto")`` of a Sell-C-σ or
    CabM structure is checked (:func:`check_auto_step`) and its record
    appended to the list the block gets."""
    from pumipic_torch import kernels
    from pumipic_torch.particles import structure as st

    real, steps = st._rebuild_auto, []

    def checked(ps, elem, active):
        pid0 = ps.fields["pid"].clone()
        before = dict(kernels.LAUNCHES)
        out = real(ps, elem, active)
        grown = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        steps.append(check_auto_step(ps, elem, out, grown, pid0))
        return out

    st._rebuild_auto = checked
    try:
        yield steps
    finally:
        st._rebuild_auto = real


def run_pps3d(results: dict, dev, grid3d, smi: str) -> None:
    """pseudoPushAndSearch's arms through ``bench_torch.main(mode="pps3d")``
    at 10M particles on the Kuhn box, the counts reset just before each;
    the walk arm reuses phase c's grid."""
    import bench_torch
    from pumipic_torch import kernels

    for name, (kw, steps, must, must_not) in PPS3D_ARMS.items():
        if kw["kuhn"] == "off":
            kw = dict(kw, locator=grid3d)
        reflect = kw.get("wall") == "reflect"
        auto = kw.get("rebuild") == "auto"
        torch.cuda.empty_cache()
        kernels.reset_launches()
        with auto_steps() if auto else contextlib.nullcontext([]) as checked:
            record, ps, fields = bench_torch.main(device=dev, num_ptcls=NUM_PTCLS,
                                                  iters=steps, mode="pps3d",
                                                  mesh_elems=PPS3D_ELEMS, **kw)
        counts = dict(kernels.LAUNCHES)
        det = record["detail"]
        log(f"[d] {name} (tag {det['tag']}, {det['mesh_elems']} tets): "
            f"{det['ms_per_step']:.4f} ms/step over {steps} steps"
            f"{' (with the per-step checks)' if auto else ''}, {record['value']:.6g} "
            f"particle-steps/s, alive {det['alive']} of {det['num_ptcls']}, iters "
            f"{det['iters']} ({smi})")
        if auto:
            branch = "sort" if name.endswith("fallback") else "reshuffle"
            log(f"[d] {name} each step's rebuild (mover share, branch): "
                + ", ".join(f"{c['share']:.4f} {c['branch']}" for c in checked))
            if len(checked) != 1 + steps or any(c["branch"] != branch for c in checked):
                raise AssertionError(f"{name}: {len(checked)} auto rebuilds checked, "
                                     f"branches {[c['branch'] for c in checked]}, every "
                                     f"one of {1 + steps} should take the {branch}")
            log(f"[d] {name}: every step's rebuild checked on the device (num_ptcls, "
                f"overflow, pids kept, stayers in place, elements by pid, segments)")
        log(f"[d] {name} setup seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in det["setup_s"].items()))
        log(f"[d] {name} kernel launches: {counts}")
        launched = {k for k, v in counts.items() if v > 0}
        if not set(must) <= launched or launched & set(must_not):
            raise AssertionError(f"{name} launched {sorted(launched)}: needs {must}, "
                                 f"none of {must_not}")
        for k, v in counts.items():
            results[k]["launches"] = results[k].get("launches", 0) + v
        act = ps.active
        if int(ps.num_ptcls) != int(act.sum()) or bool(ps.overflowed):
            raise AssertionError(f"{name}: num_ptcls {int(ps.num_ptcls)}, active "
                                 f"{int(act.sum())}, overflowed {bool(ps.overflowed)}")
        e = ps.elem[act]
        if not bool(((e >= 0) & (e < det["mesh_elems"])).all()):
            raise AssertionError(f"{name}: an active element id out of range")
        x = ps.get("x")[act]
        slack = 1e-5 if reflect else 0.0       # a mirrored position rounds
        if not bool(((x >= -slack) & (x <= 1 + slack)).all()):
            raise AssertionError(f"{name}: a position outside the box")
        if kw["kuhn"] == "auto" and det["alive"] != NUM_PTCLS:
            raise AssertionError(f"{name}: {det['alive']} of {NUM_PTCLS} alive on the "
                                 f"periodic box")
        if kw["kuhn"] == "off":
            log(f"[d] {name}: {NUM_PTCLS - det['alive']} walkers deleted over "
                f"{1 + steps} steps (on the periodic or reflecting box only at the "
                f"64-iteration limit)")
        if reflect and det["alive"] < 0.999 * NUM_PTCLS:
            raise AssertionError(f"{name}: {det['alive']} of {NUM_PTCLS} alive in the "
                                 f"reflecting box")
        del ps, fields


def run_gitr(results: dict, dev, mesh, smi: str) -> None:
    """The GITR-style app's arms through ``bench_torch.main(mode="gitr")``
    at 10M particles on phase c's 196,608-tet box, the counts reset just
    before each: exactly R, M and W launched; reflect keeps all 10M alive,
    absorb's wall tally sums to the particles lost."""
    import bench_torch
    from pumipic_torch import kernels

    for name, (wall, steps) in GITR_ARMS.items():
        torch.cuda.empty_cache()
        kernels.reset_launches()
        record, state, fields = bench_torch.main(device=dev, num_ptcls=NUM_PTCLS,
                                                 iters=steps, mode="gitr", mesh=mesh,
                                                 wall=wall)
        counts = dict(kernels.LAUNCHES)
        det = record["detail"]
        log(f"[d] {name} (tag {det['tag']}, {det['mesh_elems']} tets): "
            f"{det['ms_per_step']:.4f} ms/step over {steps} steps, {record['value']:.6g} "
            f"particle-steps/s, alive {det['alive']} of {det['num_ptcls']}, iters "
            f"{det['iters']}, wall hits {det['wall_hits_total']} ({smi})")
        log(f"[d] {name} setup seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in det["setup_s"].items()))
        log(f"[d] {name} kernel launches: {counts}")
        launched = {k for k, v in counts.items() if v > 0}
        if launched != set(GITR_KERNELS):
            raise AssertionError(f"{name} launched {sorted(launched)}, expected "
                                 f"{sorted(GITR_KERNELS)}")
        for k, v in counts.items():
            results[k]["launches"] = results[k].get("launches", 0) + v
        act = state["active"]
        x, v = state["x"], state["v"]
        if not bool(torch.isfinite(x).all()) or not bool(torch.isfinite(v[act]).all()):
            raise AssertionError(f"{name}: a position or velocity is not finite")
        e = state["elem"][act]
        if not bool(((e >= 0) & (e < det["mesh_elems"])).all()):
            raise AssertionError(f"{name}: an active element id out of range")
        xa = x[act]
        if not bool(((xa >= -1e-5) & (xa <= 1 + 1e-5)).all()):
            raise AssertionError(f"{name}: an active particle outside the box")
        if wall == "reflect" and det["alive"] != NUM_PTCLS:
            raise AssertionError(f"{name}: {det['alive']} of {NUM_PTCLS} alive over "
                                 f"{1 + steps} steps")
        if wall == "absorb" and det["wall_hits_total"] != NUM_PTCLS - det["alive"]:
            raise AssertionError(f"{name}: wall hits {det['wall_hits_total']} against "
                                 f"{NUM_PTCLS - det['alive']} particles lost")
        del state, fields


def run_app(results: dict, dev, mesh, grid, structure: str, steps: Optional[int] = None,
            label: Optional[str] = None):
    """The PseudoXGCm app at 10M particles on ``mesh`` (the 120k mesh, or
    the 1M one) through its entry points (construction, then ``run``), with
    the counts reset just before; ``grid`` is phase c's cartesian grid for
    this mesh.  The SCS arm is the timed one; the others run 3 steps
    (``steps``: another count), with the counts reset after construction
    so that they show what a step launches; ``label`` names the arm in
    the log (default: the structure).  The last timed step's search is
    run again with its count of the walkers deleted at the walk limit.  Returns
    what the last timed step's rebuild moved, read without launching
    anything and held only after the timed steps: the columns and source
    rows of its gather (``"gather"``, SCS only), the arguments of its
    slot map (``"slot_map"``, the layouts that run kernel S) and the keys
    of its sort (``"key_sort"``, SCS only)."""
    from pumipic_torch import kernels
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.utils import timing

    cfg = _cfg(px, mesh, structure=structure)
    steps = APP_STEPS[structure] if steps is None else steps
    label = label or structure
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    app = px.PseudoXGCm(mesh, cfg, device=dev, locator=grid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ps = app.ptcls
    n0, cap = int(ps.num_ptcls), ps.capacity
    if structure != "scs":
        kernels.reset_launches()
    # the warm-up's rebuild is the first, so the last timed step's is the
    # (steps + 1)th
    last = {steps + 1: "last"}
    with gathers_at(last if structure == "scs" else {}) as gathers, \
            slot_maps_at(last if "slot_map" in APP_ARMS[structure] else {}) as maps, \
            key_sorts_at(last if structure == "scs" else {}) as sorts:
        app.run(1, verbose=False)                 # warm-up step
        timing.get_registry().reset()
        mem0 = torch.cuda.memory_stats()
        step_s = []                               # each timed step's seconds
        for i in range(steps):
            prev = app.ptcls
            app.run(1, verbose=False)
            step_s.append(timing.get_registry().ops["xgcm step"].total - sum(step_s))
        mem1 = torch.cuda.memory_stats()
    counts = dict(kernels.LAUNCHES)
    st = timing.get_registry().ops["xgcm step"]
    ms = st.total / st.count * 1e3
    ps = app.ptcls
    m = {k: (float(v) if "fraction" in k else int(v)) for k, v in ps.metrics().items()}
    log(f"[d] app {label}: setup {setup_s:.2f} s, {n0} particles, capacity {cap}")
    log(f"[d] app {label}: {ms:.4f} ms/step over {st.count} steps (timing "
        f"registry; min {st.tmin * 1e3:.4f}, max {st.tmax * 1e3:.4f}), "
        f"{n0 / (ms / 1e3):.6g} particle-steps/s, num_ptcls {int(ps.num_ptcls)}, "
        f"metrics {m}")
    log(f"[d] app {label}: step ms {[round(t * 1e3, 4) for t in step_s]}, median "
        f"{sorted(step_s)[len(step_s) // 2] * 1e3:.4f}; the allocator in the timed steps: "
        + ", ".join(f"{k} {mem1.get(k, 0) - mem0.get(k, 0)}" for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries"))
        + f", reserved {mem1.get('reserved_bytes.all.current', 0) / 2**30:.2f} GiB")
    log(f"[d] app {label} kernel launches: {counts}")
    launched = {k for k, v in counts.items() if v > 0}
    if launched != set(APP_ARMS[structure]):
        raise AssertionError(f"app {label} launched {sorted(launched)}, "
                             f"expected {sorted(APP_ARMS[structure])}")
    for k, v in counts.items():
        results[k]["launches"] = results[k].get("launches", 0) + v

    # the structure's invariants
    E = mesh.nelems
    act = ps.active
    if int(ps.num_ptcls) != int(act.sum()) or bool(ps.overflowed):
        raise AssertionError(f"app {label}: num_ptcls {int(ps.num_ptcls)}, "
                             f"active {int(act.sum())}, overflowed {bool(ps.overflowed)}")
    e = ps.elem[act]
    if not bool(((e >= 0) & (e < E)).all()):
        raise AssertionError(f"app {label}: an active element id out of range")
    # conservation: the active pids are exactly those the last search kept
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    cls = prev.elem if app.bands is not None else \
        mesh.class_id[torch.clamp(prev.elem, min=0).long()]
    tx, ty, _, _ = push_ops.push_phi(prev.get("x"), prev.get("phi"), prev.get("b"),
                                     prev.active, cls, cfg.deg_per_push, cfg.h, cfg.k,
                                     cfg.d, bands=app.bands)
    _, kept, iters, deleted = se.walk_locate_counted(
        mesh.walk_geom, tx, ty, prev.elem, prev.active, cfg.max_search_iters,
        grid=app.locator)
    log(f"[d] app {label}: the last step's search: iters {int(iters)}, "
        f"{int(deleted)} walkers deleted at the walk limit")
    want = torch.sort(prev.get("pid")[kept]).values
    got = torch.sort(ps.get("pid")[act]).values
    if not torch.equal(want, got):
        raise AssertionError(f"app {label}: active pids differ from the "
                             f"last search's survivors")
    if not int(act.sum()) > 0.9 * NUM_PTCLS:
        raise AssertionError(f"app {label}: only {int(act.sum())} alive")
    log(f"[d] app {label}: invariants hold (num_ptcls == active, no overflow, "
        f"ids in range, {got.shape[0]} active pids == the last search's survivors)")
    return {k: c["last"] for k, c in (("gather", gathers), ("slot_map", maps),
                                       ("key_sort", sorts)) if c}


# ---------------------------------------------------------------------------
# phase e: the distributed runtime as ranks of a torch.distributed group
# ---------------------------------------------------------------------------

E_RANKS = 4
E_STEPS = 5
E_LABEL = f"{E_RANKS} processes sharing one H100 over gloo (host-staged)"
E_CAPF = 1.5
# BFS buffer layers: the 15° push outruns bench.py's 3 (scripts/
# picparts_buffer_cpu.py, 4 CPU ranks, 200k particles: 3 layers lose 0.03%
# (120k) and 0.2% (annulus) a step off the picparts, 8 layers none)
E_BUFFER = 12
# kernels each rank of an arm launches (from its setup on), by name
E_WALK = ("push", "locate", "histogram", "deposit")
E_ANALYTIC = ("push", "annulus_locate", "locate", "histogram", "deposit")
# launches a step of each rank, by name, of the route and exchange
# kernels: Y1 once in the arm's form (E_PACKED: the walk arms; E_BANDED:
# the annulus's analytic arms), Y2 and Y3 once (the balancer); X1 for the
# buckets, the balancer's two weight counts and its candidates; X2 and X3
# once; O's fan-in and fan-out (kernel D writes the fan-in's send rows: O's
# gather is not launched); N for migrate's free slots, for its sent,
# kept-home and illegal counts, for the step's alive and exits and for
# step_stats' reduction.  One rank migrates nothing (the comm-size-1 path)
# and has no balancer: Y1, O and N's last two.
E_EXCHANGE = {"rank_in_key": 4, "pack_send": 1, "place_arrivals": 1, "owner_reduce": 2,
              "balance_keys": 1, "balance_select": 1, "slot_counts": 4}
E_PACKED = dict(E_EXCHANGE, route_packed=1)
E_BANDED = dict(E_EXCHANGE, route_banded=1)
E_ONE_RANK = {"owner_reduce": 2, "route_packed": 1, "slot_counts": 2}
# rank 0 of the 4-rank 120k arm with the exchange and the reduction as
# torch ops (PERF.md §5, 3-layer buffer): device busy and the stream's
# split, ms a step
E_TORCH_OPS = {"busy": 10.76, "compute": 1.43, "collective": 18.20, "glue": 30.70,
          "other": 1.50}
E_DEVICE = "cuda"        # "cpu" rehearses the phase with the plain versions
E_WALK_TOL = 1e-5        # analytic against walk: |alive|, |sent| differences


def e_launch(target: str, n: int, kwargs: dict, backend: str = "gloo",
             timeout: float = 600.0) -> list:
    from pumipic_torch.parallel import group

    backend = backend if E_DEVICE == "cuda" else "gloo"
    return group.launch(target, n, kwargs, backend=backend, device=E_DEVICE,
                        timeout=timeout)


def e_tally(results: dict, name: str, ranks: list, expected, walk_steps: int,
            exchange=None, steps: int = 1 + E_STEPS) -> None:
    """Require each rank's launch set to be ``expected`` and the route and
    exchange kernels (``exchange``: launches a step, default
    :data:`E_PACKED`),
    those to be launched ``steps`` times their count a step, and its L
    launches to be the setup's gyro-map walk plus, on a walk arm
    (``walk_steps`` > 0), at least one local search in each of
    ``walk_steps`` steps; add the counts to the kernels' launches."""
    exchange = E_PACKED if exchange is None else exchange
    for r, out in enumerate(ranks):
        counts = out["launches"]
        launched = {k for k, v in counts.items() if v > 0}
        log(f"[e] {name} rank {r} kernel launches: "
            f"{ {k: v for k, v in counts.items() if v} }")
        if E_DEVICE == "cuda":
            if launched != set(expected) | set(exchange):
                raise AssertionError(f"{name} rank {r} launched {sorted(launched)}, "
                                     f"expected {sorted(set(expected) | set(exchange))}")
            for k, per_step in exchange.items():
                if counts[k] != per_step * steps:
                    raise AssertionError(f"{name} rank {r}: {counts[k]} {k} launches, "
                                         f"want {per_step} in each of {steps} steps")
            n_l = counts.get("locate", 0)
            if (n_l < 1 + walk_steps) if walk_steps else (n_l != 1):
                raise AssertionError(
                    f"{name} rank {r}: {n_l} L launches; want the setup's 1 "
                    + (f"and one or more in each of {walk_steps} steps" if walk_steps
                       else "only (the analytic arm's steps launch no L)"))
        for k, v in counts.items():
            results[k]["launches"] = results[k].get("launches", 0) + v


def e_report(name: str, ranks: list, smi: str) -> dict:
    """Print an arm's setup seconds, median ms/step and per-step split."""
    import statistics

    det = ranks[0]["record"]["detail"]
    setup = {k: max(r["record"]["detail"]["setup_s"][k] for r in ranks)
             for k in det["setup_s"]}
    med = statistics.median(det["step_ms"]) if det["step_ms"] else det["ms_per_step"]
    split = det["split_ms_per_step"] or {}
    log(f"[e] {name} ({det['tag']}, {det['ranks']} rank(s), {det['backend']}, "
        f"E={det['mesh_elems']}): setup seconds (slowest rank): "
        + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
    log(f"[e] {name}: median {med:.3f} ms/step of {det['step_ms']} "
        f"(mean {det['ms_per_step']:.3f}); rank 0's split per step: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(split.items()))
        + f" [{E_LABEL if det['ranks'] > 1 else 'one process, one H100'}; {smi}]")
    log(f"[e] {name}: native host path: {ranks[0]['native']}")
    return {"median_ms": med, "setup_s": setup, "split": split}


def e_check_run(name: str, ranks: list, num_ptcls: int) -> None:
    """Every step: no overflow, unresolved arrival, illegal destination or
    particle lost off its picpart (a destination in the domain that the
    rank's buffer does not hold); alive = the previous alive less the
    step's boundary exits; the reduced
    field equal on every copy of each vertex and its owned-vertex sum equal
    to the charge the ranks deposited (exact: multiples of 1/8).  Particles
    migrate over the run."""
    import numpy as np

    prev, sent = num_ptcls, 0
    gids = [r["vert_gid"].numpy() for r in ranks]
    owned = [r["vert_owner"].numpy() == i for i, r in enumerate(ranks)]
    for i in range(len(ranks[0]["history"])):
        st = ranks[0]["history"][i][0]
        for r in ranks[1:]:
            if any(not torch.equal(st[k], r["history"][i][0][k]) for k in st):
                raise AssertionError(f"{name} step {i}: the ranks' stats differ")
        for k in ("overflow", "unresolved", "illegal_dest", "lost"):
            if int(st[k]) != 0:
                raise AssertionError(f"{name} step {i}: {k} = {int(st[k])}")
        alive, exits = int(st["alive"]), int(st["exits"])
        if alive != prev - exits:
            raise AssertionError(f"{name} step {i}: alive {alive} != {prev} - {exits} exits")
        prev = alive
        sent += int(st["sent"])
        g = np.concatenate(gids)
        v = np.concatenate([r["history"][i][1].numpy() for r in ranks])
        order = np.lexsort((v, g))
        g, v = g[order], v[order]
        same = g[1:] == g[:-1]
        if (v[1:][same] != v[:-1][same]).any():
            raise AssertionError(f"{name} step {i}: a vertex's copies differ")
        owned_sum = sum(float(r["history"][i][1].numpy()[o].astype(np.float64).sum())
                        for r, o in zip(ranks, owned))
        deposited = sum(float(r["history"][i][2].numpy().astype(np.float64).sum())
                        for r in ranks)
        if owned_sum != deposited:
            raise AssertionError(f"{name} step {i}: owned sum {owned_sum} != "
                                 f"deposited {deposited}")
    if len(ranks) > 1 and sent == 0:
        raise AssertionError(f"{name}: no particle migrated")
    log(f"[e] {name}: {len(ranks[0]['history'])} steps checked: alive "
        f"{num_ptcls} -> {prev}, {sent} migrated, field copies equal and the "
        f"owned sum equal to the deposit (exact)")


def e_profile_rank(knobs: dict, steps: int) -> dict:
    """One rank of a picparts arm (``bench_torch.setup_picparts`` with
    ``knobs``): a warm-up step, ``steps`` steps for the wall time and the
    stream's split (``group.SplitTimer``), then ``steps`` more under
    torch.profiler: device busy ms a step and the kernels' device ms."""
    import bench_torch
    from pumipic_torch.parallel import group

    dev = group.device()
    _, state, step, _ = bench_torch.setup_picparts(dev, **knobs)
    state, _ = step(state)
    torch.cuda.synchronize()
    timer = group.SplitTimer()
    group.set_split_timer(timer)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    split = {k: v / steps for k, v in timer.totals().items()}
    group.set_split_timer(None)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.split("(")[0]
            kern[name] = kern.get(name, 0.0) + ev.self_device_time_total / 1e3 / steps
    return {"wall_ms": wall, "split": split, "busy_ms": sum(kern.values()),
            "kernels": dict(sorted(kern.items(), key=lambda kv: -kv[1])[:14])}


def e_series(ranks: list):
    return [(int(st["alive"]), int(st["sent"])) for st, _, _ in ranks[0]["history"]]


def phase_e(results: dict, dev, grid, smi: str) -> None:
    """The distributed runtime: the kernels and libmeshcore built here
    first, then five arms, each a group of rank processes on this card."""
    import bench_torch
    from pumipic_torch import native
    from pumipic_torch.kernels import _build
    from pumipic_torch.parallel.dryrun import dryrun_multirank

    t0 = time.perf_counter()
    if E_DEVICE == "cuda":
        _build.build()
    log(f"[e] kernels and libmeshcore ready in {time.perf_counter() - t0:.2f} s; "
        f"host preprocessing path: {native.path()}")
    base = dict(mesh_path=MESH, num_ptcls=NUM_PTCLS, iters=E_STEPS, cap_factor=E_CAPF,
                buffer_layers=E_BUFFER)

    # 1: the 2D picparts step at full width, 4 ranks over gloo
    ranks = e_launch("bench_torch:picparts_rank", E_RANKS, base)
    e_tally(results, "arm 1 (120k picparts)", ranks, E_WALK, 1 + E_STEPS)
    e_check_run("arm 1 (120k picparts)", ranks, NUM_PTCLS)
    e_report("arm 1 (120k picparts)", ranks, smi)
    del ranks
    if E_DEVICE == "cuda":
        # rank 0's device busy and stream split on arm 1's knobs, beside the
        # torch-op exchange's
        knobs = {k: v for k, v in base.items() if k != "iters"}
        prof = e_launch("chip_smoke:e_profile_rank", E_RANKS,
                        {"knobs": knobs, "steps": E_STEPS})[0]
        log(f"[e] arm 1 rank 0 profiled ({E_STEPS} steps): wall {prof['wall_ms']:.3f} ms, "
            f"device busy {prof['busy_ms']:.3f} ms a step (torch ops: {E_TORCH_OPS['busy']}, "
            f"3-layer buffer); split "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(prof["split"].items()))
            + f" (torch ops: {E_TORCH_OPS}) [{E_LABEL}; {smi}]")
        log(f"[e] arm 1 rank 0 kernels, device ms a step: "
            + ", ".join(f"{k} {v:.4f}" for k, v in prof["kernels"].items()))

    # 2: world size 1 over NCCL
    ranks = e_launch("bench_torch:picparts_rank", 1, base, backend="nccl")
    e_tally(results, "arm 2 (120k, 1 rank, nccl)", ranks, E_WALK, 1 + E_STEPS,
            exchange=E_ONE_RANK)
    e_check_run("arm 2 (120k, 1 rank, nccl)", ranks, NUM_PTCLS)
    e_report("arm 2 (120k, 1 rank, nccl)", ranks, smi)
    del ranks

    # 3: the annulus: analytic with the banded route, neighbour against
    # world exchange, against the walk, and over 2 slices of 2 ranks (the
    # two-stage route for the payload and the reduction)
    ann = dict(base, mesh_path="annulus", mesh_elems=ANNULUS_ELEMS)
    runs = [ann, dict(ann, neighbor_migration=False), dict(ann, analytic_locate="off"),
            dict(ann, slices=2)]
    out = e_launch("bench_torch:picparts_runs", E_RANKS, {"runs": runs})
    arms = {}
    for i, (name, expected, walks, route) in enumerate((
            ("neighbour", E_ANALYTIC, 0, E_BANDED), ("world", E_ANALYTIC, 0, E_BANDED),
            ("walk", E_WALK, 1 + E_STEPS, E_PACKED),
            ("2 x 2 slices", E_ANALYTIC, 0, E_BANDED))):
        ranks = [o[i] for o in out]
        arms[name] = ranks
        e_tally(results, f"arm 3 (annulus, {name})", ranks, expected, walks, route)
        e_check_run(f"arm 3 (annulus, {name})", ranks, NUM_PTCLS)
        e_report(f"arm 3 (annulus, {name})", ranks, smi)
    for other in ("world", "2 x 2 slices"):
        for r in range(E_RANKS):
            for (_, fa, _), (_, fb, _) in zip(arms["neighbour"][r]["history"],
                                              arms[other][r]["history"]):
                if not torch.equal(fa.view(torch.int32), fb.view(torch.int32)):
                    raise AssertionError(f"arm 3: rank {r}'s field differs between the "
                                         f"neighbour arm and the {other} arm")
    a, w, k, h = (e_series(arms[n]) for n in ("neighbour", "world", "walk", "2 x 2 slices"))
    log(f"[e] arm 3 (alive, sent) per step: neighbour {a}, world {w}, walk {k}, "
        f"2 x 2 slices {h}")
    if a != w or a != h:
        raise AssertionError("arm 3: alive/sent differ between the neighbour, the world "
                             "and the sliced exchange")
    log("[e] arm 3: the world exchange and the 2 x 2 slices (hier) equal the neighbour "
        "exchange bit for bit: every rank's field every step, alive, sent")
    # the analytic locate and the walk disagree on a few particles within
    # an ulp of a side (the JAX package's own two arms give the port's
    # counts at 1M particles, scripts/annulus_arms_cpu.py): held to
    # E_WALK_TOL of the particles per step, the differences printed
    diff = [(x[0] - y[0], x[1] - y[1]) for x, y in zip(a, k)]
    log(f"[e] arm 3 analytic - walk (alive, sent) per step: {diff} "
        f"(bound {E_WALK_TOL * NUM_PTCLS:g} each)")
    if any(max(abs(d[0]), abs(d[1])) > E_WALK_TOL * NUM_PTCLS for d in diff):
        raise AssertionError("arm 3: the walk arm strays from the analytic arm")
    del out, arms, ranks

    # 4: FULL mode over 4 ranks against the one-process step, bit for bit
    dp = dict(mesh_path=MESH, num_ptcls=NUM_PTCLS)
    cpu_grid = dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).cpu() for f in dataclasses.fields(grid)
        if isinstance(getattr(grid, f.name), torch.Tensor)})
    t0 = time.perf_counter()
    ranks = e_launch("bench_torch:dp_rank", E_RANKS, dict(dp, locator=cpu_grid))
    log(f"[e] arm 4 (FULL mode, {E_RANKS} ranks): {time.perf_counter() - t0:.2f} s "
        f"with setup; setup seconds rank 0: {ranks[0]['setup_s']}")
    e_tally(results, "arm 4 (FULL mode)", ranks, ("push", "locate", "histogram", "deposit"), 1,
            exchange={})
    from pumipic_torch import kernels

    _, state, step, _ = bench_torch.setup(dev, locator=grid, **dp)
    kernels.reset_launches()
    state, fields = step(state)
    alive = int(state["active"].sum())
    if sum(r["alive_local"] for r in ranks) != alive:
        raise AssertionError("arm 4: alive differs from the one-process step")
    for key in ("fwd", "bwd"):
        for r, out in enumerate(ranks):
            if not torch.equal(out[key], fields[key].cpu()):
                raise AssertionError(f"arm 4: rank {r}'s {key} differs from the "
                                     f"one-process step's")
    log(f"[e] arm 4: the {E_RANKS} ranks' summed fwd and bwd equal the one-process "
        f"step's bit for bit; alive {alive}")
    del state, fields, ranks
    torch.cuda.empty_cache()

    # 5: the dry run, 3D mode included
    counts = dryrun_multirank(E_RANKS, E_DEVICE, "gloo")
    # each picparts mode's 3 steps: Y1 in the mode's form (the 3D mode's
    # Kuhn arm: the g2l row), Y2 and Y3 once a step on every rank
    dry_forms = {"picparts": "route_banded", "picparts-walk": "route_packed",
                 "picparts-3d": "route_g2l"}
    for mode in ("picparts", "picparts-walk", "full-dp", "picparts-3d"):
        for r, out in enumerate(counts["ranks"]):
            got = {k: v for k, v in out[mode]["launches"].items() if v}
            log(f"[e] dryrun {mode} rank {r} kernel launches: {got}")
            if mode in dry_forms and E_DEVICE == "cuda":
                want = {dry_forms[mode]: 3, "balance_keys": 3, "balance_select": 3}
                have = {k: got.get(k, 0) for k in Y_KERNELS if got.get(k, 0) or k in want}
                if have != want:
                    raise AssertionError(f"dryrun {mode} rank {r}: Y1-Y3 launched {have}, "
                                         f"expected {want}")
                for k, v in want.items():
                    results[k]["launches"] = results[k].get("launches", 0) + v
            # the 3D picparts step rebuilds its CSR structure on arrival
            # (migrate_structure): kernels C and Q
            if mode == "picparts-3d" and E_DEVICE == "cuda" and not (
                    got.get("key_sort") and got.get("rebuild_mask")):
                raise AssertionError(f"dryrun picparts-3d rank {r}: no key_sort or "
                                     f"rebuild_mask launch")
    log(f"[e] arm 5 dryrun_multirank({E_RANKS}, {E_DEVICE}, gloo): {counts['seconds']:.1f} s")



def main() -> int:
    import pumipic_torch

    t_run = time.perf_counter()
    pkg = os.path.dirname(os.path.abspath(pumipic_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"pumipic_torch was imported from {pkg}, not from "
                           f"this checkout")
    smi = phase_a()
    results = {name: {} for name in KERNELS}
    phase_b(results)
    dev = torch.device("cuda")
    mesh, grid, band_grid, band_s, grid3d, gitr_mesh, production = phase_c(results, dev, smi)
    phase_d(results, dev, grid, band_grid, band_s, smi)
    phase_d_production(results, dev, *production, smi)
    del production
    torch.cuda.empty_cache()
    run_pps3d(results, dev, grid3d, smi)
    del grid3d
    run_gitr(results, dev, gitr_mesh, smi)
    del gitr_mesh
    for structure in APP_ARMS:
        last = run_app(results, dev, mesh, grid, structure)
        steps = APP_STEPS[structure]
        if "gather" in last:        # G at the app's own order after 20 steps
            check_columns(results, f"columns form, app step-{steps} order", *last["gather"])
        if "slot_map" in last:      # S at the app's own order
            check_slot_map(results, f"{structure}, app step-{steps} order", last["slot_map"])
        if "key_sort" in last:      # C at the app's own order after 20 steps
            elem, active, fill = last["key_sort"]
            check_key_sort(results, f"app step-{steps} order",
                           torch.where(active, elem, fill).to(torch.int32), fill)
            check_masked_key_sort(results, f"fused mode, app step-{steps} order", elem,
                                  active, fill)
        del last
    torch.cuda.empty_cache()
    phase_e(results, dev, grid, smi)
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": results[name]["launches"],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"],
         "bound_by": results[name]["bound_by"],
         "library_ms": results[name].get("library_ms"),
         **results[name]["extra"],
         "cases": [{"case": what, **rec}
                   for what, rec in results[name].get("cases", {}).items()]}
        for name, (route, src, rep) in KERNELS.items()]}
    log(f"[f] the whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
