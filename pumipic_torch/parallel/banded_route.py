"""Gather-free particle routing for sector-band picparts on a proven
structured annulus (port of ``pumipic_tpu.parallel.banded_route``).

Where the partition is a sector-band decomposition of a detection-proven
annulus, each rank's local element id, destination, sbar and non-core
flag are functions of the (ring, sector, triangle) indices of the global
analytic locate, so the step computes them elementwise (kernel Y1's
banded form, :func:`banded_decode`) instead of gathering the [g2l | route]
row.
:func:`derive_banded_route` checks every formula against the generic
picparts and balancer tables over every element and returns None on any
mismatch (callers then keep the gather).  Local ids follow from
``build_picparts`` numbering a rank's elements by ascending global id:
``ring·2W + gidx(sector)·2 + tri`` on a window of W sectors whose
wrapped sectors sort first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pumipic_torch.ops import route as rt

INVALID = -1


@dataclass(frozen=True)
class BandedRoute2D:
    """Per-rank window and safe-interval scalars ((R,) f32 exact small
    integers, on the host) and the global structure; ``sbar_runs``:
    ((lo, hi, sbar), ...) sector runs of the global sbar map."""

    win_a: np.ndarray
    win_w: np.ndarray
    win_w0: np.ndarray
    win_nsa: np.ndarray
    safe_a: np.ndarray
    safe_len: np.ndarray
    n_sectors: int = 1
    n_rings: int = 1
    num_ranks: int = 1
    sbar_runs: tuple = ()

    def scalars(self, r: int):
        """Rank r's (a, w, w0, nsa, sa, sl) as Python floats."""
        return tuple(float(v[r]) for v in (self.win_a, self.win_w, self.win_w0,
                                             self.win_nsa, self.safe_a, self.safe_len))

    def params(self, r: int) -> rt.BandedParams:
        """Rank r's constants of kernel Y1's banded form."""
        return rt.BandedParams(r, self.num_ranks, self.n_sectors, self.scalars(r),
                               self.sbar_runs)


def banded_decode(br: BandedRoute2D, ring_f, sec_f, tri_f, valid, active, me: int,
                  a: float, w: float, w0: float, nsa: float, sa: float, sl: float):
    """(lid, dest, sbar, noncore) from the f32 (ring, sector, tri) indices
    of an element id (each in range), in the JAX package's f32 arithmetic:
    kernel Y1's banded form on the element id they make
    (:func:`pumipic_torch.ops.route.route_banded`)."""
    Ns = br.n_sectors
    e = (ring_f.to(torch.int32) * (2 * Ns) + sec_f.to(torch.int32) * 2
         + tri_f.to(torch.int32))
    e_gl = torch.where(valid, e, INVALID).to(torch.int32)
    p = rt.BandedParams(me, br.num_ranks, Ns, (a, w, w0, nsa, sa, sl), br.sbar_runs)
    r = rt.route_banded(p, e_gl, active, gelem=False)
    return r.elem, r.dest, r.sbar, r.noncore


def sector_band_owners(n_rings: int, n_sectors: int, num_ranks: int) -> np.ndarray:
    """owner(e) = floor(sector·R / Ns) on the generator's element order."""
    gid = np.arange(2 * n_rings * n_sectors)
    return (((gid // 2) % n_sectors) * num_ranks) // n_sectors


def _circular_interval(present: np.ndarray) -> Optional[Tuple[int, int]]:
    """(start, length) of the single circular run of True, or None."""
    Ns = present.shape[0]
    if present.all():
        return 0, Ns
    if not present.any():
        return None
    starts = np.nonzero(present & ~np.roll(present, 1))[0]
    if len(starts) != 1:
        return None
    a = int(starts[0])
    length = int(present.sum())
    if not present[(a + np.arange(length)) % Ns].all():
        return None
    return a, length


def derive_banded_route(pp, owners: np.ndarray, analytic, bt,
                        num_ranks: int) -> Optional[BandedRoute2D]:
    """The banded routing structure, checked against the picparts (owner
    per sector, rectangular windows, the local-id formula, per-rank safe
    intervals) and the balancer tables (sector-constant sbars); None where
    anything is not banded."""
    R = num_ranks
    Ns, Nr = analytic.n_sectors, analytic.n_rings
    E_g = 2 * Nr * Ns
    if E_g >= (1 << 24) or owners.shape[0] != E_g:
        return None
    gid = np.arange(E_g)
    ring, sec, tri = gid // (2 * Ns), (gid // 2) % Ns, gid & 1
    own_sec = np.full(Ns, -1, np.int64)
    own_sec[sec] = owners
    if not np.array_equal(own_sec[sec], owners):
        return None
    formula = np.floor(sec.astype(np.float32) * np.float32(R) / np.float32(Ns))
    if not np.array_equal(formula.astype(np.int64), owners):
        return None
    eg = np.asarray(pp.elem_gid)
    es = np.asarray(pp.elem_safe)
    vals = np.zeros((6, R), np.float32)
    for r in range(R):
        valid = eg[r] >= 0
        g = eg[r][valid]
        lids = np.nonzero(valid)[0]
        present = np.zeros(Ns, bool)
        present[sec[g]] = True
        iv = _circular_interval(present)
        if iv is None:
            return None
        a, W = iv
        if len(g) != Nr * W * 2 or Nr * 2 * W >= (1 << 24):
            return None
        w0 = max(a + W - Ns, 0)
        pos = (sec[g] - a) % Ns
        gidx = np.where(pos >= Ns - a, pos + a - Ns, pos + w0)
        if not np.array_equal(ring[g] * (2 * W) + gidx * 2 + tri[g], lids):
            return None
        fl = es[r][valid].astype(bool)
        seen_safe = np.zeros(Ns, bool)
        seen_unsafe = np.zeros(Ns, bool)
        seen_safe[sec[g][fl]] = True
        seen_unsafe[sec[g][~fl]] = True
        if (seen_safe & seen_unsafe).any():
            return None
        iv_s = _circular_interval(seen_safe)
        if iv_s is None:
            if seen_safe.any():
                return None
            iv_s = (0, 0)
        vals[:, r] = (a, W, w0, Ns - a, iv_s[0], iv_s[1])
    runs = ()
    if bt is not None:
        sb = np.asarray(bt.sbar_of_elem)
        mn = np.full(Ns, np.iinfo(np.int64).max)
        mx = np.full(Ns, np.iinfo(np.int64).min)
        for r in range(R):
            valid = eg[r] >= 0
            np.minimum.at(mn, sec[eg[r][valid]], sb[r][valid].astype(np.int64))
            np.maximum.at(mx, sec[eg[r][valid]], sb[r][valid].astype(np.int64))
        seen = mx >= mn
        if (seen & (mn != mx)).any():
            return None
        sb_sec = np.where(seen, mn, -1)
        out, s = [], 0
        while s < Ns:
            v, e = sb_sec[s], s
            while e < Ns and sb_sec[e] == v:
                e += 1
            if v >= 0:
                out.append((int(s), int(e), int(v)))
            s = e
        if len(out) > 4 * R + 4:
            return None
        runs = tuple(out)
    return BandedRoute2D(*vals, n_sectors=Ns, n_rings=Nr, num_ranks=R,
                         sbar_runs=runs)
