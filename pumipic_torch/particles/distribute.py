"""Particle-per-element distribution generators (host, numpy).

Reference parity: ``particle_structs/test/Distribute.cpp`` — strategies
0=Evenly, 1=Uniform(random element per particle), 2=Gaussian (element counts
drawn around the mesh-center element), 3=Exponential, 4="GITRm Approximation"
(most particles in a small contiguous band of elements).  Used both by the
unit-test matrix and by the ps_combo performance harness
(performance_tests/ps_combo264.cpp:96-131).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

STRATEGIES = ("even", "uniform", "gaussian", "exponential", "gitrm")


def distribute_particles(
    num_elems: int, num_ptcls: int, strategy, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (ptcls_per_elem (E,), ptcl_elems (N,)) for a named or indexed
    strategy."""
    if isinstance(strategy, int):
        strategy = STRATEGIES[strategy]
    rng = np.random.default_rng(seed)
    E, N = num_elems, num_ptcls

    if E == 0 or N == 0:
        return np.zeros(E, np.int64), np.zeros(0, np.int64)

    if strategy == "even":
        p, r = divmod(N, E)
        ppe = np.full(E, p, np.int64)
        ppe[:r] += 1
    elif strategy == "uniform":
        elems = rng.integers(0, E, size=N)
        ppe = np.bincount(elems, minlength=E).astype(np.int64)
        return ppe, np.sort(elems)
    elif strategy == "gaussian":
        center = E / 2.0
        x = rng.normal(center, E / 10.0, size=N)
        elems = np.clip(np.round(x), 0, E - 1).astype(np.int64)
        ppe = np.bincount(elems, minlength=E).astype(np.int64)
        return ppe, np.sort(elems)
    elif strategy == "exponential":
        # reference: exponential with rate 4 over the normalized element axis
        x = rng.exponential(1.0 / 4.0, size=N)
        elems = np.clip((x * E).astype(np.int64), 0, E - 1)
        ppe = np.bincount(elems, minlength=E).astype(np.int64)
        return ppe, np.sort(elems)
    elif strategy == "gitrm":
        # GITRm approximation: ~90% of particles in the first 10% of elements
        band = max(E // 10, 1)
        n_band = int(N * 0.9)
        e1 = rng.integers(0, band, size=n_band)
        e2 = rng.integers(0, E, size=N - n_band)
        elems = np.concatenate([e1, e2])
        ppe = np.bincount(elems, minlength=E).astype(np.int64)
        return ppe, np.sort(elems)
    else:
        raise ValueError(f"unknown strategy {strategy}")

    # expand ppe -> sorted element id per particle
    elems = np.repeat(np.arange(E, dtype=np.int64), ppe)
    return ppe, elems


def distribute_elements(num_elems: int, strategy: int = 0, offset: int = 0) -> np.ndarray:
    """Element global ids for one rank (Distribute.cpp:307-311): contiguous
    block starting at ``offset``."""
    return np.arange(offset, offset + num_elems, dtype=np.int64)
