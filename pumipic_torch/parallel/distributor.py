"""Distributor: the ranks a rank may send particles to (port of
``pumipic_tpu.parallel.distributor``; ``Distributor<Space>``,
particle_structs/src/support/psDistributor.hpp:9-137).

``is_neighbor[r, s]``: rank r may send to rank s (the diagonal is always
set).  Host data: the neighbour exchange's split sizes come from it, so it
never needs the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Distributor:
    is_neighbor: np.ndarray     # (R, R) bool
    num_ranks: int = 1

    def neighbor_counts(self) -> np.ndarray:
        return self.is_neighbor.sum(axis=1)


def world_distributor(num_ranks: int) -> Distributor:
    """Every rank may send to every rank."""
    return Distributor(np.ones((num_ranks, num_ranks), bool), num_ranks)


def from_picparts(pp) -> Distributor:
    """Neighbours: the owners of the elements buffered in each picpart."""
    eo = np.asarray(pp.elem_owner)
    R = pp.num_ranks
    nb = np.zeros((R, R), bool)
    for r in range(R):
        nb[r, np.unique(eo[r][eo[r] >= 0])] = True
        nb[r, r] = True
    return Distributor(nb, R)
