"""Core scalar types: int32 local ids, int32 global ids on the device
(int64 on the host) and float32 reals, as in ``pumipic_tpu.utils.types``."""
from __future__ import annotations

import numpy as np
import torch

# local (on-device) id type: indexes elements/particles
LID_DTYPE = torch.int32
# global id type on the device (meshes of fewer than 2^31 entities) and on
# the host (partitioning, checkpoints)
GID_DTYPE = torch.int32
GID_HOST_DTYPE = np.int64
# real type for coordinates/fields
REAL_DTYPE = torch.float32

INVALID = -1  # sentinel for "no element / removed particle"


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    """Ceiling division of integers."""
    return -(-a // b)
