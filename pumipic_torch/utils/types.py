"""Core scalar types: int32 local ids and float32 reals, as in
``pumipic_tpu.utils.types``."""
from __future__ import annotations

import torch

# local (on-device) id type: indexes elements/particles
LID_DTYPE = torch.int32
# real type for coordinates/fields
REAL_DTYPE = torch.float32

INVALID = -1  # sentinel for "no element / removed particle"


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m
