"""Device resolution of the port's entry points.

Every public constructor and entry point takes ``device=None`` and resolves
it here: a device that is named is used as given; no device means the CUDA
card, and where there is none the call raises.  The CPU runs (with each
kernel's plain PyTorch version) only where ``device="cpu"`` is passed.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)``, or ``cuda`` when ``device`` is None; raises
    when no device is named and no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device=\"cpu\" "
                           "to run the kernels' plain versions on the CPU")
    return torch.device("cuda")
