"""Device memory telemetry (port of ``pumipic_tpu.utils.memory``).

Reference parity: ``support/ppMemUsage.hpp:25-34`` (``getMemUsage`` via
cudaMemGetInfo) and the per-step memory-imbalance telemetry in
``test/pseudoXGCm.cpp:17-39``.  On a CUDA device this is
``torch.cuda.mem_get_info``; a CPU device gives no figures, (0, 0), as the
JAX package reports for a device without memory stats.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def get_mem_usage(device=None) -> Tuple[int, int]:
    """Return (free_bytes, total_bytes) for one device; (0, 0) if unknown
    (a CPU device, or no CUDA device when ``device`` is None)."""
    if device is None:
        if not torch.cuda.is_available():
            return (0, 0)
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return (0, 0)
    free, total = torch.cuda.mem_get_info(device)
    return (int(free), int(total))


def memory_imbalance() -> Dict[str, float]:
    """Max/avg used-bytes imbalance across the visible CUDA devices
    (pseudoXGCm.cpp:17-39); 1.0 without a CUDA device."""
    used = []
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        free, total = get_mem_usage(torch.device("cuda", i))
        used.append(total - free)
    if not used or sum(used) == 0:
        return {"max": 0, "avg": 0.0, "imbalance": 1.0}
    avg = sum(used) / len(used)
    return {"max": max(used), "avg": avg, "imbalance": max(used) / avg if avg else 1.0}
