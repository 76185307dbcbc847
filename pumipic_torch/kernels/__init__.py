"""Hand-written CUDA kernels of the port and their launch counters.

Each kernel has one wrapper in ``pumipic_torch.ops``.  A wrapper runs its
plain PyTorch version only when its tensors lie on the CPU, launches the
kernel when they lie on a CUDA device, and raises otherwise.  Where it
launches, and nowhere else, it adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

# kernel name -> launches since the last reset (a plain integer each)
LAUNCHES = {"push": 0, "push_table": 0, "band_cell": 0, "annulus_locate": 0,
            "locate": 0, "histogram": 0, "deposit": 0, "row_gather": 0,
            "slot_map": 0, "kuhn_locate": 0, "push_wrap": 0, "locate3d": 0,
            "boris": 0, "trace3d": 0, "wall_tally": 0, "trace2d": 0,
            "vdeposit": 0, "rank_in_key": 0, "pack_send": 0,
            "place_arrivals": 0, "owner_reduce": 0, "gitr_update": 0,
            "rebuild_mask": 0, "key_sort": 0, "check_parents": 0,
            "reshuffle_count": 0, "reshuffle_place": 0, "reshuffle_order": 0,
            "scs_row_order": 0, "route_packed": 0, "route_g2l": 0, "route_banded": 0,
            "balance_keys": 0, "balance_select": 0, "slot_counts": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True when the wrapper ``name`` must launch its kernel (all tensors on
    one CUDA device), False when it must run the plain version (all on the
    CPU).  Anything else raises: there is no fallback."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        if dev.index is not None and dev.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensors on {dev}, but the current "
                             f"device is cuda:{torch.cuda.current_device()}")
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{name}: the kernel takes contiguous tensors")
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {dev}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
