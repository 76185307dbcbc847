"""Per-rank slot capacity of the distributed particle state, resized from
the step's telemetry (port of ``pumipic_tpu.parallel.capacity``).

Every particle-rate op of the step runs at capacity width, so idle slots
cost time each step; the reference re-sizes its views when a rebuild's
counts misfit (scs_input.hpp:15-64, SCS_rebuild.h:3-120).
:class:`CapacityMonitor` takes each step's ``stats`` (``alive_per_rank``,
``sent_per_rank``, ``kept_home``) and :meth:`CapacityMonitor.apply`
resizes every rank's state together between steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from pumipic_torch.parallel import group

__all__ = ["CapacityPolicy", "CapacityMonitor", "resize_capacity"]

# integer id fields padded with -1 (others with 0; "active" with False)
_ID_FIELDS = ("elem", "pid", "gelem")


def resize_capacity(state: Dict[str, torch.Tensor], new_cap: int
                    ) -> Dict[str, torch.Tensor]:
    """This rank's flat (cap, ...) state at ``new_cap`` slots.  Shrinking
    moves the live particles to a slot prefix first (stable order); growing
    appends empty slots.  Raises on every rank when ``new_cap`` is below
    the largest live count of any rank."""
    act = state["active"]
    live_max = int(group.all_gather(act.sum(dtype=torch.int64)).max())
    if new_cap < live_max:
        raise ValueError(f"new_cap {new_cap} < max live {live_max}")
    cur = act.shape[0]
    if new_cap == cur:
        return state
    out = {}
    if new_cap < cur:
        order = torch.argsort((~act).to(torch.uint8), stable=True)[:new_cap]
        keep = act[order]
        for k, v in state.items():
            a = v[order]
            if k in _ID_FIELDS:
                a = torch.where(keep, a, -1)
            elif k == "active":
                a = keep
            out[k] = a
    else:
        pad = new_cap - cur
        for k, v in state.items():
            fill = -1 if k in _ID_FIELDS else (False if k == "active" else 0)
            out[k] = torch.cat([v, torch.full((pad,) + tuple(v.shape[1:]), fill,
                                              dtype=v.dtype, device=v.device)])
    return out


@dataclass(frozen=True)
class CapacityPolicy:
    """needed = max_alive·alive_headroom + sent_factor·max(max_sent,
    sent_floor) + slack; shrink only for a gain of ``shrink_min_gain`` of
    the capacity, grow by ``grow_factor``."""

    alive_headroom: float = 1.02
    sent_factor: int = 4
    sent_floor: int = 16
    slack: int = 64
    shrink_min_gain: float = 0.05
    grow_factor: float = 1.25

    def needed(self, max_alive: int, max_sent: int) -> int:
        return (int(max_alive * self.alive_headroom)
                + self.sent_factor * max(max_sent, self.sent_floor) + self.slack)


class CapacityMonitor:
    """Accumulates the steps' telemetry and resizes when warranted."""

    def __init__(self, policy: CapacityPolicy = CapacityPolicy()):
        self.policy = policy
        self.max_alive = 0
        self.max_sent = 0
        self.kept_home = 0
        self.steps = 0

    def observe(self, stats: Dict[str, torch.Tensor]) -> None:
        self.max_alive = max(self.max_alive, int(stats["alive_per_rank"].max()))
        self.max_sent = max(self.max_sent, int(stats["sent_per_rank"].max()))
        if "kept_home" in stats:
            self.kept_home += int(stats["kept_home"])
        self.steps += 1

    def recommend(self, cur_cap: int) -> Optional[int]:
        if self.steps == 0:
            return None
        need = self.policy.needed(self.max_alive, self.max_sent)
        if need > cur_cap or self.kept_home > 0:
            return max(int(need * self.policy.grow_factor),
                       int(cur_cap * self.policy.grow_factor), cur_cap + 1)
        if need <= cur_cap * (1.0 - self.policy.shrink_min_gain):
            return need
        return None

    def apply(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``state`` resized per :meth:`recommend`; the window restarts."""
        new_cap = self.recommend(state["active"].shape[0])
        if new_cap is None:
            return state
        out = resize_capacity(state, new_cap)
        self.max_alive = self.max_sent = self.kept_home = self.steps = 0
        return out
