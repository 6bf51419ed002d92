"""Elastic restart + straggler telemetry, on PyTorch.

* ``reshard``: place a (logically unsharded) restored train state on the
  device training resumes on.  A port plan carries no mesh, so every leaf
  goes whole to one device; sharding over several is ROADMAP queue 1 item
  14.  Data order stays exact because the pipeline is a pure function of
  (seed, step) (data/pipeline.py).
* ``StepWatchdog``: per-step walltime telemetry with a robust z-score flag —
  you cannot drop a straggler mid-step, but you can detect it, alert, and
  evict-and-resume (checkpoint + restart).
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.policy import RegionPlan
from repro_torch.models import layers as L


def reshard(state: Any, axes_tree: Any = None,
            plan: Optional[RegionPlan] = None,
            device: DeviceLike = None) -> Any:
    """Every leaf of ``state`` on ``device`` (``cuda`` unless named); the
    logical axes and the plan's rules are accepted for the JAX package's
    signature and place nothing on one device."""
    dev = resolve_device(device)
    return L.tree_map(lambda x: x.to(dev), state)


class StepWatchdog:
    """Flags steps (hosts) whose walltime deviates from the running median."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: list[float] = []
        self._t0: Optional[float] = None
        self.flagged: list[int] = []

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        hist = np.array(self.times[-self.window:])
        med = np.median(hist)
        mad = np.median(np.abs(hist - med)) + 1e-9
        is_straggler = len(hist) >= 10 and (dt - med) / (1.4826 * mad) > self.threshold
        if is_straggler:
            self.flagged.append(step)
        return bool(is_straggler)
