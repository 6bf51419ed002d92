"""Elastic restart + straggler telemetry, on PyTorch.

* ``reshard``/``block``: place a (logically unsharded) state on the
  device training resumes on — whole on one device, or, when the plan
  carries a mesh, each leaf's block for this rank (the recovery path
  after losing a node: restart with a smaller data axis, reload the last
  checkpoint, each leaf cut to its block as it is read, the moments at
  their ZeRO-1 blocks, and keep training).  Data order stays exact
  because the pipeline is a pure function of (seed, step)
  (data/pipeline.py).
* ``StepWatchdog``: per-step walltime telemetry with a robust z-score flag —
  you cannot drop a straggler mid-step, but you can detect it, alert, and
  evict-and-resume (checkpoint + restart).
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.policy import RegionPlan, legal_spec
from repro_torch.distributed.sharding import mesh_coords, shard_leaf
from repro_torch.models import layers as L


def reshard(state: Any, axes_tree: Any = None,
            plan: Optional[RegionPlan] = None,
            device: DeviceLike = None) -> Any:
    """Every leaf of ``state`` on ``device`` (``cuda`` unless named).
    With a mesh on ``plan``, this rank's block of each leaf (:func:`block`)
    at the plan-legal spec of the leaf's logical axes (``axes_tree``, the
    state's structure; a leaf without axes stays whole).  Without one,
    the whole leaf.  A restored train state, whose moments sit at their
    ZeRO-1 blocks, is cut leaf by leaf as it is read
    (``checkpoint.restore`` with specs)."""
    dev = resolve_device(device)
    if plan is None or plan.mesh is None:
        return L.tree_map(lambda x: x.to(dev), state)
    coords = mesh_coords(plan.mesh)

    def put(x, axes):
        axes = tuple(axes) if axes else (None,) * x.ndim
        spec = legal_spec(x.shape, axes, plan.rules, plan.mesh)
        return block(x, spec, plan.mesh, coords, dev)

    return _map2(put, state, axes_tree)


def block(x: Any, spec: tuple, mesh, coords: dict,
          device: DeviceLike = None, dtype=None) -> Any:
    """This rank's block of the whole leaf ``x`` under ``spec`` at its
    mesh ``coords`` (``sharding.shard_leaf``), on ``device`` in ``dtype``
    (``x``'s unless named), in storage of its own, so that the whole leaf
    can be freed."""
    blk = shard_leaf(x, spec, mesh, coords)
    if blk.numel() < x.numel():
        # a block split on the leading dim is a view of the whole leaf
        blk = blk.clone()
    return blk.to(device=resolve_device(device), dtype=dtype or x.dtype)


def _map2(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k] if b is not None else None)
                for k in sorted(a)}
    return fn(a, b)


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
