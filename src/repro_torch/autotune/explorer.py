"""Epsilon-greedy exploration over the candidate menu.

The offline search can only label classes it can evaluate by re-counting —
``serve_only`` knobs (speculation depth) are invisible to it, so a tree
trained purely offline can never vote for them.  The explorer closes that
gap at serve time: with probability ``eps`` (and while a hard budget
lasts) it overrides the decider's greedy choice with a random candidate
from the menu, so live traffic populates corpus classes the search never
tried.  The engine attributes the following steps' measured reward to the
explored class, and the next retrain can learn it.

Exploration is strictly opt-in: ``eps=0`` (the ``--no-explore`` launcher
path) makes :meth:`maybe_explore` a guaranteed no-op, so greedy serving
output stays bit-identical to the unexplored engine.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.autotune.candidates import Candidate, explore_menu
from repro_torch.core.policy import RegionConfig, RegionPlan


def overlay(base: RegionConfig, cand: RegionConfig) -> RegionConfig:
    """Layer a candidate onto an existing region config: rules merge, and
    only knobs the candidate explicitly sets (non-default) override — a
    hand-tuned base plan keeps its block sizes when the tree votes a
    rules-only candidate."""
    defaults = RegionConfig()
    out = dataclasses.replace(base, rules={**base.rules, **cand.rules})
    for f in dataclasses.fields(RegionConfig):
        if f.name == "rules":
            continue
        v = getattr(cand, f.name)
        if v != getattr(defaults, f.name):
            out = dataclasses.replace(out, **{f.name: v})
    return out


class EpsilonGreedyExplorer:
    """Budget-capped epsilon-greedy override of the decider's plan."""

    def __init__(self, eps: float = 0.1, budget: int = 64, seed: int = 0,
                 candidates: Optional[Sequence[Candidate]] = None,
                 region: str = "layer/attn"):
        self.eps = float(eps)
        self.budget = int(budget)
        self.region = region
        self.menu = list(candidates) if candidates is not None \
            else explore_menu("decode")
        self.explored = 0           # exploration decisions taken so far
        self._rng = np.random.default_rng(seed)

    @property
    def active(self) -> bool:
        return bool(self.menu) and self.eps > 0 and self.explored < self.budget

    def maybe_explore(self, plan: RegionPlan,
                      region: Optional[str] = None
                      ) -> Optional[Tuple[str, RegionPlan]]:
        """With probability ``eps`` (while budget lasts): a copy of ``plan``
        with a uniformly random menu candidate overlaid on ``region``,
        returned as ``(class_name, plan)``; otherwise None (exploit)."""
        if not self.active or self._rng.random() >= self.eps:
            return None
        cand = self.menu[int(self._rng.integers(len(self.menu)))]
        self.explored += 1
        region = region or self.region
        out = copy.deepcopy(plan)
        base = out.region_configs.get(region, RegionConfig())
        out.region_configs[region] = overlay(base, cand.config)
        return cand.name, out
