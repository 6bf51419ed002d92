"""The serve-time "decide" stage: counters -> DecisionTree -> RegionPlan.

This is the paper's §4.2 proposal ("suggest ... without search") running in
the serving hot path: the engine hands the decider its measured per-region
step counters scaled by pool occupancy; the tree classifies each hot
region's feature vector into a candidate class; the candidate's
RegionConfig is overlaid onto the live plan.  No search is re-run.

The tree is a *swappable handle*: :meth:`PlanDecider.swap` installs a
newly retrained tree and bumps :attr:`version`, which the engine watches
to invalidate its load-bucket replan latch — without the bump, a new tree
would silently never take effect until the next occupancy-bucket change.
"""
from __future__ import annotations

import copy

from repro_torch.autotune.candidates import canonical, default_candidates
from repro_torch.autotune.explorer import overlay
from repro_torch.core.policy import RegionConfig, RegionPlan


class PlanDecider:
    """Counters -> DecisionTree -> RegionPlan, the paper loop at serve time.

    The tree's classes are the tuner's candidate names (the corpus emitted
    by the offline search and/or the engine's own serve-time tap);
    ``decide`` looks at the hottest regions of a measured step, scales
    their counters by pool occupancy (``load_frac``) so the prediction
    tracks load, and applies the predicted candidate's RegionConfig
    wherever it is applicable.  A decider built with ``tree=None`` (online
    cold start: no offline corpus yet) decides nothing until the first
    retrain swaps a tree in.
    """

    def __init__(self, tree, kind: str = "decode", candidates=None):
        self.tree = tree
        self.version = 0            # bumped by swap(); engines watch this
        self.by_name = {c.name: c for c in
                        (candidates if candidates is not None
                         else default_candidates(kind))}

    def swap(self, tree) -> int:
        """Install a (re)trained tree; returns the new version."""
        self.tree = tree
        self.version += 1
        return self.version

    def decide(self, rc, base_plan: RegionPlan, load_frac: float = 1.0,
               top_n: int = 2):
        """Returns (plan, decisions): decisions is [(region_prefix, class)]."""
        from repro_torch.core.dtree import features
        plan = copy.deepcopy(base_plan)
        decisions: list = []
        if self.tree is None:
            return plan, decisions
        seen: set = set()
        for region_name, _ in rc.top_regions("flops", 16):
            prefix = canonical(region_name)
            if prefix in seen:
                continue
            seen.add(prefix)
            cls = self.tree.predict_one(
                features(rc.regions[region_name].scaled(load_frac)))
            cand = self.by_name.get(cls)
            if cand is not None and cand.applies_to in prefix:
                base = plan.region_configs.get(prefix, RegionConfig())
                plan.region_configs[prefix] = overlay(base, cand.config)
            decisions.append((prefix, cls))
            if len(seen) >= top_n:
                break
        return plan, decisions

    def applied_class(self, prefix: str, cls: str) -> str:
        """The class actually in effect for ``prefix`` after a decision:
        the vote when its candidate is applicable there, else the default
        (reward attribution must follow what shaped the step, not what the
        tree said)."""
        cand = self.by_name.get(cls)
        if cand is not None and cand.applies_to in prefix:
            return cls
        return "keep_default"
