"""Incremental decision-tree retraining: the "train" stage, online.

The offline tuner fits one tree once, from one search corpus.  Online the
corpus keeps growing (the serve engine taps its own measured counters and
tok/s rewards in), so the tree must be refit as evidence accumulates — but
never blindly: a retrained tree replaces the incumbent only when it is at
least as good on a held-out slice of the corpus (the holdout regret
check), so a noisy retrain can never make serving decisions worse.

Retraining triggers on observation count (every ``interval`` raw
observations) or on novelty (a class never seen before — e.g. the explorer
just tried a candidate the offline search skipped).
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from repro_torch.autotune.corpus import Corpus
from repro_torch.core.dtree import DecisionTree


def holdout_value(tree, groups) -> float:
    """Mean observed reward a tree's predictions would earn over
    measurement-point groups (``Corpus.groups()``-shaped).

    For rewarded points the tree earns the mean reward observed for the
    class it predicts — or, pessimistically, the worst observed reward
    when it predicts a class never measured there (unmeasured != good).
    When no point carries a reward (pure offline corpus) the value falls
    back to label accuracy.
    """
    reward_vals, acc_vals = [], []
    for _, feat, cls_map in groups:
        pred = tree.predict_one(np.asarray(feat))
        rewarded = {c: r for c, r in cls_map.items() if r is not None}
        if rewarded:
            reward_vals.append(rewarded.get(pred, min(rewarded.values())))
        else:
            acc_vals.append(1.0 if pred in cls_map else 0.0)
    if reward_vals:
        return float(np.mean(reward_vals))
    if acc_vals:
        return float(np.mean(acc_vals))
    return 0.0


def _holdout_split(groups, holdout_frac: float):
    """Deterministic split by a stable hash of the measurement point, so
    the same corpus always yields the same holdout (process-salt-free —
    builtin ``hash`` on str is salted)."""
    cut = int(round(holdout_frac * 100))
    train, hold = [], []
    for g in groups:
        h = zlib.crc32(repr((g[0], g[1])).encode()) % 100
        (hold if h < cut else train).append(g)
    if not train or not hold:       # tiny corpus: score on everything
        return groups, groups
    return train, hold


class OnlineTrainer:
    """Refit-and-gate loop around :class:`repro_torch.core.dtree.DecisionTree`.

    ``maybe_retrain(corpus, current_tree)`` returns a new tree to swap in,
    or None (not triggered / not enough data / new tree lost the holdout
    check).  The caller owns the swap.
    """

    def __init__(self, interval: int = 32, min_samples: int = 1,
                 holdout_frac: float = 0.25, tree_kw: Optional[dict] = None):
        self.interval = max(int(interval), 1)
        self.min_samples = min_samples
        self.holdout_frac = holdout_frac
        self.tree_kw = dict(tree_kw or {"max_depth": 4})
        self.retrain_count = 0      # trees actually fit
        self.reject_count = 0       # fits that lost the holdout check
        self._seen_obs = 0
        self._seen_classes: set = set()

    def should_retrain(self, corpus: Corpus) -> bool:
        if len(corpus) == 0:
            return False
        fresh = corpus.observations - self._seen_obs
        if fresh <= 0:
            return False
        return (fresh >= self.interval
                or bool(corpus.classes() - self._seen_classes))

    def maybe_retrain(self, corpus: Corpus,
                      current_tree=None) -> Optional[DecisionTree]:
        if not self.should_retrain(corpus):
            return None
        self._seen_obs = corpus.observations
        self._seen_classes = set(corpus.classes())

        groups = corpus.groups()
        train_groups, hold_groups = _holdout_split(groups, self.holdout_frac)
        train_corpus = Corpus()
        for region, feat, cls_map in train_groups:
            for cls, reward in cls_map.items():
                train_corpus.append(region, feat, cls,
                                    float("nan") if reward is None else reward)
        X, y = train_corpus.training_data()
        if len(y) < self.min_samples:
            return None
        self.retrain_count += 1
        candidate = DecisionTree(**self.tree_kw).fit(X, y)
        if current_tree is None:
            return candidate
        # holdout regret check: never swap in a worse tree
        if (holdout_value(candidate, hold_groups)
                >= holdout_value(current_tree, hold_groups) - 1e-12):
            return candidate
        self.reject_count += 1
        return None
