"""From-scratch CART decision tree over region performance counters.

The paper (§4.2): "Constructing a decision tree for a selected representative
set of counters could lead to [a] library ... that will be able to suggest
whether reducing or increasing number of threads will speedup the execution
of a given region."

Here the counters are the per-region dry-run/profile features
(:func:`features`), and the label is the winning parallelism-config class
found by exhaustive/greedy search on the training corpus (BOTS-analog suite +
model-zoo regions).  The tree then *predicts* configs for unseen regions
without search — pure numpy, gini splits, no sklearn.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

FEATURE_NAMES = (
    "log_flops", "log_bytes", "log_collective_bytes", "log_link_bytes",
    "arithmetic_intensity", "collective_fraction", "ops",
    "prefix_hit_rate", "fault_rate",
    "step_latency_p99", "queue_delay",
)


def features(c) -> np.ndarray:
    """Counter vector -> feature vector (c: counters.Counters).

    Nodes store feature *indices*, so appending new channels keeps trees
    serialised before the channel existed predict-safe; getattr defaults
    cover counter objects that predate the channel.
    """
    eps = 1.0
    ai = c.flops / (c.bytes + eps)
    coll_frac = c.link_bytes / (c.bytes + c.link_bytes + eps)
    return np.array([
        np.log10(c.flops + eps), np.log10(c.bytes + eps),
        np.log10(c.collective_bytes + eps), np.log10(c.link_bytes + eps),
        ai, coll_frac, float(c.ops),
        float(getattr(c, "prefix_hit_rate", 0.0)),
        float(getattr(c, "fault_rate", 0.0)),
        float(getattr(c, "step_latency_p99", 0.0)),
        float(getattr(c, "queue_delay", 0.0)),
    ])


@dataclasses.dataclass
class Node:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["Node"] = None
    right: Optional["Node"] = None
    label: int = 0
    n: int = 0

    @property
    def is_leaf(self):
        return self.left is None

    def to_json(self):
        if self.is_leaf:
            return {"label": int(self.label), "n": self.n}
        return {"feature": self.feature, "threshold": self.threshold,
                "n": self.n, "left": self.left.to_json(),
                "right": self.right.to_json()}

    @staticmethod
    def from_json(d: dict) -> "Node":
        if "label" in d:
            return Node(label=d["label"], n=d.get("n", 0))
        return Node(feature=d["feature"], threshold=d["threshold"],
                    n=d.get("n", 0), left=Node.from_json(d["left"]),
                    right=Node.from_json(d["right"]))


def _gini(y: np.ndarray) -> float:
    if len(y) == 0:
        return 0.0
    _, counts = np.unique(y, return_counts=True)
    p = counts / len(y)
    return 1.0 - float(np.sum(p * p))


def _best_split(X: np.ndarray, y: np.ndarray):
    n, d = X.shape
    base = _gini(y)
    best = (None, None, 0.0)  # feature, threshold, gain
    for f in range(d):
        values = np.unique(X[:, f])
        if len(values) < 2:
            continue
        thresholds = (values[:-1] + values[1:]) / 2
        for t in thresholds:
            mask = X[:, f] <= t
            nl = int(mask.sum())
            if nl == 0 or nl == n:
                continue
            g = base - (nl * _gini(y[mask]) + (n - nl) * _gini(y[~mask])) / n
            if g > best[2] + 1e-12:
                best = (f, float(t), g)
    return best


class DecisionTree:
    """CART classifier: counter features -> parallelism-config class."""

    def __init__(self, max_depth: int = 6, min_samples: int = 2):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.root: Optional[Node] = None
        self.classes_: list = []

    def fit(self, X: np.ndarray, y: list) -> "DecisionTree":
        self.classes_ = sorted(set(y))
        idx = {c: i for i, c in enumerate(self.classes_)}
        yi = np.array([idx[v] for v in y])
        self.root = self._grow(np.asarray(X, float), yi, 0)
        return self

    def _grow(self, X, y, depth) -> Node:
        majority = int(np.bincount(y).argmax())
        node = Node(label=majority, n=len(y))
        if (depth >= self.max_depth or len(y) < self.min_samples
                or len(np.unique(y)) == 1):
            return node
        f, t, gain = _best_split(X, y)
        if f is None or gain <= 0:
            return node
        mask = X[:, f] <= t
        node.feature, node.threshold = f, t
        node.left = self._grow(X[mask], y[mask], depth + 1)
        node.right = self._grow(X[~mask], y[~mask], depth + 1)
        return node

    def predict_one(self, x: np.ndarray):
        node = self.root
        while not node.is_leaf:
            node = node.left if x[node.feature] <= node.threshold else node.right
        return self.classes_[node.label]

    def predict(self, X: np.ndarray) -> list:
        return [self.predict_one(np.asarray(x, float)) for x in X]

    def score(self, X, y) -> float:
        pred = self.predict(X)
        return float(np.mean([p == t for p, t in zip(pred, y)]))

    # -- persistence --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"classes": self.classes_,
                           "max_depth": self.max_depth,
                           "tree": self.root.to_json()})

    @staticmethod
    def from_json(text: str) -> "DecisionTree":
        d = json.loads(text)
        t = DecisionTree(max_depth=d["max_depth"])
        t.classes_ = d["classes"]
        t.root = Node.from_json(d["tree"])
        return t
