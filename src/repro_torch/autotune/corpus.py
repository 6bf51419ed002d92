"""The observation corpus: the "measure" stage's persistent output.

Append-only store of ``(region, features, chosen_class, reward)``
observations — the paper's per-region counter measurements labelled with
the parallelism-config class that was in effect and (online) the reward it
earned (tok/s).  Offline search corpora (the tuner's
``(features, winning_class)`` pairs, no reward) merge into the same store,
so one corpus can hold both ahead-of-time search results and live serve
traffic.

Dedup: observations with identical ``(region, features, class)`` collapse
into one entry whose reward is the running mean over ``n`` observations —
repeated identical measurements sharpen an estimate instead of bloating
the store.  Persistence is line-per-entry JSONL (append-friendly,
merge-on-load).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Iterable, Sequence, Tuple

import numpy as np

# feature vectors are rounded before keying so float jitter from identical
# measurements cannot defeat dedup
_ROUND = 9

OFFLINE_REGION = "offline"          # region tag for merged search corpora


def _fkey(features) -> Tuple[float, ...]:
    return tuple(round(float(v), _ROUND) for v in np.asarray(features).ravel())


def bucket_rate(rate: float, levels: int = 10) -> float:
    """Quantize a [0, 1] rate to ``levels`` buckets before featurising.

    Raw hit rates carry per-window float jitter; keyed at ``_ROUND``
    decimals every window would mint a fresh measurement point and the
    dedup/running-mean machinery above would never merge anything.
    Deciles keep the signal (cold / warming / hot) without the shatter.
    """
    r = min(max(float(rate), 0.0), 1.0)
    return round(math.floor(r * levels) / levels, _ROUND) if r < 1.0 else 1.0


def bucket_log_ms(seconds: float, steps_per_decade: int = 4) -> float:
    """Quantize a latency (seconds) to coarse ``log10(1 + ms)`` steps.

    The latency Counters channels (``step_latency_p99``,
    ``queue_delay``) need the same treatment as the rates above: raw
    per-window latencies would shatter dedup, and absolute milliseconds
    would dwarf the other features.  ``log10(1 + ms)`` compresses
    microseconds-to-minutes into roughly [0, 5] and is 0 exactly at zero
    delay; flooring to ``steps_per_decade`` levels per decade keeps
    windows with the same latency regime merging."""
    ms = max(float(seconds), 0.0) * 1e3
    v = math.log10(1.0 + ms)
    return round(math.floor(v * steps_per_decade) / steps_per_decade, _ROUND)


@dataclasses.dataclass
class CorpusEntry:
    """One deduplicated observation (``n`` raw observations merged; the
    reward is the mean over the ``n_rewarded`` of them that carried one)."""
    region: str
    features: Tuple[float, ...]
    chosen_class: str
    reward: float = math.nan        # nan = unrewarded (offline search label)
    n: int = 1
    n_rewarded: int = 0

    def __post_init__(self):
        if self.n_rewarded == 0 and not math.isnan(self.reward):
            self.n_rewarded = 1

    @property
    def rewarded(self) -> bool:
        return not math.isnan(self.reward)

    def key(self) -> tuple:
        return (self.region, self.features, self.chosen_class)

    def _fold_reward(self, reward: float, n_rewarded: int = 1):
        """Merge ``n_rewarded`` observations with mean ``reward`` into this
        entry's running mean (unrewarded observations never dilute it)."""
        if math.isnan(reward) or n_rewarded <= 0:
            return
        if self.rewarded:
            self.reward = ((self.reward * self.n_rewarded
                            + reward * n_rewarded)
                           / (self.n_rewarded + n_rewarded))
            self.n_rewarded += n_rewarded
        else:
            self.reward = float(reward)
            self.n_rewarded = n_rewarded

    def to_json(self) -> dict:
        return {"region": self.region, "features": list(self.features),
                "class": self.chosen_class,
                "reward": None if not self.rewarded else self.reward,
                "n": self.n, "n_rewarded": self.n_rewarded}

    @staticmethod
    def from_json(d: dict) -> "CorpusEntry":
        r = d.get("reward")
        return CorpusEntry(region=d["region"], features=_fkey(d["features"]),
                           chosen_class=d["class"],
                           reward=math.nan if r is None else float(r),
                           n=int(d.get("n", 1)),
                           n_rewarded=int(d.get("n_rewarded",
                                                0 if r is None else 1)))


class Corpus:
    """Append-only, deduplicating store of tuning observations."""

    def __init__(self):
        self._entries: dict = {}    # key -> CorpusEntry (insertion-ordered)
        self.observations = 0       # raw appends, pre-dedup (retrain trigger)
        self.quarantined = 0        # malformed JSONL lines skipped at load

    # -- append / dedup ------------------------------------------------------
    def append(self, region: str, features, chosen_class: str,
               reward: float = math.nan) -> CorpusEntry:
        """Record one observation; duplicates merge by running-mean reward."""
        fk = _fkey(features)
        key = (region, fk, chosen_class)
        self.observations += 1
        cur = self._entries.get(key)
        if cur is None:
            cur = CorpusEntry(region, fk, chosen_class, float(reward))
            self._entries[key] = cur
            return cur
        cur._fold_reward(reward)
        cur.n += 1
        return cur

    def _absorb(self, e: CorpusEntry):
        """Fold one (possibly pre-merged) entry in — THE dedup invariant,
        shared by merge and load_jsonl so the two can never drift."""
        cur = self._entries.get(e.key())
        self.observations += e.n
        if cur is None:
            self._entries[e.key()] = dataclasses.replace(e)
        else:
            cur._fold_reward(e.reward, e.n_rewarded)
            cur.n += e.n

    def merge(self, other: "Corpus") -> "Corpus":
        """Fold another corpus in (dedup applies; rewards n-weighted)."""
        for e in other.entries():
            self._absorb(e)
        return self

    def merge_offline(self, pairs: Iterable[Tuple[Sequence[float], str]],
                      region: str = OFFLINE_REGION) -> int:
        """Fold in an offline tuner corpus (``TuneResult.corpus``-shaped
        ``(feature_vec, winning_class)`` pairs — no rewards)."""
        n = 0
        for feat, cls in pairs:
            self.append(region, feat, cls)
            n += 1
        return n

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list:
        return list(self._entries.values())

    def classes(self) -> set:
        return {e.chosen_class for e in self._entries.values()}

    def groups(self) -> list:
        """Observations grouped by measurement point ``(region, features)``:
        list of ``(region, features, {class: mean_reward_or_None})`` — the
        unit the trainer labels (argmax reward) and scores regret over."""
        by_point: dict = {}
        for e in self._entries.values():
            by_point.setdefault((e.region, e.features), {})[e.chosen_class] = (
                e.reward if e.rewarded else None)
        return [(r, f, cls_map) for (r, f), cls_map in by_point.items()]

    def training_data(self):
        """(X, y) for DecisionTree.fit: one row per rewarded measurement
        point labelled with its best-observed class (the online analog of
        the search's "winning class"), plus one row per unrewarded
        (offline-labelled) class."""
        X, y = [], []
        for _, feat, cls_map in self.groups():
            rewarded = {c: r for c, r in cls_map.items() if r is not None}
            if rewarded:
                X.append(np.asarray(feat))
                y.append(max(rewarded, key=rewarded.get))
            else:
                for c in cls_map:
                    X.append(np.asarray(feat))
                    y.append(c)
        return (np.stack(X) if X else np.empty((0, 0))), y

    # -- persistence ---------------------------------------------------------
    def save_jsonl(self, path: str, faults=None) -> int:
        """Write the corpus atomically: a tempfile in the target directory
        then ``os.replace``, so a crash (or injected fault) mid-save can
        never destroy the previously learned corpus — the old file stays
        intact until the new one is fully on disk.  ``faults`` is an
        optional :class:`repro_torch.serve.faults.FaultInjector`; its
        ``corpus.corrupt`` site mangles individual lines to exercise the
        load-side quarantine."""
        path = os.path.abspath(path)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), prefix=".corpus-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                for e in self._entries.values():
                    line = json.dumps(e.to_json())
                    if faults is not None and faults.fire("corpus.corrupt"):
                        line = faults.corrupt_line(line)
                    f.write(line + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(self._entries)

    @classmethod
    def load_jsonl(cls, path: str) -> "Corpus":
        """Load, skipping (and counting in the ``quarantined`` tap) any
        malformed line — one corrupt line must not cost the whole learned
        corpus.  Catches JSON decode errors plus the shape errors
        ``CorpusEntry.from_json`` raises on well-formed-but-wrong JSON."""
        c = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    c._absorb(CorpusEntry.from_json(json.loads(line)))
                except (ValueError, KeyError, TypeError, AttributeError):
                    c.quarantined += 1
        return c
