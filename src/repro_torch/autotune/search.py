"""The offline search: greedy hypothesis-driven per-region tuning.

Mirrors the paper's flow end to end:

  1. instrument (regions.py — automatic)            [PdtTagger]
  2. profile per-region counters (counters.py)       [libhpm]
  3. decide per-region config                        [decision tree / search]
  4. apply (policy.RegionPlan)                       [linked library]

:meth:`Tuner.autotune` is a greedy hypothesis-driven loop: profile -> find
the dominant roofline term and its hottest region -> enumerate legal
candidates for that region -> napkin-math (predict) each -> evaluate the
best predictions by re-counting -> keep the winner -> repeat.  Every
iteration is logged as hypothesis/before/after (EXPERIMENTS.md §Perf reads
these logs).

The search also emits a (features -> winning-class) training corpus for
:class:`repro_torch.core.dtree.DecisionTree` — the paper's proposed mechanism for
deciding configs without search at runtime.  ``TuneResult.to_corpus``
exports it as a :class:`repro_torch.autotune.corpus.Corpus` so the serve engine
can merge it with its own online observations.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.autotune.candidates import canonical, default_candidates
from repro_torch.core import counters as counters_mod
from repro_torch.core import roofline as roofline_mod
from repro_torch.core.dtree import DecisionTree, features
from repro_torch.core.policy import RegionConfig, RegionPlan, default_plan


@dataclasses.dataclass
class Iteration:
    step: int
    region: str
    term: str
    hypothesis: str
    candidate: str
    before_s: float
    after_s: float
    accepted: bool
    confirmed: bool


@dataclasses.dataclass
class TuneResult:
    plan: RegionPlan
    best_bound_s: float
    baseline_bound_s: float
    history: list
    corpus: list                    # (feature_vec, winning_class) pairs

    def train_dtree(self, **kw) -> Optional[DecisionTree]:
        if len(self.corpus) < 2:
            return None
        X = np.stack([f for f, _ in self.corpus])
        y = [c for _, c in self.corpus]
        return DecisionTree(**kw).fit(X, y)

    def to_corpus(self, region: str = ""):
        """Export the search corpus as a mergeable
        :class:`repro_torch.autotune.corpus.Corpus` (unrewarded entries)."""
        from repro_torch.autotune.corpus import OFFLINE_REGION, Corpus
        c = Corpus()
        c.merge_offline(self.corpus, region=region or OFFLINE_REGION)
        return c


def compile_evaluator(build_fn: Callable[[RegionPlan], object]):
    """Default evaluator: a counting one.  ``build_fn(plan)`` returns
    ``(fn, args)``; ``fn(*args)`` is counted on the meta device
    (:func:`repro_torch.core.counters.collect`, nothing runs) and scored
    by its roofline bound on the card."""
    def evaluate(plan: RegionPlan):
        fn, args = build_fn(plan)
        rc = counters_mod.collect(fn, *args)
        rl = roofline_mod.from_counters(rc.total)
        return rl.bound_s, rc, rl
    return evaluate


def _hot_region(rc, term: str) -> Optional[str]:
    key = {"compute": "flops", "memory": "bytes",
           "collective": "link_bytes"}[term]
    top = rc.top_regions(key, 1)
    return top[0][0] if top else None


class Tuner:
    """The offline greedy searcher over a candidate menu.

    Holds the search policy (kind, candidate menu, iteration/acceptance
    thresholds); :meth:`autotune` runs one search against a build function
    or a custom evaluator and returns a :class:`TuneResult`.
    """

    def __init__(self, kind: str = "train", candidates: Optional[list] = None,
                 max_iters: int = 6, min_gain: float = 0.02,
                 verbose: bool = True):
        self.kind = kind
        self.candidates = (candidates if candidates is not None
                           else default_candidates(kind))
        self.max_iters = max_iters
        self.min_gain = min_gain
        self.verbose = verbose

    def autotune(self, build_fn, mesh, *, evaluate=None,
                 plan: Optional[RegionPlan] = None) -> TuneResult:
        candidates = self.candidates
        min_gain, verbose = self.min_gain, self.verbose
        evaluate = evaluate or compile_evaluator(build_fn)
        plan = plan or default_plan(mesh, self.kind)

        score, rc, rl = evaluate(plan)
        baseline = score
        history: list[Iteration] = []
        corpus: list = []
        tried: set = set()

        for it in range(self.max_iters):
            term = rl.dominant
            region = _hot_region(rc, term)
            if region is None:
                break
            prefix = canonical(region)
            region_counters = rc.regions.get(region)
            feat = features(region_counters) if region_counters else None

            applicable = [c for c in candidates
                          if c.applies_to in prefix and not c.serve_only
                          and (prefix, c.name) not in tried]
            if not applicable:
                # dominant region exhausted; try the next-hottest region
                tops = rc.top_regions(
                    {"compute": "flops", "memory": "bytes",
                     "collective": "link_bytes"}[term], 5)
                applicable = []
                for r, _ in tops[1:]:
                    prefix = canonical(r)
                    applicable = [c for c in candidates
                                  if c.applies_to in prefix and not c.serve_only
                                  and (prefix, c.name) not in tried]
                    if applicable:
                        region = r
                        break
                if not applicable:
                    break

            best = None
            for cand in applicable:
                tried.add((prefix, cand.name))
                trial = copy.deepcopy(plan)
                merged = trial.region_configs.get(prefix, RegionConfig())
                merged = dataclasses.replace(
                    cand.config,
                    rules={**merged.rules, **cand.config.rules})
                trial.region_configs[prefix] = merged
                try:
                    s2, rc2, rl2 = evaluate(trial)
                except Exception as e:  # illegal/broken candidate: skip
                    if verbose:
                        print(f"  [tune] {cand.name} on {prefix}: FAILED {e}")
                    continue
                hypo = (f"{term}-bound at {region}; {cand.name} should cut "
                        f"the {term} term")
                accepted = s2 < score * (1 - min_gain)
                history.append(Iteration(it, prefix, term, hypo, cand.name,
                                         score, s2, accepted, s2 < score))
                if verbose:
                    print(f"  [tune] iter{it} {prefix} {cand.name}: "
                          f"{score*1e3:.1f}ms -> {s2*1e3:.1f}ms "
                          f"{'ACCEPT' if accepted else 'reject'}")
                if best is None or s2 < best[0]:
                    best = (s2, rc2, rl2, trial, cand)
            if best is None:
                break
            s2, rc2, rl2, trial, cand = best
            if feat is not None:
                corpus.append((feat, cand.name if s2 < score
                               else "keep_default"))
            if s2 < score * (1 - min_gain):
                score, rc, rl, plan = s2, rc2, rl2, trial
            else:
                break  # no candidate moved the needle; stop

        return TuneResult(plan=plan, best_bound_s=score,
                          baseline_bound_s=baseline, history=history,
                          corpus=corpus)


def autotune(build_fn, mesh, *, kind: str = "train",
             candidates: Optional[list] = None, max_iters: int = 6,
             evaluate=None, plan: Optional[RegionPlan] = None,
             min_gain: float = 0.02, verbose: bool = True) -> TuneResult:
    """Functional wrapper around :class:`Tuner` (the original API)."""
    return Tuner(kind=kind, candidates=candidates, max_iters=max_iters,
                 min_gain=min_gain, verbose=verbose).autotune(
                     build_fn, mesh, evaluate=evaluate, plan=plan)
