"""Autotuning subsystem: the paper's measure -> corpus -> train -> decide
pipeline as explicit layers, shared by the offline tuner and the serving
engine.

The paper's flow (instrument / measure / decide / apply) maps onto:

  instrument  repro_torch.core.regions (automatic scope tagging)     [PdtTagger]
  measure     repro_torch.core.counters (per-region step counters)   [libhpm]
  corpus      repro_torch.autotune.corpus  (append-only observation store)
  train       repro_torch.autotune.trainer (incremental DecisionTree retraining)
  explore     repro_torch.autotune.explorer (epsilon-greedy over the candidate menu)
  decide      repro_torch.autotune.decider  (counters -> tree -> RegionPlan)
  search      repro_torch.autotune.search   (the offline greedy hypothesis loop)
  apply       repro_torch.core.policy (RegionPlan / RegionConfig)    [linked library]

Offline, :class:`~repro_torch.autotune.search.Tuner` runs the greedy search and
emits a corpus of (features, winning-class) pairs.  Online, the serve
engine taps its own measured step counters and tok/s rewards into the same
:class:`~repro_torch.autotune.corpus.Corpus`, retrains through
:class:`~repro_torch.autotune.trainer.OnlineTrainer`, and hot-swaps the tree in
:class:`~repro_torch.autotune.decider.PlanDecider` — the loop the paper runs
ahead of time, closed inside the serving hot path.
"""
from repro_torch.autotune.candidates import (Candidate, canonical,
                                       default_candidates, explore_menu)
from repro_torch.autotune.corpus import Corpus, CorpusEntry
from repro_torch.autotune.decider import PlanDecider
from repro_torch.autotune.explorer import EpsilonGreedyExplorer
from repro_torch.autotune.search import (Iteration, TuneResult, Tuner, autotune,
                                   compile_evaluator)
from repro_torch.autotune.trainer import OnlineTrainer, holdout_value

__all__ = [
    "Candidate", "canonical", "default_candidates", "explore_menu",
    "Corpus", "CorpusEntry", "PlanDecider", "EpsilonGreedyExplorer",
    "Iteration", "TuneResult", "Tuner", "autotune", "compile_evaluator",
    "OnlineTrainer", "holdout_value",
]
