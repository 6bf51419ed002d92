"""Compatibility shim: the autotuner moved to :mod:`repro_torch.autotune`.

The measure -> corpus -> train -> decide pipeline now lives in the
``repro_torch.autotune`` package (``search.py`` holds the offline greedy loop,
``corpus.py``/``trainer.py``/``explorer.py``/``decider.py`` the online
layers the serve engine consumes).  Everything this module used to define
re-exports from there, so existing imports keep working:

    from repro_torch.core.tuner import Tuner, autotune, default_candidates
"""
from repro_torch.autotune.candidates import (Candidate, canonical,
                                       default_candidates)
from repro_torch.autotune.search import (Iteration, TuneResult, Tuner, autotune,
                                   compile_evaluator)

__all__ = [
    "Candidate", "canonical", "default_candidates",
    "Iteration", "TuneResult", "Tuner", "autotune", "compile_evaluator",
]
