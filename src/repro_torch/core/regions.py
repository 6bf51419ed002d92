"""Region instrumentation (the PdtTagger analog), on PyTorch.

Every model module wraps its computation in :func:`region`, which

  * keeps a thread-local stack of region names whose ``"/"``-joined path
    is the key a :class:`repro_torch.core.policy.RegionPlan` resolves its
    per-region knobs against (``"layer0/attn"`` matches the plan entries
    ``"layer0/attn"`` and ``"layer/attn"`` exactly as in the JAX package),
    and
  * labels the enclosed ops with ``torch.profiler.record_function`` under
    the ``R.`` prefix, so a profiler trace attributes device time to the
    same region paths.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

REGION_PREFIX = "R."

_state = threading.local()


def _stack() -> list[str]:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def region(name: str) -> Iterator[str]:
    """Enter an instrumented region; yields the full region path."""
    st = _stack()
    st.append(name)
    try:
        with torch.profiler.record_function(REGION_PREFIX + name):
            yield "/".join(st)
    finally:
        st.pop()
