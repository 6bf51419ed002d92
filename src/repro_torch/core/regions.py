"""Region instrumentation (the PdtTagger analog), on PyTorch.

Every model module wraps its computation in :func:`region`, which

  * keeps a thread-local stack of region names whose ``"/"``-joined path
    is the key a :class:`repro_torch.core.policy.RegionPlan` resolves its
    per-region knobs against (``"layer0/attn"`` matches the plan entries
    ``"layer0/attn"`` and ``"layer/attn"`` exactly as in the JAX package),
  * tags the enclosed ops: the profiler labels them with
    ``torch.profiler.record_function`` under the ``R.`` prefix, and the
    counters (:mod:`repro_torch.core.counters`) attribute each dispatched
    op to :func:`current_region`, the path of the tagged regions it runs
    under, and
  * records the region path in a registry while :func:`collect_regions`
    is active, so the tuner can enumerate the region tree.

Like PdtTagger ("by default it instruments every OpenMP parallel
construct"), instrumentation is on by default for every module; a region
filter (:func:`set_region_filter`) plays the role of the paper's user
config file: a region it rejects is not tagged, so its ops count towards
the nearest tagged enclosing region.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional

import torch
import torch.utils.checkpoint

REGION_PREFIX = "R."

_state = threading.local()


def _stack() -> list[str]:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def _tagged() -> list[str]:
    if not hasattr(_state, "tagged"):
        _state.tagged = []
    return _state.tagged


def _registry() -> Optional[set]:
    return getattr(_state, "registry", None)


def _filter() -> Optional[Callable[[str], bool]]:
    return getattr(_state, "filter", None)


def set_region_filter(fn: Optional[Callable[[str], bool]]) -> None:
    """Restrict instrumentation to regions accepted by ``fn`` (cf. paper §4.2)."""
    _state.filter = fn


def current_region() -> str:
    """The path of the tagged regions entered so far ("" outside any):
    the region an op dispatched now is attributed to."""
    return "/".join(_tagged())


@contextlib.contextmanager
def region(name: str) -> Iterator[str]:
    """Enter an instrumented region; yields the full region path."""
    st = _stack()
    st.append(name)
    path = "/".join(st)
    reg = _registry()
    if reg is not None:
        reg.add(path)
    flt = _filter()
    try:
        if flt is None or flt(path):
            tagged = _tagged()
            tagged.append(name)
            try:
                with torch.profiler.record_function(REGION_PREFIX + name):
                    yield path
            finally:
                tagged.pop()
        else:
            yield path
    finally:
        st.pop()


def snapshot() -> tuple:
    """The region state now — (names entered, names tagged) — to run code
    under again later with :func:`push_path`."""
    return tuple(_stack()), tuple(_tagged())


def push_path(snap: tuple) -> None:
    """Run what follows under the region state ``snap`` (from
    :func:`snapshot`) until the matching :func:`pop_path`: the autograd
    engine runs a backward node, and a rematerialised layer its
    recompute, after the forward's regions have closed."""
    if not hasattr(_state, "saved"):
        _state.saved = []
    _state.saved.append((_stack(), _tagged()))
    _state.stack, _state.tagged = list(snap[0]), list(snap[1])


def pop_path() -> None:
    _state.stack, _state.tagged = _state.saved.pop()


def remat(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    forward keeps only ``args``, and the backward recomputes ``fn``.  The
    recompute runs under the region state of the first call, so its ops
    are attributed and labelled as in the forward (``jax.checkpoint`` in
    the JAX package)."""
    snap = snapshot()

    def run(*a):
        push_path(snap)
        try:
            return fn(*a)
        finally:
            pop_path()

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


@contextlib.contextmanager
def collect_regions() -> Iterator[set]:
    """Collection of the region tree while ``fn`` runs (used by the tuner)."""
    prev = _registry()
    _state.registry = reg = set()
    try:
        yield reg
    finally:
        _state.registry = prev


def discover_regions(fn: Callable, *args, **kwargs) -> set:
    """Run ``fn`` on the meta device — every tensor argument moved there,
    so nothing is computed, launched or written — and return the set of
    region paths it enters (the JAX package evaluates it abstractly with
    ``eval_shape``)."""
    from repro_torch.core.counters import to_meta
    with collect_regions() as reg, torch.no_grad():
        fn(*to_meta(args), **to_meta(kwargs))
    return set(reg)
