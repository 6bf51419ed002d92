"""The port's slot-pool serving against the JAX package's, for reduced
``rwkv6-3b``.

``test_torch_slot_serve_zamba2.py`` holds the same cases for
``zamba2-2.7b``, with the arch-free tests (the dense slot pool, static
``generate()``, ``prefill_bucket``); the two files run on separate
workers.  The models, traces and the two-engine serve are in
``_torch_slot_serve_common.py``.
"""
import pytest

from _torch_slot_serve_common import (check_chunked_state_prefill,
                                      check_slot_serve_tokens, models_for)


@pytest.fixture(scope="module", params=["rwkv6-3b"])
def models(request):
    return models_for(request.param)


@pytest.mark.parametrize("chaos", [0.0, 0.3])
@pytest.mark.parametrize("scan_mode", ["auto", "chunk", "fused_recurrent"])
@pytest.mark.parametrize("depth", [0, 2])
def test_slot_serve_tokens_match_jax(models, depth, scan_mode, chaos):
    """paged='off' at spec_depth 0 and 2 under each scan mode, with and
    without seeded logits.nan injection (faulted slots restore their
    snapshot and retry): identical tokens, steps, speculation, retries and
    injected faults, every request DONE, and no kernel launched on the
    CPU."""
    check_slot_serve_tokens(models, depth, scan_mode, chaos)


@pytest.mark.parametrize("depth", [0, 2])
def test_chunked_state_prefill_matches_jax(models, depth):
    """prefill_chunk=8, two chunks between decode steps: the state is
    threaded through 8-token chunks; the port also counts its prefill
    calls (one per chunk) and re-advances."""
    check_chunked_state_prefill(models, depth)
