"""The port's slot-pool serving and static ``generate()`` against the JAX
package's, for reduced ``zamba2-2.7b`` (and ``stablelm-1.6b`` and
``rwkv6-3b`` where a test names its arch).

``test_torch_slot_serve.py`` holds the same serve cases for
``rwkv6-3b``.  The arch-free tests live here because this file's serve
cases take less time than rwkv6's, so the two files balance on their
workers.  The models, traces and the two-engine serve are in
``_torch_slot_serve_common.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_slot_serve_common import (JEngine, JServeConfig,
                                      check_chunked_state_prefill,
                                      check_slot_serve_tokens, models_for,
                                      prompts, serve_both)
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request


@pytest.fixture(scope="module", params=["zamba2-2.7b"])
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


def test_parked_slots_decode_past_max_len():
    """One request on a 3-slot pool at spec_depth 2: the two parked slots
    decode garbage every step and their positions run far past max_len;
    attention writes clamp inside the cache as JAX's do, nothing raises,
    and the request's tokens equal JAX's."""
    models = models_for("zamba2-2.7b")
    _, _, teng = serve_both(models, prompts(2, (4,)), (12,), max_len=16,
                            max_slots=3, paged="off", spec_depth=2)
    pos = teng._pool.pool["pos"]
    assert int(pos.max()) > 2 * teng.cfg.max_len


def test_dense_slot_pool_matches_jax():
    """paged='off' for a dense family: whole K/V caches on the slot pool,
    prompts prefilled at their exact length."""
    models = models_for("stablelm-1.6b")
    serve_both(models, prompts(3, (5, 12, 7, 9)), (6, 8, 5, 7),
               max_len=32, max_slots=2, paged="off")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_generate_matches_jax(arch):
    """The static lockstep path: one batched prefill, then lockstep decode
    of every row."""
    jmodel, jparams, model, tparams = models_for(arch)
    toks = np.random.default_rng(4).integers(0, 256, (3, 8)).astype(
        np.int32)
    want = JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        max_len=16)).generate(jnp.asarray(toks), 6)["tokens"]
    got = Engine(model, tparams, serve_cfg=ServeConfig(max_len=16),
                 device="cpu").generate(toks, 6)
    assert got["tokens"].shape == (3, 6)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))
    assert got["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b"])
def test_prefill_bucket_matches_jax(arch):
    """``prefill_bucket=8`` on the slot pool, as the reference's callers
    set it: a dense cache prefills prompts padded up to a multiple of 8
    and then reads only the true length, a recurrent one (where padding
    is not sound) at exact length.  Tokens, steps and slot memory equal
    the JAX engine's, and equal an exact-length serve's."""
    models = models_for(arch)
    ps, gens = prompts(6, (5, 12, 7, 17)), (6, 8, 5, 7)
    cfg = dict(max_len=40, max_slots=2, paged="off")
    _, bres, beng = serve_both(models, ps, gens, prefill_bucket=8, **cfg)
    assert beng._pad_safe() == (arch == "stablelm-1.6b")
    widths, prefill = [], beng.model.prefill

    def record(params, batch, *a, **kw):
        widths.append(batch["tokens"].shape[1])
        return prefill(params, batch, *a, **kw)
    beng.model.prefill = record
    try:
        cache, last = beng._prefill_slot(np.arange(6, dtype=np.int32))
    finally:
        beng.model.prefill = prefill
    assert widths == [8 if beng._pad_safe() else 5] and last == 5
    assert cache["pos"].tolist() == [5]
    _, _, model, tparams = models
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(zip(ps, gens))]
    Engine(model, tparams, serve_cfg=ServeConfig(**cfg),
           device="cpu").serve(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens
                                            for r in bres["requests"]]
