"""The port's slot-pool serving and static ``generate()`` against the JAX
package's.

Reduced ``rwkv6-3b`` and ``zamba2-2.7b`` (and ``stablelm-1.6b`` for the
dense slot path), f32 weights from the JAX package's ``Model.init``
bridged through numpy; the same request traces, made with numpy from a
seed, are served greedily by the JAX ``Engine`` and by the port's
``Engine(device="cpu")`` with ``paged="off"``.  Greedy tokens must be
identical, and the step, speculation, retry and slot-memory counts equal:
both engines run the same host-side bookkeeping over logits that agree to
f32 rounding.  The prompts feed 4, 16, 69, 8 and 32 tokens: under the
chunk scan the 69-token prefill is ragged (C = 64 does not divide it) and
takes the sequential form, the others the chunked one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState

PROMPT_LENS = (5, 17, 70, 9, 33)
GENS = (6, 8, 5, 9, 7)


def _models(arch):
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config(arch).reduced())
    return jmodel, jparams, model, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=["rwkv6-3b", "zamba2-2.7b"])
def models(request):
    return _models(request.param)


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _serve_both(models, prompts, gens, **cfg):
    jmodel, jparams, model, tparams = models
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    jres = JEngine(jmodel, jparams, serve_cfg=JServeConfig(**cfg)).serve(
        jreqs)
    teng = Engine(model, tparams, serve_cfg=ServeConfig(**cfg), device="cpu")
    tres = teng.serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert (b.state.value, b.out_tokens) == (a.state.value,
                                                 a.out_tokens), b.rid
    assert tres["steps"] == jres["steps"]
    assert tres["spec"] == jres["spec"]
    assert tres["memory"] == jres["memory"]
    return jres, tres, teng


@pytest.mark.parametrize("chaos", [0.0, 0.3])
@pytest.mark.parametrize("scan_mode", ["auto", "chunk", "fused_recurrent"])
@pytest.mark.parametrize("depth", [0, 2])
def test_slot_serve_tokens_match_jax(models, depth, scan_mode, chaos):
    """paged='off' at spec_depth 0 and 2 under each scan mode, with and
    without seeded logits.nan injection (faulted slots restore their
    snapshot and retry): identical tokens, steps, speculation, retries and
    injected faults, every request DONE, and no kernel launched on the
    CPU."""
    cfg = dict(max_len=96, max_slots=3, paged="off", spec_depth=depth,
               scan_mode=scan_mode)
    if chaos:
        cfg.update(chaos_rate=chaos, chaos_seed=5,
                   chaos_sites=("logits.nan",), max_retries=8)
    launches = dict(LAUNCHES)
    jres, tres, teng = _serve_both(models, _prompts(), GENS, **cfg)
    assert all(r.state is RequestState.DONE for r in tres["requests"])
    assert tres["failures"]["retries"] == jres["failures"]["retries"]
    assert (tres["faults"]["injected_total"]
            == jres["faults"]["injected_total"])
    if chaos:
        assert tres["failures"]["retries"] > 0
    assert tres["health"]["fallbacks"] == 0
    assert LAUNCHES == launches
    assert teng.scan_mode_for(teng.plan, "prefill") == (
        "fused_recurrent" if scan_mode == "fused_recurrent" else "chunk")


@pytest.mark.parametrize("depth", [0, 2])
def test_chunked_state_prefill_matches_jax(models, depth):
    """prefill_chunk=8, two chunks between decode steps: the state is
    threaded through 8-token chunks; the port also counts its prefill
    calls (one per chunk) and re-advances."""
    _, tres, _ = _serve_both(models, _prompts(1), GENS, max_len=96,
                             max_slots=2, paged="off", spec_depth=depth,
                             prefill_chunk=8, prefill_chunks_per_step=2)
    feeds = [n - 1 for n in PROMPT_LENS]
    assert tres["slot_calls"]["prefill"] == sum(-(-f // 8) for f in feeds)
    assert (tres["slot_calls"]["readvance"] > 0) == (depth > 0)


def test_parked_slots_decode_past_max_len():
    """One request on a 3-slot pool at spec_depth 2: the two parked slots
    decode garbage every step and their positions run far past max_len;
    attention writes clamp inside the cache as JAX's do, nothing raises,
    and the request's tokens equal JAX's."""
    models = _models("zamba2-2.7b")
    _, _, teng = _serve_both(models, _prompts(2, (4,)), (12,), max_len=16,
                             max_slots=3, paged="off", spec_depth=2)
    pos = teng._pool.pool["pos"]
    assert int(pos.max()) > 2 * teng.cfg.max_len


def test_dense_slot_pool_matches_jax():
    """paged='off' for a dense family: whole K/V caches on the slot pool,
    prompts prefilled at their exact length."""
    models = _models("stablelm-1.6b")
    _serve_both(models, _prompts(3, (5, 12, 7, 9)), (6, 8, 5, 7),
                max_len=32, max_slots=2, paged="off")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_generate_matches_jax(arch):
    """The static lockstep path: one batched prefill, then lockstep decode
    of every row."""
    jmodel, jparams, model, tparams = _models(arch)
    prompts = np.random.default_rng(4).integers(0, 256, (3, 8)).astype(
        np.int32)
    want = JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        max_len=16)).generate(jnp.asarray(prompts), 6)["tokens"]
    got = Engine(model, tparams, serve_cfg=ServeConfig(max_len=16),
                 device="cpu").generate(prompts, 6)
    assert got["tokens"].shape == (3, 6)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))
    assert got["decode_tok_per_s"] > 0
