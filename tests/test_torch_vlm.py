"""The port's VLM family (internvl2-26b's LM backbone with the stubbed
vision frontend) against the JAX package's.

Reduced ``internvl2-26b`` (2 layers, d_model 64, GQA 4/2 heads of 16,
vocab 256) with f32 weights from the JAX package's ``Model.init`` bridged
by ``params_from_numpy``; tokens and vision embeddings N(0, 1) are made
with numpy from a seed.  Logits within rtol 1e-4, atol 1e-5; greedy
tokens equal; the loss within rtol 1e-5 and gradients within atol 1e-6 +
rtol 1e-4 of each leaf's largest magnitude (as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.kernels import LAUNCHES
from repro_torch.models import layers as L
from repro_torch.models.model import N_VISION_TOKENS, build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState
from repro_torch.train import trainer

ARCH = "internvl2-26b"
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params)."""
    jmodel = jbuild(jget_config(ARCH).reduced())
    jparams = jax.jit(lambda k: jmodel.init(k, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, build(get_config(ARCH).reduced()), params


def _batch(seed, B, S, n_vision=8, d=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    ve = rng.standard_normal((B, n_vision, d)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "vision_embeds": jnp.asarray(ve)},
            {"tokens": torch.from_numpy(tokens),
             "vision_embeds": torch.from_numpy(ve)})


def test_vision_family_is_the_transformer_with_its_gqa_backbone(pair):
    _, _, model, _ = pair
    full = build(get_config(ARCH))
    assert full.mod.__name__ == "repro_torch.models.transformer"
    c = full.cfg
    assert (c.n_heads, c.n_kv_heads, c.resolved_head_dim) == (48, 8, 128)
    assert model.supports_paged and N_VISION_TOKENS == 256


def test_forward_with_vision_embeds_matches_jax(pair):
    """The first 8 positions take the vision embeddings: logits against
    JAX's, and different from the text-only forward's there."""
    jmodel, jparams, model, params = pair
    jb, tb = _batch(0, 2, 12)
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    got, aux = model.forward(params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    text, _ = model.forward(params, {"tokens": tb["tokens"]})
    assert not torch.allclose(text[:, :8], got[:, :8])


def test_slot_prefill_with_vision_embeds_matches_jax(pair):
    """``prefill`` with vision embeddings: last logits and every layer's
    K/V cache against JAX's."""
    jmodel, jparams, model, params = pair
    jb, tb = _batch(1, 2, 11)
    jl, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=16))(
        jparams, jb)
    tl, tc = model.prefill(params, tb, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"].tolist() == [int(jc["pos"])] * 2 == [11, 11]
    for li in range(model.cfg.n_layers):
        for k in ("k", "v"):
            np.testing.assert_allclose(
                tc["layers"][f"l{li}"][k].numpy(),
                np.asarray(jc["layers"][f"l{li}"][k]), **TOL)


@pytest.mark.parametrize("depth", [0, 2])
def test_paged_pool_tokens_match_jax(pair, depth):
    """The backbone served on the paged pool (attn_impl='paged': the
    kernel's plain version here, Pallas in interpret mode in JAX; chunked
    prefill of 8, spec_depth 0 and 2): identical greedy tokens, steps and
    speculation counts, no kernel launched on the CPU."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 12, 20, 9, 17)]
    gens = [6, 10, 8, 12, 7]
    kw = dict(max_len=40, max_slots=3, prefill_chunk=8, spec_depth=depth)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    jres = JEngine(jmodel, jparams, plan=JRegionPlan(region_configs={
        "layer/attn": JRegionConfig(attn_impl="paged")}),
        serve_cfg=JServeConfig(**kw)).serve(jreqs)
    launches = dict(LAUNCHES)
    res = Engine(model, params, plan=RegionPlan(region_configs={
        "layer/attn": RegionConfig(attn_impl="paged")}),
        serve_cfg=ServeConfig(**kw), device="cpu").serve(reqs)
    assert LAUNCHES == launches
    for a, b in zip(jreqs, reqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    assert res["steps"] == jres["steps"] and res["spec"] == jres["spec"]
    assert res["page_leaks"] == 0 and res["health"]["fallbacks"] == 0


def test_vision_prefix_loss_and_grads_match_jax(pair):
    """At S = 264 the loss scores only the 8 tokens after the first
    N_VISION_TOKENS = 256 (the reference slices 256 positions whatever the
    prefix's length): loss and every gradient against ``jax.grad``."""
    jmodel, jparams, model, params = pair
    S = N_VISION_TOKENS + 8
    jb, tb = _batch(3, 2, S)
    labels = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    jloss = jtrainer.make_loss_fn(jmodel, None, unroll=True)
    (want, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jb)
    (loss, m), grads = trainer.make_grad_fn(model)(params, tb)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
    logits, _ = model.forward(params, tb)
    tail = trainer.cross_entropy(logits[:, N_VISION_TOKENS:],
                                 tb["labels"][:, N_VISION_TOKENS:])
    assert m["ce"].item() == tail.item()
    want_g = jax.tree.map(np.asarray, jgrads)
    assert len(L.tree_leaves(grads)) == len(jax.tree.leaves(want_g))
    for g, w in zip(L.tree_leaves(grads), jax.tree.leaves(want_g)):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(w).max())


@pytest.mark.parametrize("arch,seq", [(ARCH, N_VISION_TOKENS + 8),
                                      ("whisper-large-v3", 16)])
def test_train_launcher_feeds_the_stubbed_frontends(arch, seq, capsys):
    """``launch/train.py`` trains both families with no new flag: zero
    vision embeddings (internvl2-26b) and zero frames (whisper-large-v3)."""
    from repro_torch.launch.train import main
    loss = main(["--arch", arch, "--steps", "2", "--batch", "1", "--seq",
                 str(seq), "--log-every", "1", "--device", "cpu", "--dtype",
                 "float32"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "step     1 loss" in out and "done:" in out
