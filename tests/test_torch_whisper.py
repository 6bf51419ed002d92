"""The port's encoder-decoder family (whisper-large-v3) against the JAX
package's, and ``apply_attention``'s JAX signature.

Reduced ``whisper-large-v3`` (2 + 2 layers, d_model 64, 4 heads of 16,
enc_len 32, vocab 256) with f32 weights from the JAX package's
``Model.init`` bridged by ``params_from_numpy``; frames N(0, 1) and tokens
are made with numpy from a seed.  On random weights whisper's residual
stream reaches ~10^2 (an attention or MLP output of a layer is ~100 on
LayerNormed input), and the final LayerNorm divides that scale out, so
the logits carry the residual's absolute f32 rounding: against a float64
run of the port on these inputs, the JAX package's f32 logits stand
3.2e-4 off and the port's 2.4e-4 (max |logit| 3.7).  So tensors are held
at their own scale, as ``tests/test_torch_train.py`` holds gradients:
|port - JAX| <= 1e-5 + 1e-4 * max|JAX| elementwise.  Greedy tokens must
be equal.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.policy import null_plan as jnull_plan
from repro.models import attention as jattn
from repro.models import whisper as jwhisper
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import default_plan, null_plan
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import whisper
from repro_torch.models.attention import _out_proj, _qkv_rope
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-large-v3"
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 2e-3
B, S, MAX_LEN = 2, 7, 16


def _close(got, want, rtol=RTOL, atol=ATOL):
    """|got - want| <= atol + rtol * max|want|, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, model, params, port cfg, model, params, frames, tokens)."""
    jcfg = jget_config(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jax.jit(lambda k: jmodel.init(k, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jmodel, jparams, cfg, build(cfg), params, frames, tokens


def _batches(frames, tokens):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)})


def test_encode_matches_jax(pair):
    jcfg, _, jparams, cfg, _, params, frames, _ = pair
    want = jax.jit(lambda p, f: jwhisper.encode(jcfg, p, f, jnull_plan()))(
        jparams, jnp.asarray(frames))
    got = whisper.encode(cfg, params, torch.from_numpy(frames), null_plan())
    assert got.shape == (B, cfg.enc_len, cfg.d_model)
    _close(got, want)


def test_forward_matches_jax(pair):
    _, jmodel, jparams, _, model, params, frames, tokens = pair
    jb, tb = _batches(frames, tokens)
    want, jaux = jax.jit(jmodel.forward)(jparams, jb)
    got, aux = model.forward(params, tb)
    assert got.shape == want.shape
    _close(got, want)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    last, _ = model.forward(params, tb, final_logits_only=True)
    _close(last, got[:, -1:].detach().numpy())


def test_prefill_then_decode_matches_jax_and_forward(pair):
    """``prefill`` of 3 tokens (last logits, every layer's self-attention
    cache, the encoder output, ``pos``), then 4 teacher-forced
    ``decode_step``s: each step's logits against JAX's and against the
    forward's at the same position (JAX's test_prefill_decode_consistency).
    The port keeps ``pos`` per row; JAX keeps one scalar."""
    _, jmodel, jparams, cfg, model, params, frames, tokens = pair
    n0 = 3
    jb, tb = _batches(frames, tokens[:, :n0])
    jl, jc = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=MAX_LEN))(
        jparams, jb)
    jdecode = jax.jit(jmodel.decode)
    tl, tc = model.prefill(params, tb, max_len=MAX_LEN)
    _close(tl, jl)
    _close(tc["enc_out"], jc["enc_out"])
    assert tc["pos"].tolist() == [int(jc["pos"])] * B == [n0] * B
    for li in range(cfg.n_layers):
        for k in ("k", "v"):
            want = jc["self_kv"][f"l{li}"][k]
            assert tuple(tc["self_kv"][f"l{li}"][k].shape) == want.shape
            _close(tc["self_kv"][f"l{li}"][k], want)
    full, _ = model.forward(params, _batches(frames, tokens)[1])
    for i in range(n0, S):
        step = tokens[:, i:i + 1]
        jl, jc = jdecode(jparams, jc, jnp.asarray(step))
        tl, tc = model.decode(params, tc, torch.from_numpy(step))
        _close(tl, jl)
        _close(tl[:, 0], full[:, i].detach().numpy())
        assert tc["pos"].tolist() == [int(jc["pos"])] * B == [i + 1] * B
    empty = model.init_cache(B, MAX_LEN, dtype=torch.float32, device="cpu")
    assert L.tree_map(lambda t: tuple(t.shape), empty) == L.tree_map(
        lambda t: tuple(t.shape), tc)


def test_generate_tokens_match_jax(pair):
    """``Engine.generate`` with frames: the port's greedy tokens equal the
    JAX engine's."""
    _, jmodel, jparams, _, model, params, _, _ = pair
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((3, 32, 64)).astype(np.float32)
    prompts = rng.integers(0, 256, (3, 4)).astype(np.int32)
    want = JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        max_len=32)).generate(jnp.asarray(prompts), 10,
                              {"frames": jnp.asarray(frames)})
    got = Engine(model, params, serve_cfg=ServeConfig(max_len=32),
                 device="cpu").generate(
        prompts, 10, {"frames": torch.from_numpy(frames)})
    assert got["tokens"].dtype in (torch.int32, torch.int64)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_continuous_batching_refused_as_in_jax(pair):
    """Both engines refuse to build a pool for encdec: whisper serves
    through ``generate()`` only."""
    _, jmodel, jparams, _, model, params, _, _ = pair
    prompt = np.arange(4, dtype=np.int32)
    with pytest.raises(NotImplementedError,
                       match=r"use generate\(\) for encdec"):
        JEngine(jmodel, jparams).serve(
            [JRequest(rid=0, prompt=prompt, max_new_tokens=2)])
    with pytest.raises(NotImplementedError,
                       match=r"use generate\(\) for encdec"):
        Engine(model, params, device="cpu").serve(
            [Request(rid=0, prompt=prompt, max_new_tokens=2)])


LAUNCH = ["--device", "cpu", "--dtype", "float32", "--arch", ARCH,
          "--requests", "3", "--gen-min", "2", "--gen-max", "4", "--slots",
          "2"]


def test_launcher_serves_whisper_static_and_refuses_continuous():
    """``launch/serve.py --mode static`` exits 0 on whisper (zero frames,
    as the JAX launcher feeds them); continuous mode raises the engine's
    refusal."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
         "--mode", "static"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "tok/s" in r.stdout
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError,
                       match=r"use generate\(\) for encdec"):
        main([*LAUNCH, "--mode", "continuous"])


def test_train_step_loss_and_grads_match_jax(pair):
    """One step's loss (rtol 1e-5) and every gradient against ``jax.grad``
    of the JAX loss; under the train plan (every ``enc``/``dec`` layer
    remat) the same loss and grads.  Gradients are held at each leaf's
    scale, |port - JAX| <= 1e-6 + GRAD_RTOL x max|JAX|: against a float64
    run of the port on this batch, the JAX package's f32 gradients stand
    up to 8.6e-4 of a leaf's scale off (``dec_blocks/self_attn/wk``) and
    the port's up to 6.6e-4, for the residual's scale as above."""
    jcfg, jmodel, jparams, cfg, model, params, frames, tokens = pair
    labels = np.roll(tokens, -1, axis=1)
    jbatch = dict(_batches(frames, tokens)[0], labels=jnp.asarray(labels))
    batch = dict(_batches(frames, tokens)[1], labels=torch.from_numpy(labels))
    jloss = jtrainer.make_loss_fn(jmodel, None, unroll=True)
    (want, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jbatch)
    (loss, m), grads = trainer.make_grad_fn(model)(params, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
    want_g = jax.tree.map(np.asarray, jgrads)
    assert len(L.tree_leaves(grads)) == len(jax.tree.leaves(want_g))
    for g, w in zip(L.tree_leaves(grads), jax.tree.leaves(want_g)):
        assert g.shape == w.shape
        _close(g, w, rtol=GRAD_RTOL, atol=1e-6)
    (loss_r, _), grads_r = trainer.make_grad_fn(
        model, default_plan(kind="train"))(params, batch)
    assert loss_r.item() == loss.item()
    for a, b in zip(L.tree_leaves(grads_r), L.tree_leaves(grads)):
        _close(a, b.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# apply_attention: the JAX signature, and its earlier callers unchanged
# ---------------------------------------------------------------------------


def _attn_case(name, cross, seed):
    """(JAX cfg, port cfg, JAX params, port params) of one reduced
    config's attention, params N(0, 0.2^2) from numpy."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    if cfg.swa_window:
        jcfg = dataclasses.replace(jcfg, swa_window=5)
        cfg = dataclasses.replace(cfg, swa_window=5)
    rng = np.random.default_rng(seed)
    spec = jattn.attn_spec(jcfg, cross=cross)
    npp = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
           + (1.0 if k.endswith("norm") else 0.0) for k, s in spec.items()}
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in npp.items()},
            {k: torch.from_numpy(v) for k, v in npp.items()})


@pytest.mark.parametrize("name,kw", [
    ("qwen3-8b", dict(cross=True)),
    ("qwen3-8b", dict(causal=False, rope=False)),
    ("stablelm-1.6b", dict(causal=True, rope=True, offset=5)),
    ("h2o-danube-1.8b", dict(causal=False, rope=True)),
    (ARCH, dict(cross=True)),
])
def test_apply_attention_arguments_match_jax(name, kw):
    """Cross-attention (K/V from ``kv_x`` of another length, no qk-norm
    leaves, no mask), non-causal self-attention with and without rope (a
    window still masks), and causal at offset positions, against the JAX
    package's ``apply_attention``."""
    kw = dict(kw)
    cross, offset = kw.pop("cross", False), kw.pop("offset", 0)
    jcfg, cfg, jp, p = _attn_case(name, cross, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    args = dict(kw)
    jargs = dict(kw)
    if cross:
        kv = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
        args.update(kv_x=torch.from_numpy(kv), causal=False, rope=False,
                    name="cross_attn")
        jargs.update(kv_x=jnp.asarray(kv), causal=False, rope=False,
                     name="cross_attn")
        assert "q_norm" not in p
    if offset:
        pos = np.arange(offset, offset + 9, dtype=np.int32)
        args["positions"] = torch.from_numpy(pos)
        jargs["positions"] = jnp.asarray(pos)
    want = jattn.apply_attention(jcfg, jp, jnp.asarray(x), jnull_plan(),
                                 **jargs)
    got = attn.apply_attention(cfg, p, torch.from_numpy(x), null_plan(),
                               **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _apply_attention_before(cfg, p, x, plan, *, name="attn"):
    """``apply_attention`` as it stood before it took the JAX signature:
    causal self-attention with rope, always."""
    from repro_torch.core.regions import region
    with region(name) as rpath:
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        q, k, v = _qkv_rope(cfg, p, x, positions)
        hd = q.shape[-1]
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, S, kvh, g, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, k) / math.sqrt(hd)
        valid = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if cfg.causal:
            valid = torch.tril(valid)
        if cfg.swa_window:
            idx = torch.arange(S, device=x.device)
            valid &= (idx[:, None] - idx[None, :]) < cfg.swa_window
        s = s.float().masked_fill(~valid, attn.NEG_INF)
        probs = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
        out = _out_proj(out.reshape(B, S, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen3-8b",
                                  "h2o-danube-1.8b"])
def test_existing_callers_are_bit_identical(name, dtype):
    """The forward path's call (``apply_attention(cfg, p, x, plan)``):
    output and the gradients of x and every weight equal bit for bit to
    the implementation before the JAX signature."""
    _, cfg, _, npp = _attn_case(name, False, 4)
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model)).astype(
        np.float32)).to(dtype)
    outs = []
    for fn in (attn.apply_attention, _apply_attention_before):
        p = {k: v.to(dtype).requires_grad_() for k, v in npp.items()}
        x = x0.clone().requires_grad_()
        out = fn(cfg, p, x, null_plan())
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [x, *p.values()])
        outs.append((out.detach(), grads))
    (a, ga), (b, gb) = outs
    assert torch.equal(a, b)
    for u, v in zip(ga, gb):
        assert torch.equal(u, v)
