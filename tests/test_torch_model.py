"""The port's dense model against the JAX package's, on identical weights.

Weights come from the JAX package's ``Model.init`` (f32) and cross through
numpy with :func:`repro_torch.models.model.params_from_numpy`; token and
activation inputs are made with numpy from a seed.  Reduced
``stablelm-1.6b`` (LayerNorm, partial rotary 0.25, MHA) and reduced
``qwen3-8b`` (RMSNorm, qk-norm, GQA).  Logits agree within rtol=1e-4,
atol=1e-5: both sides compute in f32 and differ only in summation order.
Page contents are held to rtol=1e-4 and an atol of 1e-5 times the
tensor's largest magnitude: K of a deeper layer is a sum of O(1) terms
that can cancel to near zero, and the rounding of such an element is set
by the terms, not by its own size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy

ARCHS = ["stablelm-1.6b", "qwen3-8b"]
TOL = dict(rtol=1e-4, atol=1e-5)
PS, MP = 8, 4                     # page size, pages per slot


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax model, jax params, torch cfg, torch model, numpy
    params, torch params) for one reduced arch."""
    jcfg = jget_config(request.param).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = get_config(request.param).reduced()
    model = build(cfg)
    return (jcfg, jmodel, jparams, cfg, model, np_params,
            params_from_numpy(np_params, device="cpu"))


def _plans(impl):
    return (JRegionPlan(region_configs={"layer/attn": JRegionConfig(
                attn_impl=impl, block_k=4)}),
            RegionPlan(region_configs={"layer/attn": RegionConfig(
                attn_impl=impl, block_k=4)}))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_params_from_numpy_round_trips_every_leaf(pair):
    *_, np_params, tparams = pair
    want, got = _flat(np_params), _flat(tparams)
    assert set(got) == set(want)
    assert any(k.startswith("blocks/attn/") for k in got)
    for k, a in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)


def test_port_init_follows_the_spec(pair):
    """The port's own init: the JAX spec's shapes, distributions from a
    seeded torch.Generator (same seed, same weights)."""
    *_, model, np_params, _ = pair
    a = model.init(3, dtype=torch.float32, device="cpu")
    b = model.init(3, dtype=torch.float32, device="cpu")
    for k, arr in _flat(np_params).items():
        assert tuple(_flat(a)[k].shape) == arr.shape, k
        torch.testing.assert_close(_flat(a)[k], _flat(b)[k], rtol=0, atol=0)
    norm = _flat(a)["final_norm/scale"]
    assert torch.all(norm == 1)


def test_apply_norm_and_rope_match(pair):
    jcfg, _, _, cfg, _, np_params, tparams = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 2 + 0.3
    for name in ("norm1",):
        jp = jax.tree.map(lambda a: a[0], np_params["blocks"][name])
        tp = {k: v[0] for k, v in tparams["blocks"][name].items()}
        want = np.asarray(JL.apply_norm(jcfg, jp, jnp.asarray(x)))
        got = L.apply_norm(cfg, tp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    hd = cfg.resolved_head_dim
    xr = rng.standard_normal((2, 7, cfg.n_heads, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jcfg, jnp.asarray(xr), jnp.asarray(pos)))
    got = L.apply_rope(cfg, torch.from_numpy(xr), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert L.rotary_dim(cfg, hd) == (4 if cfg.partial_rotary < 1 else hd)


def test_forward_logits_match(pair):
    _, jmodel, jparams, cfg, model, _, tparams = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pools(cfg, jmodel, B):
    """Zeroed page pools for both packages and a non-aliasing block table
    (slot b owns pages 1 + b*MP ..)."""
    n_pages = 1 + B * MP
    jpages = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jmodel.paged_cache_spec(n_pages, PS, jnp.float32))
    shape = (n_pages, PS, cfg.n_kv_heads, cfg.resolved_head_dim)
    tpages = {"layers": {f"l{i}": {"k_pages": torch.zeros(shape),
                                   "v_pages": torch.zeros(shape)}
                         for i in range(cfg.n_layers)}}
    bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    return jpages, tpages, bt


def _assert_pages_close(jpages, tpages, first_page=0):
    for li, layer in tpages["layers"].items():
        for name, t in layer.items():
            want = np.asarray(jpages["layers"][li][name])[first_page:]
            np.testing.assert_allclose(
                t.numpy()[first_page:], want, rtol=TOL["rtol"],
                atol=TOL["atol"] * max(1.0, float(np.abs(want).max())),
                err_msg=f"{li}/{name}")


@pytest.fixture(scope="module")
def prefilled(pair):
    """Three slots' prompts (13, 6 and 1 tokens) prefilled in chunks of 8,
    the last one zero-padded, through both packages' prefill_chunk_step."""
    return _prefill(pair, 3, [13, 6, 1], chunk=8)


def _prefill(pair, B, prompt_lens, chunk):
    _, jmodel, jparams, cfg, model, _, tparams = pair
    jplan, plan = _plans("")
    jpages, tpages, bt = _pools(cfg, jmodel, B)
    jchunk = jax.jit(lambda *a: jmodel.paged_prefill_chunk(*a, jplan))
    rng = np.random.default_rng(2)
    for b, n in enumerate(prompt_lens):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        for base in range(0, n, chunk):
            piece = np.zeros((1, chunk), np.int32)
            part = prompt[base:base + chunk]
            piece[0, :part.size] = part
            jpages = jchunk(jparams, jpages, jnp.asarray(piece),
                            jnp.asarray(bt[b]), jnp.asarray(base, jnp.int32))
            out = model.paged_prefill_chunk(
                tparams, tpages, torch.from_numpy(piece),
                torch.from_numpy(bt[b]), base, plan)
            assert out is tpages          # pages are updated in place
    return jpages, tpages, bt


def test_prefill_chunk_pages_match(prefilled):
    jpages, tpages, _ = prefilled
    _assert_pages_close(jpages, tpages)


@pytest.mark.parametrize("impl", ["", "paged"])
@pytest.mark.parametrize("S", [1, 3])
def test_paged_decode_logits_match(pair, prefilled, impl, S):
    """One pool step at S=1 (decode) and S=3 (verify) on the gather path
    and on attn_impl='paged' (the kernel's plain version on the CPU), with
    a parked slot (all-zero block table, length 0) beside two live ones."""
    _, jmodel, jparams, cfg, model, _, tparams = pair
    jpages, tpages, bt = prefilled
    tpages = L.tree_map(torch.clone, tpages)
    bt = bt.copy()
    lengths = np.array([13, 6, 0], np.int32)
    bt[2] = 0
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, S))
    toks = toks.astype(np.int32)
    jplan, plan = _plans(impl)
    want, jpages = jax.jit(lambda *a: jmodel.paged_decode(*a, jplan))(
        jparams, jpages, jnp.asarray(toks), jnp.asarray(bt),
        jnp.asarray(lengths))
    got, out = model.paged_decode(
        tparams, tpages, torch.from_numpy(toks), torch.from_numpy(bt),
        torch.from_numpy(lengths), plan)
    assert out is tpages
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    np.testing.assert_array_equal(got.numpy()[:2].argmax(-1),
                                  np.asarray(want)[:2].argmax(-1))
    # every page but the null sink, the new rows included
    _assert_pages_close(jpages, tpages, first_page=1)
