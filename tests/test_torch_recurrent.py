"""The port's recurrent families and slot pool against the JAX package's.

Reduced ``rwkv6-3b`` (ssm) and ``zamba2-2.7b`` (hybrid: Mamba2 blocks and
one shared attention block), with f32 weights from the JAX package's
``Model.init`` carried across by ``params_from_numpy``; token and state
inputs are made with numpy from a seed.  Logits agree within rtol=1e-4,
atol=1e-5 (the dense model's tolerance, ``test_torch_model.py``): both
sides compute in f32 and differ in summation order, over a few layers.
Cache leaves are held to rtol=1e-4 and an atol of 1e-5 times the leaf's
largest magnitude, as the dense model's pages are: an element that is a
sum of large terms cancelling to near zero is rounded at the terms' scale.
The offline bf16-stream SSD form is held to 2e-2 (bf16 keeps 8 bits; both
sides round the same products to bf16, in different orders).  The slot
pool's snapshot/restore and the scans' rollback are checked bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models import attention as jattn
from repro.models import mamba2 as jmamba2
from repro.models.model import build as jbuild
from repro.serve.cache import SlotKVPool as JSlotKVPool
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan, null_plan
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.cache import SlotKVPool

ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _models(arch):
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    model = build(get_config(arch).reduced())
    return jmodel, jparams, model, np_params, params_from_numpy(np_params,
                                                                device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, torch model, numpy params, torch params)."""
    return _models(request.param)


def _plans(model, mode, chunk=0):
    """(jax plan, torch plan) pinning the scan region's mode and chunk."""
    region = "layer/tmix" if model.cfg.family == "ssm" else "layer/ssm"
    if not mode:
        return JRegionPlan(), RegionPlan()
    return (JRegionPlan(region_configs={region: JRegionConfig(
                scan_mode=mode, chunk=chunk)}),
            RegionPlan(region_configs={region: RegionConfig(
                scan_mode=mode, chunk=chunk)}))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _close_cache(tcache, jcache):
    """Every leaf equal within TOL; ``pos`` is one entry per batch row on
    the port, one scalar on the JAX side (its batch shares a position)."""
    t, j = _flat(tcache), _flat(jcache)
    assert t.keys() == j.keys()
    for key in t:
        if key == "pos":
            assert (t[key].numpy() == int(j[key])).all()
        else:
            want = np.asarray(j[key])
            _close(t[key].float().numpy(), want, rtol=1e-4,
                   atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_params_from_numpy_carries_every_leaf(pair):
    """rwkv6's (ln_in, tmix/cmix stacks) and zamba2's (mamba stacks and
    the unstacked shared block) trees cross whole, leaf for leaf."""
    _, _, model, np_params, tparams = pair
    flat_np, flat_t = _flat(np_params), _flat(tparams)
    assert flat_np.keys() == flat_t.keys()
    assert flat_t.keys() == _flat(model.spec()).keys()
    for k, a in flat_np.items():
        assert flat_t[k].dtype == torch.float32
        np.testing.assert_array_equal(flat_t[k].numpy(), a)
    if model.cfg.family == "hybrid":
        assert any(k.startswith("shared/attn/") for k in flat_t)


@pytest.mark.parametrize("mode,T", [("", 12), ("chunk", 12), ("chunk", 70)])
def test_forward_logits_match(pair, mode, T):
    """Full-sequence forward; under scan_mode 'chunk' T=12 runs the chunked
    scan (C = min(64, T)) and T=70 the sequential one (ragged)."""
    jmodel, jparams, model, _, tparams = pair
    jplan, plan = _plans(model, mode)
    toks = _tokens(0, 2, T)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, jplan)
    got, _ = model.forward(tparams, {"tokens": torch.from_numpy(toks)}, plan)
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode,chunk,S", [("", 0, 1), ("chunk", 8, 3),
                                          ("fused_recurrent", 0, 3),
                                          ("chunk", 0, 1)])
def test_prefill_and_decode_match(pair, mode, chunk, S):
    """Prefill 16 tokens, then decode S tokens (S=3: the speculative verify
    width) twice: logits and every cache leaf after each call."""
    jmodel, jparams, model, _, tparams = pair
    jplan, plan = _plans(model, mode, chunk)
    toks = _tokens(1, 2, 16 + 2 * S)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :16])},
                            jplan, max_len=32)
    tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :16])}, plan, max_len=32)
    _close(tl.numpy(), jl)
    _close_cache(tc, jc)
    for i in range(2):
        step = toks[:, 16 + i * S:16 + (i + 1) * S]
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(step), jplan)
        tl, tc = model.decode(tparams, tc, torch.from_numpy(step), plan)
        _close(tl.numpy(), jl)
        _close_cache(tc, jc)


def test_dense_slot_prefill_and_decode_match():
    """The dense family's slot cache (transformer.prefill / decode_step):
    reduced stablelm, per-row positions all equal to JAX's scalar."""
    jmodel, jparams, model, _, tparams = _models("stablelm-1.6b")
    toks = _tokens(2, 3, 12)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])},
                            max_len=16)
    tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :8])}, max_len=16)
    _close(tl.numpy(), jl)
    for t in range(8, 12):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = model.decode(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl.numpy(), jl)
    _close_cache(tc, jc)


def test_mamba2_offline_bf16_chunked_form_matches_jax():
    """``ssm_impl='chunked'`` without a scan_mode: the bf16-stream chunked
    SSD, plain PyTorch on every device, against JAX's (2e-2: bf16)."""
    jmodel, jparams, model, np_params, tparams = _models("zamba2-2.7b")
    jcfg = jmodel.cfg
    lp_np = jax.tree.map(lambda a: a[0], np_params["blocks"]["ssm"])
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    jplan = JRegionPlan(region_configs={"layer/ssm": JRegionConfig(
        ssm_impl="chunked", chunk=8)})
    plan = RegionPlan(region_configs={"layer/ssm": RegionConfig(
        ssm_impl="chunked", chunk=8)})
    want, _ = jmamba2.apply_mamba(jcfg, jax.tree.map(jnp.asarray, lp_np),
                                  jnp.asarray(x), jplan)
    got, _ = mamba2.apply_mamba(model.cfg,
                                L.tree_map(lambda a: torch.tensor(a), lp_np),
                                torch.from_numpy(x), plan)
    _close(got.numpy(), want, rtol=2e-2, atol=2e-2)


# -- the slot pool -----------------------------------------------------------


def _rand_cache(spec, rng):
    return L.tree_map(
        lambda s: (torch.from_numpy(rng.integers(0, 100, s.shape).astype(
                       np.int32))
                   if s.dtype == torch.int32 else
                   torch.from_numpy(rng.standard_normal(s.shape).astype(
                       np.float32)).to(s.dtype)), spec)


def _spec(model):
    return model.cache_spec(1, 24, torch.float32)


@given(n_slots=st.integers(1, 4), seed=st.integers(0, 2**16))
@settings(max_examples=10, deadline=None)
def test_slot_pool_snapshot_restore_bitwise_and_in_place(n_slots, seed):
    """State after a rejected draft is exactly the state before it; a
    restore never perturbs a neighbour; the snapshot is a copy (later
    writes leave it alone); the pool keeps its tensor objects through
    write, update and restore."""
    model = build(get_config("zamba2-2.7b").reduced())
    spec = _spec(model)
    rng = np.random.default_rng(seed)
    pool = SlotKVPool(spec, n_slots, device=torch.device("cpu"))
    ids = [id(t) for t in L.tree_leaves(pool.pool)]
    slot = pool.alloc()
    before = _rand_cache(spec, rng)
    pool.write(slot, before)
    snap = pool.snapshot(slot)
    other = pool.alloc() if n_slots > 1 else None
    held = _rand_cache(spec, rng)
    if other is not None:
        pool.write(other, held)
    pool.write(slot, _rand_cache(spec, rng))        # the draft advance
    pool.update(L.tree_map(lambda t: t * 2, pool.pool))
    for s, b in zip(L.tree_leaves(snap), L.tree_leaves(before)):
        assert torch.equal(s, b)
    pool.restore(slot, snap)
    for g, w in zip(L.tree_leaves(pool.read(slot)), L.tree_leaves(before)):
        assert torch.equal(g, w)
    if other is not None:
        for g, w in zip(L.tree_leaves(pool.read(other)),
                        L.tree_leaves(held)):
            assert torch.equal(g, w * 2)
    assert [id(t) for t in L.tree_leaves(pool.pool)] == ids


def test_slot_pool_accounting_matches_jax(pair):
    """Slot and pool bytes and the occupancy high-water equal the JAX
    pool's, on the model's own slot cache."""
    jmodel, _, model, _, _ = pair
    jpool = JSlotKVPool(jmodel.cache_spec(1, 24, jnp.float32), 3)
    pool = SlotKVPool(_spec(model), 3, device=torch.device("cpu"))
    for p in (jpool, pool):
        a = p.alloc()
        p.alloc()
        p.free(a)
    assert pool.hbm_bytes() == jpool.hbm_bytes()
    assert pool.slot_bytes() == jpool.slot_bytes()
    assert (pool.high_water, pool.n_free, pool.n_active) == \
        (jpool.high_water, jpool.n_free, jpool.n_active) == (2, 2, 1)
    assert pool.high_water_bytes() == jpool.high_water_bytes()
    with pytest.raises(ValueError, match="double free"):
        pool.free(a)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("ring", [False, True])
def test_parked_slot_positions_clamp_as_jax(T, ring):
    """Per-slot decode positions past the cache (a parked pool slot keeps
    decoding, its position growing without bound): the write start clamps
    to [0, C - T] exactly as ``jax.lax.dynamic_update_slice`` clamps it,
    rows decode with their own RoPE angles and masks, and each row equals
    JAX's single-row decode at its own scalar position.  ``ring``: a
    sliding-window cache (C = window = 8), T=1 only."""
    if ring and T > 1:
        with pytest.raises(ValueError, match="ring"):
            cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                                      swa_window=8)
            cache = attn.init_kv_cache(cfg, 1, 32, torch.float32)
            attn.apply_attention_decode(cfg, _attn_params(cfg)[1],
                                        torch.zeros(1, T, 64), cache,
                                        torch.zeros(1, dtype=torch.int32),
                                        null_plan())
        return
    jcfg = jget_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    if ring:
        jcfg = dataclasses.replace(jcfg, swa_window=8)
        cfg = dataclasses.replace(cfg, swa_window=8)
    jp, tp = _attn_params(cfg)
    C = 8 if ring else 16
    pos = np.array([0, 5, C - 1, C + 7, 5 * C + 3], np.int32)
    B = pos.size
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    kv = rng.standard_normal((2, B, C, cfg.n_kv_heads, 16)).astype(np.float32)
    cache = {"k": torch.from_numpy(kv[0].copy()),
             "v": torch.from_numpy(kv[1].copy())}
    out, cache = attn.apply_attention_decode(
        cfg, tp, torch.from_numpy(x), cache, torch.from_numpy(pos),
        null_plan())
    for b in range(B):
        jout, jc = jattn.apply_attention_decode(
            jcfg, jp, jnp.asarray(x[b:b + 1]),
            {"k": jnp.asarray(kv[0, b:b + 1]),
             "v": jnp.asarray(kv[1, b:b + 1])},
            jnp.int32(pos[b]), JRegionPlan())
        _close(out[b:b + 1].numpy(), jout)
        _close(cache["k"][b:b + 1].numpy(), jc["k"])
        _close(cache["v"][b:b + 1].numpy(), jc["v"])


def _attn_params(cfg):
    """(jax, torch) shared-attention params of the reduced zamba2, from
    numpy."""
    rng = np.random.default_rng(8)
    shapes = {"wq": (64, cfg.n_heads, 16), "wk": (64, cfg.n_kv_heads, 16),
              "wv": (64, cfg.n_kv_heads, 16), "wo": (cfg.n_heads, 16, 64)}
    arrs = {k: (rng.standard_normal(s) * 0.125).astype(np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrs.items()},
            {k: torch.from_numpy(a) for k, a in arrs.items()})


@given(Tp=st.integers(1, 24), D=st.integers(1, 4), A=st.integers(0, 4),
       seed=st.integers(0, 2**16))
@settings(max_examples=15, deadline=None)
def test_scan_snapshot_restore_rollback_bitwise(Tp, D, A, seed):
    """Snapshot -> draft D tokens -> restore -> re-advance the A accepted
    == an uninterrupted scan over Tp + A tokens, bitwise, for both
    recurrences (the contract the engine's speculation rests on)."""
    A = min(A, D)
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    T = Tp + D
    wkv = ([f32(n((1, T, 2, 8)) * 0.3) for _ in range(3)]
           + [f32(0.45 + 0.5 / (1 + np.exp(-n((1, T, 2, 8)))))],
           (f32(n((2, 8)) * 0.1), f32(n((1, 2, 8, 8)) * 0.1)),
           rwkv6.wkv_scan)
    ssd = ([f32(n((1, T, 2, 8)) * 0.3), f32(n((1, T, 8)) * 0.3),
            f32(n((1, T, 8)) * 0.3), f32(np.log1p(np.exp(n((1, T, 2)))))],
           (f32(-np.exp(n((2,)) * 0.3)), f32(n((1, 2, 8, 8)) * 0.1)),
           mamba2.ssd_scan)
    for seqs, (const, s0), scan in (wkv, ssd):
        sl = lambda lo, hi: [t[:, lo:hi] for t in seqs]  # noqa: E731
        _, snap = scan(*sl(0, Tp), const, s0)
        scan(*sl(Tp, Tp + D), const, snap)          # the rejected draft
        s_roll = snap if A == 0 else scan(*sl(Tp, Tp + A), const, snap)[1]
        _, s_want = scan(*sl(0, Tp + A), const, s0)
        assert torch.equal(s_roll, s_want)
