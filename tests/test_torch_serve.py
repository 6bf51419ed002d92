"""The port's paged serving engine against the JAX package's.

One reduced ``stablelm-1.6b`` with f32 weights from the JAX package's
``Model.init`` (bridged through numpy); the same request traces, made with
numpy from a seed, are served greedily by the JAX ``Engine`` and by the
port's ``Engine(device="cpu")``.  Greedy tokens must be identical, and the
pool's and governor's counts equal: both engines run the same host-side
bookkeeping over logits that agree to f32 rounding.
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
from repro.serve import cache as jcache
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan, null_plan
from repro_torch.kernels import LAUNCHES
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve import cache
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("stablelm-1.6b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config("stablelm-1.6b").reduced())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, model, tparams


def _plans(impl="paged"):
    return (JRegionPlan(region_configs={"layer/attn": JRegionConfig(
                attn_impl=impl)}),
            RegionPlan(region_configs={"layer/attn": RegionConfig(
                attn_impl=impl)}))


def _traces(prompts, gens):
    """The same trace as JAX Requests and as the port's Requests."""
    def mk(cls):
        return [cls(rid=i, prompt=np.asarray(p, np.int32).copy(),
                    max_new_tokens=g) for i, (p, g) in enumerate(zip(prompts,
                                                                     gens))]
    return mk(JRequest), mk(Request)


def _serve_both(models, prompts, gens, jplan=None, plan=None, **cfg):
    jmodel, jparams, model, tparams = models
    jreqs, treqs = _traces(prompts, gens)
    jres = JEngine(jmodel, jparams, plan=jplan,
                   serve_cfg=JServeConfig(**cfg)).serve(jreqs)
    teng = Engine(model, tparams, plan=plan, serve_cfg=ServeConfig(**cfg),
                  device="cpu")
    tres = teng.serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    assert tres["page_leaks"] == 0
    return jres, tres, teng


@pytest.mark.parametrize("depth", [0, 2])
def test_paged_kernel_path_tokens_match_jax(models, depth):
    """attn_impl='paged' (the kernel's plain version on the CPU; Pallas in
    interpret mode on the JAX side), chunked prefill, spec_depth 0 and 2:
    identical greedy tokens, step counts and speculation counts."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n) for n in (5, 12, 20, 9, 17)]
    gens = [6, 10, 8, 12, 7]
    jplan, plan = _plans("paged")
    launches = dict(LAUNCHES)
    jres, tres, _ = _serve_both(models, prompts, gens, jplan, plan,
                                max_len=40, max_slots=3, prefill_chunk=8,
                                spec_depth=depth)
    assert tres["steps"] == jres["steps"]
    assert tres["spec"] == jres["spec"]
    assert tres["health"]["fallbacks"] == 0
    assert LAUNCHES == launches         # the CPU path launches no kernel


def test_lazy_reservation_preemption_matches_jax(models):
    """Overcommit (6 decode-heavy requests over 10 allocatable pages) with
    lazy reservation: both engines preempt, grow and stall identically and
    every request completes with the same tokens."""
    rng = np.random.default_rng(0)
    prompts = list(rng.integers(0, 256, (6, 8)))
    gens = [20, 20, 24, 20, 20, 24]
    jplan, plan = _plans("")
    jres, tres, teng = _serve_both(
        models, prompts, gens, jplan, plan, max_len=33, max_slots=4,
        page_size=8, prefill_chunk=8, kv_pages=11, reservation="lazy",
        mem_watermark=0.0)
    jm, tm = jres["memory"], tres["memory"]
    assert tm["preemptions"] >= 1
    for k in ("preemptions", "grown_pages", "stall_steps", "peak_resident",
              "free_pages_min"):
        assert tm[k] == jm[k], k
    teng._pool.allocator.check_invariants()
    assert teng._pool.allocator.n_live == 0


def test_cow_prefix_sharing_matches_jax(models):
    """Prefix caching under lazy reservation: full-prefix hits adopt the
    partially-covered boundary page and copy it on first write (CoW); the
    hit, saved-token and copy counts equal the JAX pool's, and the pool's
    page tensors are the same objects after every in-place copy."""
    rng = np.random.default_rng(0)
    P = rng.integers(0, 256, (24,))
    div = np.concatenate([P[:16], rng.integers(0, 256, (8,))])
    jmodel, jparams, model, tparams = models
    jplan, plan = _plans("paged")
    cfg = dict(max_len=40, max_slots=2, page_size=8, prefill_chunk=8,
               spec_depth=2, prefix_cache="on", reservation="lazy")
    jreqs, treqs = _traces([P, P, P, div], [8, 8, 10, 8])
    jres = JEngine(jmodel, jparams, plan=jplan,
                   serve_cfg=JServeConfig(**cfg)).serve(jreqs)
    teng = Engine(model, tparams, plan=plan, serve_cfg=ServeConfig(**cfg),
                  device="cpu")
    teng._ensure_pool()
    ids = [id(t) for t in teng._pool.page_tensors()]
    tres = teng.serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    jp, tp = jres["memory"]["prefix"], tres["memory"]["prefix"]
    assert tp["cow_copies"] >= 1 and tp["hit_requests"] >= 2
    for k in ("hit_requests", "tokens_saved", "cow_copies", "evictions",
              "indexed_pages"):
        assert tp[k] == jp[k], k
    assert [id(t) for t in teng._pool.page_tensors()] == ids


def test_injected_faults_walk_the_same_health_ladder(models):
    """Seeded logits.nan injection: the same fault schedule on both sides
    gives the same retries, the same safe-plan fallbacks (the port falls
    back from the kernel path to the gather path) and the same tokens."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n) for n in (6, 11, 7)]
    gens = [12, 10, 14]
    jplan, plan = _plans("paged")
    cfg = dict(max_len=40, max_slots=3, prefill_chunk=8, chaos_rate=0.3,
               chaos_seed=3, chaos_sites=("logits.nan",), max_retries=8)
    jreqs, treqs = _traces(prompts, gens)
    jmodel, jparams, model, tparams = models
    jres = JEngine(jmodel, jparams, plan=jplan,
                   serve_cfg=JServeConfig(**cfg)).serve(jreqs)
    tres = Engine(model, tparams, plan=plan, serve_cfg=ServeConfig(**cfg),
                  device="cpu").serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert (b.state.value, b.out_tokens) == (a.state.value, a.out_tokens)
    assert tres["failures"]["retries"] == jres["failures"]["retries"] > 0
    assert tres["health"]["fallbacks"] == jres["health"]["fallbacks"]
    assert tres["faults"]["injected_total"] == jres["faults"]["injected_total"]


def test_page_allocator_matches_jax_under_random_ops():
    """The same random sequence of alloc / append / share / replace / drop
    / free on both allocators: identical results, invariants after every
    operation."""
    rng = np.random.default_rng(7)
    a, b = jcache.PageAllocator(24), cache.PageAllocator(24)
    a.track_solo("idx")
    b.track_solo("idx")
    owners: list = []
    for step in range(400):
        op = rng.integers(0, 6)
        if op == 0:
            o = step + 100                  # a fresh owner every time
            n = int(rng.integers(0, 4))
            ra, rb = a.alloc(o, n), b.alloc(o, n)
            assert ra == rb
            if ra is not None:
                owners.append(o)
        elif not owners:
            continue
        else:
            o = owners[int(rng.integers(0, len(owners)))]
            if op == 1:
                assert a.append(o) == b.append(o)
            elif op == 2 and a.pages_of(o):
                pg = a.pages_of(o)[:int(rng.integers(1, 3))]
                if not set(pg) & set(a.pages_of("idx")):
                    a.share("idx", pg)
                    b.share("idx", pg)
            elif op == 3 and a.pages_of(o):
                old = a.pages_of(o)[0]
                assert a.replace(o, old) == b.replace(o, old)
            elif op == 4 and a.pages_of(o):
                pg = a.pages_of(o)[-1]
                assert a.drop(o, pg) == b.drop(o, pg)
            elif op == 5:
                assert a.free(o) == b.free(o)
                owners.remove(o)
        b.check_invariants()
        assert (b.n_free, b.n_live, b.n_solo, b.high_water) == \
            (a.n_free, a.n_live, a.n_solo, a.high_water)
        assert b.free_run_histogram() == a.free_run_histogram()


def test_features_outside_the_slice_raise(models, monkeypatch):
    """What the engine refuses, it refuses as the JAX engine does —
    never silently dropped.  (The slot pool, paged='off', and the static
    generate() are ported: tests/test_torch_slot_serve.py; the decision
    tree and the online loop: tests/test_torch_autotune_serve.py; MoE:
    tests/test_torch_moe.py; telemetry: tests/test_torch_telemetry.py.)
    A tensor-parallel degree clamps down to the ranks, as in the JAX
    package, and resolves without a raise for every family the paged
    pool serves, MoE included (served at tp 2:
    tests/test_torch_tp_serving.py and
    tests/test_torch_tp_serving_moe.py).  An encoder-decoder model
    builds, and the engine refuses to serve it with continuous batching,
    as the JAX engine does (tests/test_torch_whisper.py)."""
    _, _, model, tparams = models
    whisper = build(get_config("whisper-large-v3").reduced())
    with pytest.raises(NotImplementedError,
                       match=r"use generate\(\) for encdec"):
        Engine(whisper, whisper.init(0, dtype=torch.float32, device="cpu"),
               device="cpu").serve(_traces([np.arange(4)], [2])[1])
    with pytest.raises(ValueError, match="paged KV unsupported"):
        Engine(build(get_config("rwkv6-3b").reduced()), {},
               serve_cfg=ServeConfig(paged="on"), device="cpu").serve([])
    tp2 = RegionPlan(region_configs={"layer/attn": RegionConfig(tp_degree=2)})
    monkeypatch.setattr(Engine, "_n_devices", lambda self: 2)
    for kw in (dict(plan=tp2), dict(serve_cfg=ServeConfig(tp=2))):
        eng = Engine(model, tparams, device="cpu", **kw)
        assert eng.tp_for(eng.plan) == 2
    moe = build(get_config("qwen2-moe-a2.7b").reduced())
    assert Engine(moe, {}, device="cpu", serve_cfg=ServeConfig(tp=2)).tp_for(
        null_plan()) == 2


@pytest.mark.parametrize("arrival", ["poisson", "burst"])
def test_trace_matches_jax_and_draws_prompt_lengths(arrival):
    """The launcher's trace equals the JAX launcher's for the same flags;
    ``--prompt-max`` draws each prompt's length from [--prompt-len,
    --prompt-max] (the smoke's serve traffic) and leaves the default trace
    as it was."""
    import argparse

    from repro.launch.serve import build_trace as jbuild_trace
    from repro_torch.launch.serve import build_trace
    args = argparse.Namespace(seed=3, arrival=arrival, rate=20.0,
                              requests=16, gen_min=32, gen_max=64,
                              prompt_len=64, prompt_max=0)
    want, got = jbuild_trace(args, 256), build_trace(args, 256)
    assert [(r.prompt.tolist(), r.max_new_tokens, r.arrival_s)
            for r in got] == [(r.prompt.tolist(), r.max_new_tokens,
                               r.arrival_s) for r in want]
    args.prompt_max = 512
    ranged = build_trace(args, 256)
    lens = [len(r.prompt) for r in ranged]
    assert all(64 <= n <= 512 for n in lens) and len(set(lens)) > 1
    assert [r.arrival_s for r in ranged] == [r.arrival_s for r in want]


def test_serve_config_fields_match_jax():
    """The port's ServeConfig has exactly the JAX package's fields, in the
    same order and with the same defaults, so a reference caller's
    keyword arguments mean the same thing in both."""
    import dataclasses
    jf = [(f.name, f.default) for f in dataclasses.fields(JServeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    assert tf == jf
    assert (ServeConfig().prefill_bucket, ServeConfig().autoplan,
            ServeConfig().autoplan_top_n) == (0, True, 2)


def test_paged_result_mesh_matches_jax(models):
    """The paged serve's result carries the reference's ``mesh`` entry:
    tp 1, one device here, and the pool's page, HBM and high-water bytes
    per device, equal to the JAX engine's."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n) for n in (6, 13, 9)]
    jres, tres, teng = _serve_both(models, prompts, [5, 7, 6], max_len=32,
                                   max_slots=2, page_size=8)
    assert tres["mesh"] == jres["mesh"]
    pool = teng._pool
    assert tres["mesh"] == {
        "tp": 1, "devices": 1,
        "page_bytes_per_device": pool.page_bytes(),
        "hbm_bytes_per_device": pool.hbm_bytes(),
        "high_water_bytes_per_device": pool.high_water_bytes()}
    assert tres["mesh"]["high_water_bytes_per_device"] > 0


class _ConstTree:
    """A decision tree that votes one class everywhere."""
    def __init__(self, cls):
        self.cls = cls

    def predict_one(self, x):
        return self.cls


@pytest.mark.parametrize("autoplan,top_n", [(False, 2), (True, 8)])
def test_autoplan_fields_match_jax(models, autoplan, top_n):
    """``autoplan=False``: a supplied tree is never consulted (no
    decisions, the base plan's spec depth 0); ``autoplan_top_n=8``: the
    tree is consulted for the eight hottest regions, not two.  Decisions,
    steps, speculation and greedy tokens equal the JAX engine's."""
    jmodel, jparams, model, tparams = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in (6, 9, 7, 11)]
    jreqs, treqs = _traces(prompts, [8, 6, 9, 7])
    cfg = dict(max_len=32, max_slots=2, page_size=8, spec_depth=-1,
               autoplan=autoplan, autoplan_top_n=top_n)
    jres = JEngine(jmodel, jparams, serve_cfg=JServeConfig(**cfg),
                   dtree=_ConstTree("spec2")).serve(jreqs)
    teng = Engine(model, tparams, serve_cfg=ServeConfig(**cfg),
                  dtree=_ConstTree("spec2"), device="cpu")
    tres = teng.serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    assert tres["decisions"] == jres["decisions"]
    assert (tres["steps"], tres["spec"]) == (jres["steps"], jres["spec"])
    if autoplan:
        assert tres["decisions"]
        assert max(len(d) for _, d in tres["decisions"]) > 2
        assert tres["spec"]["max_depth"] == 2
    else:
        assert tres["decisions"] == [] and teng._pool_rc is None
        assert tres["spec"]["max_depth"] == 0
