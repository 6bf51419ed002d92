"""The paper loop on the port's serve engine against the JAX engine's.

The four engine cases of ``test_autotune_online.py`` (a hot-swapped tree
takes effect within the current bucket; online retraining keeps greedy
output bit-identical; a mid-window class change flushes the old
attribution; ``autotune_summary`` works with the loop off), each also
serving a trace through both engines with identical greedy tokens in f32.
Then single-class trees — ``spec2``, ``mem_lazy`` and ``tp2`` on reduced
``stablelm-1.6b`` (paged pool), ``scan_chunk_ssd`` on reduced
``zamba2-2.7b`` (slot pool; ``scan_chunk`` is rwkv6's time-mix class) —
whose plan decisions and greedy tokens must equal the JAX engine's, and
the ``tp_for`` repair: a plan asking ``tp_degree=2`` serves on one device
like the JAX engine, at tp 1.  Weights come from the JAX package's
``Model.init`` through numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState

CFG = dict(max_len=32, max_slots=2, page_size=8)


class _FixedTree:
    """Stand-in tree with a hand-set decision rule."""
    def __init__(self, fn):
        self.fn = fn

    def predict_one(self, x):
        return self.fn(np.asarray(x))


def _const(cls):
    return _FixedTree(lambda x: cls)


def _models(arch):
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config(arch).reduced())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, model, tparams


@pytest.fixture(scope="module")
def stablelm():
    return _models("stablelm-1.6b")


def _traces(vocab, n=4, gen=8, plen=6, seed=3):
    """The same trace as JAX Requests and as the port's Requests."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, plen).astype(np.int32)
               for _ in range(n)]
    return ([JRequest(rid=i, prompt=p.copy(), max_new_tokens=gen)
             for i, p in enumerate(prompts)],
            [Request(rid=i, prompt=p.copy(), max_new_tokens=gen)
             for i, p in enumerate(prompts)])


def _engines(models, jplan=None, plan=None, jtree=None, tree=None, **kw):
    jmodel, jparams, model, tparams = models
    cfg = {**CFG, **kw}
    return (JEngine(jmodel, jparams, plan=jplan, serve_cfg=JServeConfig(**cfg),
                    dtree=jtree),
            Engine(model, tparams, plan=plan, serve_cfg=ServeConfig(**cfg),
                   dtree=tree, device="cpu"))


def _serve_both(jeng, eng, vocab, **trace):
    """Serve one trace through both engines: every request DONE, greedy
    tokens identical; returns both results."""
    jreqs, treqs = _traces(vocab, **trace)
    jres, tres = jeng.serve(jreqs), eng.serve(treqs)
    for a, b in zip(jreqs, treqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    return jres, tres


def test_hot_swapped_dtree_takes_effect_within_the_current_bucket(stablelm):
    jeng, eng = _engines(stablelm, jtree=_const("spec2"), tree=_const("spec2"))
    for e in (jeng, eng):
        e._ensure_pool()
        e._maybe_replan(2)
        assert e._spec_depth == 2
        n_log = len(e.decisions_log)
        e._maybe_replan(2)                  # same bucket, same tree: latched
        assert len(e.decisions_log) == n_log
        e.dtree = _const("spec4")           # hot-swap mid-bucket
        e._maybe_replan(2)
        assert e._spec_depth == 4, "swapped tree never took effect"
        assert len(e.decisions_log) == n_log + 1
        assert dict(e.decisions_log[-1][1])["layer/attn"] == "spec4"
    assert eng.decisions_log == jeng.decisions_log
    jres, tres = _serve_both(jeng, eng, 256)
    assert tres["decisions"] == jres["decisions"]
    assert tres["spec"]["max_depth"] == jres["spec"]["max_depth"] == 4


def test_online_retrain_keeps_greedy_output_bit_identical(stablelm):
    """With exploration off the online loop (tap -> corpus -> retrain ->
    swap) changes no greedy token: the port's plain engine, its online
    engine and the JAX online engine agree."""
    jmodel, jparams, model, tparams = stablelm
    plain = Engine(model, tparams, device="cpu",
                   serve_cfg=ServeConfig(**CFG, spec_depth=0))
    jeng, online = _engines(stablelm, spec_depth=-1, online_retrain=True,
                            retrain_interval=3, explore_eps=0.0)
    _, reqs_a = _traces(256)
    plain.serve(reqs_a)
    jres, res = _serve_both(jeng, online, 256)
    _, reqs_b = _traces(256)
    online_again = online.serve(reqs_b)
    for a, b in zip(reqs_a, reqs_b):
        assert a.out_tokens == b.out_tokens
    at, jat = res["autotune"], jres["autotune"]
    assert at["corpus_entries"] >= 1
    assert at["retrains"] >= 1 and at["swaps"] >= 1
    assert (at["retrains"], at["swaps"]) == (jat["retrains"], jat["swaps"])
    assert online.dtree is not None and at["explore_fraction"] == 0.0
    assert online_again["autotune"]["steps"] > at["steps"]
    n_steps = len(online._pool_steps)
    online.autotune_reset(tree=None)
    assert len(online.corpus) == 0 and online.dtree is None
    assert online.autotune_stats["retrains"] == 0
    assert len(online._pool_steps) == n_steps


def test_mid_window_class_change_flushes_old_attribution(stablelm):
    jeng, eng = _engines(stablelm, jtree=_const("spec2"), tree=_const("spec2"),
                         spec_depth=0, online_retrain=True,
                         retrain_interval=100, explore_eps=0.0)
    for e in (jeng, eng):
        e._ensure_pool()
        e._maybe_replan(2)
        assert e._bucket_class[2] == "spec2"
        e._tap_step(2, 8, 0.01)
        e._tap_step(2, 8, 0.01)
        e.dtree = _const("spec4")
        e._maybe_replan(2)
        assert e._bucket_class[2] == "spec4"
        spec2 = [x for x in e.corpus.entries() if x.chosen_class == "spec2"]
        assert spec2 and spec2[0].rewarded, "old-class window lost"
        assert np.isclose(spec2[0].reward, 16 / 0.02)
        assert not any(x.chosen_class == "spec4"
                       for x in e.corpus.entries())
        assert 2 not in e._tap_acc
    assert ([(x.region, x.chosen_class, x.reward, x.n)
             for x in eng.corpus.entries()]
            == [(x.region, x.chosen_class, x.reward, x.n)
                for x in jeng.corpus.entries()])
    _serve_both(jeng, eng, 256)


def test_serve_reports_autotune_summary_even_when_off(stablelm):
    jeng, eng = _engines(stablelm, spec_depth=0)
    jres, res = _serve_both(jeng, eng, 256, n=2, gen=4)
    assert res["autotune"] == jres["autotune"]
    assert res["autotune"]["retrains"] == res["autotune"]["swaps"] == 0
    assert res["decisions"] == jres["decisions"] == []


@pytest.mark.parametrize("cls,knob", [("spec2", ("spec_depth", 2)),
                                      ("mem_lazy", ("reservation", "lazy")),
                                      ("tp2", ("tp_degree", 2))])
def test_single_class_tree_decides_like_jax(stablelm, cls, knob):
    """A tree that always votes one class: the same decisions at every
    load bucket, the knob on the decided plan, identical greedy tokens."""
    jeng, eng = _engines(stablelm, jtree=_const(cls), tree=_const(cls),
                         spec_depth=-1, reservation="auto", tp=0)
    jres, res = _serve_both(jeng, eng, 256, n=4, gen=10)
    assert res["decisions"] == jres["decisions"] and res["decisions"]
    assert all(dict(d)["layer/attn"] == cls for _, d in res["decisions"])
    name, value = knob
    assert getattr(eng._decided_plan.config_for("layer0/attn"), name) == value
    assert res["steps"] == jres["steps"]
    if cls == "spec2":
        assert res["spec"] == jres["spec"] and res["spec"]["max_depth"] == 2
    if cls == "tp2":
        assert eng.tp_for(eng._decided_plan) == 1   # clamped to one device


def test_tp2_plan_serves_on_one_device_like_jax(stablelm):
    """The tp_for repair: layer0/attn asks tp_degree=2 under ServeConfig(
    tp=0); both engines clamp to the one device and serve at tp 1."""
    jplan = JRegionPlan(region_configs={"layer0/attn": JRegionConfig(
        tp_degree=2)})
    plan = RegionPlan(region_configs={"layer0/attn": RegionConfig(
        tp_degree=2)})
    jeng, eng = _engines(stablelm, jplan=jplan, plan=plan, tp=0)
    assert eng.tp_for(plan) == jeng.tp_for(jplan) == 1
    _serve_both(jeng, eng, 256, n=3, gen=6)


def test_scan_class_tree_on_the_slot_pool_decides_like_jax():
    """zamba2's mamba block on the slot pool: a tree voting the chunked
    SSD scan replans both engines alike and pins the decode scan mode;
    greedy tokens equal the JAX engine's."""
    models = _models("zamba2-2.7b")
    jeng, eng = _engines(models, jtree=_const("scan_chunk_ssd"),
                         tree=_const("scan_chunk_ssd"), paged="off",
                         max_len=48)
    vocab = models[2].cfg.vocab_size
    jres, res = _serve_both(jeng, eng, vocab, n=3, gen=5, plen=7)
    assert res["decisions"] == jres["decisions"] and res["decisions"]
    assert eng.scan_mode_for(eng._decided_plan) == "chunk"
    assert jeng.scan_mode_for(jeng._decided_plan) == "chunk"
