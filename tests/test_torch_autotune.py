"""The port's autotuning layers (``repro_torch.autotune``, ``core.dtree``,
``core.tuner``) against the JAX package's.

Every case of ``test_tuner.py``, ``test_plan_decider.py`` and the
non-engine part of ``test_autotune_online.py``, run through both packages
on the same inputs: the tree JSON, the decisions, the search history, the
explorer's picks and the corpus JSONL bytes must be identical, and each
package must load the other's files.  The engine cases are in
``test_torch_autotune_serve.py``.
"""
import dataclasses
import math
import os
import tempfile
import types

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

import repro.autotune as jat
import repro.core.tuner as jtuner
import repro_torch.autotune as tat
import repro_torch.core.tuner as ttuner
from repro.autotune import candidates as jcand
from repro.autotune import corpus as jcorpus
from repro.core import counters as jcounters
from repro.core import dtree as jdtree
from repro.core import policy as jpolicy
from repro.core import roofline as jroofline
from repro.serve import engine as jengine
from repro_torch.autotune import candidates as tcand
from repro_torch.autotune import corpus as tcorpus
from repro_torch.core import counters as tcounters
from repro_torch.core import dtree as tdtree
from repro_torch.core import policy as tpolicy
from repro_torch.core import roofline as troofline
from repro_torch.serve import engine as tengine


def _ns(at, tuner, cand, corpus, counters, dtree, policy, roofline, engine):
    return types.SimpleNamespace(
        Counters=counters.Counters, DecisionTree=dtree.DecisionTree,
        features=dtree.features, FEATURE_NAMES=dtree.FEATURE_NAMES,
        RegionConfig=policy.RegionConfig, RegionPlan=policy.RegionPlan,
        null_plan=policy.null_plan, Roofline=roofline.Roofline,
        Candidate=tuner.Candidate, TuneResult=tuner.TuneResult,
        Tuner=tuner.Tuner, autotune=tuner.autotune,
        canonical=tuner.canonical, explore_menu=cand.explore_menu,
        PlanDecider=engine.PlanDecider, load_bucket=engine.load_bucket,
        Corpus=at.Corpus, OnlineTrainer=at.OnlineTrainer,
        holdout_value=at.holdout_value,
        EpsilonGreedyExplorer=at.EpsilonGreedyExplorer,
        bucket_log_ms=corpus.bucket_log_ms, bucket_rate=corpus.bucket_rate)


J = _ns(jat, jtuner, jcand, jcorpus, jcounters, jdtree, jpolicy, jroofline,
        jengine)
T = _ns(tat, ttuner, tcand, tcorpus, tcounters, tdtree, tpolicy, troofline,
        tengine)


def both(fn):
    """Run ``fn`` against each package; assert identical results; return
    the port's."""
    got, want = fn(T), fn(J)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the offline search (test_tuner.py)
# ---------------------------------------------------------------------------


class FakeRC:
    """RegionCounters stand-in with a controllable cost model."""
    def __init__(self, P, regions):
        self.regions = regions
        self.total = P.Counters()
        for c in regions.values():
            self.total.add(c)

    def top_regions(self, key, n):
        items = [(r, getattr(c, key)) for r, c in self.regions.items()]
        return sorted(items, key=lambda kv: -kv[1])[:n]


def fake_evaluator(P):
    """Region 'layer0/attn' is memory-bound unless the plan sets
    block_q=1024, which cuts its bytes 4x."""
    def evaluate(plan):
        attn_bytes = (8e12 if plan.config_for("layer0/attn").block_q != 1024
                      else 2e12)
        rc = FakeRC(P, {"layer0/attn": P.Counters(flops=1e14,
                                                  bytes=attn_bytes),
                        "layer0/mlp": P.Counters(flops=8e13, bytes=5e11)})
        rl = P.Roofline(compute_s=rc.total.flops / 197e12,
                        memory_s=rc.total.bytes / 819e9, collective_s=0.0)
        return rl.bound_s, rc, rl
    return evaluate


def _mem_bound(P, rc):
    return P.Roofline(compute_s=rc.total.flops / 1e18,
                      memory_s=rc.total.bytes / 819e9, collective_s=0.0)


def _blockq_cands(P, both_sizes=True):
    cands = [P.Candidate("attn_blockq_1k", P.RegionConfig(block_q=1024),
                         "attn")]
    if both_sizes:
        cands.append(P.Candidate("attn_blockq_4k",
                                 P.RegionConfig(block_q=4096), "attn"))
    return cands


def _result(res):
    """A TuneResult as plain data."""
    return (res.best_bound_s, res.baseline_bound_s,
            [dataclasses.astuple(h) for h in res.history],
            [(list(map(float, f)), c) for f, c in res.corpus],
            {k: rc.to_json() for k, rc in res.plan.region_configs.items()})


def test_autotune_finds_the_win():
    def run(P):
        res = P.autotune(None, None, kind="train", candidates=_blockq_cands(P),
                         evaluate=fake_evaluator(P), max_iters=4,
                         verbose=False)
        return _result(res)

    best, base, history, corpus, plan = both(run)
    assert best < base * 0.5
    assert plan["layer/attn"]["block_q"] == 1024
    assert any(h[7] for h in history) and len(corpus) >= 1


def test_canonical():
    assert both(lambda P: (P.canonical("layer12/attn"),
                           P.canonical("enc3"))) == ("layer/attn", "enc")


def test_autotune_rejects_below_min_gain():
    def run(P):
        def evaluate(plan):
            frac = (0.99 if plan.config_for("layer0/attn").block_q == 1024
                    else 1.0)
            rc = FakeRC(P, {
                "layer0/attn": P.Counters(flops=1e12, bytes=8e12 * frac),
                "layer0/mlp": P.Counters(flops=1e12, bytes=1e11)})
            return _mem_bound(P, rc).bound_s, rc, _mem_bound(P, rc)

        res = P.autotune(None, None, kind="train",
                         candidates=_blockq_cands(P, False),
                         evaluate=evaluate, max_iters=5, min_gain=0.02,
                         verbose=False)
        return _result(res)

    best, base, history, corpus, plan = both(run)
    assert history and not any(h[7] for h in history)
    assert all(h[8] for h in history) and best == base
    assert "layer/attn" not in plan
    assert corpus and corpus[0][1] == "attn_blockq_1k"


def test_autotune_tried_set_exhausts_without_repeats():
    def run(P):
        evals = []

        def evaluate(plan):
            enc = 2e12 if plan.config_for("enc/attn").block_q == 1024 else 8e12
            dec = 1e12 if plan.config_for("dec/attn").block_q == 1024 else 4e12
            rc = FakeRC(P, {"enc/attn": P.Counters(flops=1e12, bytes=enc),
                            "dec/attn": P.Counters(flops=1e12, bytes=dec)})
            evals.append((enc, dec))
            return _mem_bound(P, rc).bound_s, rc, _mem_bound(P, rc)

        res = P.autotune(None, None, kind="train", candidates=_blockq_cands(P),
                         evaluate=evaluate, max_iters=10, verbose=False)
        return _result(res), evals

    (_, _, history, corpus, plan), evals = both(run)
    assert plan["enc/attn"]["block_q"] == plan["dec/attn"]["block_q"] == 1024
    tried = [(h[1], h[4]) for h in history]
    assert len(tried) == len(set(tried)) == 4 and len(evals) == 5
    assert {c for _, c in corpus} == {"attn_blockq_1k"}


def test_autotune_corpus_feeds_dtree():
    def run(P):
        res = P.autotune(None, None, kind="train", candidates=_blockq_cands(P),
                         evaluate=fake_evaluator(P), max_iters=4,
                         verbose=False)
        one = P.TuneResult(plan=P.RegionPlan(), best_bound_s=0.0,
                           baseline_bound_s=0.0, history=[],
                           corpus=res.corpus[:1])
        doubled = P.TuneResult(plan=P.RegionPlan(), best_bound_s=0.0,
                               baseline_bound_s=0.0, history=[],
                               corpus=res.corpus * 2)
        tree = doubled.train_dtree()
        X = np.stack([f for f, _ in doubled.corpus])
        return one.train_dtree() is None, tree.to_json(), tree.predict(X)

    none_for_one, _, pred = both(run)
    assert none_for_one and set(pred) <= {"attn_blockq_1k", "keep_default"}


def _separable(P, seed=0):
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(60):
        ai = rng.uniform(0.5, 200)
        c = P.Counters(flops=ai * 1e9, bytes=1e9,
                       link_bytes=rng.uniform(0, 1e6))
        X.append(P.features(c))
        y.append("chunk" if ai < 20 else "keep")
    return np.stack(X), y


def test_dtree_learns_separable_rule():
    """Identical tree JSON for the same (X, y) in both packages."""
    def run(P):
        X, y = _separable(P)
        tree = P.DecisionTree(max_depth=4).fit(X, y)
        tree2 = P.DecisionTree.from_json(tree.to_json())
        return (tree.to_json(), tree.score(X, y),
                tree2.predict(X) == tree.predict(X))

    text, score, same = both(run)
    assert score > 0.95 and same
    # each package reads the other's tree
    X, y = _separable(T)
    assert (J.DecisionTree.from_json(text).predict(X)
            == T.DecisionTree.from_json(text).predict(X))


def test_dtree_single_class():
    assert both(lambda P: P.DecisionTree().fit(
        np.zeros((3, 7)), ["a", "a", "a"]).predict(np.zeros((3, 7)))) == [
        "a", "a", "a"]


def test_core_tuner_shim_reexports_the_autotune_package():
    from repro_torch.core.tuner import (Candidate, Iteration,  # noqa: F401
                                        TuneResult, Tuner, autotune,
                                        canonical, compile_evaluator,
                                        default_candidates)
    assert Tuner is tat.Tuner and autotune is tat.autotune
    assert default_candidates is tat.default_candidates

    def run(P):
        res = P.Tuner(kind="train", candidates=_blockq_cands(P), max_iters=4,
                      verbose=False).autotune(None, None,
                                              evaluate=fake_evaluator(P))
        corpus = res.to_corpus()
        return (_result(res), len(corpus),
                [e.to_json() for e in corpus.entries()])

    (best, base, _, corpus, _), n, entries = both(run)
    assert best < base * 0.5 and n == len(corpus)
    assert all(e["reward"] is None for e in entries)
    assert {c.name for c in tat.default_candidates("decode")} == {
        c.name for c in jat.default_candidates("decode")}


def test_compile_evaluator_counts_the_plan_on_meta():
    """The port's default evaluator: build_fn(plan) returns (fn, args),
    counted on the meta device and scored by its roofline bound."""
    import torch
    from repro_torch.core.regions import region

    def build_fn(plan):
        n = 256 if plan.config_for("layer0/attn").block_q == 1024 else 1024

        def fn(x):
            with region("layer0"), region("attn"):
                return x @ x
        return fn, [torch.ones(n, n)]

    evaluate = ttuner.compile_evaluator(build_fn)
    score, rc, rl = evaluate(tpolicy.null_plan())
    assert rc.regions["layer0/attn"].flops == 2 * 1024 ** 3
    assert score == rl.bound_s == troofline.from_counters(rc.total).bound_s
    res = ttuner.autotune(build_fn, None, kind="train",
                          candidates=_blockq_cands(T), verbose=False)
    assert res.plan.config_for("layer0/attn").block_q == 1024
    assert res.best_bound_s < res.baseline_bound_s / 10


# ---------------------------------------------------------------------------
# the serve-time decider (test_plan_decider.py)
# ---------------------------------------------------------------------------


class _RC:
    def __init__(self, regions):
        self.regions = regions

    def top_regions(self, key, n):
        items = [(r, getattr(c, key)) for r, c in self.regions.items()]
        return sorted(items, key=lambda kv: -kv[1])[:n]


def test_counters_scaled_is_proportional_and_preserves_ops():
    def run(P):
        c = P.Counters(flops=8e9, bytes=2e9, collective_bytes=1e8,
                       link_bytes=5e7, collective_ops=3, ops=17)
        half = c.scaled(0.5)
        return (dataclasses.astuple(half), list(P.features(c)),
                list(P.features(half)))

    half, f_full, f_half = both(run)
    assert half[:6] == (4e9, 1e9, 5e7, 2.5e7, 3, 17)
    assert np.isclose(f_full[4], f_half[4]) and f_half[0] < f_full[0]


def _tree(P, rows, **kw):
    """A tree over ``(counters, label)`` rows."""
    X = np.stack([P.features(c) for c, _ in rows])
    return P.DecisionTree(max_depth=3).fit(X, [lab for _, lab in rows])


def _occupancy_tree(P, labels):
    base = P.Counters(flops=8e9, bytes=2e9)
    return _tree(P, [(base.scaled(f), lab) for f, lab in zip(
        (0.125, 0.25, 0.5, 1.0), labels)]), base


def _decide(P, tree, rc, fracs, region="layer3/attn"):
    dec = P.PlanDecider(tree, kind="decode")
    out = []
    for frac in fracs:
        plan, decisions = dec.decide(rc, P.null_plan(), load_frac=frac)
        out.append((decisions, plan.config_for(region).to_json()))
    return out


def test_occupancy_scaling_switches_spec_depth_decision():
    def run(P):
        tree, base = _occupancy_tree(P, ("spec4", "spec4", "spec2", "spec2"))
        return tree.to_json(), _decide(P, tree, _RC({"layer0/attn": base}),
                                       (0.25, 1.0))

    _, [(dlow, low), (dhigh, high)] = both(run)
    assert dict(dlow)["layer/attn"] == "spec4" and low["spec_depth"] == 4
    assert dict(dhigh)["layer/attn"] == "spec2" and high["spec_depth"] == 2


def test_spec_candidate_not_applied_to_non_attn_regions():
    def run(P):
        tree, base = _occupancy_tree(P, ("spec4", "spec4", "spec2", "spec2"))
        return _decide(P, tree, _RC({"layer0/mlp": base}), (0.25,),
                       region="layer0/mlp")

    [(decisions, mlp)] = both(run)
    assert dict(decisions)["layer/mlp"].startswith("spec")
    assert mlp["spec_depth"] == -1


def test_load_bucket_is_next_power_of_two():
    assert both(lambda P: [P.load_bucket(n) for n in range(9)]) == [
        1, 1, 2, 4, 4, 8, 8, 8, 8]


def test_load_bucket_triggers_replan_only_on_bucket_change():
    def run(P):
        last, replans = None, []
        for n_active in [1, 1, 2, 2, 3, 4, 4, 3, 2, 1, 1]:
            b = P.load_bucket(n_active)
            if b != last:
                replans.append((n_active, b))
                last = b
        return replans

    assert both(run) == [(1, 1), (2, 2), (3, 4), (2, 2), (1, 1)]


def test_bucketed_decisions_follow_occupancy_over_a_trace():
    """The test_plan_decider occupancy trace: identical decisions."""
    def run(P):
        tree, base = _occupancy_tree(P, ("spec4", "spec4", "spec2", "spec2"))
        dec = P.PlanDecider(tree, kind="decode")
        picked, last = [], None
        for n_active in [1, 2, 5, 8, 5, 2, 1]:
            b = P.load_bucket(n_active)
            if b == last:
                continue
            last = b
            _, decisions = dec.decide(_RC({"layer0/attn": base}),
                                      P.null_plan(), load_frac=min(b, 8) / 8)
            picked.append((b, decisions))
        return picked

    picked = dict((b, dict(d)["layer/attn"]) for b, d in both(run))
    assert picked[1] == picked[2] == "spec4" and picked[8] == "spec2"


def test_latency_channels_reach_the_feature_vector():
    def run(P):
        c = dataclasses.replace(P.Counters(flops=8e9, bytes=2e9),
                                step_latency_p99=0.25, queue_delay=0.5)
        return (P.FEATURE_NAMES, list(P.features(c)),
                list(P.features(c.scaled(0.25))))

    names, f, fs = both(run)
    assert names[-2:] == ("step_latency_p99", "queue_delay")
    assert len(f) == len(names) == 11 and f[-2:] == [0.25, 0.5]
    assert fs[-2:] == [0.25, 0.5] and fs[0] < f[0]


def test_latency_features_switch_memory_policy_decision():
    def run(P):
        base = P.Counters(flops=8e9, bytes=2e9)
        rows = [(dataclasses.replace(base, step_latency_p99=lat,
                                     queue_delay=qd), lab)
                for lat, qd, lab in ((0.0, 0.0, "mem_lazy"),
                                     (0.25, 0.0, "mem_lazy"),
                                     (1.5, 1.0, "mem_full"),
                                     (2.0, 1.5, "mem_full"))]
        tree = _tree(P, rows)
        calm = dataclasses.replace(base, step_latency_p99=0.25)
        stressed = dataclasses.replace(base, step_latency_p99=1.75,
                                       queue_delay=1.25)
        return [_decide(P, tree, _RC({"layer0/attn": c}), (1.0,))[0]
                for c in (calm, stressed)]

    (d_c, calm), (d_s, stressed) = both(run)
    assert dict(d_c)["layer/attn"] == "mem_lazy" and calm["reservation"] == \
        "lazy"
    assert dict(d_s)["layer/attn"] == "mem_full" and stressed[
        "reservation"] == "full"


def test_bucket_log_ms_quantization_dedups_latency_windows():
    sweep = (0.0, 1e-4, 1e-3, 0.010, 0.011, 1e-2, 0.1, 1.0, 10.0)
    vals = both(lambda P: [P.bucket_log_ms(s) for s in sweep])
    assert vals[0] == 0.0 and vals[3] == vals[4] and vals == sorted(vals)
    assert both(lambda P: [P.bucket_rate(r) for r in (0.0, 0.33, 0.99, 1.0,
                                                      1.5)])[-1] == 1.0


def test_occupancy_scaling_switches_tp_degree_decision():
    def run(P):
        tree, base = _occupancy_tree(P, ("tp1", "tp1", "tp4", "tp4"))
        return _decide(P, tree, _RC({"layer0/attn": base}), (0.25, 1.0))

    [(dlow, low), (dhigh, high)] = both(run)
    assert dict(dlow)["layer/attn"] == "tp1" and low["tp_degree"] == 1
    assert dict(dhigh)["layer/attn"] == "tp4" and high["tp_degree"] == 4


def _stub_engines(tp_pin=0, n_kv_heads=4):
    """Engine shells of both packages exercising tp_for/_step_cache_key
    without a model."""
    out = []
    for mod in (tengine, jengine):
        eng = object.__new__(mod.Engine)
        eng.cfg = mod.ServeConfig(tp=tp_pin)
        eng.model = types.SimpleNamespace(cfg=types.SimpleNamespace(
            n_kv_heads=n_kv_heads, n_experts=0))
        eng._paged = True
        out.append(eng)
    return out


def _plan_with_tp(P, tp_degree):
    plan = P.null_plan()
    plan.region_configs["layer/attn"] = P.RegionConfig(tp_degree=tp_degree)
    return plan


@pytest.mark.parametrize("n_dev,tp_pin,n_kv,want_tp,clamped", [
    (4, 0, 4, 2, 2), (4, 0, 4, 0, 1), (4, 4, 4, 1, 4), (2, 0, 4, 4, 2),
    (4, 0, 6, 4, 3), (1, 4, 4, 4, 1), (1, 0, 4, 2, 1), (1, 0, 6, 4, 1)])
def test_tp_for_resolution_precedence_and_clamping(monkeypatch, n_dev,
                                                   tp_pin, n_kv, want_tp,
                                                   clamped):
    """The port clamps like the JAX package (its ranks as JAX's device
    count, then kv-head divisibility) and returns the clamped degree."""
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [None] * n_dev)
    monkeypatch.setattr(tengine.Engine, "_n_devices", lambda self: n_dev)
    teng, jeng = _stub_engines(tp_pin, n_kv)
    assert jeng.tp_for(_plan_with_tp(J, want_tp)) == clamped
    assert teng.tp_for(_plan_with_tp(T, want_tp)) == clamped


def test_step_cache_keys_on_resolved_tp_and_nothing_else(monkeypatch):
    """On one device every tp degree clamps to 1 and shares one step, in
    both packages; memory-policy knobs never reshape the step."""
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [None])

    def run(eng, P):
        def key(**kw):
            plan = P.null_plan()
            plan.region_configs["layer/attn"] = P.RegionConfig(**kw)
            return eng._step_cache_key(plan)

        k1 = key(tp_degree=1)
        return [key(tp_degree=2) == k1, key(tp_degree=4) == k1,
                key(tp_degree=2, reservation="lazy", mem_watermark=0.3,
                    prefix_cache="on") == k1, key(spec_depth=2) == k1]

    teng, jeng = _stub_engines()
    assert run(teng, T) == run(jeng, J) == [True, True, True, False]


# ---------------------------------------------------------------------------
# corpus, trainer, explorer (test_autotune_online.py, non-engine part)
# ---------------------------------------------------------------------------

_F = np.arange(7.0)


def _entries(corpus):
    return [e.to_json() for e in corpus.entries()]


def test_corpus_append_dedups_and_means_rewards():
    def run(P):
        c = P.Corpus()
        e1 = c.append("layer/attn", _F, "spec2", 10.0)
        e2 = c.append("layer/attn", _F, "spec2", 30.0)
        same = e1 is e2
        c.append("layer/attn", _F, "spec4", 5.0)
        c.append("layer/mlp", _F, "spec2", 5.0)
        c.append("layer/attn", _F + 1, "spec2", 5.0)
        return same, c.observations, _entries(c), sorted(c.classes())

    same, n_obs, entries, classes = both(run)
    assert same and n_obs == 5 and len(entries) == 4
    assert entries[0]["n"] == 2 and entries[0]["reward"] == 20.0
    assert classes == ["spec2", "spec4"]


def test_corpus_reward_upgrades_offline_label():
    def run(P):
        c = P.Corpus()
        c.append("offline", _F, "ff_tp")
        first = c.entries()[0].rewarded
        c.append("offline", _F, "ff_tp", 7.0)
        return first, _entries(c)

    first, entries = both(run)
    assert not first and len(entries) == 1
    assert entries[0]["reward"] == 7.0 and entries[0]["n"] == 2


def test_corpus_merge_offline_pairs():
    def run(P):
        c = P.Corpus()
        n = c.merge_offline([(_F, "attn_tp_heads"), (_F + 1, "ff_tp")])
        X, y = c.training_data()
        return n, _entries(c), X.tolist(), y

    n, entries, X, y = both(run)
    assert n == 2 and all(e["reward"] is None for e in entries)
    assert sorted(y) == ["attn_tp_heads", "ff_tp"] and np.shape(X) == (2, 7)


def test_corpus_training_data_labels_argmax_reward():
    def run(P):
        c = P.Corpus()
        c.append("layer/attn", _F, "spec0", 100.0)
        c.append("layer/attn", _F, "spec4", 300.0)
        c.append("layer/attn", _F + 1, "spec0", 50.0)
        X, y = c.training_data()
        return X.tolist(), y

    X, y = both(run)
    assert dict(zip(map(tuple, X), y)) == {tuple(_F): "spec4",
                                           tuple(_F + 1): "spec0"}


def _decode_obs(o):
    return (f"r{o % 2}", _F + (o // 2) % 3, ["spec0", "spec2", "spec4"][
        (o // 6) % 3], float(o) if o % 5 else math.nan)


@settings(max_examples=25, deadline=None)
@given(obs=st.lists(
    st.integers(min_value=0, max_value=59), min_size=0, max_size=40))
def test_corpus_merge_equals_sequential_append(obs):
    """Appending a stream into one corpus == splitting it into two and
    merging, in each package, and the packages agree entry for entry."""
    def run(P):
        whole, left, right = P.Corpus(), P.Corpus(), P.Corpus()
        for i, o in enumerate(obs):
            whole.append(*_decode_obs(o))
            (left if i % 2 else right).append(*_decode_obs(o))
        merged = left.merge(right)
        key = lambda c: {e.key(): (e.n, e.rewarded)  # noqa: E731
                         for e in c.entries()}
        assert key(merged) == key(whole)
        assert merged.observations == whole.observations == len(obs)
        for e in whole.entries():
            if e.rewarded:
                assert np.isclose(merged._entries[e.key()].reward, e.reward)
        return _entries(whole)

    both(run)


@settings(max_examples=15, deadline=None)
@given(obs=st.lists(
    st.integers(min_value=0, max_value=59), min_size=1, max_size=30))
def test_corpus_jsonl_bytes_identical_and_cross_loadable(obs):
    """The same appends write byte-identical JSONL in both packages, and
    each package loads the other's file to the same corpus."""
    def fill(P):
        c = P.Corpus()
        for o in obs:
            c.append(f"r{o % 3}", _F * (o % 4), f"cls{o % 5}",
                     float(o) if o % 2 else math.nan)
        return c

    tc, jc = fill(T), fill(J)
    d = tempfile.mkdtemp()
    tp, jp = os.path.join(d, "t.jsonl"), os.path.join(d, "j.jsonl")
    try:
        assert tc.save_jsonl(tp) == jc.save_jsonl(jp) == len(tc)
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()
        for loader, path in ((T.Corpus, jp), (J.Corpus, tp)):
            c2 = loader.load_jsonl(path)
            assert len(c2) == len(tc) and c2.observations == tc.observations
            assert _entries(c2) == _entries(tc)
    finally:
        for p in (tp, jp):
            if os.path.exists(p):
                os.unlink(p)
        os.rmdir(d)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n=st.integers(min_value=2, max_value=40),
       k=st.integers(min_value=1, max_value=4))
def test_dtree_json_roundtrip_identical_predictions(seed, n, k):
    def run(P):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 7)) * rng.uniform(0.5, 5.0)
        y = [f"class{int(i)}" for i in rng.integers(0, k, n)]
        tree = P.DecisionTree(max_depth=5).fit(X, y)
        tree2 = P.DecisionTree.from_json(tree.to_json())
        X2 = rng.normal(size=(16, 7)) * 3.0
        assert tree2.classes_ == tree.classes_
        assert tree2.predict(X) == tree.predict(X)
        assert tree2.predict(X2) == tree.predict(X2)
        return tree.to_json(), tree.predict(X2)

    both(run)


def test_dtree_roundtrip_on_autotune_corpus():
    def run(P):
        c = P.Corpus()
        base = P.Counters(flops=8e9, bytes=2e9)
        for frac, cls, r in ((0.25, "spec4", 900.0), (0.25, "spec2", 500.0),
                             (1.0, "spec2", 800.0), (1.0, "spec4", 300.0)):
            c.append("layer/attn", P.features(base.scaled(frac)), cls, r)
        X, y = c.training_data()
        tree = P.DecisionTree(max_depth=4).fit(X, y)
        return tree.to_json(), P.DecisionTree.from_json(
            tree.to_json()).predict(X)

    assert both(run)[1] == ["spec4", "spec2"]


class _FixedTree:
    def __init__(self, fn):
        self.fn = fn

    def predict_one(self, x):
        return self.fn(np.asarray(x))


def _two_regime_corpus(P, n_points=12):
    c = P.Corpus()
    for i in range(n_points):
        low = i < n_points // 2
        f = np.full(7, float(i if low else 100 + i))
        best, worst = ("spec4", "spec0") if low else ("spec0", "spec4")
        c.append("layer/attn", f, best, 1000.0)
        c.append("layer/attn", f, worst, 100.0)
    return c


def test_trainer_interval_and_novelty_triggers():
    def run(P):
        t, c, seen = P.OnlineTrainer(interval=10), P.Corpus(), []
        seen.append(t.should_retrain(c))
        c.append("r", _F, "spec2", 1.0)
        seen += [t.should_retrain(c), t.maybe_retrain(c) is not None]
        for i in range(9):
            c.append("r", _F + i, "spec2", 1.0)
        seen.append(t.should_retrain(c))
        c.append("r", _F + 9, "spec2", 1.0)
        seen += [t.should_retrain(c), t.maybe_retrain(c) is not None]
        c.append("r", _F, "spec4", 2.0)
        seen += [t.should_retrain(c), t.maybe_retrain(c) is not None,
                 t.should_retrain(c)]
        return seen

    assert both(run) == [False, True, True, False, True, True, True, True,
                         False]


def test_trainer_cold_start_swaps_first_tree_in():
    def run(P):
        t, c = P.OnlineTrainer(interval=1), P.Corpus()
        c.append("layer/attn", _F, "spec2", 10.0)
        tree = t.maybe_retrain(c, current_tree=None)
        return tree.to_json(), tree.predict_one(_F), t.retrain_count, \
            t.reject_count

    assert both(run)[1:] == ("spec2", 1, 0)


def test_trainer_never_swaps_in_a_worse_tree():
    oracle = _FixedTree(lambda x: "spec4" if x[0] < 50 else "spec0")

    def run(P):
        c = _two_regime_corpus(P)
        crippled = P.OnlineTrainer(interval=1, tree_kw={"max_depth": 0})
        rejected = crippled.maybe_retrain(c, current_tree=oracle) is None
        full = P.OnlineTrainer(interval=1, tree_kw={"max_depth": 4})
        tree = full.maybe_retrain(c, current_tree=oracle)
        return (rejected, crippled.reject_count, full.reject_count,
                tree.to_json(), tree.predict_one(np.full(7, 0.0)),
                tree.predict_one(np.full(7, 110.0)))

    rejected, n_rej, n_full_rej, _, low, high = both(run)
    assert rejected and n_rej == 1 and n_full_rej == 0
    assert (low, high) == ("spec4", "spec0")


def test_holdout_value_scores_predictions_by_observed_reward():
    def run(P):
        c = P.Corpus()
        c.append("r", _F, "good", 100.0)
        c.append("r", _F, "bad", 10.0)
        g = c.groups()
        return [P.holdout_value(_FixedTree(lambda x, cls=cls: cls), g)
                for cls in ("good", "bad", "unseen")]

    assert both(run) == [100.0, 10.0, 10.0]


def test_explorer_eps_zero_is_a_guaranteed_noop():
    def run(P):
        ex = P.EpsilonGreedyExplorer(eps=0.0, budget=100)
        return ex.active, [ex.maybe_explore(P.null_plan()) for _ in range(50)]

    active, picks = both(run)
    assert not active and all(p is None for p in picks)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_explorer_picks_identical_for_the_same_seed(seed):
    """Budget-capped picks: the same classes and plans in both packages,
    each candidate's knob set on the plan copy."""
    def run(P):
        ex = P.EpsilonGreedyExplorer(eps=0.5, budget=6, seed=seed)
        out = []
        for _ in range(20):
            got = ex.maybe_explore(P.null_plan(), region="layer/attn")
            out.append(None if got is None else (
                got[0], got[1].config_for("layer3/attn").to_json()))
        return out, ex.explored, ex.active

    picks, explored, active = both(run)
    taken = [p for p in picks if p is not None]
    assert len(taken) == explored == 6 and not active
    for cls, rc in taken:
        if cls.startswith("spec"):
            assert rc["spec_depth"] == int(cls[-1])
        elif cls.startswith("tp"):
            assert rc["tp_degree"] == int(cls[2:])
        elif cls.startswith("scan"):
            assert rc["scan_mode"] in ("chunk", "fused_recurrent")


def test_explorer_menu_is_the_serve_only_classes():
    names = both(lambda P: sorted(c.name for c in P.explore_menu()))
    assert set(names) == {
        "spec0", "spec2", "spec4",
        "mem_full", "mem_lazy", "mem_lazy_wm10", "mem_lazy_wm30",
        "mem_prefix_on", "mem_prefix_off", "tp1", "tp2", "tp4",
        "scan_chunk", "scan_fused", "scan_chunk_ssd", "scan_fused_ssd"}
    assert all(c.serve_only for c in T.explore_menu())
    assert {c.name: c.config.mem_watermark for c in T.explore_menu()
            if c.name.startswith("mem_lazy_wm")} == {"mem_lazy_wm10": 0.10,
                                                     "mem_lazy_wm30": 0.30}
