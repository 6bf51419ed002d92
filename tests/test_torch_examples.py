"""The port's examples (``examples/*_torch.py``) against the JAX package on
the CPU.

Each example's sections are plain functions of ``(model, params,
device)``; here they get the JAX package's ``Model.init`` weights (f32,
bridged through numpy) and the same inputs as the JAX calls they stand
for.  Then each script runs as a process at ``--device cpu``, and at its
default device, where without a card it must refuse to run.
"""
import importlib.util
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

from _torch_slot_serve_common import models_for
from repro.autotune.candidates import default_candidates
from repro.autotune.corpus import Corpus as JCorpus
from repro.core import counters as jcounters
from repro.core.policy import RegionPlan as JRegionPlan
from repro.core.regions import collect_regions as jcollect_regions
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.autotune.corpus import Corpus
from repro_torch.core.policy import RegionPlan
from repro_torch.serve.scheduler import RequestState

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = torch.device("cpu")
# the top regions' flops, port over JAX's compiled count: XLA's program
# holds more elementwise ops than the port's op-by-op count (layer0/attn:
# 199 against 72); measured 0.91-1.00 on reduced qwen3-8b in f32
FLOPS_RATIO = (0.85, 1.0)


def _example(name: str):
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_regions_and_counters_match_jax():
    """The region set of a forward equals JAX's; the top 5 regions by
    flops have JAX's names in JAX's order, each within FLOPS_RATIO of
    JAX's compiled count; the feature vector is the hottest region's."""
    qs = _example("quickstart")
    jmodel, jparams, model, params = models_for(qs.ARCH)
    batch = {"tokens": jax.random.randint(
        jax.random.PRNGKey(1), (2, 64), 0, model.cfg.vocab_size,
        dtype=jnp.int32)}
    with jcollect_regions() as want:
        jax.eval_shape(lambda p, b: jmodel.forward(p, b), jparams, batch)
    assert qs.instrument(model, params, CPU) == set(want)

    fwd = lambda p, b: jmodel.forward(p, b)[0].astype(  # noqa: E731
        jnp.float32).mean()
    jrc = jcounters.collect(jax.jit(fwd).lower(jparams, batch).compile())
    rc = qs.profile(model, params, CPU)
    top, jtop = rc.top_regions("flops", 5), jrc.top_regions("flops", 5)
    assert [n for n, _ in top] == [n for n, _ in jtop]
    for (name, flops), (_, jflops) in zip(top, jtop):
        assert FLOPS_RATIO[0] <= flops / jflops <= FLOPS_RATIO[1], (
            name, flops, jflops)
    feat = qs.decide(rc)
    assert list(feat) == list(qs.FEATURES)
    assert feat["log_flops"] == round(math.log10(top[0][1] + 1.0), 2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-1.8b",
                                  "rwkv6-3b"])
def test_serve_batched_lockstep_matches_jax(arch):
    """The lockstep section at temperature 0 (greedy): the full-KV, ring
    and O(1)-state caches give JAX's ``generate`` tokens."""
    sb = _example("serve_batched")
    jmodel, jparams, model, params = models_for(arch)
    prompts = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (4, 32)).astype(np.int32)
    want = JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        max_len=96)).generate(jnp.asarray(prompts), 16)["tokens"]
    got = sb.lockstep(model, params, CPU, temperature=0.0,
                      prompts=torch.from_numpy(prompts))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def dense_models():
    return models_for(_example("serve_batched").DENSE_ARCH)


def test_serve_batched_continuous_and_overcommit_match_jax(dense_models):
    """The continuous-batching and overcommit sections on the example's
    numpy traces, against JAX's ``Engine.serve`` with the same
    ``ServeConfig``: every request's greedy tokens and state, the pool
    steps and the memory stats (preemptions, grown pages, peak resident)
    equal.  Arrivals are read off the wall clock, so the continuous trace
    arrives at once here (its gap is 0), which makes the schedule the
    same in both engines."""
    sb = _example("serve_batched")
    jmodel, jparams, model, params = dense_models
    vocab = model.cfg.vocab_size
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for section, make, cfg, extra in (
            (sb.continuous, sb.continuous_requests, sb.CONTINUOUS_CFG,
             {"gap_s": 0.0}),
            (sb.overcommit, sb.overcommit_requests, sb.OVERCOMMIT_CFG, {})):
        reqs = make(rng, vocab, **extra)
        jreqs = make(jrng, vocab, cls=JRequest, **extra)
        jres = JEngine(jmodel, jparams,
                       serve_cfg=JServeConfig(**cfg)).serve(jreqs)
        res = section(model, params, CPU, reqs)
        for a, b in zip(jreqs, reqs):
            assert (b.state.value, b.out_tokens) == (
                a.state.value, a.out_tokens), (section.__name__, b.rid)
        assert all(r.state is RequestState.DONE for r in reqs)
        assert res["steps"] == jres["steps"]
        assert res["memory"] == jres["memory"]
        assert res["page_leaks"] == 0
    assert res["memory"]["preemptions"] > 0


def test_serve_batched_staggered_trace_tokens_match_jax(dense_models):
    """The continuous section on the example's own trace, arriving every
    20 ms: each engine admits on its own wall clock, so the schedules may
    part, but a request's greedy tokens do not depend on which others
    share its steps.  Every request is DONE in both, with JAX's tokens."""
    sb = _example("serve_batched")
    jmodel, jparams, model, params = dense_models
    vocab = model.cfg.vocab_size
    reqs = sb.continuous_requests(np.random.default_rng(0), vocab)
    jreqs = sb.continuous_requests(np.random.default_rng(0), vocab,
                                   cls=JRequest)
    assert reqs[-1].arrival_s > 0
    JEngine(jmodel, jparams,
            serve_cfg=JServeConfig(**sb.CONTINUOUS_CFG)).serve(jreqs)
    res = sb.continuous(model, params, CPU, reqs)
    for a, b in zip(jreqs, reqs):
        assert (b.state.value, b.out_tokens) == (
            a.state.value, a.out_tokens), b.rid
    assert all(r.state is RequestState.DONE for r in reqs)
    assert res["page_leaks"] == 0


_EXPECT = {
    "quickstart": ("instrumented 8 regions", "per-region counters",
                   "counter feature vector for the hottest region"),
    "serve_batched": ("rwkv6-3b           [O(1) state  ] generated (4, 16)",
                      "continuous batching: 8 requests over 3 slots",
                      "6/6 requests completed"),
    "autotune_regions": ("[tune] iter0 layer/ssm", "baseline bound:",
                         "plan saved to", "search corpus saved to"),
}


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """Each script as a process at ``--device cpu``, the three at once;
    the autotune script writes under ``--out-dir``.  Returns (name ->
    (exit code, stdout, stderr), the out dir)."""
    out = tmp_path_factory.mktemp("examples")
    extra = {"autotune_regions": ["--out-dir", str(out)]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py"), "--device",
         "cpu", *extra.get(name, [])], cwd=out, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in _EXPECT}
    runs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        runs[name] = (proc.returncode, stdout, stderr)
    return runs, out


def test_examples_run_on_the_cpu(cpu_runs):
    """Exit 0 and each script's summary lines."""
    runs, out = cpu_runs
    for name, (code, stdout, stderr) in runs.items():
        assert code == 0, (name, stderr[-800:])
        for line in _EXPECT[name]:
            assert line in stdout, (name, line, stdout[-800:])
    assert sorted(p.name for p in out.iterdir()) == [
        "tuned_corpus.jsonl", "tuned_plan.json"]


def test_autotune_regions_search_plan_and_corpus_match_jax(cpu_runs):
    """The search's first iteration takes the hot region ``layer/ssm``
    and tries exactly the candidates that the JAX package's train menu
    applies to it, in its order (the candidates' counts run on the meta
    device, so the weights do not enter); the plan JSON loads through
    JAX's ``RegionPlan.from_json`` to the same region configs as through
    the port's, and the corpus JSONL loads in both packages, each
    reading the other's."""
    runs, out = cpu_runs
    log = runs["autotune_regions"][1]
    tried = [ln.split()[3].rstrip(":") for ln in log.splitlines()
             if ln.startswith("  [tune] iter0 ")]
    assert {ln.split()[2] for ln in log.splitlines()
            if ln.startswith("  [tune] iter0 ")} == {"layer/ssm"}
    assert tried == [c.name for c in default_candidates("train")
                     if c.applies_to in "layer/ssm" and not c.serve_only]

    text = (out / "tuned_plan.json").read_text()
    assert ({k: rc.to_json()
             for k, rc in JRegionPlan.from_json(text).region_configs.items()}
            == {k: rc.to_json()
                for k, rc in RegionPlan.from_json(text).region_configs.items()
                })

    def rows(corpus):
        return [e.to_json() for e in corpus.entries()]
    path = str(out / "tuned_corpus.jsonl")
    ours = Corpus.load_jsonl(path)
    assert len(ours) >= 1 and f"({len(ours)} entries)" in log
    assert rows(JCorpus.load_jsonl(path)) == rows(ours)
    jc = JCorpus()
    jc.merge_offline([(e.features, e.chosen_class) for e in ours.entries()])
    jc.save_jsonl(str(out / "jax_corpus.jsonl"))
    assert rows(Corpus.load_jsonl(str(out / "jax_corpus.jsonl"))) == (
        rows(jc))


_NO_CARD = r"""
import runpy, sys
sys.modules["jax"] = None
for path in sys.argv[1:]:
    sys.argv = [path]
    try:
        runpy.run_path(path, run_name="__main__")
    except RuntimeError as e:
        assert "device='cpu'" in str(e), (path, e)
    else:
        raise AssertionError(path + " ran on the CPU without being asked")
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ok")
"""


def test_examples_refuse_the_cpu_unasked():
    """Each script at its default device, in a process that sees no card
    and cannot import jax: the ``device='cpu'`` error, and no module of
    the JAX package loaded."""
    files = sorted(str(p) for p in EXAMPLES.glob("*_torch.py"))
    assert len(files) == 4
    proc = subprocess.run(
        [sys.executable, "-c", _NO_CARD, *files], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], (
        proc.stderr[-800:])
