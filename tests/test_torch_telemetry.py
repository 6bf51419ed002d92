"""Serve telemetry on the port, against the JAX package's.

The counterparts of ``tests/test_telemetry.py``: the metrics ring, the
latency sketch and the span tracer on the port's copy of
``serve/telemetry.py``; then real serves of one reduced ``stablelm-1.6b``
(f32 weights from the JAX package's ``Model.init``, bridged through numpy)
with telemetry off and on — greedy tokens equal request by request, and
equal to the JAX engine's with telemetry on, gap-free request lifecycles,
the Chrome trace, Prometheus and JSONL exports, the one aggregate, and the
off path that never touches ``telemetry.py``.  Added here: the slot pool's
lifecycle (rwkv6 reduced), the engine's graph path with telemetry on (the
eager stand-in of ``tests/test_torch_graphs.py``) and the launcher's four
outputs.

The property tests set ``deadline=None``: hypothesis' default 200 ms
deadline counts the first example's warm-up, which is no property of the
code under test.
"""
import json
import math
import tracemalloc
from collections import Counter

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
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState
from repro_torch.serve.telemetry import (LatencySketch, MetricsRing,
                                         SpanTracer, Telemetry)

# ---------------------------------------------------------------------------
# MetricsRing: bounded memory, exact aggregates under decimation
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(n=st.integers(min_value=0, max_value=3000),
       cap=st.integers(min_value=2, max_value=64),
       dts=st.lists(st.integers(min_value=1, max_value=10_000_000),
                    min_size=1, max_size=50))
def test_ring_bounded_and_aggregates_exact(n, cap, dts):
    """However many steps are appended, the ring holds <= cap records,
    while count / token total / dt min / dt max / dt sum stay exact."""
    ring = MetricsRing(cap=cap)
    appended = []
    for i in range(n):
        dt = dts[i % len(dts)] * 1e-6
        ring.append(i, i * 1e-3, dt, tokens=i % 5, n_active=1 + i % 3,
                    free_pages=10, n_faults=i % 2, plan_class="c")
        appended.append(dt)
    assert len(ring) <= cap
    assert ring.count == n
    assert ring.tokens_total == sum(i % 5 for i in range(n))
    assert ring.faults_total == sum(i % 2 for i in range(n))
    if n:
        assert ring.dt_min == min(appended)
        assert ring.dt_max == max(appended)
        assert math.isclose(ring.dt_sum, sum(appended), rel_tol=1e-9)
        steps = [r[0] for r in ring.records]
        assert steps == sorted(set(steps))
        assert all(0 <= s < n for s in steps)
    summary = ring.summary()
    assert summary["steps"] == n and summary["kept"] == len(ring)


# ---------------------------------------------------------------------------
# LatencySketch: rank and relative-error bound
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(micros=st.lists(st.integers(min_value=1, max_value=100_000_000),
                       min_size=1, max_size=200))
def test_sketch_quantile_relative_error_bound(micros):
    """For every p the sketch's quantile brackets the exact order
    statistic q at rank ceil(p*n): q <= quantile(p) <= q * growth."""
    sk = LatencySketch()
    vals = [m * 1e-6 for m in micros]
    for v in vals:
        sk.add(v)
    ordered = sorted(vals)
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        q = ordered[max(1, math.ceil(p * len(vals))) - 1]
        v = sk.quantile(p)
        assert q <= v * (1 + 1e-9), f"p={p}: {v} below exact {q}"
        assert v <= q * sk.growth * (1 + 1e-9), (
            f"p={p}: {v} above bound {q * sk.growth}")


@settings(max_examples=40, deadline=None)
@given(micros=st.lists(st.integers(min_value=1, max_value=100_000_000),
                       min_size=1, max_size=100))
def test_sketch_count_min_max_mean_exact(micros):
    sk = LatencySketch()
    vals = [m * 1e-6 for m in micros]
    for v in vals:
        sk.add(v)
    assert sk.count == len(vals)
    assert sk.min == min(vals) and sk.max == max(vals)
    assert math.isclose(sk.mean, sum(vals) / len(vals), rel_tol=1e-9)
    s = sk.summary()
    assert s["count"] == len(vals) and s["p50"] <= s["p90"] <= s["p99"]


def test_sketch_empty_and_bad_growth():
    assert LatencySketch().quantile(0.99) == 0.0
    with pytest.raises(ValueError):
        LatencySketch(growth=1.0)


# ---------------------------------------------------------------------------
# SpanTracer
# ---------------------------------------------------------------------------


def test_tracer_nesting_and_auto_close():
    tr = SpanTracer()
    tr.begin(7, "PREFILL", 1.0)
    tr.begin(7, "PREFILL_CHUNK", 1.1)
    # ending the parent auto-closes the still-open child at the same instant
    assert tr.end(7, "PREFILL", 2.0)
    kinds = {k: (t0, t1) for _, k, t0, t1, _ in tr.spans}
    assert kinds["PREFILL"] == (1.0, 2.0)
    assert kinds["PREFILL_CHUNK"] == (1.1, 2.0)
    assert not tr.end(7, "PREFILL", 3.0)        # nothing left open
    assert not tr.end(8, "DECODE", 3.0)         # never opened


def test_tracer_end_all_and_cap():
    tr = SpanTracer(cap=2)
    tr.begin(1, "PREFILL", 0.0)
    tr.begin(1, "DECODE", 1.0)
    tr.end_all(1, 2.0)
    assert len(tr.spans) == 2 and tr.dropped == 0
    tr.add(2, "QUEUED", 0.0, 1.0)               # over cap: counted, dropped
    assert len(tr.spans) == 2 and tr.dropped == 1
    assert not tr.has_open(1, "DECODE")


def test_tracer_chrome_trace_schema():
    tr = SpanTracer()
    tr.add(0, "QUEUED", 0.0, 0.5, note="x")
    tr.instant(0, "DONE", 0.5)
    doc = tr.chrome_trace()
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    evs = doc["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert metas and metas[0]["name"] == "thread_name"
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and xs[0]["dur"] == pytest.approx(0.5e6)
    assert xs[0]["args"] == {"note": "x"}
    ins = [e for e in evs if e["ph"] == "i"]
    assert ins and ins[0]["s"] == "t" and "dur" not in ins[0]
    json.loads(json.dumps(doc))


# ---------------------------------------------------------------------------
# Real serves
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _models(arch):
    """(JAX model, JAX params, port model, port params) of the reduced
    config, the port's weights the JAX ones through numpy."""
    if arch not in _MODELS:
        jmodel = jbuild(jget_config(arch).reduced())
        jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        model = build(get_config(arch).reduced())
        _MODELS[arch] = (jmodel, jparams, model, params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return _MODELS[arch]


GENS = [6, 10, 6, 8]
COMMON = dict(max_len=8 + max(GENS) + 1, max_slots=2, page_size=8,
              prefill_chunk=8, spec_depth=0)


def _prompts():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (4, 8)).astype(np.int32)


def _trace(cls=Request):
    return [cls(rid=i, prompt=p.copy(), max_new_tokens=g,
                arrival_s=0.002 * i)
            for i, (p, g) in enumerate(zip(_prompts(), GENS))]


@pytest.fixture(scope="module")
def served():
    """The port's telemetry-off and telemetry-on engines serving the same
    mixed-length trace, and the JAX engine with telemetry on."""
    jmodel, jparams, model, params = _models("stablelm-1.6b")
    eng_off = Engine(model, params, device="cpu",
                     serve_cfg=ServeConfig(**COMMON))
    eng_on = Engine(model, params, device="cpu", serve_cfg=ServeConfig(
        **COMMON, telemetry=True, log_level="debug"))
    reqs_off, reqs_on = _trace(), _trace()
    res_off = eng_off.serve(reqs_off)
    res_on = eng_on.serve(reqs_on)
    jeng = JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        **COMMON, telemetry=True, log_level="debug"))
    jreqs = _trace(JRequest)
    jeng.serve(jreqs)
    return dict(model=model, params=params, eng_off=eng_off, eng_on=eng_on,
                reqs_off=reqs_off, reqs_on=reqs_on, res_off=res_off,
                res_on=res_on, jeng=jeng, jreqs=jreqs)


def test_telemetry_on_is_bit_identical(served):
    for a, b in zip(served["reqs_on"], served["reqs_off"]):
        assert a.state is RequestState.DONE
        assert a.out_tokens == b.out_tokens, (
            f"telemetry changed request {a.rid}'s greedy tokens")


def test_tokens_and_spans_equal_jax_with_telemetry_on(served):
    """With telemetry on in both packages, the port's greedy tokens equal
    the JAX engine's, and every request traced the same kinds of span the
    same number of times."""
    jtr, ttr = served["jeng"].telemetry.tracer, served["eng_on"].telemetry.tracer
    for a, b in zip(served["jreqs"], served["reqs_on"]):
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
        assert (Counter(s[1] for s in ttr.spans_for(b.rid))
                == Counter(s[1] for s in jtr.spans_for(a.rid))), b.rid
    jtm = served["jeng"].telemetry.summary()
    ttm = served["eng_on"].telemetry.summary()
    assert ttm["counts"] == jtm["counts"]
    assert ttm["ttft_s"]["count"] == jtm["ttft_s"]["count"]
    assert ttm["ring"]["tokens"] == jtm["ring"]["tokens"]


def _check_lifecycle(tracer, reqs):
    """Spans per request nest, start at arrival, and cover the whole
    admission -> terminal timeline without gaps, ending in one DONE."""
    lifecycle = ("QUEUED", "PREFILL", "DECODE", "PREEMPTED")
    for r in reqs:
        spans = tracer.spans_for(r.rid)
        assert spans, f"request {r.rid} traced no spans"
        for i, (_, _, a0, a1, _) in enumerate(spans):
            for _, _, b0, b1, _ in spans[i + 1:]:
                assert (a1 <= b0 or b1 <= a0
                        or (a0 <= b0 and b1 <= a1)
                        or (b0 <= a0 and a1 <= b1)), (
                    f"request {r.rid}: spans overlap without nesting")
        chain = sorted([s for s in spans if s[1] in lifecycle],
                       key=lambda s: (s[2], s[3]))
        assert chain[0][1] == "QUEUED", f"request {r.rid} skipped QUEUED"
        assert chain[0][2] == pytest.approx(r.arrival_s), (
            f"request {r.rid}'s QUEUED span misses its arrival")
        for prev, nxt in zip(chain, chain[1:]):
            assert nxt[2] == prev[3], (
                f"request {r.rid}: gap between {prev[1]} and {nxt[1]}")
        assert chain[-1][1] == "DECODE", f"request {r.rid} never decoded"
        terminals = [s for s in spans if s[1] == "DONE"]
        assert len(terminals) == 1
        assert terminals[0][2] == chain[-1][3], (
            f"request {r.rid}: DONE marker off the DECODE close")
        pf = [(t0, t1) for _, k, t0, t1, _ in spans if k == "PREFILL"]
        for _, k, t0, t1, _ in spans:
            if k == "PREFILL_CHUNK":
                assert any(p0 <= t0 and t1 <= p1 for p0, p1 in pf)


def test_span_lifecycle_covers_admission_to_terminal(served):
    eng_on, reqs_on, res_on = (served["eng_on"], served["reqs_on"],
                               served["res_on"])
    _check_lifecycle(eng_on.telemetry.tracer, reqs_on)
    tm = res_on["telemetry"]
    assert tm["spans"] == len(eng_on.telemetry.tracer.spans)
    assert tm["spans_dropped"] == 0
    assert tm["ring"]["steps"] == res_on["steps"]
    assert tm["queue_delay_s"]["count"] == len(reqs_on)
    assert tm["ttft_s"]["count"] == len(reqs_on)
    assert tm["counts"]["admissions"] == len(reqs_on)


def test_preemption_spans_under_overcommit(served):
    """An overcommitted lazy pool preempts; the victim's timeline gains a
    PREEMPTED span that still chains gap-free into its re-admission, and
    the debug log holds the governor's victim picks."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (6, 8)).astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i].copy(), max_new_tokens=g)
            for i, g in enumerate([20, 20, 24, 20, 20, 24])]
    eng = Engine(served["model"], served["params"], device="cpu",
                 serve_cfg=ServeConfig(
                     max_len=8 + 24 + 1, max_slots=4, page_size=8,
                     prefill_chunk=8, kv_pages=11, reservation="lazy",
                     mem_watermark=0.0, telemetry=True, log_level="debug"))
    res = eng.serve(reqs)
    assert res["memory"]["preemptions"] >= 1
    preempted = [s for s in eng.telemetry.tracer.spans
                 if s[1] == "PREEMPTED"]
    assert len(preempted) >= 1
    assert all(t1 > t0 for _, _, t0, t1, _ in preempted)
    _check_lifecycle(eng.telemetry.tracer, reqs)
    assert eng.telemetry.counts.get("readmissions", 0) >= 1
    assert any(e["kind"] == "victim_picked" for e in eng.telemetry.events)


def test_chrome_trace_export_valid(served):
    doc = served["eng_on"].telemetry.chrome_trace()
    evs = doc["traceEvents"]
    assert evs
    for ev in evs:
        assert {"ph", "pid", "tid", "name"} <= set(ev)
        assert ev["ph"] in ("X", "i", "M")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0 and "ts" in ev
        if ev["ph"] == "i":
            assert ev["s"] == "t" and "ts" in ev
    kinds = {e["name"] for e in evs if e["ph"] != "M"}
    assert {"QUEUED", "PREFILL", "PREFILL_CHUNK", "DECODE", "DONE"} <= kinds
    json.loads(json.dumps(doc))


def _parse_prometheus(text):
    samples = {}
    for line in text.splitlines():
        if line.startswith("#"):
            assert line.startswith(("# TYPE ", "# HELP ")), line
            continue
        name, val = line.rsplit(" ", 1)
        samples[name] = float(val)          # every sample value parses
    return samples


def test_prometheus_export_parses(served):
    samples = _parse_prometheus(served["eng_on"].metrics_text())
    assert any(k.startswith("repro_serve_step_latency_seconds{")
               for k in samples)
    assert samples["repro_serve_step_latency_seconds_count"] > 0
    assert "repro_serve_health_steps" in samples
    assert "repro_serve_memory_preemptions" in samples
    # the exporter also works with telemetry off: observability only
    off_text = served["eng_off"].metrics_text()
    assert "repro_serve_health_steps" in off_text
    assert "step_latency_seconds" not in off_text


def test_event_log_levels_and_jsonl(served, tmp_path):
    tm = served["res_on"]["telemetry"]
    assert tm["events"] > 0
    kinds = {e["kind"] for e in served["eng_on"].telemetry.events}
    assert "step" in kinds and "serve_done" in kinds
    t = Telemetry(level="warning", log_out=str(tmp_path / "ev.jsonl"))
    t.event("noise", level="debug", x=1)
    t.event("info_noise", level="info", x=2)
    t.event("trouble", level="warning", x=3)
    t.close()
    lines = [json.loads(line) for line in open(tmp_path / "ev.jsonl")]
    assert [e["kind"] for e in lines] == ["trouble"]
    with pytest.raises(ValueError):
        Telemetry(level="loud")


def test_observability_aggregate_matches_legacy_keys(served):
    """serve() returns the JAX engine's top-level keys, and the one
    aggregate carries the telemetry summary when telemetry is on."""
    eng_on, res_on = served["eng_on"], served["res_on"]
    for res in (served["res_off"], res_on):
        for key in ("stats", "failures", "memory", "mesh", "health",
                    "faults", "autotune", "requests", "decisions", "steps"):
            assert key in res, f"serve() lost the {key!r} key"
    assert "telemetry" not in served["res_off"]
    obs = eng_on.observability()
    assert {"memory", "health", "faults", "autotune", "telemetry"} <= set(obs)
    assert "stats" not in obs
    assert "reservation" in obs["memory"]
    assert obs["telemetry"]["enabled"] is True
    obs_r = eng_on.observability(res_on["requests"])
    assert obs_r["stats"] == res_on["stats"]
    assert obs_r["failures"] == res_on["failures"]


def test_disabled_path_allocates_nothing_from_telemetry(served):
    """With telemetry off the subsystem is never built and a traced serve
    shows no allocation from the port's ``serve/telemetry.py``."""
    eng_off = served["eng_off"]
    assert eng_off.telemetry is None
    reqs = _trace()
    tracemalloc.start()
    try:
        eng_off.serve(reqs)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    tele = snap.filter_traces(
        [tracemalloc.Filter(True, "*/serve/telemetry.py")]
    ).statistics("filename")
    assert not tele, f"telemetry-off serve allocated via telemetry.py: {tele}"


def test_residual_tap_flush_not_lost(served):
    """A serve ending mid-retrain-interval flushes its last partial
    measurement-tap window into the corpus, with the latency channels."""
    eng = Engine(served["model"], served["params"], device="cpu",
                 serve_cfg=ServeConfig(**COMMON, online_retrain=True,
                                       retrain_interval=10_000,
                                       explore_eps=0.0))
    res = eng.serve(_trace())
    assert res["steps"] < 10_000
    assert eng.autotune_summary()["corpus_entries"] >= 1
    feats = [e.features for e in eng.corpus.entries()]
    assert all(len(f) == 11 for f in feats)
    assert any(f[-2] > 0 for f in feats)
    assert all(f[-1] >= 0 for f in feats)


# ---------------------------------------------------------------------------
# Added on the port: the slot pool, the graph path, the launcher
# ---------------------------------------------------------------------------


def test_slot_pool_lifecycle_nests_and_ends_done():
    """rwkv6 on the slot pool with chunked prefill and telemetry on:
    tokens equal the telemetry-off serve's, every lifecycle chains gap-free
    into one DONE, each chunk sits inside its PREFILL, and the ring counts
    every decode step."""
    _, _, model, params = _models("rwkv6-3b")
    cfg = dict(max_len=40, max_slots=2, paged="off", prefill_chunk=4)
    off_reqs, on_reqs = _trace(), _trace()
    Engine(model, params, device="cpu",
           serve_cfg=ServeConfig(**cfg)).serve(off_reqs)
    eng = Engine(model, params, device="cpu",
                 serve_cfg=ServeConfig(**cfg, telemetry=True))
    res = eng.serve(on_reqs)
    for a, b in zip(off_reqs, on_reqs):
        assert b.state is RequestState.DONE
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    tr = eng.telemetry.tracer
    _check_lifecycle(tr, on_reqs)
    assert sum(s[1] == "PREFILL_CHUNK" for s in tr.spans) == 2 * len(on_reqs)
    tm = res["telemetry"]
    assert tm["ring"]["steps"] == res["steps"]
    assert tm["ring"]["tokens"] == res["spec"]["committed_tokens"]
    assert res["memory"]["pool"] == "slot"


def test_graph_path_with_telemetry_matches_eager(served, monkeypatch):
    """The engine's graph path (the eager stand-in replaying) with
    telemetry on: tokens equal the eager telemetry-off serve's, the decode
    and prefill-chunk graphs are built, and every step reaches the ring."""
    from test_torch_graphs import EagerGraph
    monkeypatch.setattr(engine_mod, "StepGraph", EagerGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(Engine, "_use_graphs", lambda self: True)
    eng = Engine(served["model"], served["params"], device="cpu",
                 serve_cfg=ServeConfig(**COMMON, telemetry=True))
    reqs = _trace()
    res = eng.serve(reqs)
    for a, b in zip(served["reqs_off"], reqs):
        assert b.out_tokens == a.out_tokens, f"req {b.rid} diverged"
    assert set(eng._graphs) == {eng._pool_step, ("prefill_chunk", 8)}
    assert eng._graphs[eng._pool_step].replays == res["steps"]
    assert res["telemetry"]["ring"]["steps"] == res["steps"]
    _check_lifecycle(eng.telemetry.tracer, reqs)


def test_launcher_writes_all_four_outputs(tmp_path, capsys):
    """``--telemetry --trace-out --metrics-out --log-out --log-level``:
    the trace loads as JSON, the metrics parse as Prometheus text, every
    JSONL line parses and one is ``serve_done``."""
    from repro_torch.launch.serve import main
    trace, metrics, log = (tmp_path / "t.json", tmp_path / "m.prom",
                           tmp_path / "e.jsonl")
    res = main(["--device", "cpu", "--dtype", "float32", "--requests", "3",
                "--gen-min", "3", "--gen-max", "5", "--slots", "2",
                "--prompt-len", "8", "--arrival", "burst", "--telemetry",
                "--trace-out", str(trace), "--metrics-out", str(metrics),
                "--log-out", str(log), "--log-level", "debug"])
    assert res["stats"]["n_done"] == 3
    out = capsys.readouterr().out
    assert "[telemetry] level=debug" in out
    doc = json.loads(trace.read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= {"QUEUED", "DONE"}
    samples = _parse_prometheus(metrics.read_text())
    assert samples["repro_serve_step_latency_seconds_count"] == res["steps"]
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert [e["kind"] for e in events].count("serve_done") == 1
    assert any(e["kind"] == "step" for e in events)
