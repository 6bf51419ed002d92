"""Fault injection and failure domains on the port, against the JAX
package and ``docs/failure-semantics.md``.

The counterparts of ``tests/test_faults.py`` on the port's ``faults``,
``health``, ``scheduler``, ``cache``, ``autotune.corpus`` and engine:
injector determinism, corpus quarantine and atomic save, the health
ladder, the scheduler's terminal transitions, page conservation under
injected allocator exhaustion (the same op sequence also run on the JAX
pool, whose answers the port's must equal), and the chaos properties of
the serving engine — ``serve()`` returns, every request ends in exactly one
terminal state, survivors' greedy tokens equal a fault-free run's, nothing
leaks.  Where the JAX engine can serve the same seeded schedule, the
port's states and tokens are held to it.

The deadline test drives the engine from a stubbed clock (one
millisecond a reading), so the request with a sub-millisecond deadline
expires by construction instead of by a wall-clock race.  The property
tests set ``deadline=None``: hypothesis' default 200 ms deadline counts
the first example's warm-up, which is no property of the code under test.
"""
import glob
import json
import math
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.serve.cache import PagedKVPool as JPagedKVPool
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.faults import FaultInjector as JFaultInjector
from repro.serve.scheduler import Request as JRequest
from repro_torch.autotune.corpus import Corpus
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.cache import PagedKVPool
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.faults import FAULT_SITES, FaultInjector
from repro_torch.serve.health import HealthMonitor, HealthPolicy, HealthState
from repro_torch.serve.scheduler import (TERMINAL_STATES, Request,
                                         RequestState, Scheduler, summarize)

# ---------------------------------------------------------------------------
# FaultInjector (pure host logic)
# ---------------------------------------------------------------------------


def test_injector_deterministic_and_site_isolated():
    """The n-th draw at a site is a pure function of (seed, site, n), the
    same as the JAX package's injector, and draws at other sites never
    perturb it."""
    a = FaultInjector(seed=3, rate=0.4)
    b = FaultInjector(seed=3, rate=0.4)
    seq_a = [a.fire("logits.nan") for _ in range(64)]
    seq_b = []
    for _ in range(64):
        b.fire("alloc.exhaust")
        seq_b.append(b.fire("logits.nan"))
        b.fire("mem.grow")
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)
    c = FaultInjector(seed=4, rate=0.4)
    assert [c.fire("logits.nan") for _ in range(64)] != seq_a
    j = JFaultInjector(seed=3, rate=0.4)
    assert [j.fire("logits.nan") for _ in range(64)] == seq_a


def test_injector_disabled_paths():
    off = FaultInjector(seed=0, rate=0.0)
    assert not off.enabled
    assert not any(off.fire("logits.nan") for _ in range(32))
    assert off.injected_total == 0
    only = FaultInjector(seed=0, rate=1.0, sites=("mem.grow",))
    assert not only.fire("logits.nan")
    assert only.fire("mem.grow")
    with pytest.raises(ValueError):
        only.fire("no.such.site")
    with pytest.raises(ValueError):
        FaultInjector(sites=("bogus",))
    with pytest.raises(ValueError):
        FaultInjector(rate=1.5)


def test_injector_summary_counts():
    inj = FaultInjector(seed=1, rate=0.5)
    for _ in range(40):
        inj.fire("alloc.exhaust")
        inj.fire("step.latency")
    s = inj.summary()
    assert s["enabled"] and s["draws"] == 80
    assert s["injected_total"] == sum(s["injected"].values())
    assert set(s["injected"]) <= set(FAULT_SITES)


# ---------------------------------------------------------------------------
# Corpus: quarantine on load, atomicity on save
# ---------------------------------------------------------------------------


def _toy_corpus(n: int = 20) -> Corpus:
    c = Corpus()
    for i in range(n):
        c.append(f"r{i}", [float(i), 0.5], f"cls{i % 3}", reward=float(i))
    return c


def test_corpus_quarantines_corrupt_lines(tmp_path):
    path = str(tmp_path / "corpus.jsonl")
    c = _toy_corpus()
    inj = FaultInjector(seed=5, rate=0.5, sites=("corpus.corrupt",))
    c.save_jsonl(path, faults=inj)
    n_corrupt = inj.fired["corpus.corrupt"]
    assert n_corrupt >= 1
    loaded = Corpus.load_jsonl(path)
    assert loaded.quarantined == n_corrupt
    assert len(loaded) == len(c) - n_corrupt
    for e in loaded.entries():
        assert e.region.startswith("r") and not math.isnan(e.reward)


def test_corpus_corrupt_line_modes_all_quarantine(tmp_path):
    """Every corruption mode defeats the parser."""
    inj = FaultInjector(seed=0, rate=1.0, sites=("corpus.corrupt",))
    good = json.dumps(_toy_corpus(1).entries()[0].to_json())
    path = str(tmp_path / "one.jsonl")
    for _ in range(6):                  # cycles through all three modes
        with open(path, "w") as f:
            f.write(inj.corrupt_line(good) + "\n")
        assert len(Corpus.load_jsonl(path)) == 0
        assert Corpus.load_jsonl(path).quarantined == 1


def test_corpus_save_is_atomic(tmp_path):
    """A crash mid-save leaves the previous corpus intact and no temp
    litter behind."""
    path = str(tmp_path / "corpus.jsonl")
    _toy_corpus(5).save_jsonl(path)
    before = open(path).read()

    class Boom:
        def fire(self, site):
            raise RuntimeError("disk died mid-save")

    with pytest.raises(RuntimeError):
        _toy_corpus(20).save_jsonl(path, faults=Boom())
    assert open(path).read() == before
    assert glob.glob(str(tmp_path / ".corpus-*")) == []


# ---------------------------------------------------------------------------
# Health state machine
# ---------------------------------------------------------------------------


def test_health_ladder_up_and_down():
    p = HealthPolicy(window=8, degrade_after=2, shed_after=4,
                     recover_after=3)
    m = HealthMonitor(p)
    m.note_step(0.0, n_slot_faults=1)
    assert m.state is HealthState.HEALTHY
    m.note_step(0.0, n_slot_faults=2)
    assert m.state is HealthState.DEGRADED and m.degraded
    for _ in range(2):
        m.note_step(0.0, n_slot_faults=1)
    assert m.state is HealthState.SHEDDING and m.shedding
    for _ in range(3):
        m.note_step(0.0)
    assert m.state is HealthState.DEGRADED
    for _ in range(3):
        m.note_step(0.0)
    assert m.state is HealthState.HEALTHY and not m.degraded
    s = m.summary()
    assert s["degraded_entries"] == 1 and s["shed_entries"] == 1
    assert s["recoveries"] == 1


def test_health_watchdog_counts_latency():
    m = HealthMonitor(HealthPolicy(watchdog_s=0.01, degrade_after=2))
    m.note_step(0.5)
    m.note_step(0.5)
    assert m.taps["latency_faults"] == 2
    assert m.state is HealthState.DEGRADED


def test_backoff_is_capped_exponential():
    p = HealthPolicy(backoff_base=1, backoff_cap=8)
    assert [p.backoff(k) for k in range(1, 7)] == [1, 2, 4, 8, 8, 8]


def test_health_reset_clears_everything():
    m = HealthMonitor(HealthPolicy(degrade_after=1))
    m.note_step(0.0, n_slot_faults=1)
    assert m.degraded and m.fault_rate() > 0
    m.reset()
    assert m.state is HealthState.HEALTHY
    assert m.fault_rate() == 0.0
    assert all(v == 0 for v in m.taps.values())


# ---------------------------------------------------------------------------
# Scheduler terminal transitions
# ---------------------------------------------------------------------------


def _req(rid, arrival=0.0, gen=4, plen=4, deadline=0.0):
    return Request(rid=rid, prompt=np.arange(1, plen + 1, dtype=np.int32),
                   max_new_tokens=gen, arrival_s=arrival,
                   deadline_s=deadline)


def test_scheduler_fail_moves_resident_to_terminal():
    sched = Scheduler()
    r0, r1 = _req(0), _req(1)
    sched.submit(r0)
    sched.submit(r1)
    a = sched.pop_ready(0.0)
    sched.bind(a, slot=0, now_s=0.0)
    b = sched.pop_ready(0.0)
    sched.bind_prefill(b, slot=1, now_s=0.0)
    sched.fail(a, now_s=1.0, reason="nan logits")
    sched.fail(b, now_s=1.0, reason="prefill fault")
    assert a.state is RequestState.FAILED and a.error == "nan logits"
    assert a.t_done == 1.0 and a.slot is None
    assert not sched.active and not sched.prefilling
    assert sched.done()
    with pytest.raises(ValueError):
        sched.fail(a, now_s=2.0)
    s = summarize([r0, r1])
    assert s["failed"] == 2 and s["n_done"] == 0


def test_scheduler_shed_deadline_and_queue_bound():
    sched = Scheduler()
    reqs = [_req(0, deadline=0.5), _req(1), _req(2), _req(3),
            _req(4, arrival=99.0)]
    for r in reqs:
        sched.submit(r)
    expired, rejected = sched.shed_waiting(1.0, max_queue=2)
    assert [r.rid for r in expired] == [0]
    assert [r.rid for r in rejected] == [3]
    assert reqs[0].state is RequestState.EXPIRED and reqs[0].error
    assert reqs[3].state is RequestState.REJECTED
    assert reqs[4].state is RequestState.WAITING
    assert {r.rid for r in sched.shed} == {0, 3}
    expired, _ = sched.shed_waiting(200.0, default_deadline_s=50.0)
    assert {r.rid for r in expired} == {1, 2, 4}
    assert sched.done()
    s = summarize(reqs)
    assert s["expired"] == 4 and s["rejected"] == 1


def test_terminal_states_registry():
    assert RequestState.DONE in TERMINAL_STATES
    assert RequestState.FAILED in TERMINAL_STATES
    assert RequestState.EXPIRED in TERMINAL_STATES
    assert RequestState.REJECTED in TERMINAL_STATES
    assert RequestState.DECODE not in TERMINAL_STATES


# ---------------------------------------------------------------------------
# Property: fault sequences conserve allocator pages (pool level)
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.integers(min_value=0, max_value=9),
                    min_size=1, max_size=40),
       seed=st.integers(min_value=0, max_value=999))
def test_pool_fault_sequences_conserve_pages(ops, seed):
    """Random admit / grow / release interleavings with ``alloc.exhaust``
    injected at 50%: page conservation holds at every step, a full drain
    empties the pool, and every answer and block table equals the JAX
    pool's under the same op sequence and injector seed."""
    ps, n_slots, n_pages = 4, 3, 13
    pool = PagedKVPool({"k": (n_pages, ps, 1, 2)}, n_slots, ps, n_pages,
                       max_pages_per_slot=4, dtype=torch.float32,
                       device=torch.device("cpu"))
    jpool = JPagedKVPool(
        {"k": jax.ShapeDtypeStruct((n_pages, ps, 1, 2), jnp.float32)},
        n_slots, ps, n_pages, max_pages_per_slot=4)
    pool.faults = FaultInjector(seed=seed, rate=0.5,
                                sites=("alloc.exhaust",))
    jpool.faults = JFaultInjector(seed=seed, rate=0.5,
                                  sites=("alloc.exhaust",))
    held: list[int] = []
    for op in ops:
        if op <= 4:
            slot = pool.admit_shared(1 + op % 3)
            assert slot == jpool.admit_pages(1 + op % 3)
            if slot is not None:
                held.append(slot)
        elif op <= 7 and held:
            s = held[op % len(held)]
            assert pool.grow(s) == jpool.grow(s)
        elif held:
            s = held.pop(op % len(held))
            assert pool.release(s) == jpool.release(s)
        pool.allocator.check_invariants()
        assert pool.leaked_pages() == 0
        np.testing.assert_array_equal(pool.block_tables, jpool.block_tables)
    for slot in held:
        pool.release(slot)
    assert pool.allocator.n_live == 0
    assert pool.leaked_pages() == 0


# ---------------------------------------------------------------------------
# Engine-level chaos (module-scoped model)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_model():
    """The reduced stablelm in both packages, the port's weights the JAX
    ones through numpy."""
    jmodel = jbuild(jget_config("stablelm-1.6b").reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config("stablelm-1.6b").reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return model.cfg, model, params, jmodel, jparams


def _trace(vocab, n=6, plen=12, gens=(8, 6, 7, 5, 6, 4), deadlines=None,
           cls=Request):
    rng = np.random.default_rng(5)
    return [cls(rid=i, prompt=rng.integers(0, vocab, plen).astype(np.int32),
                max_new_tokens=gens[i % len(gens)],
                deadline_s=(deadlines or {}).get(i, 0.0))
            for i in range(n)]


_CHAOS_COMMON = dict(max_len=21, max_slots=3, page_size=8, prefill_chunk=8,
                     spec_depth=2, kv_pages=12, reservation="lazy",
                     mem_watermark=0.0, prefix_cache="on")


def _engine(served_model, **kw):
    _, model, params, _, _ = served_model
    return Engine(model, params, device="cpu",
                  serve_cfg=ServeConfig(**_CHAOS_COMMON, **kw))


def _jax_serve(served_model, reqs, **kw):
    _, _, _, jmodel, jparams = served_model
    return JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        **_CHAOS_COMMON, **kw)).serve(reqs)


def test_chaos_survivors_bit_identical_no_leaks(served_model):
    """Under injected NaNs, allocator exhaustion, growth denials and
    latency spikes, with speculation and prefix caching on: serve()
    returns, every request reaches one terminal state, survivors' greedy
    tokens equal a fault-free run's, the pool leaks nothing — and each
    request's state and tokens equal the JAX engine's under the same
    seeded schedule."""
    cfg = served_model[0]
    base = _trace(cfg.vocab_size)
    res_b = _engine(served_model).serve(base)
    assert res_b["stats"]["n_done"] == len(base)
    assert res_b["faults"] == {"enabled": False, "injected_total": 0}

    chaos = dict(chaos_rate=0.15, chaos_seed=7)
    eng = _engine(served_model, **chaos)
    reqs = _trace(cfg.vocab_size)
    res = eng.serve(reqs)
    assert res["faults"]["injected_total"] >= 1
    assert res["page_leaks"] == 0
    eng._pool.allocator.check_invariants()
    for r in reqs:
        assert r.state in TERMINAL_STATES, f"rid {r.rid} stuck in {r.state}"
        if r.state is RequestState.DONE:
            assert r.out_tokens == base[r.rid].out_tokens, (
                f"chaos changed survivor {r.rid}'s tokens")
    assert res["failures"]["retries"] >= 1
    jreqs = _trace(cfg.vocab_size, cls=JRequest)
    jres = _jax_serve(served_model, jreqs, **chaos)
    for a, b in zip(jreqs, reqs):
        assert (b.state.value, b.out_tokens) == (a.state.value, a.out_tokens)
    assert res["faults"]["injected"] == jres["faults"]["injected"]
    assert res["failures"]["retries"] == jres["failures"]["retries"]


def test_chaos_relentless_nan_fails_requests(served_model):
    """A slot faulting past max_retries ends FAILED with its pages
    released; the trace still returns."""
    cfg = served_model[0]
    eng = _engine(served_model, chaos_rate=0.95, chaos_seed=1,
                  chaos_sites=("logits.nan",), max_retries=2)
    reqs = _trace(cfg.vocab_size, n=2)
    res = eng.serve(reqs)
    assert all(r.state is RequestState.FAILED for r in reqs)
    assert all(r.error for r in reqs)
    assert res["failures"]["failed"] == 2
    assert set(res["failures"]["errors"]) == {0, 1}
    assert res["page_leaks"] == 0
    assert res["health"]["state"] != "healthy"


def test_chaos_safe_plan_fallback_and_recovery(served_model):
    """Sustained faults pin the safe plan (spec 0) as often as on the JAX
    engine, without poisoning the step cache: a follow-up fault-free serve
    on the same engine runs healthy and equals an untouched engine."""
    cfg = served_model[0]
    chaos = dict(chaos_rate=0.3, chaos_seed=11)
    eng = _engine(served_model, **chaos)
    reqs = _trace(cfg.vocab_size)
    res = eng.serve(reqs)
    assert res["health"]["fallbacks"] >= 1, "fallback never engaged"
    assert res["page_leaks"] == 0
    jres = _jax_serve(served_model, _trace(cfg.vocab_size, cls=JRequest),
                      **chaos)
    assert res["health"]["fallbacks"] == jres["health"]["fallbacks"]
    eng.faults = None
    eng._pool.faults = None
    eng.governor.faults = None
    clean = _trace(cfg.vocab_size)
    res2 = eng.serve(clean)
    assert res2["stats"]["n_done"] == len(clean)
    assert res2["health"]["state"] == "healthy"
    assert res2["health"]["fallbacks"] == 0
    fresh = _trace(cfg.vocab_size)
    _engine(served_model).serve(fresh)
    for a, b in zip(clean, fresh):
        assert a.out_tokens == b.out_tokens, (
            f"post-chaos engine diverged on rid {a.rid}")


def test_engine_abort_releases_pages(served_model):
    """A crash mid-serve releases every resident's pages, marks residents
    FAILED and re-raises with the allocator invariants intact."""
    cfg = served_model[0]
    eng = _engine(served_model)
    eng.serve(_trace(cfg.vocab_size, n=2))      # build the pool
    calls = {"n": 0}
    real_step = eng._pool_step

    def dying_step(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("device lost")
        return real_step(*a, **k)

    eng._pool_step = dying_step
    reqs = _trace(cfg.vocab_size)
    with pytest.raises(RuntimeError, match="device lost"):
        eng.serve(reqs)
    eng._pool_step = real_step
    eng._pool.allocator.check_invariants()
    assert eng._pool.leaked_pages() == 0
    assert all(r.state in (RequestState.FAILED, RequestState.WAITING,
                           RequestState.EXPIRED, RequestState.REJECTED)
               for r in reqs)
    assert any(r.state is RequestState.FAILED and "engine aborted" in r.error
               for r in reqs)


def test_engine_deadline_and_queue_shed(served_model, monkeypatch):
    """Bounded admission on a live engine: the first waiting request
    carries a sub-millisecond deadline (expired), the backlog is capped
    (newest arrivals rejected), and everything admitted completes.  The
    engine reads a stubbed clock that advances 1 ms a reading, so the
    deadline has passed by the first shed."""
    cfg = served_model[0]
    ticks = iter(range(10**9))
    monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 1e-3, sleep=time.sleep))
    eng = _engine(served_model, max_queue=3)
    gens = (6, 5, 6, 5, 6, 5, 6, 5, 6)
    reqs = _trace(cfg.vocab_size, n=9, gens=gens, deadlines={3: 2e-4})
    res = eng.serve(reqs)
    by_state = {r.rid: r.state for r in reqs}
    assert by_state[3] is RequestState.EXPIRED
    assert [r for r, s in by_state.items()
            if s is RequestState.REJECTED] == [7, 8]
    assert res["failures"]["expired"] == 1
    assert res["failures"]["rejected"] == 2
    assert res["stats"]["n_done"] == 6
    assert res["page_leaks"] == 0


@pytest.fixture(scope="module")
def prop_engine(served_model):
    """One engine shared by every property example; each example rewires
    only its injector."""
    return _engine(served_model, max_retries=2)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_chaos_every_request_terminal_property(prop_engine, served_model,
                                               seed):
    """For any injector seed: serve() returns, every request lands in one
    terminal state, page conservation holds, nothing leaks."""
    cfg = served_model[0]
    eng = prop_engine
    inj = FaultInjector(seed=seed, rate=0.3)
    eng.faults = inj
    eng._ensure_pool()
    eng._pool.faults = inj
    eng.governor.faults = inj
    reqs = _trace(cfg.vocab_size, n=4, gens=(6, 5, 4, 6))
    res = eng.serve(reqs)
    for r in reqs:
        assert r.state in TERMINAL_STATES, (
            f"seed {seed}: rid {r.rid} stuck in {r.state}")
    eng._pool.allocator.check_invariants()
    assert res["page_leaks"] == 0
    done = [r for r in reqs if r.state is RequestState.DONE]
    assert res["stats"]["n_done"] == len(done)
