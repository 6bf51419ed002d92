"""The elastic KV-memory governor on the port, against the JAX package.

The counterparts of ``tests/test_memory_governor.py``: the
:class:`MemoryGovernor`'s policy units (lazy admission, the watermark,
growth, victim selection) on the port's pool, each also run on the JAX
governor where it answers a question both can be asked, and the engine's
overcommit lifecycle — preemption and recompute-prefill resume complete
every request with greedy tokens equal to the JAX engine's unconstrained
run.  The governor's two debug events, ``admit_blocked`` and
``victim_picked``, are held at debug level (and absent above it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.serve.cache import PagedKVPool as JPagedKVPool
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.memory import MemoryGovernor as JMemoryGovernor
from repro.serve.memory import MemoryPolicy as JMemoryPolicy
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.cache import PagedKVPool, pages_for
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.memory import MemoryGovernor, MemoryPolicy
from repro_torch.serve.scheduler import Request, RequestState, summarize
from repro_torch.serve.telemetry import Telemetry


def _pool(n_pages=13, ps=8, n_slots=6, max_pages=5):
    return PagedKVPool({"k": (n_pages, ps, 1, 2)}, n_slots, ps, n_pages,
                       max_pages, dtype=torch.float32,
                       device=torch.device("cpu"))


def _jpool(n_pages=13, ps=8, n_slots=6, max_pages=5):
    avals = {"k": jax.ShapeDtypeStruct((n_pages, ps, 1, 2), jnp.float32)}
    return JPagedKVPool(avals, n_slots, ps, n_pages, max_pages)


# ---------------------------------------------------------------------------
# Governor policy units (pure host logic)
# ---------------------------------------------------------------------------


def test_lazy_admit_takes_prompt_pages_plus_one():
    pool = _pool()
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy", watermark=0.0))
    slot = gov.admit(prompt_tokens=9, total_tokens=40)   # 2 + 1 decode page
    assert slot is not None
    assert len(pool.allocator.pages_of(slot)) == 3
    gov.set_policy(reservation="full")
    slot2 = gov.admit(prompt_tokens=9, total_tokens=40)
    assert len(pool.allocator.pages_of(slot2)) == pages_for(40, 8)
    assert gov.peak_resident == 2


def test_lazy_admit_never_exceeds_worst_case():
    pool = _pool(ps=8)
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy", watermark=0.0))
    slot = gov.admit(prompt_tokens=3, total_tokens=6)
    assert len(pool.allocator.pages_of(slot)) == 1


def test_watermark_blocks_admission_but_not_into_deadlock():
    """The watermark defers an admission that would cut free pages below
    it (never on an empty pool), the same admissions as the JAX governor's;
    the deferral is a debug event with its page counts."""
    pool, jpool = _pool(n_pages=13), _jpool(n_pages=13)
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy",
                                            watermark=0.5))
    jgov = JMemoryGovernor(jpool, JMemoryPolicy(reservation="lazy",
                                                watermark=0.5))
    gov.telemetry = Telemetry(level="debug")
    got = [gov.admit(prompt_tokens=9, total_tokens=40) for _ in range(3)]
    want = [jgov.admit(prompt_tokens=9, total_tokens=40) for _ in range(3)]
    assert got == want
    assert got[0] is not None and got[1] is not None and got[2] is None
    assert gov.admit_blocked == jgov.admit_blocked == 1
    blocked = [e for e in gov.telemetry.events if e["kind"] == "admit_blocked"]
    assert len(blocked) == 1
    assert (blocked[0]["need_pages"], blocked[0]["free_eq"]) == (3, 6)
    assert blocked[0]["level"] == "debug"
    gov.telemetry = Telemetry(level="info")     # debug events filtered
    assert gov.admit(prompt_tokens=9, total_tokens=40) is None
    assert not gov.telemetry.events
    gov.set_policy(watermark=0.0)
    assert gov.admit(prompt_tokens=9, total_tokens=40) is not None


def test_ensure_headroom_grows_at_boundary_and_respects_cap():
    pool = _pool(n_pages=13, ps=8)
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy",
                                            watermark=0.0))
    slot = gov.admit(prompt_tokens=9, total_tokens=40)   # 3 pages, reach 24
    pool.advance(slot, 23)
    assert gov.ensure_headroom(slot, 1, 40) == 1
    assert gov.grown_pages == 0
    pool.advance(slot, 1)
    assert gov.ensure_headroom(slot, 1, 40) == 8
    assert gov.grown_pages == 1
    got = gov.ensure_headroom(slot, 24, 40)
    assert got == 16                      # 5 pages = 40 tokens reach, not 48
    assert pool.reserved_tokens(slot) == 40


def test_ensure_headroom_opportunistic_growth_respects_watermark():
    pool = _pool(n_pages=13, ps=8)
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy",
                                            watermark=0.75))
    slot = pool.admit_shared(2)           # reach 16, 10 free of 12
    pool.advance(slot, 16)
    assert gov.ensure_headroom(slot, 8, 64) >= 1
    assert pool.reserved_tokens(slot) == 24


@dataclasses.dataclass
class _Res:
    rid: int
    t_admit: float
    n_preempts: int = 0


def test_pick_victim_lifo_cap_and_overrides():
    """LIFO victims, the preempt cap, its override and the younger-than
    guard — every pick the JAX governor's, and every pick a debug event."""
    pool = _pool()
    gov = MemoryGovernor(pool, MemoryPolicy(max_preempts=2))
    jgov = JMemoryGovernor(_jpool(), JMemoryPolicy(max_preempts=2))
    gov.telemetry = Telemetry(level="debug")
    residents = {0: _Res(0, 0.1), 1: _Res(1, 0.3), 2: _Res(2, 0.2)}

    def pick(want, **kw):
        got = gov.pick_victim(residents, **kw)
        assert got == jgov.pick_victim(residents, **kw) == want, kw

    pick(1)
    pick(1, younger_than=(0.2, 2))
    pick(None, younger_than=(0.3, 1))
    residents[1].n_preempts = 2
    pick(2)
    pick(0, exclude=(2,))
    pick(None, younger_than=(0.2, 2))
    for r in residents.values():
        r.n_preempts = 2
    pick(None)
    pick(1, ignore_cap=True)
    assert gov.pick_victim({}) is None
    events = [e for e in gov.telemetry.events if e["kind"] == "victim_picked"]
    assert [e["slot"] for e in events] == [1, 1, 2, 0, 1]
    assert not any(e["shared_spared"] for e in events)


# ---------------------------------------------------------------------------
# Engine lifecycle: overcommit -> preempt -> resume, bit-identical
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oc():
    """The port's model, its weights (the JAX ones through numpy), the
    overcommit trace, and its tokens from the JAX engine's unconstrained
    (never-preempting) pool."""
    jmodel = jbuild(jget_config("stablelm-1.6b").reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config("stablelm-1.6b").reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (6, 8)).astype(np.int32)
    gens = [20, 20, 24, 20, 20, 24]

    def mk(cls=Request):
        return [cls(rid=i, prompt=prompts[i].copy(), max_new_tokens=g)
                for i, g in enumerate(gens)]

    max_len = 8 + 24 + 1
    ref_reqs = mk(JRequest)
    JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        max_len=max_len, max_slots=4, page_size=8,
        prefill_chunk=8)).serve(ref_reqs)
    return model, params, max_len, mk, [r.out_tokens for r in ref_reqs]


def _oc_engine(model, params, max_len, **kw):
    base = dict(max_len=max_len, max_slots=4, page_size=8, prefill_chunk=8,
                kv_pages=11, reservation="lazy", mem_watermark=0.0)
    base.update(kw)
    return Engine(model, params, device="cpu", serve_cfg=ServeConfig(**base))


def test_overcommit_preempts_completes_all_bit_identical(oc):
    """Six decode-heavy requests over 10 allocatable pages: lazy admission
    preempts, every preempted request re-enters and completes, and each
    request's greedy stream equals the JAX engine's unconstrained run."""
    model, params, max_len, mk, ref_tokens = oc
    eng = _oc_engine(model, params, max_len)
    reqs = mk()
    res = eng.serve(reqs)
    mem = res["memory"]
    assert mem["reservation"] == "lazy"
    assert mem["preemptions"] >= 1, mem
    for r, want in zip(reqs, ref_tokens):
        assert r.state is RequestState.DONE
        assert r.out_tokens == want, f"req {r.rid} diverged after preemption"
    s = summarize(reqs)
    assert s["n_done"] == len(reqs)
    assert s["preempts"] == mem["preemptions"]
    assert s["preempted_requests"] >= 1
    assert set(s["preempts_by_rid"]) <= {r.rid for r in reqs}
    assert s["requeue_wait_max_s"] >= s["requeue_wait_p50_s"] >= 0
    eng._pool.allocator.check_invariants()
    assert eng._pool.allocator.n_live == 0
    assert mem["grown_pages"] >= 1
    assert len(mem["free_page_trace"]) >= 1
    assert sum(n * c for n, c in mem["fragmentation"].items()) == 10


def test_overcommit_capped_victims_stall_not_starve(oc):
    """max_preempts=0: growth failures surface as stalls, yet the oldest
    resident's progress guarantee drains the trace, bit-identically."""
    model, params, max_len, mk, ref_tokens = oc
    eng = _oc_engine(model, params, max_len, max_preempts=0)
    reqs = mk()
    res = eng.serve(reqs)
    assert res["memory"]["stall_steps"] >= 1, res["memory"]
    for r, want in zip(reqs, ref_tokens):
        assert r.state is RequestState.DONE
        assert r.out_tokens == want, f"req {r.rid} diverged after stalls"
    eng._pool.allocator.check_invariants()
    assert eng._pool.allocator.n_live == 0


def test_full_reservation_never_preempts_under_overcommit(oc):
    model, params, max_len, mk, ref_tokens = oc
    eng = _oc_engine(model, params, max_len, reservation="full")
    reqs = mk()
    res = eng.serve(reqs)
    mem = res["memory"]
    assert mem["preemptions"] == 0 and mem["stall_steps"] == 0
    for r, want in zip(reqs, ref_tokens):
        assert r.out_tokens == want


def test_auto_reservation_follows_dtree_vote(oc):
    """reservation='auto': a tree voting mem_lazy switches the governor's
    policy at replan time, without changing tokens."""
    from repro_torch.core.counters import Counters
    from repro_torch.core.dtree import DecisionTree, features
    model, params, max_len, mk, ref_tokens = oc
    X = np.stack([features(Counters(flops=1e9, bytes=1e9)),
                  features(Counters(flops=1e12, bytes=1e10))])
    tree = DecisionTree().fit(X, ["mem_lazy", "mem_lazy"])
    eng = Engine(model, params, dtree=tree, device="cpu",
                 serve_cfg=ServeConfig(max_len=max_len, max_slots=4,
                                       page_size=8, prefill_chunk=8,
                                       kv_pages=11, reservation="auto"))
    assert eng.reservation_for(eng.plan) == "full"       # unset -> full
    reqs = mk()
    res = eng.serve(reqs)
    assert eng.governor.policy.reservation == "lazy"
    assert any(cls == "mem_lazy" for _, dec in res["decisions"]
               for _r, cls in dec)
    for r, want in zip(reqs, ref_tokens):
        assert r.out_tokens == want
