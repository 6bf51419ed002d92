"""Cross-request prefix caching on the port, against the JAX package.

The counterparts of ``tests/test_prefix_cache.py``: the refcounted
allocator's sharing and copy-on-write bookkeeping, the prefix index
(register -> lookup -> reclaim), the pool's sharing lifecycle (adopt,
copy-on-write before a write, defensive privatisation on rollback,
reclaiming index-only pages, preempting a sharer), the governor's
shared-aware victim scoring and watermark, and engine-level bit identity
of cache-hit serving: the port's tokens with the prefix cache on equal
the JAX engine's on a cold pool, under chunked prefill, speculation and
overcommit preemption.  The property tests also run each op sequence on
the JAX pool in lockstep and require equal answers and block tables.

The property tests set ``deadline=None``, as the reference's do:
hypothesis' default 200 ms deadline counts the first example's warm-up.
"""
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
from repro.serve import cache as jcache
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.cache import PageAllocator, PagedKVPool, PrefixIndex
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.memory import MemoryGovernor, MemoryPolicy
from repro_torch.serve.scheduler import Request, RequestState, summarize


def _pool(n_pages=17, ps=8, n_slots=4, max_pages=6, prefix=True):
    pool = PagedKVPool({"k": (n_pages, ps, 1, 2)}, n_slots, ps, n_pages,
                       max_pages, dtype=torch.float32,
                       device=torch.device("cpu"))
    pool.prefix_enabled = prefix
    return pool


def _jpool(n_pages=17, ps=8, n_slots=4, max_pages=6):
    avals = {"k": jax.ShapeDtypeStruct((n_pages, ps, 1, 2), jnp.float32)}
    pool = jcache.PagedKVPool(avals, n_slots, ps, n_pages, max_pages)
    pool.prefix_enabled = True
    return pool


# ---------------------------------------------------------------------------
# Refcounted PageAllocator
# ---------------------------------------------------------------------------


def test_allocator_share_refcounts_and_deferred_reclaim():
    a = PageAllocator(8)
    p = a.alloc("r0", 3)
    a.share("r1", p[:2])
    assert a.refcount(p[0]) == 2 and a.refcount(p[2]) == 1
    assert a.n_held("r1") == 2
    a.check_invariants()
    assert a.free("r1") == []             # r0 still maps everything
    assert a.refcount(p[0]) == 1
    assert set(a.free("r0")) == set(p)
    assert a.n_live == 0 and a.n_free == 7
    a.check_invariants()


def test_allocator_share_guards():
    a = PageAllocator(8)
    p = a.alloc("r0", 2)
    with pytest.raises(ValueError):       # not live
        a.share("r1", [7])
    a.share("r1", p)
    with pytest.raises(ValueError):       # already mapped by this owner
        a.share("r1", [p[0]])
    with pytest.raises(ValueError):       # duplicates in one request
        a.share("r2", [p[0], p[0]])
    a.check_invariants()


def test_allocator_drop_and_replace():
    a = PageAllocator(8)
    p = a.alloc("r0", 3)
    a.share("idx", [p[1]])
    assert a.drop("idx", p[1]) is False   # r0 still maps it
    assert a.refcount(p[1]) == 1
    with pytest.raises(ValueError):
        a.drop("idx", p[1])
    a.share("r1", [p[0]])
    new = a.replace("r0", p[0])
    assert new is not None and new != p[0]
    assert a.pages_of("r0")[0] == new     # in place, order kept
    assert a.refcount(p[0]) == 1 and a.refcount(new) == 1
    a.check_invariants()
    a.alloc("fill", a.n_free)
    assert a.replace("r0", new) is None   # dry free list: nothing mutated
    a.check_invariants()


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3)),
                    min_size=1, max_size=40))
def test_allocator_share_free_sequences_conserve_pages(ops):
    """Random share / free / replace interleavings: refcounts equal the
    owners mapping each page, pages are reclaimed exactly at refcount
    zero, freeing everyone restores the pool, the solo counter matches a
    recount — and every answer equals the JAX allocator's."""
    a, ja = PageAllocator(12), jcache.PageAllocator(12)
    a.track_solo("o1")
    ja.track_solo("o1")
    owners = {}
    for op, owner_i in ops:
        name = f"o{owner_i}"
        if op == 0 and name not in owners:
            got = a.alloc(name, min(2, a.n_free))
            assert got == ja.alloc(name, min(2, ja.n_free))
            if got is not None:
                owners[name] = got
        elif op == 1 and owners and name not in owners:
            src = sorted(owners)[owner_i % len(owners)]
            share = [p for p in owners[src]
                     if p not in a.pages_of(name)][:2]
            if share:
                a.share(name, share)
                ja.share(name, share)
                owners[name] = a.pages_of(name)
        elif op == 2 and name in owners:
            assert a.free(name) == ja.free(name)
            del owners[name]
        elif op == 3 and name in owners and a.pages_of(name):
            old = a.pages_of(name)[0]
            new = a.replace(name, old)
            assert new == ja.replace(name, old)
            if new is not None:
                owners[name] = a.pages_of(name)
        a.check_invariants()
        assert (a.n_free, a.n_live, a.n_solo) == (ja.n_free, ja.n_live,
                                                  ja.n_solo)
    for name in list(owners):
        a.free(name)
        a.check_invariants()
    assert a.n_live == 0 and a.n_free == 11


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------


def test_prefix_index_roundtrip_and_divergence():
    idx = PrefixIndex()
    toks = np.arange(40, dtype=np.int32)
    assert idx.register(toks, [3, 5, 7, 9], 8, 4) == [3, 5, 7, 9]
    assert idx.lookup(toks, 8) == [3, 5, 7, 9]
    assert idx.lookup(toks[:17], 8) == [3, 5]
    div = toks.copy()
    div[20] += 1
    assert idx.lookup(div, 8) == [3, 5]   # diverges inside page 2
    other = toks + 100
    assert idx.lookup(other, 8) == []     # keys hash the whole prefix
    assert idx.register(toks, [11, 12, 13, 14], 8, 4) == []
    assert idx.lookup(toks, 8) == [3, 5, 7, 9]   # first writer wins


def test_prefix_index_lru_eviction_order():
    idx = PrefixIndex()
    a = np.arange(16, dtype=np.int32)
    b = np.arange(16, dtype=np.int32) + 50
    idx.register(a, [1, 2], 8, 2)
    idx.register(b, [3, 4], 8, 2)
    idx.lookup(a, 8)                      # touch a: b's pages now oldest
    assert idx.lru_pages()[:2] == [3, 4]
    idx.drop_page(3)
    assert idx.lookup(b, 8) == []         # chain broken at page 0
    assert 4 in idx.lru_pages()           # orphaned tail still evictable


# ---------------------------------------------------------------------------
# PagedKVPool sharing lifecycle
# ---------------------------------------------------------------------------


def test_pool_register_lookup_admit_shared_roundtrip():
    pool = _pool()
    toks = np.arange(30, dtype=np.int32)
    s0 = pool.admit_shared(4)
    pool.advance(s0, 29)                  # rows 0..28 written
    assert pool.register_prefix(s0, toks) == 3   # 29 // 8 full pages
    owned = pool.allocator.pages_of(s0)
    pool.release(s0)
    assert pool.allocator.n_live == 3     # the index holds them
    shared, matched = pool.prefix_lookup(toks[:25])
    assert shared == owned[:3] and matched == 24
    s1 = pool.admit_shared(1, shared)
    assert pool.reserved_tokens(s1) == 32
    assert [int(p) for p in pool.block_tables[s1, :4]] == shared + \
        [int(pool.block_tables[s1, 3])]
    assert all(pool.allocator.refcount(p) == 2 for p in shared)
    pool.advance(s1, matched)
    pool.allocator.check_invariants()
    shared2, matched2 = pool.prefix_lookup(toks[:21])
    assert matched2 == 16 and len(shared2) == 2


def test_pool_cow_privatises_shared_page_before_write():
    """A write into a partially-adopted shared page copies it first: the
    new page holds the old page's rows (the device copy, in place in the
    same page tensor), the old page falls back to index-only."""
    pool = _pool()
    toks = np.arange(17, dtype=np.int32)
    s0 = pool.admit_shared(3)
    pool.advance(s0, 16)
    pool.register_prefix(s0, toks)
    pool.release(s0)
    shared, matched = pool.prefix_lookup(toks)     # 2 pages, 16 tokens
    s1 = pool.admit_shared(1, shared)
    pool.advance(s1, matched)
    k = pool.pages["k"]
    k[shared[1], :, 0, 0] = 7.0
    assert pool.cow_for_write(s1, 1) and pool.cow_copies == 0
    pool.release(s1)
    shared2, matched2 = pool.prefix_lookup(toks[:16])   # capped at 15
    assert matched2 == 15
    s2 = pool.admit_shared(1, shared2)
    pool.advance(s2, matched2)
    old = int(pool.block_tables[s2, 1])
    assert pool.cow_for_write(s2, 1)
    new = int(pool.block_tables[s2, 1])
    assert pool.cow_copies == 1 and new != old
    assert pool.allocator.refcount(old) == 1
    assert pool.pages["k"] is k
    assert float(k[new, 0, 0, 0]) == 7.0
    assert torch.equal(k[new], k[old])
    pool.allocator.check_invariants()


def test_pool_rollback_defensively_privatises():
    pool = _pool()
    toks = np.arange(17, dtype=np.int32)
    s0 = pool.admit_shared(3)
    pool.advance(s0, 16)
    pool.register_prefix(s0, toks)
    pool.release(s0)
    shared, matched = pool.prefix_lookup(toks[:16])     # 15 tokens, 2 pages
    s1 = pool.admit_shared(1, shared)
    pool.advance(s1, matched)
    old = int(pool.block_tables[s1, 1])
    pool.rollback(s1, 1)                  # truncates into the shared page
    assert int(pool.block_tables[s1, 1]) != old
    assert pool.cow_copies == 1
    pool.allocator.check_invariants()


def test_cow_drops_index_ref_when_free_list_dry():
    """A page shared only with the index, a dry free list and nothing else
    reclaimable: copy-on-write privatises in place by dropping the index's
    reference instead of stalling the slot."""
    pool = _pool(n_pages=7, ps=8, n_slots=4, max_pages=6)
    toks = np.arange(17, dtype=np.int32)
    s0 = pool.admit_shared(3)
    pool.advance(s0, 16)
    pool.register_prefix(s0, toks)
    pool.release(s0)
    shared, matched = pool.prefix_lookup(toks[:16])
    assert matched == 15 and len(shared) == 2
    s1 = pool.admit_shared(1, shared)
    pool.advance(s1, matched)
    assert pool.admit_shared(3) is not None            # free list now dry
    assert pool.allocator.n_free == 0 and pool.n_reclaimable == 0
    old = int(pool.block_tables[s1, 1])
    assert pool.allocator.refcount(old) == 2
    assert pool.cow_for_write(s1, 1)
    assert int(pool.block_tables[s1, 1]) == old
    assert pool.allocator.refcount(old) == 1
    assert pool.cow_copies == 0 and pool.prefix_evictions == 1
    assert pool.prefix_lookup(toks[:16])[0] == shared[:1]
    pool.allocator.check_invariants()


def test_pool_preempt_of_sharer_never_frees_survivor_pages():
    pool = _pool()
    toks = np.arange(25, dtype=np.int32)
    s0 = pool.admit_shared(4)
    pool.advance(s0, 24)
    pool.register_prefix(s0, toks)
    shared, matched = pool.prefix_lookup(toks)
    s1 = pool.admit_shared(1, shared)
    pool.advance(s1, matched)
    live0 = pool.allocator.n_live
    freed = pool.preempt(s0)              # victim shares 3 of its 4 pages
    assert freed == 1
    assert pool.allocator.n_live == live0 - 1
    for p in shared:
        assert pool.allocator.refcount(p) == 2     # survivor + index
    pool.allocator.check_invariants()
    assert pool.reserved_tokens(s1) == 32
    assert [int(p) for p in pool.block_tables[s1, :3]] == shared


def test_pool_reclaims_index_only_pages_for_admission_and_growth():
    pool = _pool(n_pages=9, ps=8, max_pages=8)
    toks = np.arange(33, dtype=np.int32)
    s0 = pool.admit_shared(5)
    pool.advance(s0, 32)
    pool.register_prefix(s0, toks)                 # 4 pages indexed
    pool.release(s0)
    assert pool.n_reclaimable == 4 and pool.allocator.n_free == 4
    s1 = pool.admit_shared(6)
    assert s1 is not None
    assert pool.prefix_evictions == 2
    assert pool.allocator.n_free == 0
    assert pool.grow(s1)
    assert pool.prefix_evictions == 3
    pool.release(s1)
    assert pool.prefix_lookup(toks) == ([], 0)
    assert pool.n_reclaimable == 1
    pool.allocator.check_invariants()


def test_admit_shared_never_sacrifices_its_own_hit():
    pool = _pool(n_pages=5, ps=8, max_pages=4)
    toks = np.arange(9, dtype=np.int32)
    s0 = pool.admit_shared(2)
    pool.advance(s0, 8)
    pool.register_prefix(s0, toks)
    pool.release(s0)                               # 3 free, 1 index-only
    shared, matched = pool.prefix_lookup(toks)
    assert len(shared) == 1 and matched == 8
    assert pool.admit_shared(4, shared) is None
    assert pool.prefix_evictions == 0
    s1 = pool.admit_shared(3, shared)
    assert s1 is not None
    assert pool.allocator.refcount(shared[0]) == 2
    pool.allocator.check_invariants()


def test_reserved_tokens_counts_shared_pages_once():
    pool = _pool()
    toks = np.arange(17, dtype=np.int32)
    s0 = pool.admit_shared(3)
    pool.advance(s0, 16)
    pool.register_prefix(s0, toks)
    shared, _ = pool.prefix_lookup(toks)
    s1 = pool.admit_shared(2, shared)
    assert pool.reserved_tokens(s0) == 3 * 8
    assert pool.reserved_tokens(s1) == 4 * 8
    total_held = (pool.allocator.n_held(s0) + pool.allocator.n_held(s1)
                  + len(list(pool.prefix.pages())))
    assert total_held > pool.allocator.n_live      # sharing overcommits


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.integers(0, 2), min_size=1, max_size=24),
       seed=st.integers(0, 5))
def test_pool_share_cow_release_property(ops, seed):
    """Random admit-hit / advance with copy-on-write / release against one
    shared prompt, on the port's pool and the JAX pool in lockstep: the
    invariants hold throughout, the reclaimable counter matches a recount,
    the index never loses a page, every answer and block table equals the
    JAX pool's, and releasing every slot leaves only the index's pages."""
    rng = np.random.default_rng(seed)
    pool = _pool(n_pages=21, n_slots=3, max_pages=6)
    jpool = _jpool(n_pages=21, n_slots=3, max_pages=6)
    toks = rng.integers(0, 1000, (33,)).astype(np.int32)
    for p in (pool, jpool):
        s0 = p.admit_pages(5) if p is jpool else p.admit_shared(5)
        p.advance(s0, 32)
        p.register_prefix(s0, toks)
        p.release(s0)
    idx_pages = set(pool.prefix.pages())
    slots = []
    for op in ops:
        if op == 0 and pool.n_free:
            shared, matched = pool.prefix_lookup(toks)
            assert (shared, matched) == jpool.prefix_lookup(toks)
            s = pool.admit_shared(1, shared)
            assert s == jpool.admit_shared(1, shared)
            if s is not None:
                pool.advance(s, matched)
                jpool.advance(s, matched)
                slots.append(s)
        elif op == 1 and slots:
            s = slots[rng.integers(len(slots))]
            if pool.reserved_tokens(s) - int(pool.lengths[s]) >= 1:
                ok = pool.cow_for_write(s, 1)
                assert ok == jpool.cow_for_write(s, 1)
                if ok:
                    pool.advance(s, 1)
                    jpool.advance(s, 1)
        elif op == 2 and slots:
            slots.remove(s := slots[rng.integers(len(slots))])
            pool.release(s)
            jpool.release(s)
        pool.allocator.check_invariants()
        np.testing.assert_array_equal(pool.block_tables, jpool.block_tables)
        assert pool.cow_copies == jpool.cow_copies
        assert pool.n_reclaimable == sum(
            1 for p in pool.prefix.pages()
            if pool.allocator.refcount(p) == 1)
        for p in idx_pages:
            assert pool.allocator.refcount(p) >= 1
    for s in slots:
        pool.release(s)
    pool.allocator.check_invariants()
    assert pool.allocator.n_live == len(idx_pages)


# ---------------------------------------------------------------------------
# Governor: shared-aware victim scoring + prefix-aware watermark
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, rid, t_admit):
        self.rid, self.t_admit, self.n_preempts = rid, t_admit, 0


def test_pick_victim_prefers_unshared_over_hotter_shared():
    pool = _pool()
    gov = MemoryGovernor(pool, MemoryPolicy(max_preempts=4))
    toks = np.arange(25, dtype=np.int32)
    s_old = pool.admit_shared(4)
    pool.advance(s_old, 24)
    pool.register_prefix(s_old, toks)
    pool.release(s_old)
    shared, matched = pool.prefix_lookup(toks)
    s_shared = pool.admit_shared(1, shared)
    pool.advance(s_shared, matched)
    s_plain = pool.admit_shared(4)
    # LIFO alone would evict the younger sharer; the shared-page cost
    # spares it
    residents = {s_plain: _Req(0, 0.1), s_shared: _Req(1, 0.9)}
    assert gov.pick_victim(residents) == s_plain
    assert gov.shared_spared == 1
    pool.release(s_shared)
    residents = {s_plain: _Req(0, 0.1)}
    assert gov.pick_victim(residents) == s_plain
    assert gov.shared_spared == 1


def test_admit_reserves_only_unshared_remainder_and_counts_reclaimable():
    pool = _pool(n_pages=11, ps=8, max_pages=6)    # 10 allocatable
    gov = MemoryGovernor(pool, MemoryPolicy(reservation="lazy",
                                            watermark=0.5))
    toks = np.arange(25, dtype=np.int32)
    s0 = pool.admit_shared(4)
    pool.advance(s0, 24)
    pool.register_prefix(s0, toks)
    pool.release(s0)                      # 3 indexed, 7 free
    shared, _ = pool.prefix_lookup(toks)
    s1 = gov.admit(prompt_tokens=25, total_tokens=48, shared_pages=shared)
    assert s1 is not None
    assert pool.allocator.n_held(s1) == 5
    assert pool.allocator.n_free == 5


# ---------------------------------------------------------------------------
# set_policy plumbing + bounded trace
# ---------------------------------------------------------------------------


def test_set_policy_plumbs_max_preempts_and_rejects_unknown():
    gov = MemoryGovernor(_pool(), MemoryPolicy())
    gov.set_policy(max_preempts=0)
    assert gov.policy.max_preempts == 0
    gov.set_policy(reservation="lazy", watermark=0.3, max_preempts=7)
    assert (gov.policy.reservation, gov.policy.watermark,
            gov.policy.max_preempts) == ("lazy", 0.3, 7)
    with pytest.raises(ValueError):
        gov.set_policy(reservation="elastic")
    with pytest.raises(ValueError):
        gov.set_policy(max_preempts=-1)
    assert gov.policy.reservation == "lazy"        # reject mutated nothing


def test_free_page_trace_bounded_with_exact_min():
    pool = _pool(n_pages=40)
    gov = MemoryGovernor(pool, MemoryPolicy())
    slot = pool.admit_shared(2)
    lows = []
    for i in range(5000):
        if i == 2500:                     # a one-step dip between samples
            for _ in range(20):
                pool.grow(slot)
            gov.note_step(0)
            lows.append(pool.allocator.n_free)
            pool.release(slot)
            slot = pool.admit_shared(2)
        gov.note_step(0)
    assert len(gov.free_page_trace) < gov._TRACE_CAP
    for _ in range(3):
        pool.admit_shared(6)
    end_free = pool.allocator.n_free
    assert end_free < min(lows)
    for _ in range(400):
        gov.note_step(0)
    s = gov.summary()
    assert s["free_pages_min"] == end_free         # exact, not sampled
    assert len(s["free_page_trace"]) <= 64
    assert min(s["free_page_trace"]) <= end_free   # tail regime reported


# ---------------------------------------------------------------------------
# Engine lifecycle: cache-hit serving equals the JAX engine on a cold pool
# ---------------------------------------------------------------------------


def _models(arch):
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config(arch).reduced())
    return jmodel, jparams, model, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


_BASE = dict(max_len=40, max_slots=2, page_size=8, prefill_chunk=8,
             spec_depth=2)


@pytest.fixture(scope="module")
def shared_trace():
    """The port's model and weights, the shared-prefix trace, and the JAX
    engine's tokens for it on a cold pool (prefix cache off)."""
    jmodel, jparams, model, params = _models("stablelm-1.6b")
    rng = np.random.default_rng(0)
    P = rng.integers(0, 256, (24,)).astype(np.int32)
    div = np.concatenate([P[:16], rng.integers(0, 256, (8,)).astype(np.int32)])

    def mk(cls=Request):
        # r0 populates the index; r1/r2 are full-prefix hits; r3 diverges
        # after 16 tokens
        return [cls(rid=0, prompt=P.copy(), max_new_tokens=8),
                cls(rid=1, prompt=P.copy(), max_new_tokens=8),
                cls(rid=2, prompt=P.copy(), max_new_tokens=10),
                cls(rid=3, prompt=div.copy(), max_new_tokens=8)]

    cold = mk(JRequest)
    JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        **_BASE, prefix_cache="off")).serve(cold)
    return model, params, mk, [r.out_tokens for r in cold]


def _engine(model, params, prefix, **kw):
    return Engine(model, params, device="cpu", serve_cfg=ServeConfig(
        **{**_BASE, **kw}, prefix_cache=prefix))


def _check_tokens(reqs, want):
    for r, w in zip(reqs, want):
        assert r.state is RequestState.DONE
        assert r.out_tokens == w, f"req {r.rid} diverged"


def test_prefix_serving_bit_identical_and_saves_prefill(shared_trace):
    """Full reservation: hits adopt page-aligned runs only, so the serve
    never copies, preempts or stalls; tokens equal the JAX cold pool's."""
    model, params, mk, want = shared_trace
    warm = _engine(model, params, "on")
    warm_reqs = mk()
    res = warm.serve(warm_reqs)
    _check_tokens(warm_reqs, want)
    pf = res["memory"]["prefix"]
    assert pf["hit_requests"] >= 2 and pf["tokens_saved"] > 0
    assert pf["cow_copies"] == 0
    assert pf["tokens_saved"] % 8 == 0
    assert res["memory"]["preemptions"] == 0
    assert res["memory"]["stall_steps"] == 0
    s = summarize(warm_reqs)
    assert s["prefix_hit_tokens"] == pf["tokens_saved"]
    assert s["prefix_hit_requests"] == pf["hit_requests"]
    warm._pool.allocator.check_invariants()
    assert warm._pool.allocator.n_live == len(list(warm._pool.prefix.pages()))
    assert warm._pool.prefix_lookup(mk()[0].token_history())[1] > 0


def test_prefix_serving_survives_overcommit_preemption(shared_trace):
    """Sharing under lazy overcommit: preempting a sharer never corrupts
    a survivor, and the tokens equal the JAX cold pool's."""
    model, params, mk, want = shared_trace
    eng = _engine(model, params, "on", max_slots=4, kv_pages=13,
                  reservation="lazy", mem_watermark=0.0)
    reqs = mk()
    res = eng.serve(reqs)
    _check_tokens(reqs, want)
    eng._pool.allocator.check_invariants()
    assert res["memory"]["prefix"]["tokens_saved"] > 0


def test_prefix_lazy_mode_cows_partial_boundary_page(shared_trace):
    """Lazy reservation adopts the partially-covered boundary page of a
    full-prefix hit, so the hit's first decode write copies it; tokens
    equal the JAX cold pool's."""
    model, params, mk, want = shared_trace
    eng = _engine(model, params, "on", reservation="lazy")
    reqs = mk()
    res = eng.serve(reqs)
    _check_tokens(reqs, want)
    assert res["memory"]["prefix"]["cow_copies"] >= 1
    eng._pool.allocator.check_invariants()


def test_moe_prefix_cache_forced_off_bit_identical():
    """MoE routes by token-group length, so the engine forces prefix
    sharing off for it: '--prefix-cache on' serves the JAX engine's tokens
    with prefix caching off."""
    jmodel, jparams, model, params = _models("granite-moe-1b-a400m")
    rng = np.random.default_rng(3)
    P = rng.integers(0, 256, (24,)).astype(np.int32)

    def mk(cls=Request):
        return [cls(rid=i, prompt=P.copy(), max_new_tokens=6)
                for i in range(3)]

    off_reqs = mk(JRequest)
    JEngine(jmodel, jparams, serve_cfg=JServeConfig(
        **_BASE, prefix_cache="off")).serve(off_reqs)
    on = _engine(model, params, "on")
    assert on.prefix_cache_for(on.plan) is False
    on_reqs = mk()
    res = on.serve(on_reqs)
    pf = res["memory"]["prefix"]
    assert not pf["enabled"]
    assert pf["hit_requests"] == 0 and pf["tokens_saved"] == 0
    _check_tokens(on_reqs, [r.out_tokens for r in off_reqs])
