"""The port's paged KV pool, against the JAX package's.

The counterparts of ``tests/test_paged_cache.py``: block-allocator
aliasing and conservation, the pool's admit / release, multi-token append
and rollback, lazy grow / preempt / resume lifecycles, its guards, and the
fragmentation regression against the slot pool at fixed memory.  The
property tests run every op sequence on the port's pool and the JAX pool
in lockstep: each answer, block table and length must be equal, besides
the invariants the JAX tests assert.  The port's pool admits through
``admit_shared(n_fresh)``; the JAX pool's ``admit(n_tokens)`` and
``admit_pages(n)`` are the same call with ``n = pages_for(n_tokens,
page_size)``.

The property tests set ``deadline=None``: the reference's
``test_pool_admit_release_roundtrip`` fails hypothesis' default 200 ms
deadline on its first example, which pays JAX's warm-up; that time is no
property of the pool.
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

from repro.serve import cache as jcache
from repro_torch.serve.cache import (PageAllocator, PagedKVPool, SlotKVPool,
                                     pages_for)

CPU = torch.device("cpu")


def _pools(n_pages, ps, n_slots, max_pages):
    """The port's pool and the JAX package's, both empty, same shape."""
    pool = PagedKVPool({"k": (n_pages, ps, 1, 2)}, n_slots, ps, n_pages,
                       max_pages, dtype=torch.float32, device=CPU)
    jpool = jcache.PagedKVPool(
        {"k": jax.ShapeDtypeStruct((n_pages, ps, 1, 2), jnp.float32)},
        n_slots, ps, n_pages, max_pages)
    return pool, jpool


def _admit(pool, n_tokens):
    """The JAX pool's ``admit(n_tokens)``: the worst case, atomically."""
    return pool.admit_shared(pages_for(n_tokens, pool.page_size))


def _same(pool, jpool):
    np.testing.assert_array_equal(pool.block_tables, jpool.block_tables)
    np.testing.assert_array_equal(pool.lengths, jpool.lengths)
    assert (pool.allocator.n_free, pool.allocator.high_water,
            pool.n_free) == (jpool.allocator.n_free,
                             jpool.allocator.high_water, jpool.n_free)


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------


def test_allocator_basics():
    a = PageAllocator(8)                  # pages 1..7 allocatable
    assert a.n_free == 7
    p0 = a.alloc("r0", 3)
    assert p0 is not None and len(p0) == 3 and 0 not in p0
    assert a.alloc("r1", 5) is None       # all-or-nothing
    p1 = a.alloc("r1", 4)
    assert a.n_free == 0
    assert not set(p0) & set(p1)
    assert a.append("r0") is None         # exhausted
    a.free("r0")
    assert a.n_free == 3
    with pytest.raises(ValueError):       # double free
        a.free("r0")
    with pytest.raises(ValueError):       # double alloc for one owner
        a.alloc("r1", 1)
    a.check_invariants()


def test_allocator_null_page_reserved():
    a = PageAllocator(4)
    pages = a.alloc("r", 3)
    assert 0 not in pages                 # page 0 is the null sink
    a.check_invariants()
    with pytest.raises(ValueError):
        PageAllocator(1)


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.integers(min_value=0, max_value=5),
                    min_size=1, max_size=60),
       n_pages=st.integers(min_value=2, max_value=24))
def test_allocator_never_aliases_live_pages(ops, n_pages):
    """Random alloc / append / free interleavings: live pages of distinct
    owners stay disjoint, page 0 never escapes, free + live partition the
    pool, and every answer equals the JAX allocator's."""
    rng = np.random.default_rng(len(ops) * 1000 + n_pages)
    a, ja = PageAllocator(n_pages), jcache.PageAllocator(n_pages)
    owners: dict[int, set] = {}
    next_owner = 0
    for op in ops:
        if op <= 2:
            n = int(rng.integers(0, max(n_pages // 2, 1)))
            got = a.alloc(next_owner, n)
            assert got == ja.alloc(next_owner, n)
            if got is not None:
                assert len(got) == n
                for prev in owners.values():
                    assert not prev & set(got), "aliased a live page"
                owners[next_owner] = set(got)
            next_owner += 1
        elif op <= 3 and owners:
            o = int(rng.choice(list(owners)))
            p = a.append(o)
            assert p == ja.append(o)
            if p is not None:
                for oo, pages in owners.items():
                    assert p not in pages, f"append aliased owner {oo}"
                owners[o].add(p)
        elif owners:
            o = int(rng.choice(list(owners)))
            freed = a.free(o)
            assert freed == ja.free(o)
            assert set(freed) == owners.pop(o)
        a.check_invariants()
        live = set().union(*owners.values()) if owners else set()
        assert a.n_live == len(live)
        assert a.n_free == (n_pages - 1) - len(live)


# ---------------------------------------------------------------------------
# PagedKVPool lifecycles
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(seq=st.lists(st.integers(min_value=1, max_value=40),
                    min_size=1, max_size=12))
def test_pool_admit_release_roundtrip(seq):
    """Admitting and releasing arbitrary token demands conserves pages and
    never hands two slots overlapping block-table entries."""
    pool, jpool = _pools(33, 8, 4, 5)
    held = []
    for need in seq:
        slot = _admit(pool, need)
        assert slot == jpool.admit(need)
        if slot is None:
            if held:
                s = held.pop(0)
                pool.release(s)
                jpool.release(s)
            _same(pool, jpool)
            continue
        held.append(slot)
        row = pool.block_tables[slot]
        live = row[row > 0]
        assert len(set(live)) == len(live)
        for other in held[:-1]:
            orow = pool.block_tables[other]
            assert not set(live) & set(orow[orow > 0]), "block tables alias"
        pool.allocator.check_invariants()
        _same(pool, jpool)
    for slot in held:
        pool.release(slot)
    assert pool.allocator.n_live == 0
    assert pool.n_free == 4
    assert (pool.block_tables == 0).all()


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.integers(min_value=0, max_value=9),
                    min_size=1, max_size=40))
def test_pool_multi_token_append_rollback_properties(ops):
    """Random admit / multi-token advance / rollback / release (the
    speculative decode lifecycle): conservation at every step, no aliasing,
    lengths within the block table's reach, and rollback — pure length
    bookkeeping — leaves the allocator's high-water mark untouched."""
    ps = 4
    pool, jpool = _pools(13, ps, 3, 4)
    cap = 4 * ps
    rng = np.random.default_rng(sum(ops) * 131 + len(ops))
    held: list[int] = []
    for op in ops:
        if op <= 3:
            n = int(rng.integers(1, cap + 1))
            slot = _admit(pool, n)
            assert slot == jpool.admit(n)
            if slot is not None:
                held.append(slot)
        elif op <= 6 and held:
            slot = int(rng.choice(held))
            n = int(rng.integers(0, cap - int(pool.lengths[slot]) + 1))
            pool.advance(slot, n)
            jpool.advance(slot, n)
        elif op <= 8 and held:
            slot = int(rng.choice(held))
            hw = pool.allocator.high_water
            n = int(rng.integers(0, int(pool.lengths[slot]) + 1))
            pool.rollback(slot, n)
            jpool.rollback(slot, n)
            assert pool.allocator.high_water == hw, \
                "rollback touched the allocator"
        elif held:
            slot = held.pop(int(rng.integers(len(held))))
            pool.release(slot)
            jpool.release(slot)
        pool.allocator.check_invariants()
        _same(pool, jpool)
        rows = {s: set(pool.block_tables[s][pool.block_tables[s] > 0])
                for s in held}
        for a in held:
            assert int(pool.lengths[a]) <= cap
            for b in held:
                if a < b:
                    assert not rows[a] & rows[b], "block tables alias"
    for slot in held:
        pool.release(slot)
    assert pool.allocator.n_live == 0 and pool.n_free == 3


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.integers(min_value=0, max_value=11),
                    min_size=1, max_size=50))
def test_pool_lazy_grow_preempt_resume_properties(ops):
    """Random lazy admit / grow / advance / preempt / resume / release
    (the elastic-memory lifecycle): conservation, no aliasing, lengths
    within the pages actually held, preemption returns every page, and a
    preempted demand is re-admittable once enough pages are free."""
    pool, jpool = _pools(11, 4, 3, 4)
    rng = np.random.default_rng(sum(ops) * 977 + len(ops))
    held: list[int] = []
    preempted_demands: list[int] = []
    for op in ops:
        if op <= 2:
            n = int(rng.integers(1, 4))
            slot = pool.admit_shared(n)
            assert slot == jpool.admit_pages(n)
            if slot is not None:
                held.append(slot)
        elif op <= 4 and preempted_demands:
            n = preempted_demands[0]
            slot = pool.admit_shared(n)
            assert slot == jpool.admit_pages(n)
            if slot is not None:
                preempted_demands.pop(0)
                held.append(slot)
        elif op <= 6 and held:
            slot = int(rng.choice(held))
            before = len(pool.allocator.pages_of(slot))
            grew = pool.grow(slot)
            assert grew == jpool.grow(slot)
            assert len(pool.allocator.pages_of(slot)) == before + int(grew)
        elif op <= 8 and held:
            slot = int(rng.choice(held))
            room = pool.reserved_tokens(slot) - int(pool.lengths[slot])
            if room > 0:
                n = int(rng.integers(1, room + 1))
                pool.advance(slot, n)
                jpool.advance(slot, n)
        elif op <= 9 and held:
            slot = held.pop(int(rng.integers(len(held))))
            n_held = len(pool.allocator.pages_of(slot))
            free0 = pool.allocator.n_free
            freed = pool.preempt(slot)
            assert freed == jpool.preempt(slot) == n_held
            assert pool.allocator.n_free == free0 + n_held
            assert (pool.block_tables[slot] == 0).all()
            preempted_demands.append(min(n_held + 1, 4))
        elif held:
            slot = held.pop(int(rng.integers(len(held))))
            pool.release(slot)
            jpool.release(slot)
        pool.allocator.check_invariants()
        _same(pool, jpool)
        rows = {s: set(pool.block_tables[s][pool.block_tables[s] > 0])
                for s in held}
        for a in held:
            assert int(pool.lengths[a]) <= pool.reserved_tokens(a)
            for b in held:
                if a < b:
                    assert not rows[a] & rows[b], "block tables alias"
    for slot in held:
        pool.release(slot)
    assert pool.allocator.n_live == 0 and pool.n_free == 3
    for n in preempted_demands:
        slot = pool.admit_shared(n)
        assert slot is not None
        pool.release(slot)


def test_pool_grow_guards_and_bounds():
    pool, _ = _pools(7, 4, 2, 3)
    with pytest.raises(ValueError):
        pool.grow(0)                      # inactive slot
    slot = pool.admit_shared(1)
    assert pool.reserved_tokens(slot) == 4
    assert pool.grow(slot)
    assert pool.reserved_tokens(slot) == 8
    other = pool.admit_shared(3)          # holds its max; 1 page left free
    assert other is not None
    assert not pool.grow(other)           # block table full
    assert pool.admit_shared(4) is None   # beyond max_pages_per_slot
    assert pool.grow(slot)                # takes the last free page
    assert not pool.grow(slot)            # table full and allocator dry
    pool.allocator.check_invariants()
    assert pool.preempt(other) == 3
    assert pool.n_preempts == 1
    assert pool.allocator.n_free == 3
    pool.release(slot)
    assert pool.allocator.n_live == 0


def test_allocator_free_run_histogram():
    a = PageAllocator(10)
    assert a.free_run_histogram() == {9: 1}
    a.alloc("r0", 3)
    a.alloc("r1", 2)
    a.free("r0")
    hist = a.free_run_histogram()
    assert hist == {3: 1, 4: 1}
    assert sum(n * c for n, c in hist.items()) == a.n_free
    a.free("r1")
    assert a.free_run_histogram() == {9: 1}
    assert PageAllocator(2).free_run_histogram() == {1: 1}


def test_pool_rollback_guards():
    pool, _ = _pools(9, 4, 2, 2)
    slot = _admit(pool, 8)
    pool.advance(slot, 5)
    with pytest.raises(ValueError):
        pool.rollback(slot, 6)            # more than is written
    with pytest.raises(ValueError):
        pool.rollback(slot, -1)
    with pytest.raises(ValueError):
        pool.rollback(1 - slot, 1)        # inactive slot
    pool.rollback(slot, 5)
    assert int(pool.lengths[slot]) == 0
    pool.release(slot)


def test_pool_advance_overflow_guarded():
    pool, _ = _pools(9, 4, 2, 2)
    slot = _admit(pool, 8)
    pool.advance(slot, 8)
    with pytest.raises(ValueError):
        pool.advance(slot, 1)             # beyond the block table
    with pytest.raises(ValueError):
        pool.advance(1 - slot, 1)         # inactive slot


# ---------------------------------------------------------------------------
# Fragmentation regression: in-flight capacity at fixed memory
# ---------------------------------------------------------------------------


def test_paged_admits_more_requests_at_fixed_memory():
    """At the KV budget of 4 whole-cache slots, a mixed-length trace fits
    >= 2x more concurrent requests on the paged pool, because each request
    reserves its own worst case, not max_len."""
    max_len, ps, kv, hd = 256, 16, 2, 8
    meta = torch.empty((1, max_len, kv, hd), dtype=torch.float32,
                       device="meta")
    slot_pool = SlotKVPool({"k": meta, "v": meta}, 4, device=CPU)
    budget = slot_pool.hbm_bytes()
    page_bytes = 2 * ps * kv * hd * 4
    n_pages = budget // page_bytes + 1
    pool = PagedKVPool({"k": (n_pages, ps, kv, hd),
                        "v": (n_pages, ps, kv, hd)}, 64, ps, n_pages,
                       pages_for(max_len, ps), dtype=torch.float32,
                       device=CPU)
    assert pool.page_bytes() == page_bytes
    assert pool.hbm_bytes() <= budget + page_bytes
    rng = np.random.default_rng(0)
    demands = [int(rng.choice([24, 32, 48, 200], p=[.4, .3, .2, .1]))
               for _ in range(64)]
    paged_admitted = sum(_admit(pool, need) is not None for need in demands)
    assert paged_admitted >= 2 * slot_pool.n_slots, (
        f"paged pool admitted {paged_admitted} vs slot {slot_pool.n_slots} "
        f"at the same memory")
    pool.allocator.check_invariants()
