"""The paged KV-cache pool for continuous batching, on PyTorch.

* :class:`PagedKVPool` backs :meth:`repro_torch.serve.engine.Engine.serve`
  for full-KV attention families.  KV
  memory is ONE global block pool per layer: ``k_pages``/``v_pages`` of
  shape ``(n_pages, page_size, KV, HD)``.  A request maps only the pages
  its sequence actually occupies, recorded in a per-slot *block table*
  (``(n_slots, max_pages_per_slot)`` int32 page ids, zero-padded).  Token
  ``t`` of a slot lives at ``(block_table[t // page_size], t % page_size)``.
  Page 0 is a reserved *null sink*: the allocator never hands it out, freed
  slots have all-zero block tables, so fixed-shape decode writes for
  inactive slots land harmlessly in page 0 instead of corrupting a live
  page.  Admission has two modes, chosen by the
  :class:`repro_torch.serve.memory.MemoryGovernor`: **full** reservation admits a
  request only when its whole worst case ``ceil(tokens_needed /
  page_size)`` is free (preemption-free — decode never hits an
  out-of-pages fault mid-flight), while **lazy** admission
  (:meth:`PagedKVPool.admit_shared`) grants only the prompt's pages plus
  one decode page and grows one page at a time (:meth:`PagedKVPool.grow`)
  as generation crosses page boundaries — overcommitting the pool and
  falling back to victim preemption (:meth:`PagedKVPool.preempt`) when the
  free list runs dry.

  **Cross-request prefix sharing.**  A page may be mapped by
  *several* owners at once: :class:`PageAllocator` keeps a per-page
  refcount, ``free``/``drop`` decrement it, and a page returns to the
  free list only when the count hits zero.  Fully-written pages of a
  finished (or decode-started) request are published to a host-side
  :class:`PrefixIndex` — a cumulative ``hash(token run) -> page`` map —
  and the index itself holds one reference per published page (under the
  ``_PREFIX_OWNER`` sentinel), so prefix K/V survives the request that
  computed it.  At admission the engine looks the new prompt up
  (:meth:`PagedKVPool.prefix_lookup`); on a hit the resident pages are
  mapped straight into the new slot's block table
  (:meth:`PagedKVPool.admit_shared`) and only the un-matched suffix is
  prefilled — a cache-hit prompt reaches its first token with near-zero
  prefill compute.  The match is capped at ``len(history) - 1`` tokens so
  the pending token's K/V row is always written by the new request
  itself, keeping greedy output bit-identical to a cold pool.

  **Copy-on-write.**  Shared pages are read-only by construction: before
  any decode step writes rows ``[length, length + S)`` the engine calls
  :meth:`PagedKVPool.cow_for_write`, which copies every still-shared page
  in that range to a fresh page (device row copy + host block-table
  remap, :meth:`PageAllocator.replace`) and decrements the old page's
  refcount.  The first divergent write therefore never mutates another
  request's (or the index's) K/V, and speculative *rollback* is still
  pure length truncation — by the time rejected rows are discarded the
  pages they were written to are private (``rollback`` re-checks this
  defensively).  When the free list runs dry, index-only pages
  (refcount 1, held just by the index) are reclaimed LRU-first
  (:meth:`PagedKVPool.reclaim_prefix`) before admission/growth gives up;
  if even that yields no copy target but the page's only co-owner is the
  index itself, the index's reference is dropped and the page becomes
  private in place (no copy needed — one cache entry is sacrificed so
  the write can always proceed).  The
  :class:`repro_torch.serve.memory.MemoryGovernor` counts reclaimable pages as
  free for watermark purposes and scores preemption victims by how many
  *shared* pages they map (evicting a page with refcount N throws away N
  requests' worth of recompute).  Write-time CoW needs a free page a
  fully-committed pool cannot promise, so under **full** reservation the
  engine trims a partially-adopted boundary page from every prefix hit
  at admission (only that page could ever be written) — full mode's
  preemption-free contract survives sharing; **lazy** mode adopts the
  partial page and CoWs on first write.

  The device state is pages only; block tables, per-slot lengths and the
  prefix index are host-side (the host is the source of truth for slot
  composition, exactly like the engine's pending-token vector) and the
  tables are shipped to the fixed-shape decode step as tiny int32 arrays
  each step.  ``page_size`` and ``prefix_cache`` (on/off) are knobs of
  the attention region's ``RegionConfig``.

  The page tensors live on the pool's device and are updated **in place**
  by the model's steps and by copy-on-write (the JAX package donates the
  buffers instead): ``PagedKVPool.pages`` holds the same tensor objects for
  the pool's whole life.

* :class:`SlotKVPool` backs the slot path of the engine (``paged='off'``,
  and every family without a growing positional KV cache: the recurrent
  ssm/hybrid families and sliding-window rings).  Whole per-request caches
  sit on a slot axis; the decode step runs the model's ``decode_step``
  batched over it.  Its tensors, like the page pool's, are updated in
  place, and a speculative snapshot is a clone.
"""
from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Page allocator (host-side free list, the paged pool's bookkeeping core)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list allocator over ``n_pages`` fixed-size KV blocks.

    Page 0 is reserved as the null sink and never allocated.  A live page
    has one or more owners: :meth:`alloc`/:meth:`append` hand out fresh
    pages at refcount 1, :meth:`share` maps already-live pages into an
    additional owner (prefix reuse), and :meth:`free`/:meth:`drop` only
    *decrement* — a page returns to the free list at refcount zero.
    ``alloc`` is all-or-nothing so admission control can reserve a
    request's worst case atomically; :meth:`replace` swaps one owned page
    for a fresh one in place (the copy-on-write bookkeeping step).
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is the null sink)")
        self.n_pages = n_pages
        # pop() from the end -> low page ids first
        self._free = list(range(n_pages - 1, 0, -1))
        self._owned: dict[Any, list[int]] = {}
        self._refcount: dict[int, int] = {}
        self.high_water = 0                     # peak live pages (frag metric)
        # incremental solo accounting for one designated owner (track_solo)
        self._solo_owner: Any = None
        self._solo_pages: set[int] = set()      # that owner's pages (O(1) in)
        self._solo = 0                          # of those, at refcount 1

    def track_solo(self, owner) -> None:
        """Designate ``owner`` for O(1) solo-page accounting:
        :attr:`n_solo` is maintained incrementally across every refcount
        transition and reports how many of ``owner``'s pages have
        refcount 1 (it is their sole owner).  The pool tracks the prefix
        index this way — its reclaimable-page count feeds every
        per-slot per-step watermark check, where recomputing the sum
        would scan all indexed pages each time."""
        self._solo_owner = owner
        self._solo_pages = set(self._owned.get(owner, ()))
        self._solo = sum(1 for p in self._solo_pages
                         if self._refcount[p] == 1)

    @property
    def n_solo(self) -> int:
        """Pages solely owned by the :meth:`track_solo` owner — O(1)."""
        return self._solo

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._refcount)

    def pages_of(self, owner) -> list[int]:
        return list(self._owned.get(owner, ()))

    def n_held(self, owner) -> int:
        """Pages mapped by ``owner`` — O(1), shared pages count once per
        owner (the hot-path replacement for scanning the block table)."""
        return len(self._owned.get(owner, ()))

    def refcount(self, page: int) -> int:
        """Owners currently mapping ``page`` (0 = free / never allocated)."""
        return self._refcount.get(page, 0)

    def _decref(self, page: int, owner) -> bool:
        """Drop ``owner``'s reference; True when the page was reclaimed."""
        n = self._refcount[page] - 1
        if owner == self._solo_owner:
            self._solo_pages.discard(page)
            if n == 0:
                self._solo -= 1     # was solo-owned by the tracked owner
        elif n == 1 and page in self._solo_pages:
            self._solo += 1         # the tracked owner is now sole owner
        if n:
            self._refcount[page] = n
            return False
        del self._refcount[page]
        self._free.append(page)
        return True

    def alloc(self, owner, n: int) -> Optional[list[int]]:
        """Atomically claim ``n`` fresh pages for a new ``owner`` (None if
        short)."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds pages")
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[owner] = pages
        for p in pages:
            self._refcount[p] = 1
        if owner == self._solo_owner:
            self._solo_pages.update(pages)
            self._solo += len(pages)
        self.high_water = max(self.high_water, self.n_live)
        return list(pages)      # a copy: replace() edits the owned list

    def append(self, owner) -> Optional[int]:
        """Grow an existing owner by one fresh page (None when exhausted)."""
        if owner not in self._owned:
            raise ValueError(f"owner {owner!r} holds no pages (alloc first)")
        if not self._free:
            return None
        p = self._free.pop()
        self._owned[owner].append(p)
        self._refcount[p] = 1
        if owner == self._solo_owner:
            self._solo_pages.add(p)
            self._solo += 1
        self.high_water = max(self.high_water, self.n_live)
        return p

    def share(self, owner, pages: Sequence[int]) -> None:
        """Map already-live ``pages`` into ``owner`` as well, bumping each
        refcount (the prefix-reuse entry point).  Creates ``owner`` if it
        holds nothing yet; raises if a page is not live or is already
        mapped by this owner."""
        held = self._owned.get(owner, [])
        for p in pages:                         # validate before mutating
            if p not in self._refcount:
                raise ValueError(f"page {p} is not live (cannot share)")
            if p in held:
                raise ValueError(f"owner {owner!r} already maps page {p}")
        if len(set(pages)) != len(pages):
            raise ValueError("duplicate pages in share request")
        if owner not in self._owned:
            self._owned[owner] = []
        for p in pages:
            self._owned[owner].append(p)
            self._refcount[p] += 1
            if self._refcount[p] == 2 and p in self._solo_pages:
                self._solo -= 1     # the tracked owner gained a co-owner
            if owner == self._solo_owner:
                self._solo_pages.add(p)     # refcount >= 2 here: not solo

    def free(self, owner) -> list[int]:
        """Unmap every page held by ``owner``; returns the pages actually
        *reclaimed* (refcount hit zero — with sharing this can be fewer
        than the pages the owner mapped)."""
        if owner not in self._owned:
            raise ValueError(f"owner {owner!r} holds no pages (double free?)")
        pages = self._owned.pop(owner)
        return [p for p in reversed(pages) if self._decref(p, owner)][::-1]

    def drop(self, owner, page: int) -> bool:
        """Unmap one ``page`` from ``owner`` (True when reclaimed)."""
        held = self._owned.get(owner)
        if held is None or page not in held:
            raise ValueError(f"owner {owner!r} does not map page {page}")
        held.remove(page)
        return self._decref(page, owner)

    def replace(self, owner, old: int) -> Optional[int]:
        """Swap ``old`` for a fresh page *in place* in ``owner``'s mapping
        (copy-on-write bookkeeping: the caller copies device contents and
        remaps its block table).  The fresh page starts at refcount 1 and
        ``old`` loses this owner's reference.  None when the free list is
        dry — the caller must reclaim or stall."""
        held = self._owned.get(owner)
        if held is None or old not in held:
            raise ValueError(f"owner {owner!r} does not map page {old}")
        if not self._free:
            return None
        new = self._free.pop()
        held[held.index(old)] = new
        self._refcount[new] = 1
        if owner == self._solo_owner:
            self._solo_pages.add(new)
            self._solo += 1
        self.high_water = max(self.high_water, self.n_live)
        self._decref(old, owner)
        return new

    def free_run_histogram(self) -> dict[int, int]:
        """Histogram of contiguous free-page-id runs: ``{run_len: count}``.

        The paged layout never *needs* contiguity (the block table is a full
        indirection), so this is purely an observability metric: a free list
        shredded into short runs means admissions and releases have
        interleaved heavily — the governor reports it next to the HBM
        high-water so memory-pressure incidents can be read off one line."""
        hist: dict[int, int] = {}
        run, prev = 0, None
        for p in sorted(self._free):
            if prev is not None and p == prev + 1:
                run += 1
            else:
                if run:
                    hist[run] = hist.get(run, 0) + 1
                run = 1
            prev = p
        if run:
            hist[run] = hist.get(run, 0) + 1
        return hist

    def check_invariants(self) -> None:
        """Free + live partition pages 1..n-1; per-owner mappings are
        duplicate-free; refcounts equal the number of owners mapping each
        page (so no reclaim while refcount > 0 and no leak at zero)."""
        free = set(self._free)
        live = set(self._refcount)
        assert not (free & live), f"pages both free and live: {free & live}"
        assert free | live == set(range(1, self.n_pages)), "page leak"
        assert 0 not in free and 0 not in live, "null page escaped"
        assert len(free) == len(self._free), "free list duplicates"
        counts: Counter = Counter()
        for owner, pages in self._owned.items():
            assert len(pages) == len(set(pages)), \
                f"owner {owner!r} maps a page twice"
            counts.update(pages)
        assert dict(counts) == self._refcount, \
            "refcounts disagree with ownership maps"
        assert all(c >= 1 for c in self._refcount.values()), \
            "live page with refcount < 1"
        if self._solo_owner is not None:
            held = set(self._owned.get(self._solo_owner, ()))
            assert self._solo_pages == held, "solo page set drifted"
            want = sum(1 for p in held if self._refcount[p] == 1)
            assert self._solo == want, \
                f"solo count drifted ({self._solo} != {want})"


# ---------------------------------------------------------------------------
# Prefix index (host-side hash(token run) -> resident page)
# ---------------------------------------------------------------------------


def _page_keys(tokens: np.ndarray, page_size: int, n_full: int) -> list[bytes]:
    """Cumulative content keys for the first ``n_full`` full pages of a
    token run.  Key ``i`` hashes tokens ``[0, (i+1) * page_size)`` — the
    whole *prefix*, not just the page's own chunk — so two different
    histories that happen to share one middle page never collide, and a
    lookup can walk key-by-key without materialising the run."""
    h = hashlib.sha1()
    keys = []
    for i in range(n_full):
        h.update(tokens[i * page_size:(i + 1) * page_size]
                 .astype("<i4").tobytes())
        keys.append(h.digest())
    return keys


class PrefixIndex:
    """LRU map from cumulative token-prefix hashes to resident page ids.

    One entry per *fully-written* page: ``key = sha1(tokens[:(i+1)*ps])``
    maps to the physical page holding rows ``[i*ps, (i+1)*ps)`` of some
    past request.  Lookup walks a new prompt's keys in order and stops at
    the first miss, so a hit is always a contiguous leading run of pages.
    The index stores host ints only — page *references* are held by the
    pool on the index's behalf (``_PREFIX_OWNER`` in the allocator), and
    eviction (:meth:`drop_page`) is driven by the pool's
    ``reclaim_prefix`` walking :meth:`lru_pages` oldest-first.  Dropping a
    mid-chain page orphans the chain's tail (unreachable by lookup); the
    orphans are index-only (refcount 1) and get reclaimed by the very
    next walks, so they cannot pin memory."""

    def __init__(self):
        self._entries: OrderedDict[bytes, int] = OrderedDict()  # key -> page
        self._key_of: dict[int, bytes] = {}                     # page -> key
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, tokens: np.ndarray, page_size: int) -> list[int]:
        """Longest resident leading page run for ``tokens`` (LRU-touched)."""
        self.lookups += 1
        toks = np.asarray(tokens, np.int32).reshape(-1)
        pages: list[int] = []
        for key in _page_keys(toks, page_size, toks.size // page_size):
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)
            pages.append(page)
        if pages:
            self.hits += 1
        return pages

    def register(self, tokens: np.ndarray, pages: Sequence[int],
                 page_size: int, n_full: int) -> list[int]:
        """Publish the first ``n_full`` fully-written pages of ``tokens``.
        Keys already present keep their existing page (first writer wins —
        identical content, and the older page may already be shared);
        returns the pages *newly* held by the index so the caller can take
        the index's reference on exactly those."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        new: list[int] = []
        for i, key in enumerate(_page_keys(toks, page_size, n_full)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            page = int(pages[i])
            if page in self._key_of:        # already published under another
                continue                    # (orphaned) chain — keep that ref
            self._entries[key] = page
            self._key_of[page] = key
            new.append(page)
        return new

    def drop_page(self, page: int) -> None:
        key = self._key_of.pop(page, None)
        if key is not None:
            del self._entries[key]

    def lru_pages(self) -> list[int]:
        """Resident pages, least-recently-used first (eviction order)."""
        return list(self._entries.values())

    def pages(self) -> Iterable[int]:
        return self._key_of.keys()


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-max(n_tokens, 0) // page_size)


#: Allocator owner under which the :class:`PrefixIndex` holds its page
#: references (slots are ints, so the string can never collide).
_PREFIX_OWNER = "prefix-cache"


class PagedKVPool:
    """Global KV block pool + per-slot block tables (see module docstring).

    ``pages`` is the nested dict of per-layer page tensors (shaped by the
    model's ``paged_cache_spec``, zero-initialised on ``device``), updated
    in place; ``block_tables``/``lengths`` are host numpy, updated by
    :meth:`admit`/:meth:`advance`/:meth:`release`.
    Prefix sharing is off until the engine sets ``prefix_enabled`` (the
    ``--prefix-cache`` knob / ``mem_prefix_*`` candidates).
    """

    def __init__(self, page_shapes: Any, n_slots: int, page_size: int,
                 n_pages: int, max_pages_per_slot: int, *,
                 dtype: torch.dtype, device: torch.device):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_slots = n_slots
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages_per_slot = max_pages_per_slot
        # tensor-parallel shard count of the pages (the kv-head dim, as in
        # the JAX package).  Page, slot and watermark arithmetic is in page
        # counts, which sharding leaves untouched.  At tp > 1 ``pages``
        # holds this rank's shard (``page_shapes`` are the shard's), so the
        # byte views multiply it back up and the per_device_* views are
        # the shard's own bytes
        self.tp_shards = 1
        # called as mirror(old, new) after each copy-on-write page copy:
        # the other ranks' shards copy the same page (None on one rank)
        self.mirror = None
        self.pages = tree_map(
            lambda shape: torch.zeros(shape, dtype=dtype, device=device),
            page_shapes)
        self.allocator = PageAllocator(n_pages)
        # reclaimable-page accounting is on every watermark check (per
        # slot per step): the allocator maintains the index's solo count
        # incrementally instead of scanning the indexed pages each time
        self.allocator.track_solo(_PREFIX_OWNER)
        self.block_tables = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._active: set[int] = set()
        self.n_preempts = 0                 # victims evicted mid-flight
        # -- prefix sharing ----------------------------------------------------
        self.prefix_enabled = False
        self.prefix = PrefixIndex()
        self.prefix_hit_requests = 0        # admissions that mapped shared pages
        self.prefix_tokens_saved = 0        # prompt tokens skipped by sharing
        self.cow_copies = 0                 # shared pages privatised pre-write
        self.prefix_evictions = 0           # index-only pages reclaimed
        self.dedup_holds = 0                # admissions held for an identical
                                            # in-flight prompt to publish
        # optional FaultInjector (serve/faults.py), threaded in by the
        # engine; None = zero-overhead production path
        self.faults = None

    # -- slot accounting -----------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return len(self._active)

    def admit_shared(self, n_fresh: int,
                     shared_pages: Sequence[int] = ()) -> Optional[int]:
        """Admit a request mapping ``shared_pages`` (a prefix-cache hit,
        refcounts bumped — becoming rows ``[0, len(shared) * page_size)``
        of its block table) plus ``n_fresh`` fresh pages.  Index-only
        pages are reclaimed LRU-first if the free list is short, but the
        hit's own pages are never sacrificed to admit it.  Atomic; None
        when no slot or still not enough pages."""
        if n_fresh < 0:
            raise ValueError("n_fresh must be >= 0")
        if self.faults is not None and self.faults.fire("alloc.exhaust"):
            return None                 # injected: free list reads as dry
        shared = [int(p) for p in shared_pages]
        if (not self._free_slots
                or n_fresh + len(shared) > self.max_pages_per_slot):
            return None
        if n_fresh > self.allocator.n_free:
            self.reclaim_prefix(n_fresh - self.allocator.n_free, keep=shared)
            if n_fresh > self.allocator.n_free:
                return None
        slot = self._free_slots.pop()
        self.allocator.share(slot, shared)
        for _ in range(n_fresh):
            self.allocator.append(slot)
        pages = self.allocator.pages_of(slot)
        self._active.add(slot)
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        self.lengths[slot] = 0
        return slot

    def grow(self, slot: int) -> bool:
        """Extend ``slot`` by one page (lazy growth at a page boundary),
        reclaiming an index-only prefix page if the free list is dry.
        False when nothing is reclaimable either or the block table is
        full — the governor then evicts a victim or stalls the slot."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        if self.faults is not None and self.faults.fire("alloc.exhaust"):
            return False                # injected: free list reads as dry
        held = self.allocator.n_held(slot)
        if held >= self.max_pages_per_slot:
            return False
        if self.allocator.n_free == 0:
            self.reclaim_prefix(1)
        p = self.allocator.append(slot)
        if p is None:
            return False
        self.block_tables[slot, held] = p
        return True

    def release(self, slot: int) -> list[int]:
        """Unmap a slot's pages (reclaimed only where this was the last
        reference); its block-table row reverts to the null page.  Returns
        the reclaimed pages."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active (double free?)")
        reclaimed = self.allocator.free(slot)
        self._active.remove(slot)
        self._free_slots.append(slot)
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        return reclaimed

    def preempt(self, slot: int) -> int:
        """Evict a victim mid-flight: identical page bookkeeping to
        :meth:`release` (the request's K/V is *discarded*, not swapped —
        it re-enters as recompute-prefill over prompt + generated-so-far),
        but counted separately so the governor's report distinguishes
        completions from evictions.  Pages the victim *shared* with a
        survivor or the prefix index stay live (only the victim's
        reference drops).  Returns the number of pages reclaimed."""
        reclaimed = self.release(slot)
        self.n_preempts += 1
        return len(reclaimed)

    def leaked_pages(self) -> int:
        """Live pages reachable from neither an active slot nor the prefix
        index — stranded references left by a buggy fault path.  Zero on a
        healthy pool; the engine audits this at serve end and after any
        aborted serve (on top of ``allocator.check_invariants``, which
        already guarantees refcounts match owners)."""
        reachable: set[int] = set(self.allocator.pages_of(_PREFIX_OWNER))
        for slot in self._active:
            reachable.update(self.allocator.pages_of(slot))
        return self.allocator.n_live - len(reachable)

    def advance(self, slot: int, n_tokens: int) -> None:
        """Record ``n_tokens`` newly covered tokens for ``slot`` — rows
        written by prefill/verify steps at offsets ``lengths ..
        lengths+n-1``, or rows *adopted* from shared prefix pages at
        admission (no write happened; the K/V is already resident)."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        new_len = int(self.lengths[slot]) + n_tokens
        if new_len > self.max_pages_per_slot * self.page_size:
            raise ValueError(f"slot {slot} overflows its block table "
                             f"({new_len} tokens)")
        self.lengths[slot] = new_len

    def reserved_tokens(self, slot: int) -> int:
        """Token capacity of the pages ``slot`` actually maps — the reach
        of its block table.  Writes beyond it land in the null page, so
        speculative acceptance must stop here (not at the pool-wide
        ``max_pages_per_slot`` bound, which a lazily-allocated slot need
        not have reserved).  O(1) from the allocator's held-page count —
        a block-table ``count_nonzero`` scan would both cost
        O(max_pages_per_slot) in the per-slot per-step hot path and
        (now that pages can be shared) give the same answer only by
        accident of the mapping being positional."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        return self.allocator.n_held(slot) * self.page_size

    def rollback(self, slot: int, n_tokens: int) -> None:
        """Truncate ``slot`` by ``n_tokens`` — the rejected tail of a
        speculative block.  Pure length bookkeeping, no page churn: the
        slot keeps every reserved page (so high-water accounting is
        untouched) and the stale K/V rows beyond the new length are masked
        by attention and overwritten by the next step's writes before any
        mask admits them.  Pages in the rolled-back range must be private:
        the engine privatises them (:meth:`cow_for_write`) before the
        verify step writes, so finding a shared one here means rows were
        written into another owner's K/V — re-privatised defensively, or
        an error if no page is left to copy into."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        length = int(self.lengths[slot])
        if n_tokens < 0 or n_tokens > length:
            raise ValueError(f"slot {slot}: cannot roll back {n_tokens} of "
                             f"{length} tokens")
        if n_tokens:
            for idx in range((length - n_tokens) // self.page_size,
                             (length - 1) // self.page_size + 1):
                page = int(self.block_tables[slot, idx])
                if page and self.allocator.refcount(page) > 1:
                    if not self._cow(slot, idx):
                        raise RuntimeError(
                            f"slot {slot}: rollback over shared page {page} "
                            f"with no free page to privatise into")
        self.lengths[slot] = length - n_tokens

    # -- prefix sharing ------------------------------------------------------
    def prefix_lookup(self, tokens: np.ndarray) -> tuple[list[int], int]:
        """Longest cached leading page run for a token history: returns
        ``(pages, matched_tokens)``.  ``matched`` is capped at
        ``len(tokens) - 1`` so the engine always prefills (at least) the
        pending last token itself — its K/V row is never adopted, which
        keeps cache-hit output bit-identical to a cold pool.  ``([], 0)``
        when sharing is disabled or nothing matches."""
        if not self.prefix_enabled:
            return [], 0
        toks = np.asarray(tokens, np.int32).reshape(-1)
        pages = self.prefix.lookup(toks, self.page_size)
        if not pages:
            return [], 0
        matched = min(len(pages) * self.page_size, toks.size - 1)
        if matched <= 0:
            return [], 0
        return pages[:pages_for(matched, self.page_size)], matched

    def register_prefix(self, slot: int, tokens: np.ndarray) -> int:
        """Publish ``slot``'s fully-written pages under ``tokens`` (its
        committed history) to the prefix index, which takes one reference
        per newly published page so the K/V outlives the request.  The
        last history token is pending (row not written) and a partial tail
        page is never published.  Returns pages newly indexed."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        if not self.prefix_enabled:
            return 0
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n_full = min(int(self.lengths[slot]), toks.size - 1) // self.page_size
        if n_full <= 0:
            return 0
        new = self.prefix.register(
            toks, [int(p) for p in self.block_tables[slot, :n_full]],
            self.page_size, n_full)
        if new:
            self.allocator.share(_PREFIX_OWNER, new)
        return len(new)

    @property
    def n_reclaimable(self) -> int:
        """Index-only pages (refcount 1): reclaimable on demand, so the
        governor's watermark treats them as free.  O(1) — the allocator
        keeps the count incremental (:meth:`PageAllocator.track_solo`);
        this sits on the per-slot per-step watermark/growth hot path, so
        a per-call scan over the indexed pages would not do."""
        return self.allocator.n_solo

    def reclaim_prefix(self, n: int, keep: Sequence[int] = ()) -> int:
        """Evict up to ``n`` index-only prefix pages, least recently used
        first.  Pages in ``keep`` (e.g. the very hit being admitted) and
        pages still mapped by a resident slot are skipped.  Returns the
        number of pages actually reclaimed."""
        if n <= 0 or not len(self.prefix):
            return 0
        keep_set = set(int(p) for p in keep)
        dropped = 0
        for page in self.prefix.lru_pages():
            if dropped >= n:
                break
            if page in keep_set or self.allocator.refcount(page) != 1:
                continue
            self.prefix.drop_page(page)
            self.allocator.drop(_PREFIX_OWNER, page)
            self.prefix_evictions += 1
            dropped += 1
        return dropped

    def cow_for_write(self, slot: int, n_tokens: int) -> bool:
        """Privatise every shared page the next ``n_tokens`` rows of
        ``slot`` would write into (rows ``[length, length + n)``, clipped
        to the reserved reach).  Device contents are copied row-for-row to
        a fresh page and the block table remapped, so the write can
        proceed without mutating a co-owner's K/V.  False when a copy
        target cannot be found even after reclaiming index-only pages —
        the engine then treats the slot like a failed growth (victim or
        stall)."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        length = int(self.lengths[slot])
        hi = min(length + n_tokens, self.reserved_tokens(slot))
        if hi <= length:
            return True
        for idx in range(length // self.page_size,
                         (hi - 1) // self.page_size + 1):
            page = int(self.block_tables[slot, idx])
            if page and self.allocator.refcount(page) > 1:
                if not self._cow(slot, idx):
                    return False
        return True

    def _cow(self, slot: int, idx: int) -> bool:
        """Copy block-table entry ``idx`` of ``slot`` to a private page.

        When no copy target exists anywhere (free list dry, nothing
        reclaimable) but the page's only co-owner is the prefix index,
        the index's reference is dropped instead: the page becomes
        private *in place* with no device copy, at the cost of one cache
        entry.  Without this a slot sharing its page only with the index
        could never be privatised — ``reclaim_prefix`` skips pages with
        refcount > 1, so it cannot unpin the index's reference on the
        slot's own page, and the serve loop would stall forever."""
        old = int(self.block_tables[slot, idx])
        if self.allocator.n_free == 0:
            self.reclaim_prefix(1)
        new = self.allocator.replace(slot, old)
        if new is None:
            if (self.allocator.refcount(old) == 2
                    and old in self.prefix.pages()):
                self.prefix.drop_page(old)
                self.allocator.drop(_PREFIX_OWNER, old)
                self.prefix_evictions += 1
                return True
            return False
        for t in self.page_tensors():
            t[new].copy_(t[old])            # in place: pages keep identity
        if self.mirror is not None:
            self.mirror(old, new)
        self.block_tables[slot, idx] = new
        self.cow_copies += 1
        return True

    def prefix_stats(self) -> dict:
        """Machine-readable sharing counters (the governor's summary
        reports them next to the memory taps)."""
        return {
            "enabled": self.prefix_enabled,
            "indexed_pages": len(self.prefix),
            "reclaimable_pages": self.n_reclaimable,
            "lookups": self.prefix.lookups,
            "hit_lookups": self.prefix.hits,
            "hit_requests": self.prefix_hit_requests,
            "tokens_saved": self.prefix_tokens_saved,
            "cow_copies": self.cow_copies,
            "evictions": self.prefix_evictions,
            "dedup_holds": self.dedup_holds,
        }

    # -- memory accounting ---------------------------------------------------
    def page_tensors(self) -> list[torch.Tensor]:
        """Every layer's K and V page tensor."""
        return tree_leaves(self.pages)

    def page_bytes(self) -> int:
        """Bytes of one page across all layers (K and V) and all
        tensor-parallel shards."""
        return sum(t[0].numel() * t.element_size()
                   for t in self.page_tensors()) * self.tp_shards

    def hbm_bytes(self) -> int:
        """Total pool HBM footprint (all pages, live or free)."""
        return self.page_bytes() * self.n_pages

    def high_water_bytes(self) -> int:
        """Peak bytes of *live* pages — the trace's real KV working set."""
        return self.page_bytes() * self.allocator.high_water

    # per-device views: each of ``tp_shards`` devices holds 1/tp of every
    # page's bytes
    def per_device_page_bytes(self) -> int:
        return self.page_bytes() // self.tp_shards

    def per_device_hbm_bytes(self) -> int:
        return self.hbm_bytes() // self.tp_shards

    def per_device_high_water_bytes(self) -> int:
        return self.high_water_bytes() // self.tp_shards


# ---------------------------------------------------------------------------
# Slot (whole-cache) pool — recurrent/ring families and the legacy layout
# ---------------------------------------------------------------------------


class SlotKVPool:
    """Fixed-shape pool of per-request caches with a free-slot list.

    A per-request cache is the model's ``cache_spec(batch=1, ...)`` tree;
    each leaf becomes a pooled tensor of ``n_slots`` rows in its place
    (``pos`` becomes one position per slot).  The decode step reads the
    whole pool as a batch of ``n_slots`` caches; :meth:`write` copies one
    request's cache into its row, :meth:`update` the step's new caches
    into every row — in place, so :attr:`pool` holds the same tensor
    objects for the pool's whole life.  Freed slots keep their stale
    contents; correctness relies on allocation always overwriting via
    :meth:`write` (or :meth:`empty_slot_cache` for promptless requests),
    never on zeroing.
    """

    def __init__(self, slot_cache_spec: Any, n_slots: int, *,
                 device: torch.device):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.slot_spec = slot_cache_spec
        self.device = device
        self.pool = tree_map(
            lambda s: torch.zeros((n_slots,) + tuple(s.shape[1:]),
                                  dtype=s.dtype, device=device),
            slot_cache_spec)
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> slot 0 first
        self._active: set[int] = set()
        self.high_water = 0                     # peak live slots

    # -- slot accounting -----------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._active)

    def alloc(self) -> Optional[int]:
        """Claim a free slot (None when the pool is full)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._active.add(slot)
        self.high_water = max(self.high_water, len(self._active))
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active (double free?)")
        self._active.remove(slot)
        self._free.append(slot)

    # -- cache data ----------------------------------------------------------
    def write(self, slot: int, cache: Any) -> None:
        """Copy one request's cache (batch 1) into the pool at ``slot``."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        for dst, src in zip(tree_leaves(self.pool), tree_leaves(cache)):
            dst[slot:slot + 1].copy_(src)

    def update(self, caches: Any) -> None:
        """Copy the decode step's new caches (batch ``n_slots``) into the
        pool; a leaf the step already wrote in place is skipped."""
        for dst, src in zip(tree_leaves(self.pool), tree_leaves(caches)):
            if src is not dst:
                dst.copy_(src)

    def empty_slot_cache(self) -> Any:
        """A zeroed single-request cache (pos=0): the pre-prompt state."""
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=self.device),
                        self.slot_spec)

    def read(self, slot: int) -> Any:
        """One slot's cache (batch 1), cloned out of the pool: safe across
        later writes to the pool."""
        return tree_map(lambda p: p[slot:slot + 1].clone(), self.pool)

    # -- speculative snapshot/restore ----------------------------------------
    # A recurrence has no length-truncation rollback: rejected draft tokens
    # are already folded into the state.  The speculative contract for slot
    # families is therefore copy-before-verify: ``snapshot`` clones the
    # slot's whole cache, ``restore`` copies it back after a rejection, and
    # the engine re-advances only the accepted tokens through the exact
    # sequential recurrence.
    def snapshot(self, slot: int) -> Any:
        """A clone of every leaf of a slot's cache, taken before a verify
        step.  It costs the slot's bytes: the recurrent state, plus for a
        hybrid the per-slot K/V of every attention site at max_len rows,
        so it grows with max_len."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        return self.read(slot)

    def restore(self, slot: int, snap: Any) -> None:
        """Copy a snapshot back: state after a rejected draft is exactly
        the state before the draft (bitwise)."""
        self.write(slot, snap)

    # -- memory accounting ---------------------------------------------------
    def slot_bytes(self) -> int:
        """Bytes of one resident slot's cache across all leaves."""
        return self.hbm_bytes() // self.n_slots

    def hbm_bytes(self) -> int:
        """Total pool footprint, every leaf."""
        return int(sum(t.numel() * t.element_size()
                       for t in tree_leaves(self.pool)))

    def high_water_bytes(self) -> int:
        """Peak bytes of *live* slots — the trace's real state working set
        (the pool itself is fixed-shape; this is the occupancy peak)."""
        return self.slot_bytes() * self.high_water
