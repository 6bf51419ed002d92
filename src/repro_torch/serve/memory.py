"""Elastic KV-memory governor: lazy admission, watermark control, preemption.

Full reservation provisions KV memory statically: admission reserves
every request's worst case up front, so the pool runs half-empty on
short-generation traffic.  The :class:`MemoryGovernor` makes allocation
policy a knob of its own:

* **Lazy admission** — a request enters with only
  ``ceil(prompt_len / page_size)`` pages plus one decode page
  (:meth:`repro_torch.serve.cache.PagedKVPool.admit_shared`) and grows one page
  at a time at page boundaries (:meth:`PagedKVPool.grow`) as generation
  proceeds, so the pool's free list tracks *actual* occupancy instead of
  the sum of worst cases — an overcommitted trace fits far more
  concurrent requests into the same ``--kv-pages``.

* **Watermark admission control** — new requests are admitted only while
  the free list sits above ``watermark`` (a fraction of allocatable
  pages), so decode growth for residents keeps headroom and admission
  churn can't thrash the pool into preemption storms.  The watermark is
  bypassed when the pool is empty (nothing resident could ever free a
  page, so blocking would deadlock).

* **Preemption** — when growth fails mid-step the governor picks a victim
  (LIFO by admission time among resident decodes, each request protected
  after ``max_preempts`` evictions), frees its pages
  (:meth:`PagedKVPool.preempt`) and the engine re-queues it through the
  scheduler's PREEMPTED state: it re-enters as recompute-prefill over
  prompt + generated-so-far, so per-request greedy output is bit-identical
  to a never-preempted run (equivalence-tested).  A slot that can neither
  grow nor find a victim *stalls* — it is masked out of the decode step
  (its write would land in the null page) and retried next step.

* **Prefix-aware accounting** — with cross-request prefix sharing
  (:class:`repro_torch.serve.cache.PrefixIndex`) the governor's arithmetic
  learns two things.  Admission asks the pool for the prompt's cached
  leading run first and reserves only the *un-shared* remainder; the
  watermark compares demand against ``free + reclaimable`` (index-only
  pages are droppable on demand, so counting them as occupied would
  starve admission to protect droppable cache).  And victim selection
  scores each resident by how many *shared* pages it maps: evicting a
  page with refcount N throws away N requests' worth of recompute, so
  among cap-eligible residents the governor prefers the one sharing the
  fewest pages, falling back to LIFO admission order to break ties
  (``shared_spared`` counts how often this overrode the pure-LIFO pick).

* **Policy from the plan** — ``reservation`` and the watermark fraction
  are knobs of the attention region's ``RegionConfig`` (a ``ServeConfig``
  value pins them), resolved once when the engine builds its pool.

The governor owns *policy and accounting*; page bookkeeping stays in
:class:`repro_torch.serve.cache.PagedKVPool` and lifecycle in
:class:`repro_torch.serve.scheduler.Scheduler` (the engine mediates, as for
everything else in the serving loop).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.serve.cache import PagedKVPool, pages_for


@dataclasses.dataclass
class MemoryPolicy:
    """The governor's knobs."""
    reservation: str = "full"   # 'full' = worst case up front; 'lazy' = grow
    watermark: float = 0.1      # lazy-admission free-page high watermark,
                                # as a fraction of allocatable pages
    max_preempts: int = 4       # per-request eviction cap (victim filter)


class MemoryGovernor:
    """Admission + reclamation policy for one :class:`PagedKVPool`."""

    def __init__(self, pool: PagedKVPool, policy: Optional[MemoryPolicy] = None):
        self.pool = pool
        self.policy = policy or MemoryPolicy()
        # -- taps (the measurement side of the loop) -------------------------
        self.stall_steps = 0        # decode steps where >= 1 slot stalled
        self.stall_slot_steps = 0   # slot-granular stall count
        self.admit_blocked = 0      # admissions deferred by the watermark
        self.grown_pages = 0        # pages added by lazy growth
        self.peak_resident = 0      # max concurrent resident requests
        self.shared_spared = 0      # victim picks diverted off a sharer
        # free pages per decode step, decimated in place: the stride
        # doubles whenever the buffer fills, so a serve of any length
        # holds <= _TRACE_CAP samples
        self.free_page_trace: list[int] = []
        self.free_pages_min: Optional[int] = None   # exact, not sampled
        self._trace_stride = 1
        self._trace_skip = 0
        # optional FaultInjector (serve/faults.py), threaded in by the
        # engine; None = zero-overhead production path
        self.faults = None

    _TRACE_CAP = 128                # decimate when the trace hits this

    # -- admission ------------------------------------------------------------
    def admit(self, prompt_tokens: int, total_tokens: int,
              shared_pages: Sequence[int] = ()) -> Optional[int]:
        """Admit one request; returns its slot or None (head-of-line waits).

        ``prompt_tokens`` is the length of the token history the slot must
        hold before its first decode step (prompt + any recomputed
        generation for a preempted request); ``total_tokens`` is the
        request's worst case.  ``shared_pages`` is the prompt's cached
        leading page run (a prefix-index hit): both modes map it and
        reserve only the *fresh* remainder.  Full mode reserves the whole
        remainder atomically and stays preemption-free under sharing
        because the engine never passes it a partially-covered boundary
        page (the only shared page a request could ever write, whose CoW
        would need a free page at write time that a fully-committed pool
        cannot promise — see ``Engine.serve``'s admission path); lazy
        mode adopts partial boundary pages and copies on first write.
        Lazy mode takes the un-shared prompt pages
        plus one decode page — never more than the worst case — and only
        while free-equivalent pages (free list + reclaimable index-only
        pages) stay above the watermark."""
        pool = self.pool
        n_shared = len(shared_pages)
        worst = pages_for(total_tokens, pool.page_size)
        if self.policy.reservation != "lazy":
            slot = pool.admit_shared(max(worst - n_shared, 0), shared_pages)
        else:
            need = max(min(pages_for(prompt_tokens, pool.page_size) + 1,
                           worst) - n_shared, 0)
            allocatable = pool.n_pages - 1
            free_eq = pool.allocator.n_free + pool.n_reclaimable
            if (pool.n_active > 0 and free_eq - need
                    < self.policy.watermark * allocatable):
                self.admit_blocked += 1
                return None
            slot = pool.admit_shared(need, shared_pages)
        if slot is not None and pool.n_active > self.peak_resident:
            self.peak_resident = pool.n_active
        return slot

    # -- growth ---------------------------------------------------------------
    def ensure_headroom(self, slot: int, want_tokens: int,
                        cap_tokens: int) -> int:
        """Grow ``slot`` so its reserved reach covers the next decode write;
        returns the headroom actually available (tokens past the current
        length — 0 means the caller must reclaim a victim or stall).

        The first token of headroom is *mandatory* (without it the step's
        K/V write lands in the null page and the sampled token would be
        garbage); growth toward ``want_tokens`` (the speculative block
        width) is opportunistic — it stops at the watermark so speculation
        never starves admission.  Growth never exceeds ``cap_tokens`` (the
        request's own worst case), so a fully-reserved slot — or any slot
        near its budget — never takes pages it cannot use."""
        pool = self.pool
        length = int(pool.lengths[slot])
        reserved = pool.reserved_tokens(slot)
        if self.faults is not None and self.faults.fire("mem.grow"):
            # injected growth/CoW denial: report only what is already
            # reserved, as if the allocator were dry.  Transient — the
            # engine's victim/stall machinery retries next step.
            return reserved - length
        while reserved < length + 1:
            if not pool.grow(slot):
                return reserved - length
            self.grown_pages += 1
            reserved += pool.page_size
        allocatable = pool.n_pages - 1
        target = min(length + want_tokens, cap_tokens)
        while (reserved < target
               and pool.allocator.n_free + pool.n_reclaimable - 1
               >= self.policy.watermark * allocatable
               and pool.grow(slot)):
            self.grown_pages += 1
            reserved += pool.page_size
        return reserved - length

    # -- reclamation ----------------------------------------------------------
    def pick_victim(self, residents: Mapping[int, "object"],
                    exclude: Sequence[int] = (),
                    ignore_cap: bool = False,
                    younger_than: Optional[tuple] = None) -> Optional[int]:
        """LIFO victim selection over resident decodes: the most recently
        admitted request loses its pages (it has sunk the least compute
        and its re-prefill is cheapest).  ``younger_than`` — the
        requester's own ``(t_admit, rid)`` admission key — restricts
        eligibility to strictly younger residents, so a slot never evicts
        itself (a stall preserves its K/V; self-eviction would discard
        it) and never inverts the LIFO order by evicting someone older.
        Requests already evicted ``max_preempts`` times are protected
        unless ``ignore_cap`` (the engine's oldest-request progress
        guarantee overrides the cap so the head of the line can always
        finish).

        Among eligible residents the governor minimises *shared-page
        cost* first: a page with refcount N serves N owners, so evicting
        its mapper forfeits recompute that other requests (or future
        prefix-cache hits) would otherwise skip.  LIFO admission order
        breaks ties, and on a sharing-free pool every cost is zero so the
        choice degrades to the original pure-LIFO rule.  Returns a slot
        id or None when nothing is eligible."""
        alloc = self.pool.allocator
        best, best_slot = None, None            # best = (cost, admit key)
        lifo_key, lifo_slot = None, None        # what pure LIFO would pick
        for slot, req in residents.items():
            if slot in exclude:
                continue
            key = (req.t_admit if req.t_admit is not None else 0.0, req.rid)
            if younger_than is not None and key <= younger_than:
                continue
            if not ignore_cap and req.n_preempts >= self.policy.max_preempts:
                continue
            cost = sum(1 for p in alloc.pages_of(slot) if alloc.refcount(p) > 1)
            if best is None or cost < best[0] or (cost == best[0]
                                                  and key > best[1]):
                best, best_slot = (cost, key), slot
            if lifo_key is None or key > lifo_key:
                lifo_key, lifo_slot = key, slot
        if best_slot is not None and best_slot != lifo_slot:
            self.shared_spared += 1
        return best_slot

    # -- taps -----------------------------------------------------------------
    def note_step(self, n_stalled: int) -> None:
        """Record one decode step's memory state (the free-page trajectory
        and stall counters the serve report reads).  The
        trace is capped *at append time*: only every ``_trace_stride``-th
        sample is kept, and when the buffer still fills the stride doubles
        and the buffer is decimated in place — O(_TRACE_CAP) host memory
        for a serve of any length.  ``free_pages_min`` is updated on every
        step, so the reported minimum stays exact, not a sample."""
        n_free = self.pool.allocator.n_free
        if self.free_pages_min is None or n_free < self.free_pages_min:
            self.free_pages_min = n_free
        if self._trace_skip == 0:
            self.free_page_trace.append(n_free)
            if len(self.free_page_trace) >= self._TRACE_CAP:
                self.free_page_trace = self.free_page_trace[::2]
                self._trace_stride *= 2
        self._trace_skip = (self._trace_skip + 1) % self._trace_stride
        if n_stalled:
            self.stall_steps += 1
            self.stall_slot_steps += n_stalled

    def summary(self) -> dict:
        """Machine-readable governor report (serve() returns it under
        ``"memory"``)."""
        alloc = self.pool.allocator
        # the decimated buffer holds up to ~2x 64 samples between stride
        # doublings: stride (never truncate) down to <= 64 so the
        # reported trajectory still spans the whole serve
        trace = self.free_page_trace
        s = max(-(-len(trace) // 64), 1)
        return {
            "reservation": self.policy.reservation,
            "watermark": self.policy.watermark,
            "max_preempts": self.policy.max_preempts,
            "preemptions": self.pool.n_preempts,
            "stall_steps": self.stall_steps,
            "stall_slot_steps": self.stall_slot_steps,
            "admit_blocked": self.admit_blocked,
            "grown_pages": self.grown_pages,
            "peak_resident": self.peak_resident,
            "shared_spared": self.shared_spared,
            "free_pages_min": (self.free_pages_min
                               if self.free_pages_min is not None
                               else alloc.n_free),
            "free_pages_final": alloc.n_free,
            "free_page_trace": list(trace[::s][:64]),
            "fragmentation": alloc.free_run_histogram(),
            "prefix": self.pool.prefix_stats(),
        }
