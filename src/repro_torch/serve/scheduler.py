"""Request scheduler for the continuous-batching engine.

Requests move WAITING -> PREFILL -> DECODE -> DONE.  Admission is strict
FIFO over the arrival-ordered queue: a request becomes admissible once its
``arrival_s`` has passed (trace-driven serving replays an arrival process),
and is admitted as soon as a cache slot (and, on the paged pool, its page
reservation) is available — including mid-flight, while other slots are
still decoding.  On the paged path PREFILL is a *resident* state: the
request already holds its slot and pages while its prompt is prefilled in
chunks interleaved with pool decode steps (``prefill_pos`` tracks
progress); ``bind_prefill``/``start_decode`` split the old one-shot
``bind`` into those two transitions.  Completion is by per-request token
budget (``max_new_tokens``) or an EOS token id.

Under lazy page allocation a decoding request can additionally be
**PREEMPTED** (:meth:`Scheduler.preempt`): the memory governor evicted it
to reclaim its pages for an older request.  Preempted requests hold no
slot; they re-enter through the normal admission path as
recompute-prefill over prompt + generated-so-far, so their greedy token
stream is bit-identical to an uninterrupted run.  Re-queue ordering is
the no-starvation rule: *all* preempted requests are admissible ahead of
fresh arrivals (FIFO among themselves — oldest preemption first), so a
victim re-enters before the traffic that evicted it can queue-jump, and
victim selection (LIFO by admission time, capped per request by
``max_preempts``) can never pick the same request unboundedly while
younger work proceeds.

The scheduler owns lifecycle bookkeeping only; cache memory itself is
owned by :class:`repro_torch.serve.cache.PagedKVPool` /
:class:`repro_torch.serve.cache.SlotKVPool` (the engine mediates).
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from collections import deque
from typing import Optional, Sequence

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"     # evicted mid-decode; awaiting re-admission
    DONE = "done"
    FAILED = "failed"           # unrecoverable fault; all pages released
    EXPIRED = "expired"         # deadline_s elapsed while still WAITING
    REJECTED = "rejected"       # bounded-queue shed or invalid at submit


#: States a request can never leave.  Every request in a finished trace
#: is in exactly one of these (the chaos property tests assert it).
TERMINAL_STATES = frozenset({
    RequestState.DONE, RequestState.FAILED,
    RequestState.EXPIRED, RequestState.REJECTED,
})


@dataclasses.dataclass
class Request:
    """One generation request in a serve trace."""
    rid: int
    prompt: np.ndarray                  # (L,) int32 token ids, L >= 1
    max_new_tokens: int
    arrival_s: float = 0.0
    eos_id: Optional[int] = None        # falls back to ServeConfig.eos_id
    deadline_s: float = 0.0             # time-to-admission budget from
                                        # arrival; 0 falls back to
                                        # ServeConfig.deadline_s (0 = none).
                                        # Applies only while WAITING —
                                        # residents and preempted requests
                                        # are never expired (their pages/
                                        # progress are already paid for).
    # -- runtime state (filled in by the scheduler/engine) -------------------
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    prefill_pos: int = 0                # prompt tokens already prefilled
    out_tokens: list = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None     # seconds since serve() start
    t_first: Optional[float] = None     # first generated token
    t_done: Optional[float] = None
    n_preempts: int = 0                 # times evicted by the governor
    t_preempt: Optional[float] = None   # pending eviction timestamp
    requeue_wait_s: float = 0.0         # total preempted->readmitted wait
    prefix_hit_tokens: int = 0          # history tokens adopted from the
                                        # prefix cache instead of prefilled
                                        # (summed over re-admissions)
    error: str = ""                     # why FAILED/EXPIRED/REJECTED
    retries: int = 0                    # total faulted steps survived
    fail_streak: int = 0                # consecutive step failures (reset
                                        # on any committed token)
    backoff: int = 0                    # decode steps left to sit out
    _prompt_key: Optional[str] = dataclasses.field(default=None, repr=False)

    def prompt_key(self) -> str:
        """Stable digest of the prompt tokens, for duplicate-arrival dedup
        (admission holds a WAITING twin until the in-flight copy publishes
        its prefix).  Cached: prompts are immutable after __post_init__."""
        if self._prompt_key is None:
            self._prompt_key = hashlib.sha1(
                np.ascontiguousarray(self.prompt).tobytes()).hexdigest()
        return self._prompt_key

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    def token_history(self) -> np.ndarray:
        """Every token the request has committed so far (prompt followed by
        generated output) — the draft corpus for self-speculative n-gram
        lookup.  The last entry is the engine's pending token: committed,
        but its K/V row not yet written."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])


class Scheduler:
    """FIFO admission queue + active-set tracking."""

    def __init__(self):
        self._queue: deque[Request] = deque()
        self.preempted: deque[Request] = deque()  # evicted; readmit first
        self.prefilling: dict[int, Request] = {}  # slot -> mid-prefill request
        self.active: dict[int, Request] = {}      # slot -> decoding request
        self.finished: list[Request] = []
        self.failed: list[Request] = []           # terminal FAILED
        self.shed: list[Request] = []             # terminal EXPIRED/REJECTED
        # optional telemetry SpanTracer (serve/telemetry.py), threaded in
        # by the engine per serve; None = zero-overhead production path.
        # Lifecycle transitions below emit the request-timeline spans
        # (QUEUED/PREFILL/DECODE/PREEMPTED + terminal markers) — the
        # engine adds the intra-phase ones (PREFILL_CHUNK, RETRY_BACKOFF,
        # COW).
        self.tracer = None

    def submit(self, req: Request) -> None:
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.rid} already {req.state}")
        self._queue.append(req)

    def sort_queue(self) -> None:
        """Order the queue by arrival time (stable, so rid breaks ties)."""
        self._queue = deque(sorted(self._queue, key=lambda r: r.arrival_s))

    # -- admission -----------------------------------------------------------
    def has_ready(self, now_s: float) -> bool:
        return bool(self.preempted) or (
            bool(self._queue) and self._queue[0].arrival_s <= now_s)

    def peek_ready(self, now_s: float) -> Optional[Request]:
        """The next admissible request, left on the queue (admission
        control checks its memory reservation before popping).  Preempted
        requests come first — they already arrived and paid for their
        eviction — FIFO among themselves, then the arrival queue."""
        if self.preempted:
            return self.preempted[0]
        return self._queue[0] if self.has_ready(now_s) else None

    def pop_ready(self, now_s: float) -> Optional[Request]:
        if self.preempted:
            req = self.preempted.popleft()
            req.state = RequestState.PREFILL
            if req.t_preempt is not None:
                req.requeue_wait_s += max(now_s - req.t_preempt, 0.0)
                req.t_preempt = None
            return req
        if not self.has_ready(now_s):
            return None
        req = self._queue.popleft()
        req.state = RequestState.PREFILL
        return req

    def bind_prefill(self, req: Request, slot: int, now_s: float) -> None:
        """Make a popped request resident on ``slot`` while it prefills."""
        if slot in self.active or slot in self.prefilling:
            raise ValueError(f"slot {slot} already bound")
        if req.state is not RequestState.PREFILL:
            raise ValueError(f"request {req.rid} not in PREFILL")
        req.slot = slot
        req.t_admit = now_s
        self.prefilling[slot] = req
        if self.tracer is not None:
            # a PREEMPTED re-entry closes its eviction span; a fresh
            # admission records its whole wait as one complete QUEUED
            # span — either way the timeline stays gap-free up to now_s
            if not self.tracer.end(req.rid, "PREEMPTED", now_s):
                self.tracer.add(req.rid, "QUEUED", req.arrival_s, now_s)
            self.tracer.begin(req.rid, "PREFILL", now_s, slot=slot)

    def start_decode(self, req: Request, now_s: float = 0.0) -> None:
        """Prompt fully prefilled: the request joins the decode batch."""
        if self.prefilling.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} not prefilling on "
                             f"slot {req.slot}")
        del self.prefilling[req.slot]
        req.state = RequestState.DECODE
        self.active[req.slot] = req
        if self.tracer is not None:
            self.tracer.end(req.rid, "PREFILL", now_s)
            self.tracer.begin(req.rid, "DECODE", now_s, slot=req.slot)

    def bind(self, req: Request, slot: int, now_s: float) -> None:
        """One-shot admission (slot path: the whole prompt prefills at
        once): bind_prefill + start_decode."""
        self.bind_prefill(req, slot, now_s)
        self.start_decode(req, now_s)

    # -- preemption ----------------------------------------------------------
    def preempt(self, req: Request, now_s: float) -> None:
        """Evict an active decode: the request loses its slot (the caller
        frees its pages) and re-queues ahead of fresh arrivals.  Its
        committed ``out_tokens`` survive — re-admission recomputes their
        K/V as prefill, so the continued token stream is bit-identical."""
        if self.active.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} not active on slot {req.slot}")
        del self.active[req.slot]
        req.slot = None
        req.state = RequestState.PREEMPTED
        req.n_preempts += 1
        req.t_preempt = now_s
        self.preempted.append(req)
        if self.tracer is not None:
            self.tracer.end_all(req.rid, now_s)     # DECODE (+ children)
            self.tracer.begin(req.rid, "PREEMPTED", now_s,
                              n_preempts=req.n_preempts)

    # -- failure domains -----------------------------------------------------
    def fail(self, req: Request, now_s: float, reason: str = "") -> None:
        """A resident request hit an unrecoverable fault: drop it from its
        slot (the caller releases its pages *before* calling this) and move
        it to the terminal FAILED state.  Other residents are untouched —
        the failure domain is one request."""
        if self.active.get(req.slot) is req:
            del self.active[req.slot]
        elif self.prefilling.get(req.slot) is req:
            del self.prefilling[req.slot]
        else:
            raise ValueError(f"request {req.rid} not resident on slot "
                             f"{req.slot}")
        req.slot = None
        req.state = RequestState.FAILED
        req.error = reason
        req.t_done = now_s
        self.failed.append(req)
        if self.tracer is not None:
            self.tracer.end_all(req.rid, now_s)
            self.tracer.instant(req.rid, "FAILED", now_s, reason=reason)

    def shed_waiting(self, now_s: float, max_queue: int = 0,
                     default_deadline_s: float = 0.0) -> tuple[list, list]:
        """Load shedding over the WAITING queue: expire requests whose
        admission deadline has passed, then bound the arrived-but-waiting
        backlog to ``max_queue`` (0 = unbounded), rejecting the newest
        arrivals beyond it.  Explicit EXPIRED/REJECTED outcomes instead of
        unbounded queueing; residents and preempted requests are exempt.
        Returns the (expired, rejected) requests shed this call."""
        expired: list[Request] = []
        rejected: list[Request] = []
        keep: deque[Request] = deque()
        n_arrived = 0
        for req in self._queue:
            deadline = req.deadline_s or default_deadline_s
            if deadline > 0 and now_s > req.arrival_s + deadline:
                req.state = RequestState.EXPIRED
                req.error = f"deadline {deadline:.3f}s exceeded while waiting"
                req.t_done = now_s
                expired.append(req)
                continue
            if req.arrival_s <= now_s:
                n_arrived += 1
                if max_queue > 0 and n_arrived > max_queue:
                    req.state = RequestState.REJECTED
                    req.error = f"admission queue full (max_queue={max_queue})"
                    req.t_done = now_s
                    rejected.append(req)
                    continue
            keep.append(req)
        if expired or rejected:
            self._queue = keep
            self.shed.extend(expired)
            self.shed.extend(rejected)
            if self.tracer is not None:
                for req in expired + rejected:
                    self.tracer.add(req.rid, "QUEUED", req.arrival_s, now_s)
                    self.tracer.instant(req.rid, req.state.value.upper(),
                                        now_s, reason=req.error)
        return expired, rejected

    def reject(self, req: Request, reason: str) -> None:
        """Refuse a request before it ever queues (infeasible shape, bad
        budget).  Terminal REJECTED; the trace keeps serving."""
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.rid} already {req.state}")
        req.state = RequestState.REJECTED
        req.error = reason
        req.t_done = 0.0
        self.shed.append(req)
        if self.tracer is not None:
            self.tracer.instant(req.rid, "REJECTED", 0.0, reason=reason)

    # -- completion ----------------------------------------------------------
    def complete(self, req: Request, now_s: float) -> None:
        if self.active.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} not active on slot {req.slot}")
        del self.active[req.slot]
        req.slot = None
        req.state = RequestState.DONE
        req.t_done = now_s
        self.finished.append(req)
        if self.tracer is not None:
            self.tracer.end_all(req.rid, now_s)     # DECODE (+ children)
            self.tracer.instant(req.rid, "DONE", now_s,
                                tokens=len(req.out_tokens))

    def done(self) -> bool:
        return (not self._queue and not self.preempted and not self.active
                and not self.prefilling)

    def next_arrival(self) -> Optional[float]:
        if self.preempted:
            return 0.0                  # already arrived: admissible now
        return self._queue[0].arrival_s if self._queue else None


def summarize(requests: Sequence[Request]) -> dict:
    """Aggregate throughput/latency stats over a finished trace."""
    done = [r for r in requests if r.state is RequestState.DONE]
    failures = {
        "failed": sum(1 for r in requests if r.state is RequestState.FAILED),
        "expired": sum(1 for r in requests if r.state is RequestState.EXPIRED),
        "rejected": sum(
            1 for r in requests if r.state is RequestState.REJECTED),
        "retries": int(sum(r.retries for r in requests)),
    }
    if not done:
        return {"n_done": 0, "tokens": 0, "tok_per_s": 0.0, **failures}
    tokens = sum(len(r.out_tokens) for r in done)
    t_end = max(r.t_done for r in done)
    t_start = min(r.arrival_s for r in done)
    lat = np.array([r.t_done - r.arrival_s for r in done])
    ttft = np.array([r.t_first - r.arrival_s for r in done
                     if r.t_first is not None])
    span = max(t_end - t_start, 1e-9)
    preempted = [r for r in requests if r.n_preempts]
    waits = np.array([r.requeue_wait_s for r in preempted])
    return {
        "n_done": len(done),
        "tokens": tokens,
        "wall_s": span,
        "tok_per_s": tokens / span,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft.size else 0.0,
        # preemption accounting (zeros on preemption-free traces)
        "preempts": int(sum(r.n_preempts for r in requests)),
        "preempted_requests": len(preempted),
        "preempts_by_rid": {r.rid: r.n_preempts for r in preempted},
        "requeue_wait_p50_s": (float(np.percentile(waits, 50))
                               if waits.size else 0.0),
        "requeue_wait_max_s": float(waits.max()) if waits.size else 0.0,
        # prefix-cache accounting (zeros with sharing off)
        "prefix_hit_requests": sum(1 for r in requests if r.prefix_hit_tokens),
        "prefix_hit_tokens": int(sum(r.prefix_hit_tokens for r in requests)),
        # failure-domain accounting (zeros on fault-free traces)
        **failures,
    }
