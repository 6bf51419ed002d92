"""Serve telemetry: request span tracing, step metrics ring, exporters.

The paper's loop is *measure hardware counters -> decide execution
parameters*; LIKWID (the measurement tool the paper builds on) works
because its overhead is low enough to leave enabled.  This module is the
serve engine's LIKWID layer: an always-on-capable observability
subsystem whose **disabled path costs one ``is not None`` attribute
check** (the same contract as :class:`repro_torch.serve.faults.FaultInjector`)
and whose enabled path is bounded host memory regardless of serve
length.

Four pieces:

* :class:`SpanTracer` — per-request typed spans (QUEUED, PREFILL,
  PREFILL_CHUNK, DECODE, PREEMPTED, RETRY_BACKOFF, COW, SWAP) recorded
  at the existing scheduler/engine/governor transition points and
  exportable as Chrome trace-event JSON (:meth:`SpanTracer
  .chrome_trace`), loadable directly in Perfetto / ``chrome://tracing``.
  Spans per request nest and cover admission -> terminal (the lifecycle
  property tests pin this).  The span store is capped; overflow is
  counted, never silently truncated.

* :class:`MetricsRing` — a fixed-capacity per-step metrics ring
  (latency, tokens, occupancy, free pages, faults, resolved plan class)
  with the same stride-doubling in-place decimation as the governor's
  ``free_page_trace``: when the buffer fills, every other sample is
  dropped and the stride doubles, so a serve of any length holds
  ``<= cap`` samples.  Exact aggregates (count / sum / min / max) are
  tracked on every append — decimation never loses the extremes.

* :class:`LatencySketch` — a log-bucketed quantile sketch (HDR-histogram
  style, sparse dict of geometric buckets).  ``quantile(p)`` returns the
  upper edge of the bucket holding the ``ceil(p*n)``-th sample, so the
  estimate ``v`` brackets a true order statistic:
  ``exact <= v <= exact * growth`` — a provable relative-error bound in
  O(log(range)/log(growth)) memory, no samples retained.

* Exporters — :func:`prometheus_text` flattens the engine's
  :meth:`~repro_torch.serve.engine.Engine.observability` aggregate (plus the
  sketches' quantiles) into the Prometheus text exposition format, and
  :meth:`Telemetry.event` feeds a bounded, levelled event buffer that
  can stream as JSONL (the structured replacement for the launcher's
  scattered ``[pool]``/``[spec]``/``[scan]``/``[failures]`` lines).

The latency signals also close the paper's loop: the engine's
measurement tap quantizes the windowed step-latency p99 and mean queue
delay (:func:`repro_torch.autotune.corpus.bucket_log_ms`) into the
``step_latency_p99`` / ``queue_delay`` ``Counters`` channels, so the
PlanDecider can learn from observed latency, not just tok/s.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Any, Optional

#: Typed span kinds (the request-lifecycle vocabulary).  SWAP is defined
#: ahead of tiered KV memory (ROADMAP item 5): the tracer, exporters and
#: tests already accept it, so the swap engine only has to emit it.
SPAN_KINDS = ("QUEUED", "PREFILL", "PREFILL_CHUNK", "DECODE",
              "PREEMPTED", "RETRY_BACKOFF", "COW", "SWAP")

#: JSONL event levels (Prometheus-ish severity ladder).
LEVELS = {"debug": 10, "info": 20, "warning": 30}


# ---------------------------------------------------------------------------
# Quantile sketch
# ---------------------------------------------------------------------------
class LatencySketch:
    """Log-bucketed quantile sketch over positive values.

    Bucket ``b`` holds values in ``[growth**b, growth**(b+1))``; counts
    live in a sparse dict, so memory is O(occupied buckets) — about 127
    buckets span 1e-7..1e3 seconds at the default growth — while min /
    max / sum stay exact.

    Guarantee (property-tested): for ``v = quantile(p)`` over ``n``
    samples with exact order statistic ``q`` at rank ``ceil(p*n)``,
    ``q <= v <= q * growth`` (up to float rounding on bucket edges).
    """

    def __init__(self, growth: float = 1.2, floor: float = 1e-7):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = growth
        self.floor = floor
        self._lg = math.log(growth)
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def add(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        b = int(math.floor(math.log(max(v, self.floor)) / self._lg))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def quantile(self, p: float) -> float:
        """Upper edge of the bucket holding the ``ceil(p*n)``-th sample
        (clamped to the exact max, which only tightens the bound)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(min(max(p, 0.0), 1.0) * self.count))
        cum = 0
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= rank:
                return min(self.growth ** (b + 1), self.max)
        return self.max                             # unreachable

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min or 0.0, "max": self.max or 0.0,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


# ---------------------------------------------------------------------------
# Step metrics ring
# ---------------------------------------------------------------------------
class MetricsRing:
    """Bounded per-step metrics buffer with stride-doubling decimation.

    Each record is ``(step, t_s, dt_s, tokens, n_active, free_pages,
    n_faults, plan_class)``.  Appends follow the governor's
    ``free_page_trace`` discipline: only every ``stride``-th record is
    kept, and when the buffer still reaches ``cap`` it is decimated in
    place (``[::2]``) and the stride doubles — O(cap) host memory for a
    serve of any length.  Aggregates (count, token total, latency
    min/max/sum) are updated on *every* append, so decimation never
    loses the extremes (property-tested).
    """

    FIELDS = ("step", "t_s", "dt_s", "tokens", "n_active", "free_pages",
              "n_faults", "plan_class")

    def __init__(self, cap: int = 256):
        if cap < 2:
            raise ValueError(f"ring cap must be >= 2, got {cap}")
        self.cap = cap
        self.records: list[tuple] = []
        self.stride = 1
        self._skip = 0
        # exact aggregates, independent of decimation
        self.count = 0
        self.tokens_total = 0
        self.faults_total = 0
        self.dt_sum = 0.0
        self.dt_min: Optional[float] = None
        self.dt_max: Optional[float] = None

    def append(self, step: int, t_s: float, dt_s: float, tokens: int,
               n_active: int, free_pages: int, n_faults: int,
               plan_class: str = "") -> None:
        self.count += 1
        self.tokens_total += tokens
        self.faults_total += n_faults
        self.dt_sum += dt_s
        if self.dt_min is None or dt_s < self.dt_min:
            self.dt_min = dt_s
        if self.dt_max is None or dt_s > self.dt_max:
            self.dt_max = dt_s
        if self._skip == 0:
            self.records.append((step, t_s, dt_s, tokens, n_active,
                                 free_pages, n_faults, plan_class))
            if len(self.records) >= self.cap:
                self.records = self.records[::2]
                self.stride *= 2
        self._skip = (self._skip + 1) % self.stride

    def __len__(self) -> int:
        return len(self.records)

    def summary(self) -> dict:
        return {"steps": self.count, "kept": len(self.records),
                "stride": self.stride, "tokens": self.tokens_total,
                "faults": self.faults_total,
                "dt_sum_s": self.dt_sum,
                "dt_min_s": self.dt_min or 0.0,
                "dt_max_s": self.dt_max or 0.0}


# ---------------------------------------------------------------------------
# Request span tracing
# ---------------------------------------------------------------------------
class SpanTracer:
    """Per-request typed spans with Chrome trace-event JSON export.

    Completed spans are ``(rid, kind, t0, t1, args)`` tuples; open spans
    live on a per-request stack so closes nest properly (closing a kind
    auto-closes any children still open above it, and terminal
    transitions close everything).  The store is capped at ``cap``
    completed spans — overflow increments ``dropped`` instead of growing
    without bound.
    """

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.spans: list[tuple] = []
        self.dropped = 0
        self._open: dict[Any, list] = {}    # rid -> [(kind, t0, args), ...]

    def _emit(self, rid, kind, t0, t1, args) -> None:
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return
        self.spans.append((rid, kind, t0, t1, args))

    def begin(self, rid, kind: str, t_s: float, **args) -> None:
        self._open.setdefault(rid, []).append((kind, t_s, args))

    def end(self, rid, kind: str, t_s: float) -> bool:
        """Close the innermost open ``kind`` span for ``rid``, closing
        any still-open children above it first (at the same instant, so
        nesting is preserved).  Returns False if no such span is open."""
        stack = self._open.get(rid)
        if not stack or not any(k == kind for k, _, _ in stack):
            return False
        while stack:
            k, t0, args = stack.pop()
            self._emit(rid, k, t0, t_s, args)
            if k == kind:
                break
        if not stack:
            self._open.pop(rid, None)
        return True

    def end_all(self, rid, t_s: float) -> None:
        """Terminal transition: close every open span for ``rid``."""
        for k, t0, args in reversed(self._open.pop(rid, [])):
            self._emit(rid, k, t0, t_s, args)

    def add(self, rid, kind: str, t0: float, t1: float, **args) -> None:
        """Record an already-complete span (e.g. QUEUED, PREFILL_CHUNK)."""
        self._emit(rid, kind, t0, t1, args)

    def instant(self, rid, kind: str, t_s: float, **args) -> None:
        """Zero-duration marker (terminal states, COW copies)."""
        self._emit(rid, kind, t_s, t_s, args)

    def has_open(self, rid, kind: str) -> bool:
        return any(k == kind for k, _, _ in self._open.get(rid, ()))

    def spans_for(self, rid) -> list:
        return [s for s in self.spans if s[0] == rid]

    def chrome_trace(self, pid: int = 1) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): one thread per
        request id, complete ``"X"`` events for spans, instant ``"i"``
        events for zero-duration markers, thread-name metadata so the
        Perfetto timeline labels rows ``req <rid>``."""
        events = []
        tids = sorted({s[0] for s in self.spans}, key=str)
        for tid in tids:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"req {tid}"}})
        for rid, kind, t0, t1, args in self.spans:
            ev = {"name": kind, "cat": "request", "pid": pid, "tid": rid,
                  "ts": round(t0 * 1e6, 3)}
            if t1 > t0:
                ev["ph"] = "X"
                ev["dur"] = round((t1 - t0) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"               # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}


# ---------------------------------------------------------------------------
# The aggregate subsystem (what the engine holds as ``self.telemetry``)
# ---------------------------------------------------------------------------
class Telemetry:
    """Tracer + ring + sketches + levelled event log for one engine.

    Per-trace state (spans, ring, sketches, counters) is reset by
    :meth:`start_trace` at every ``serve()`` entry, so exports reflect
    the most recent trace — matching ``decisions_log``/health semantics.
    """

    def __init__(self, level: str = "info", log_out: str = "",
                 span_cap: int = 65536, ring_cap: int = 256,
                 event_cap: int = 4096):
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r} "
                             f"(expected one of {sorted(LEVELS)})")
        self.level = level
        self.tracer = SpanTracer(cap=span_cap)
        self.ring = MetricsRing(cap=ring_cap)
        self.step_latency = LatencySketch()
        self.queue_delay = LatencySketch()
        self.ttft = LatencySketch()
        self.counts: dict[str, int] = {}
        self.events: deque = deque(maxlen=event_cap)
        self.events_total = 0
        self._span_cap, self._ring_cap = span_cap, ring_cap
        self._t0 = time.perf_counter()
        self._log_f = open(log_out, "w") if log_out else None

    # -- lifecycle ---------------------------------------------------------
    def start_trace(self) -> None:
        """Fresh per-serve state (the event log stream stays open)."""
        self.tracer = SpanTracer(cap=self._span_cap)
        self.ring = MetricsRing(cap=self._ring_cap)
        self.step_latency = LatencySketch()
        self.queue_delay = LatencySketch()
        self.ttft = LatencySketch()
        self.counts = {}
        self._t0 = time.perf_counter()

    def close(self) -> None:
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None

    # -- recording ---------------------------------------------------------
    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def on_step(self, step: int, t_s: float, dt_s: float, tokens: int,
                n_active: int, free_pages: int, n_faults: int,
                plan_class: str = "") -> None:
        """One decode step: feed the ring + latency sketch, and (at debug
        level) a structured per-step event."""
        self.ring.append(step, t_s, dt_s, tokens, n_active, free_pages,
                         n_faults, plan_class)
        self.step_latency.add(dt_s)
        if LEVELS[self.level] <= LEVELS["debug"]:
            self.event("step", level="debug", step=step, dt_s=round(dt_s, 6),
                       tokens=tokens, n_active=n_active,
                       free_pages=free_pages, faults=n_faults,
                       plan_class=plan_class)

    def on_admit(self, rid, queue_delay_s: float, preempted: bool) -> None:
        if not preempted:
            self.queue_delay.add(queue_delay_s)
        self.count("readmissions" if preempted else "admissions")

    def event(self, kind: str, level: str = "info", **fields) -> None:
        """Levelled structured event: buffered (bounded) always, streamed
        as one JSONL line when a log file is open and the event clears
        the configured level."""
        if LEVELS.get(level, 20) < LEVELS[self.level]:
            return
        ev = {"t_s": round(time.perf_counter() - self._t0, 6),
              "kind": kind, "level": level, **fields}
        self.events.append(ev)
        self.events_total += 1
        if self._log_f is not None:
            self._log_f.write(json.dumps(ev, sort_keys=True) + "\n")
            self._log_f.flush()

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        return self.tracer.chrome_trace()

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def summary(self) -> dict:
        return {
            "enabled": True,
            "level": self.level,
            "spans": len(self.tracer.spans),
            "spans_dropped": self.tracer.dropped,
            "events": self.events_total,
            "counts": dict(sorted(self.counts.items())),
            "ring": self.ring.summary(),
            "step_latency_s": self.step_latency.summary(),
            "queue_delay_s": self.queue_delay.summary(),
            "ttft_s": self.ttft.summary(),
        }


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _metric_name(*parts: str) -> str:
    out = "_".join(p for p in parts if p)
    return "".join(ch if (ch.isalnum() or ch == "_") else "_"
                   for ch in out.lower())


def _flatten(prefix: str, obj: Any, out: list) -> None:
    """Walk an observability dict, emitting every numeric leaf as a
    gauge (bools as 0/1).  Non-numeric leaves (states, class names,
    traces) are skipped — they belong to the JSON/event exporters."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(_metric_name(prefix, str(k)), v, out)
    elif isinstance(obj, bool):
        out.append((prefix, int(obj)))
    elif isinstance(obj, (int, float)) and math.isfinite(obj):
        out.append((prefix, obj))


def prometheus_text(obs: dict, telemetry: Optional[Telemetry] = None,
                    prefix: str = "repro_serve") -> str:
    """Render an :meth:`Engine.observability` aggregate (and, when
    present, the telemetry sketches' quantiles) as Prometheus text
    exposition format — one flat snapshot, parseable by any scraper."""
    lines = [f"# HELP {prefix}_info serve observability snapshot",
             f"# TYPE {prefix}_info gauge",
             f'{prefix}_info{{version="1"}} 1']
    flat: list = []
    for section, sub in obs.items():
        if section in ("requests", "decisions", "telemetry"):
            continue
        _flatten(_metric_name(prefix, section), sub, flat)
    for name, value in flat:
        lines.append(f"# TYPE {name} gauge")
        v = f"{value:.9g}" if isinstance(value, float) else str(value)
        lines.append(f"{name} {v}")
    if telemetry is not None:
        for metric, sk in (("step_latency_seconds", telemetry.step_latency),
                           ("queue_delay_seconds", telemetry.queue_delay),
                           ("ttft_seconds", telemetry.ttft)):
            name = f"{prefix}_{metric}"
            lines.append(f"# TYPE {name} summary")
            for q in (0.5, 0.9, 0.99):
                lines.append(f'{name}{{quantile="{q}"}} '
                             f"{sk.quantile(q):.9g}")
            lines.append(f"{name}_sum {sk.total:.9g}")
            lines.append(f"{name}_count {sk.count}")
        for key, n in sorted(telemetry.counts.items()):
            name = _metric_name(prefix, key, "total")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {n}")
    return "\n".join(lines) + "\n"
