"""Deterministic fault injection for the serve stack.

The paper's loop is measure -> decide; closing it over *failure* signals
requires failures that can be produced on demand, reproducibly. A
``FaultInjector`` owns one seeded RNG stream per named injection site, so
a given ``(seed, rate)`` fires the exact same fault sequence on every
run regardless of which other sites are enabled — chaos benches and
property tests stay bit-reproducible.

Sites are threaded through the hot paths as an optional attribute
(``engine.faults``, ``pool.faults``, ``governor.faults``) that defaults
to ``None``; the disabled path is a single ``is not None`` check, so
production serving pays nothing.

Registry (see docs/failure-semantics.md for the recovery policy per site):

==================  ====================================================
site                effect when fired
==================  ====================================================
``alloc.exhaust``   ``PagedKVPool.admit_shared`` / ``grow`` report an
                    empty free list (admission stalls, growth fails)
``logits.nan``      one decoded slot's logits are flagged non-finite
                    for this step (commit suppressed, step retried)
``prefill.nan``     one prefill chunk is flagged corrupt (chunk is
                    re-run; no lengths advance)
``step.latency``    an artificial wall-clock spike after a decode step
                    (exercises the watchdog's latency accounting)
``mem.grow``        ``MemoryGovernor.ensure_headroom`` denies growth
                    once, as if the allocator were dry
``corpus.corrupt``  ``Corpus.save_jsonl`` writes one garbage line
                    (exercises load-side quarantine)
==================  ====================================================
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

FAULT_SITES = {
    "alloc.exhaust": "paged-pool admission/growth sees an empty free list",
    "logits.nan": "a decode/verify slot's logits flagged non-finite",
    "prefill.nan": "a prefill chunk flagged corrupt, forcing a re-run",
    "step.latency": "artificial wall-clock spike after a decode step",
    "mem.grow": "governor headroom growth denied once",
    "corpus.corrupt": "a corpus JSONL line corrupted on save",
}


class FaultInjector:
    """Seeded, per-site Bernoulli fault source.

    Each site draws from its own ``random.Random(f"{seed}:{site}")``
    stream: enabling or disabling one site never perturbs another
    site's sequence, and the n-th draw at a site is a pure function of
    ``(seed, site, n)``.
    """

    def __init__(
        self,
        seed: int = 0,
        rate: float = 0.0,
        sites: Optional[Iterable[str]] = None,
        latency_s: float = 0.01,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        wanted = frozenset(sites) if sites is not None else frozenset(FAULT_SITES)
        unknown = wanted - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault sites: {sorted(unknown)}")
        self.seed = seed
        self.rate = rate
        self.sites = wanted
        self.latency_s = latency_s
        self._rngs = {s: random.Random(f"{seed}:{s}") for s in wanted}
        self.draws = {s: 0 for s in wanted}
        self.fired = {s: 0 for s in wanted}
        # optional Telemetry (serve/telemetry.py), threaded in by the
        # engine; injections emit debug-level events.  Telemetry never
        # touches the per-site RNG streams, so traces with and without
        # it observe the identical fault sequence.
        self.telemetry = None

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0 and bool(self.sites)

    def fire(self, site: str) -> bool:
        """Draw once at ``site``; True means inject the fault now."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site: {site!r}")
        if site not in self.sites or self.rate <= 0.0:
            return False
        self.draws[site] += 1
        hit = self._rngs[site].random() < self.rate
        if hit:
            self.fired[site] += 1
            if self.telemetry is not None:
                self.telemetry.event("fault_injected", level="debug",
                                     site=site, n=self.fired[site])
        return hit

    @property
    def injected_total(self) -> int:
        return sum(self.fired.values())

    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "seed": self.seed,
            "rate": self.rate,
            "injected_total": self.injected_total,
            "injected": {s: n for s, n in sorted(self.fired.items()) if n},
            "draws": sum(self.draws.values()),
        }

    def corrupt_line(self, line: str) -> str:
        """Deterministically mangle one JSONL line (``corpus.corrupt``)."""
        rng = self._rngs.get("corpus.corrupt")
        if rng is None:  # site disabled: pass through untouched
            return line
        mode = rng.randrange(3)
        if mode == 0:  # truncate mid-object -> json.JSONDecodeError
            return line[: max(1, len(line) // 2)]
        if mode == 1:  # valid JSON, wrong shape -> KeyError/TypeError
            return '{"not": "a corpus entry"}'
        return "\x00garbage\x00" + line[:8]
