"""Engine health monitoring and the graceful-degradation state machine.

LIKWID-style lightweight always-on monitoring applied to failure
signals: every paged decode step carries a compiled finite-logits guard
(one reduction over the logits it already produced), and the
``HealthMonitor`` folds those per-step fault flags plus wall-clock
watchdog overruns into a sliding window. The window drives a three-state
ladder:

    HEALTHY --(faults in window >= degrade_after)--> DEGRADED
    DEGRADED --(faults in window >= shed_after)----> SHEDDING
    any state --(recover_after consecutive clean steps)--> one rung down

While DEGRADED (or worse) the engine pins the *safe plan* — spec0 /
gather attention / tp1 — by fetching it through the regular step cache,
so healthy executables are never recompiled and the fallback is a
dictionary lookup after the first use. While SHEDDING the engine
additionally stops admitting fresh requests (preempted residents still
re-enter), bounding work to what is already resident.

The monitor's fault rate is exported as a ``Counters`` feature
(``fault_rate``, decile-bucketed like ``prefix_hit_rate``) so the
PlanDecider can learn degradation responses from the corpus the same way
it learns ``spec_depth``.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Optional


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    SHEDDING = "shedding"


# ladder order, for stepping up/down one rung at a time
_LADDER = (HealthState.HEALTHY, HealthState.DEGRADED, HealthState.SHEDDING)


@dataclasses.dataclass
class HealthPolicy:
    """Retry, watchdog and degradation thresholds (all in steps)."""

    max_retries: int = 3  # consecutive per-request failures before FAILED
    backoff_base: int = 1  # steps a slot sits out after its 1st failure
    backoff_cap: int = 8  # ceiling on the exponential backoff
    window: int = 32  # sliding window of step fault flags
    degrade_after: int = 2  # faulted steps in window -> DEGRADED
    shed_after: int = 6  # faulted steps in window -> SHEDDING
    recover_after: int = 16  # consecutive clean steps -> one rung down
    watchdog_s: float = 0.0  # per-step wall budget; 0 disables

    def backoff(self, fail_streak: int) -> int:
        """Steps to sit out after the ``fail_streak``-th consecutive failure."""
        return min(self.backoff_base << max(0, fail_streak - 1), self.backoff_cap)


class HealthMonitor:
    """Per-engine fault accounting + HEALTHY/DEGRADED/SHEDDING ladder."""

    def __init__(self, policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self.state = HealthState.HEALTHY
        self._window: deque = deque(maxlen=max(1, self.policy.window))
        self._clean_run = 0
        self.taps = {
            "steps": 0,
            "fault_steps": 0,  # steps with >= 1 faulted slot
            "slot_faults": 0,  # faulted (slot, step) pairs
            "latency_faults": 0,  # watchdog overruns
            "degraded_entries": 0,
            "shed_entries": 0,
            "fallbacks": 0,  # safe-plan activations (engine tap)
            "recoveries": 0,  # returns to HEALTHY
        }
        # optional Telemetry (serve/telemetry.py), threaded in by the
        # engine; ladder transitions emit warning-level events through it
        self.telemetry = None

    def reset(self) -> None:
        """Fresh trace: clear the window and ladder, keep the policy."""
        self.state = HealthState.HEALTHY
        self._window.clear()
        self._clean_run = 0
        for k in self.taps:
            self.taps[k] = 0

    # -- step accounting --------------------------------------------------

    def note_step(self, dt_s: float, n_slot_faults: int = 0) -> None:
        """Fold one decode step's outcome into the window and ladder."""
        p = self.policy
        faulted = n_slot_faults > 0
        if p.watchdog_s > 0 and dt_s > p.watchdog_s:
            self.taps["latency_faults"] += 1
            faulted = True
        self.taps["steps"] += 1
        self.taps["slot_faults"] += n_slot_faults
        if faulted:
            self.taps["fault_steps"] += 1
        self._window.append(1 if faulted else 0)
        self._clean_run = 0 if faulted else self._clean_run + 1

        prev = self.state
        w = sum(self._window)
        if self.state is HealthState.HEALTHY and w >= p.degrade_after:
            self.state = HealthState.DEGRADED
            self.taps["degraded_entries"] += 1
        if self.state is HealthState.DEGRADED and w >= p.shed_after:
            self.state = HealthState.SHEDDING
            self.taps["shed_entries"] += 1
        if self._clean_run >= p.recover_after and self.state is not HealthState.HEALTHY:
            # step down one rung; clear history so stale faults don't
            # immediately re-trigger the threshold we just left
            self.state = _LADDER[_LADDER.index(self.state) - 1]
            self._window.clear()
            self._clean_run = 0
            if self.state is HealthState.HEALTHY:
                self.taps["recoveries"] += 1
        if self.state is not prev and self.telemetry is not None:
            self.telemetry.event(
                "health_transition", level="warning",
                state=self.state.value, prev=prev.value,
                fault_rate=round(self.fault_rate(), 4))

    # -- signals -----------------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True while the safe plan should be pinned."""
        return self.state is not HealthState.HEALTHY

    @property
    def shedding(self) -> bool:
        """True while fresh admissions should stop."""
        return self.state is HealthState.SHEDDING

    def fault_rate(self) -> float:
        """Faulted-step fraction over the sliding window (0 when idle)."""
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    def summary(self) -> dict:
        return {
            "state": self.state.value,
            "fault_rate": round(self.fault_rate(), 4),
            **self.taps,
        }
