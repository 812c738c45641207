"""Fault tolerance (``repro.train.fault_tolerance``): step-time watchdog
(straggler mitigation), heartbeat tracking, and the crash-recovery driver
with checkpoint auto-resume.

On a real deployment the heartbeat feed comes from the cluster manager;
here the monitors are process-local, but the decision logic (EWMA-based
straggler flags, missing-heartbeat eviction, restart from the latest
checkpoint with a bounded, backed-off budget) is the production logic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StepWatchdog:
    """EWMA step-time tracker; flags stragglers exceeding ratio * EWMA."""
    ratio: float = 3.0
    alpha: float = 0.1
    warmup_steps: int = 5
    ewma: Optional[float] = None
    observed: int = 0
    straggler_events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.observed += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.observed > self.warmup_steps
                        and dt > self.ratio * self.ewma)
        if is_straggler:
            self.straggler_events.append((step, dt, self.ewma))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclass
class HeartbeatMonitor:
    """Tracks worker liveness; workers missing ``timeout`` seconds of
    heartbeats are declared dead (triggering elastic restart upstream)."""
    timeout: float = 60.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, worker, now: Optional[float] = None) -> None:
        self.last_seen[worker] = now if now is not None else time.monotonic()

    def dead_workers(self, now: Optional[float] = None) -> list:
        now = now if now is not None else time.monotonic()
        return [w for w, t in self.last_seen.items() if now - t > self.timeout]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_workers(now)


def run_with_recovery(run_fn: Callable[[int], tuple], *, checkpointer,
                      max_restarts: int = 3,
                      on_restart: Optional[Callable] = None,
                      backoff_base: float = 1.0, backoff_max: float = 60.0,
                      sleep: Callable[[float], None] = time.sleep):
    """Crash-recovery driver.

    ``run_fn(start_step)`` runs (a segment of) training from
    ``start_step`` and returns its result; on an exception the driver
    resumes from the latest checkpoint, up to ``max_restarts``
    *consecutive unproductive* times.  The budget counts crashes since the
    last checkpoint advance: a crash loop that still makes checkpoint
    progress each time can run indefinitely, while a crash at a stuck step
    exhausts the budget and re-raises.  Consecutive restarts back off
    exponentially (``backoff_base * 2^(k-1)`` seconds, capped at
    ``backoff_max``); ``sleep`` is injectable for tests.
    """
    restarts = 0
    while True:
        start = checkpointer.latest_step() or 0
        try:
            return run_fn(start)
        except Exception as e:  # noqa: BLE001 - the restart boundary
            if (checkpointer.latest_step() or 0) > start:
                restarts = 0   # progress was made: reset the budget
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            sleep(min(backoff_base * 2.0 ** (restarts - 1), backoff_max))
