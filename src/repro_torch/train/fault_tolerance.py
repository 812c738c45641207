"""Heartbeat tracking (``repro.train.fault_tolerance.HeartbeatMonitor``).

On a real deployment the heartbeat feed comes from the cluster manager;
here the monitor is process-local, but the decision (a worker silent for
``timeout`` seconds is dead) is the production logic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


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
