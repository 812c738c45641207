"""The guard of a sharded fan-out (``repro.serve.resilience``, DESIGN.md
§16 of the reference): the errors a guarded shard call raises, the retry
policy (exponential backoff under a per-call deadline, a
``TimeoutError`` terminal at once) and shard health (explicit down-marks
plus missed heartbeats, riding
:class:`repro_torch.train.fault_tolerance.HeartbeatMonitor`).

The sharded discovery engine
(:class:`repro_torch.serve.discovery.ShardedDiscoveryEngine`) guards its
shard-pair tasks with these.  Snapshots, the ingest journal and the
resilient indexes of the reference module are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.train.fault_tolerance import HeartbeatMonitor


class ResilienceError(RuntimeError):
    """Base class for serving-resilience failures."""


class ShardDownError(ResilienceError):
    """A shard call failed terminally (retries/deadline exhausted)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Retry with exponential backoff and a per-call deadline.

    ``attempts`` total tries; backoff sleeps ``base_delay * 2^k`` capped at
    ``max_delay``; once ``deadline`` seconds have elapsed for this call no
    further retries are attempted.  A ``TimeoutError`` from the shard call
    is terminal immediately: a hanging shard should be marked unhealthy,
    not retried into.
    """
    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: Optional[float] = 5.0


@dataclass
class ShardHealth:
    """Shard liveness = explicit down-marks + missed heartbeats.

    Shards that stop beating for ``timeout`` seconds are treated as down
    even if no call has failed yet; a successful call or a fresh heartbeat
    revives a down-marked shard.  Pass ``monitor`` to share one with the
    cluster manager: its ``timeout`` then wins, and beats it already
    recorded are preserved (only shards it has never seen are registered
    live at construction time).
    """
    num_shards: int
    timeout: float = 60.0
    clock: Callable[[], float] = time.monotonic
    monitor: Optional[HeartbeatMonitor] = None
    down_reasons: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.monitor is None:
            self.monitor = HeartbeatMonitor(timeout=self.timeout)
        else:
            self.timeout = self.monitor.timeout
        now = self.clock()
        for p in range(self.num_shards):
            if p not in self.monitor.last_seen:
                self.monitor.beat(p, now=now)

    def beat(self, shard: int) -> None:
        """A heartbeat (or successful call) proves liveness and revives."""
        self.down_reasons.pop(shard, None)
        self.monitor.beat(shard, now=self.clock())

    def mark_down(self, shard: int, reason: str = "marked down") -> None:
        self.down_reasons[shard] = reason

    def down_shards(self) -> dict:
        """shard -> reason for every shard currently considered down."""
        out = dict(self.down_reasons)
        for shard in self.monitor.dead_workers(self.clock()):
            out.setdefault(shard, f"no heartbeat for > {self.timeout}s")
        return out

    def is_up(self, shard: int) -> bool:
        return shard not in self.down_shards()
