"""Training-side fault tolerance.  Only :class:`HeartbeatMonitor` is
ported so far: the sharded serving fan-out's shard health rides it.  The
step watchdog, the recovery driver and the training surface come later."""
from .fault_tolerance import HeartbeatMonitor

__all__ = ["HeartbeatMonitor"]
