"""Structured tracing: context-manager spans, an in-memory ring buffer
and a Chrome ``trace_event`` JSONL exporter (a copy of
``repro.obs.tracing``, DESIGN.md §19 of the reference).

A span records ``(name, span_id, parent_id, thread, wall start,
monotonic start, duration, ok, attrs)``.  Parents are tracked with a
``threading.local`` stack, so the sharded fan-out's worker threads make
correctly nested per-thread trees and a span opened on one thread never
becomes the parent of another thread's work.  Finished spans land in a
bounded ring (``collections.deque(maxlen=...)``): tracing holds
O(capacity) memory however long the process serves.

Spans are exception-safe: ``__exit__`` always pops the stack and records
the span (``ok=False`` and the exception type under ``error``), so a
fault cannot leak an open handle; ``active_depth()`` is the balance
check.

Export is Chrome ``trace_event`` JSONL: one complete (``"ph": "X"``)
event per line with microsecond ``ts``/``dur``, loadable by
``chrome://tracing`` and Perfetto.  Timestamps are wall-clock epoch
micros; durations come from the monotonic clock.

Stdlib only; the disabled path (one shared no-op span, nothing allocated
a call) lives in ``repro_torch.obs``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 4096


class Span:
    """One in-flight span; use as a context manager via
    :meth:`Tracer.span`.  ``set(key, value)`` attaches attributes (JSON-
    able scalars) visible in the ring buffer and the Chrome export."""

    __slots__ = ("tracer", "name", "span_id", "parent_id", "tid",
                 "t_wall", "t0", "dur", "ok", "attrs")

    def __init__(self, tracer: "Tracer", name: str,
                 span_id: int, parent_id: Optional[int], tid: int):
        self.tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.t_wall = 0.0
        self.t0 = 0.0
        self.dur = 0.0
        self.ok = True
        self.attrs: Optional[dict] = None

    def set(self, key: str, value) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        self.t_wall = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur = time.perf_counter() - self.t0
        if exc_type is not None:
            self.ok = False
            self.set("error", exc_type.__name__)
        self.tracer._pop(self)
        return False


class Tracer:
    """Bounded-memory span recorder with per-thread parent nesting."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.spans_started = 0
        self.spans_finished = 0
        self.spans_dropped = 0   # evicted from the ring by newer spans

    # -- span lifecycle -------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str) -> Span:
        st = self._stack()
        parent = st[-1].span_id if st else None
        return Span(self, name, next(self._ids), parent,
                    threading.get_ident())

    def _push(self, span: Span) -> None:
        self._stack().append(span)
        with self._lock:
            self.spans_started += 1

    def _pop(self, span: Span) -> None:
        st = self._stack()
        # exception safety: pop THIS span even if an inner span leaked
        while st and st[-1] is not span:
            st.pop()
        if st:
            st.pop()
        with self._lock:
            if len(self._ring) == self.capacity:
                self.spans_dropped += 1
            self._ring.append(span)
            self.spans_finished += 1

    def active_depth(self) -> int:
        """Open spans on the *calling* thread — 0 means balanced."""
        return len(self._stack())

    # -- introspection / export -----------------------------------------

    def events(self) -> list:
        """Finished spans currently in the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.spans_started = 0
            self.spans_finished = 0
            self.spans_dropped = 0

    def export_chrome(self, path: str) -> int:
        """Write the ring as Chrome ``trace_event`` JSONL (one complete
        event per line); returns the number of events written."""
        events = self.events()
        pid = os.getpid()
        with open(path, "w") as f:
            for s in events:
                args = {"span_id": s.span_id, "ok": s.ok}
                if s.parent_id is not None:
                    args["parent_id"] = s.parent_id
                if s.attrs:
                    args.update(s.attrs)
                f.write(json.dumps({
                    "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                    "ts": s.t_wall * 1e6, "dur": s.dur * 1e6,
                    "args": args}) + "\n")
        return len(events)


class _NoopSpan:
    """Shared do-nothing span for the disabled path: enter/exit return
    immediately, ``set`` discards — one stateless singleton serves every
    disabled call site with zero per-call allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key: str, value) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()
