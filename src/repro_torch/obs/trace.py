"""Span tracer emitting Chrome-trace ("catapult") JSON.

Spans cover the host-side serving path (`apply` -> `apply_round` ->
deferral rounds), the pressure scheduler's compaction passes, bucket
migrations, replica resync/rebuild, and checkpoint/WAL operations.  Load
the saved file in `chrome://tracing` or Perfetto (`ui.perfetto.dev`).

API: `span(name, cat, **args)` is a context manager, `traced` the
decorator form, `instant(name)` a zero-duration marker.  When
observability is disabled every call returns the no-op singleton —
no event object, no timestamp read, no allocation.

Events use the Chrome trace "complete" phase (`ph: "X"`): one record per
span with microsecond `ts`/`dur` relative to tracer start.  The buffer
is bounded; once full, new events are counted in `dropped` instead of
growing without bound."""
from __future__ import annotations

import functools
import json
import os
import threading
import time

from . import _flags

DEFAULT_CAPACITY = 200_000


class _NoopSpan:
    """The disabled-path singleton: entering/exiting does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._add({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": (self._t0 - self._tracer._t0) / 1e3,
            "dur": (t1 - self._t0) / 1e3,
            "pid": self._tracer._pid, "tid": threading.get_ident(),
            "args": self.args,
        })
        return False


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: list = []
        self.dropped = 0
        self._t0 = time.perf_counter_ns()
        self._pid = os.getpid()

    def _add(self, ev: dict):
        with self._lock:
            if len(self._events) >= self.capacity:
                self.dropped += 1
                return
            self._events.append(ev)

    def span(self, name: str, cat: str = "f2", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "f2", **args):
        self._add({
            "name": name, "cat": cat, "ph": "i", "s": "p",
            "ts": (time.perf_counter_ns() - self._t0) / 1e3,
            "pid": self._pid, "tid": threading.get_ident(), "args": args,
        })

    def __len__(self):
        with self._lock:
            return len(self._events)

    def snapshot(self) -> dict:
        """The Chrome trace JSON object (`{"traceEvents": [...]}`)."""
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f)
        return path

    def clear(self):
        with self._lock:
            self._events = []
            self.dropped = 0
            self._t0 = time.perf_counter_ns()


TRACER = Tracer()


def span(name: str, cat: str = "f2", **args):
    """A traced region; the no-op singleton when obs is disabled."""
    if not _flags.ENABLED:
        return NOOP_SPAN
    return TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "f2", **args):
    if not _flags.ENABLED:
        return
    TRACER.instant(name, cat, **args)


def traced(name=None, cat: str = "f2"):
    """Decorator form: `@traced()` spans the wrapped call by its
    qualified name, `@traced("label")` by an explicit one."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _flags.ENABLED:
                return fn(*a, **kw)
            with TRACER.span(label, cat):
                return fn(*a, **kw)
        return wrapper
    return deco
