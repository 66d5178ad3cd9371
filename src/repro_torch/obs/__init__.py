"""Unified observability for the F2 store: metrics, traces, journal (the
JAX package's `obs/`, the port's own copy: the port imports nothing of
that package).

Three pillars, one kill-switch:

* `metrics`   — process-wide registry of Counters / Gauges / fixed-bucket
                Histograms; every facade's `stats()` tree is re-backed by
                it (`fold_stats`) while staying bit-compatible.
* `trace`     — span tracer emitting Chrome-trace/Perfetto JSON over the
                serving path, scheduler, migrations, resync and
                checkpoint/WAL operations.
* `journal`   — bounded structured lifecycle event log fault-injection
                tests assert sequences against.

`configure(enabled=True)` arms all three; disabled (the default), every
instrumentation site is a single flag check returning a shared no-op —
store behavior, state and `stats()` output are bit-exact with the
pre-observability code.  Device-side signals are folded host-side at
the stores' existing lazy folding points (`_fold_traffic`, `_fold_read`,
`_fold_fill`, the bounds reads), never inside a kernel: enabled, a routed
or session round adds no stream sync of its own (the `TicketClock`'s fold
reads its queued tickets in one copy)."""
from __future__ import annotations

from . import _flags, export, journal, latency, metrics, rules, trace
from .latency import observe_phase, observe_phase_many
from .metrics import (COUNT_BUCKETS, LATENCY_BUCKETS, MetricError,
                      fold_stats, get_registry)
from .trace import NOOP_SPAN, instant, span, traced

__all__ = [
    "COUNT_BUCKETS", "LATENCY_BUCKETS", "MetricError", "NOOP_SPAN",
    "configure", "count", "enabled", "export", "fold_stats", "gauge_set",
    "get_registry", "instant", "journal", "latency", "metrics", "observe",
    "observe_phase", "observe_phase_many", "reset_all", "rules", "span",
    "trace", "traced",
]


def configure(enabled: bool = True, *, reset: bool = False) -> None:
    """Flip the process-wide observability switch.  `reset=True` also
    clears the registry, tracer and journal (fresh run boundaries)."""
    _flags.ENABLED = bool(enabled)
    if reset:
        reset_all()


def enabled() -> bool:
    return _flags.ENABLED


def reset_all() -> None:
    metrics.REGISTRY.clear()
    trace.TRACER.clear()
    journal.JOURNAL.clear()
    latency.reset()
    rules.reset()


# -- one-line guarded instrumentation helpers --------------------------------

def count(name: str, n=1, help: str = "", **labels) -> None:
    """Increment a counter (created on first use); no-op when disabled."""
    if not _flags.ENABLED:
        return
    metrics.REGISTRY.counter(name, help=help,
                             labels=tuple(sorted(labels))).labels(
                                 **labels).inc(n)


def count_total(name: str, total, help: str = "", **labels) -> None:
    """Install an absolute cumulative counter total (the fold path for
    device-side running sums); no-op when disabled."""
    if not _flags.ENABLED:
        return
    metrics.REGISTRY.counter(name, help=help,
                             labels=tuple(sorted(labels))).labels(
                                 **labels).set_total(total)


def gauge_set(name: str, value, help: str = "", **labels) -> None:
    """Set a gauge to a raw value; no-op when disabled."""
    if not _flags.ENABLED:
        return
    metrics.REGISTRY.gauge(name, help=help,
                           labels=tuple(sorted(labels))).labels(
                               **labels).set(value)


def observe(name: str, value, buckets=None, help: str = "",
            **labels) -> None:
    """Observe one value (or an iterable of values) into a histogram;
    no-op when disabled."""
    if not _flags.ENABLED:
        return
    child = metrics.REGISTRY.histogram(
        name, help=help, labels=tuple(sorted(labels)),
        buckets=buckets).labels(**labels)
    if hasattr(value, "__iter__"):
        child.observe_many(value)
    else:
        child.observe(value)
