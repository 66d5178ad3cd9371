"""Request-level latency: log-bucketed quantiles, decaying live windows,
and the ticket lifecycle clock.

The fixed-bucket `metrics.Histogram` is the storage; this module adds
the *shape* request latency needs.  Linear edges bin a 100us queue wait
and a 100ms promotion stall into the same handful of buckets, so the
phase histograms use geometric (log-spaced) edges instead
(`LATENCY_LOG_BUCKETS`: `per_decade` buckets per power of ten) and
`quantile()` reads p50/p95/p99/p99.9 back out of the counts with
geometric interpolation inside the winning bucket — the estimate is
within one bucket ratio of the true order statistic by construction.

Two consumers sit on top:

* `observe_phase(phase, seconds)` — the one helper every instrumentation
  site calls.  It feeds BOTH the cumulative `f2_latency_seconds{phase=}`
  registry histogram (scraped by `/metrics`, folded into bench
  envelopes) and a per-phase `DecayingQuantile` window (exponentially
  decayed bucket counts, half-life `LIVE_HALF_LIFE_S`) that
  `/snapshot.json` serves as the *live* view — a latency spike shows up
  immediately and ages out, instead of drowning in the cumulative sum.
  Centralizing the call also pins the bucket edges and the single
  `phase` label, so no call site can redeclare the family
  (`MetricError`).

* `TicketClock` — host-side lifecycle stamps for the session service
  (enqueue -> packed -> applied -> collected).  Stamps are plain
  `perf_counter()` reads at points the host already executes; the only
  device value involved (each round's packed-ticket gather) is queued
  and materialized lazily in `fold()`, mirroring the service's
  `_pending_fill` pattern — never a sync on the serving hot path, never
  anything in a kernel.

Everything here is stdlib-only; callers inject array materialization: the
session service passes `serve.sessions.fetch_tickets`, which reads a fold's
queued ticket tensors in one device-to-host copy.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import _flags
from . import metrics as _metrics

# the request phases instrumented across the stack (the bench and the
# README table enumerate these; rules may reference any of them)
PHASES = ("queue", "pack", "apply", "deferral", "promote", "fsync", "e2e")

LIVE_HALF_LIFE_S = 30.0


def log_buckets(lo: float = 1e-6, hi: float = 10.0,
                per_decade: int = 5) -> Tuple[float, ...]:
    """Geometric histogram edges: `per_decade` per power of ten over
    [lo, hi].  Strictly increasing (float artifacts deduped)."""
    assert lo > 0 and hi > lo and per_decade >= 1
    n = int(round(math.log10(hi / lo) * per_decade))
    out: List[float] = []
    for i in range(n + 1):
        e = lo * 10.0 ** (i / per_decade)
        if not out or e > out[-1] * (1.0 + 1e-12):
            out.append(e)
    return tuple(out)


# 1us .. 10s, 5 buckets per decade: 36 edges, ~58% bucket ratio
LATENCY_LOG_BUCKETS = log_buckets(1e-6, 10.0, 5)

_HELP = "request-phase latency in seconds (log-bucketed)"


def quantile(edges: Sequence[float], counts: Sequence[int],
             q: float) -> Optional[float]:
    """The q-quantile of a bucketed distribution (len(counts) ==
    len(edges) + 1, trailing overflow bucket).  Returns the geometric
    midpoint of the winning bucket (its upper edge for the first and
    overflow buckets), so the estimate is within one bucket ratio of the
    true order statistic; None on an empty histogram."""
    assert 0.0 <= q <= 1.0, q
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            if i >= len(edges):         # overflow: no upper bound
                return float(edges[-1])
            hi = float(edges[i])
            if i == 0:
                return hi
            lo = float(edges[i - 1])
            return math.sqrt(lo * hi) if lo > 0 else hi
    return float(edges[-1])


def quantiles(edges: Sequence[float], counts: Sequence[int],
              qs: Sequence[float] = (0.5, 0.95, 0.99, 0.999)) -> dict:
    """{"p50": ..., "p95": ...} for the requested quantile list."""
    out = {}
    for q in qs:
        key = ("p" + f"{q * 100:g}").replace(".", "")
        out[key] = quantile(edges, counts, q)
    return out


def summary(name: str = "f2_latency_seconds",
            registry: Optional[_metrics.MetricsRegistry] = None) -> dict:
    """Per-label quantile summary of one registry histogram family:
    `{label_key: {count, mean, p50, p95, p99, p999}}` where label_key is
    the joined label values ("e2e" for the phase histograms).  Empty
    dict when the metric does not exist."""
    reg = registry or _metrics.REGISTRY
    m = reg.get(name)
    if m is None or m.kind != "histogram":
        return {}
    out = {}
    for key, child in m.samples():
        row = dict(count=child.count,
                   mean=(child.sum / child.count) if child.count else 0.0)
        row.update(quantiles(child.edges, child.counts))
        out["|".join(key) if key else ""] = row
    return out


class DecayingQuantile:
    """Log-bucketed counts with exponential time decay: quantiles over a
    sliding ~`half_life_s` window, for live views.  A 30s-old spike has
    half its original weight; a 5-minute-old one is gone.  Thread-safe
    (observes land from the checkpointer's worker thread too)."""

    def __init__(self, edges: Sequence[float] = LATENCY_LOG_BUCKETS,
                 half_life_s: float = LIVE_HALF_LIFE_S):
        assert half_life_s > 0
        self.edges = tuple(float(e) for e in edges)
        self.half_life_s = float(half_life_s)
        self.counts = [0.0] * (len(self.edges) + 1)
        self._t: Optional[float] = None
        self._lock = threading.Lock()

    def _decay_locked(self, now: float) -> None:
        if self._t is None:
            self._t = now
            return
        dt = now - self._t
        if dt <= 0.0:
            return
        f = 0.5 ** (dt / self.half_life_s)
        self.counts = [c * f for c in self.counts]
        self._t = now

    def observe(self, v: float, now: Optional[float] = None) -> None:
        self.observe_many((v,), now)

    def observe_many(self, values: Sequence[float],
                     now: Optional[float] = None) -> None:
        """Bulk observe: one decay + one lock pass for the whole batch
        (the TicketClock folds hundreds of durations at once)."""
        if not values:
            return
        now = time.monotonic() if now is None else now
        idx = [bisect.bisect_left(self.edges, float(v)) for v in values]
        with self._lock:
            self._decay_locked(now)
            for i in idx:
                self.counts[i] += 1.0

    def total(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._decay_locked(now)
            return sum(self.counts)

    def quantile(self, q: float, now: Optional[float] = None
                 ) -> Optional[float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._decay_locked(now)
            counts = list(self.counts)
        total = sum(counts)
        if total < 1e-9:                # fully decayed = empty
            return None
        return quantile(self.edges, counts, q)


# per-phase live windows fed by observe_phase (module-global, like the
# registry; reset() at fresh-run boundaries)
LIVE: Dict[str, DecayingQuantile] = {}
_LIVE_LOCK = threading.Lock()


def observe_phase(phase: str, seconds: float,
                  registry: Optional[_metrics.MetricsRegistry] = None
                  ) -> None:
    """Record one request-phase duration into the cumulative
    `f2_latency_seconds{phase=...}` histogram AND the live decaying
    window.  The single entry point for every phase site keeps the
    bucket edges and label set consistent.  No-op when disabled."""
    if not _flags.ENABLED:
        return
    reg = registry or _metrics.REGISTRY
    reg.histogram("f2_latency_seconds", help=_HELP, labels=("phase",),
                  buckets=LATENCY_LOG_BUCKETS).labels(
                      phase=phase).observe(seconds)
    with _LIVE_LOCK:
        win = LIVE.get(phase)
        if win is None:
            win = LIVE[phase] = DecayingQuantile()
    win.observe(seconds)


def observe_phase_many(phase: str, seconds: Sequence[float],
                       registry: Optional[_metrics.MetricsRegistry] = None
                       ) -> None:
    """Bulk `observe_phase`: one registry/child lookup and one live-window
    decay for the whole batch.  The TicketClock's fold emits hundreds of
    per-ticket durations at a time — per-value lookups were the dominant
    cost of the enabled path."""
    if not _flags.ENABLED or not seconds:
        return
    reg = registry or _metrics.REGISTRY
    reg.histogram("f2_latency_seconds", help=_HELP, labels=("phase",),
                  buckets=LATENCY_LOG_BUCKETS).labels(
                      phase=phase).observe_many(seconds)
    with _LIVE_LOCK:
        win = LIVE.get(phase)
        if win is None:
            win = LIVE[phase] = DecayingQuantile()
    win.observe_many(seconds)


def live_summary(now: Optional[float] = None) -> dict:
    """{phase: {total, p50, p99}} over the decaying windows — the live
    companion to `summary()`'s cumulative view."""
    with _LIVE_LOCK:
        wins = dict(LIVE)
    out = {}
    for phase in sorted(wins):
        w = wins[phase]
        out[phase] = dict(total=round(w.total(now), 3),
                          p50=w.quantile(0.5, now),
                          p99=w.quantile(0.99, now))
    return out


def reset() -> None:
    """Drop the live windows (fresh-run boundaries; the cumulative
    histograms live in the registry and are cleared with it)."""
    with _LIVE_LOCK:
        LIVE.clear()


# ---------------------------------------------------------------------------
# the ticket lifecycle clock
# ---------------------------------------------------------------------------

class TicketClock:
    """Host-side lifecycle stamps for the session service's tickets.

    The service stamps three points it already executes on the host:

    * `note_enqueue(t0, n, now)` — tickets t0..t0+n-1 accepted into the
      pool (tickets are host-deterministic, so no device involvement).
    * `note_round(tickets, t_pack0, t_pack1, t_applied)` — one packed
      round dispatched; `tickets` is the round's packed-ticket gather
      (a device array, -1 for unfilled lanes).  Queued, not read: the
      serving hot path never syncs.
    * `note_collected(tickets, now)` — tickets handed back to a caller.

    `fold()` materializes the queued rounds in one host transfer (the
    service's lazy-fold idiom) and emits the per-phase durations through
    `observe_phase`: `pack` (packer dispatch, once per round), `queue`
    (enqueue -> packed), `apply` (packed -> applied+committed) and, at
    collection, `e2e` (enqueue -> collected).  A collected ticket's
    round is always queued before the caller can see DONE, so
    `note_collected` folds first and never misses a stamp.
    """

    FOLD_EVERY = 128        # rounds queued before an implicit fold

    def __init__(self, fetch: Callable = lambda xs: xs):
        self._fetch = fetch
        self._open: Dict[int, List[float]] = {}   # ticket -> [enq, packed]
        self._rounds: List[tuple] = []

    @property
    def outstanding(self) -> int:
        return len(self._open)

    def note_enqueue(self, t0: int, n: int, now: float) -> None:
        for t in range(int(t0), int(t0) + int(n)):
            self._open[t] = [now, -1.0]

    def note_round(self, tickets, t_pack0: float, t_pack1: float,
                   t_applied: float) -> None:
        self._rounds.append((tickets, t_pack0, t_pack1, t_applied))
        if len(self._rounds) >= self.FOLD_EVERY:
            self.fold()

    def fold(self) -> None:
        if not self._rounds:
            return
        rounds, self._rounds = self._rounds, []
        fetched = self._fetch([r[0] for r in rounds])
        pack_vals, queue_vals, apply_vals = [], [], []
        for (_, t_p0, t_p1, t_ap), tkts in zip(rounds, fetched):
            pack_vals.append(t_p1 - t_p0)
            for t in tkts:
                t = int(t)
                if t < 0:
                    continue
                rec = self._open.get(t)
                if rec is None or rec[1] >= 0.0:
                    continue            # unknown ticket / already packed
                rec[1] = t_p1
                queue_vals.append(t_p1 - rec[0])
                apply_vals.append(t_ap - t_p1)
        observe_phase_many("pack", pack_vals)
        observe_phase_many("queue", queue_vals)
        observe_phase_many("apply", apply_vals)

    def note_collected(self, tickets, now: float) -> None:
        self.fold()
        e2e_vals = []
        for t in tickets:
            rec = self._open.pop(int(t), None)
            if rec is None:
                continue
            e2e_vals.append(now - rec[0])
        observe_phase_many("e2e", e2e_vals)

    def clear(self) -> None:
        self._open.clear()
        self._rounds.clear()
