"""Process-wide metrics registry: Counters, Gauges and fixed-bucket
host-side Histograms.

All four store facades (`KV`, `ShardedKV`, `ReplicatedKV`, `DurableKV`)
plus `KVSessionService` register here and fold device-side deltas —
IoStats totals, per-shard fills, per-bucket traffic EWMAs, deferral
rounds, chain-walk hops, WAL fsync and checkpoint-save latencies — at
their existing host-side folding points, once per round at most and
never inside a kernel.

Semantics
---------
* **Counter** — monotone by `inc(n >= 0)`; `set_total(v)` installs an
  absolute cumulative total (the fold path for device-side counters that
  are already running sums, e.g. `IoStats`).
* **Gauge** — `set(v)` stores the raw Python value (int, float, bool,
  str, list); `value` returns it unchanged.  Raw storage is what makes
  the registry-backed `stats()` trees bit-compatible with the pre-obs
  nested dicts: `fold_stats` writes every leaf through a gauge and reads
  it back, type and value intact.
* **Histogram** — fixed upper-bound bucket edges chosen at creation;
  `observe` bins host-side floats (latencies, hop counts, deferral
  rounds).

Every metric may declare label names; `metric.labels(**kv)` returns the
per-label-set child.  Creation is idempotent get-or-create by name; a
kind or label-name mismatch raises `MetricError`.  All mutation is
lock-protected (the checkpointer's commit callback observes from its
worker thread)."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from . import _flags

# default edges for latency-shaped histograms (seconds)
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# small-count histograms (deferral rounds per batch, chain hops per lane)
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class MetricError(ValueError):
    """Metric redeclared with a different kind, labels or buckets."""


class _CounterChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise MetricError(f"counter increment must be >= 0, got {n}")
        self._value += n

    def set_total(self, v):
        """Install an absolute cumulative total (device-side counters are
        already running sums; re-folding them is a set, not an add)."""
        self._value = v

    @property
    def value(self):
        return self._value


class _GaugeChild:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0

    def set(self, v):
        self._value = v

    def inc(self, n=1):
        self._value += n

    @property
    def value(self):
        return self._value


class _HistogramChild:
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)    # last bucket: > edges[-1]
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        i = 0
        for edge in self.edges:
            if v <= edge:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def observe_many(self, values):
        for v in values:
            self.observe(v)


_CHILD_OF = {"counter": _CounterChild, "gauge": _GaugeChild,
             "histogram": _HistogramChild}


class Metric:
    """One named metric family; children keyed by label values."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Optional[Tuple[float, ...]] = None,
                 lock: Optional[threading.RLock] = None):
        assert kind in _CHILD_OF, kind
        if kind == "histogram":
            buckets = tuple(float(b) for b in (buckets or LATENCY_BUCKETS))
            if list(buckets) != sorted(set(buckets)):
                raise MetricError(
                    f"{name}: bucket edges must be strictly increasing, "
                    f"got {buckets}")
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = lock or threading.RLock()

    def _make_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self.buckets)
        return _CHILD_OF[self.kind]()

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    @property
    def default(self):
        """The unlabeled child (only for metrics declared without labels)."""
        assert not self.label_names, \
            f"{self.name} has labels {self.label_names}; use .labels()"
        return self.labels()

    def samples(self):
        """[(label_values_tuple, child)] — stable snapshot for exporters."""
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Idempotent get-or-create metric store; one per process by default
    (`repro_torch.obs.get_registry()`)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind: str, help: str, labels: Sequence[str],
             buckets=None) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(
                    name, kind, help=help, label_names=labels,
                    buckets=buckets, lock=self._lock)
                return m
            if m.kind != kind:
                raise MetricError(
                    f"{name} already registered as {m.kind}, not {kind}")
            if tuple(labels) != m.label_names:
                raise MetricError(
                    f"{name} already registered with labels "
                    f"{m.label_names}, not {tuple(labels)}")
            if (kind == "histogram" and buckets is not None
                    and tuple(float(b) for b in buckets) != m.buckets):
                raise MetricError(f"{name} already registered with buckets "
                                  f"{m.buckets}")
            return m

    def counter(self, name, help="", labels=()):
        return self._get(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        return self._get(name, "histogram", help, labels, buckets=buckets)

    def get(self, name) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able view of every metric: `{name: {type, help, labels,
        samples: [...]}}`.  Counter/gauge samples carry raw values;
        histogram samples carry per-bucket counts plus sum/count."""
        out = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                samples = []
                for key, child in m.samples():
                    row = {"labels": dict(zip(m.label_names, key))}
                    if m.kind == "histogram":
                        row.update(count=child.count, sum=child.sum,
                                   bucket_counts=list(child.counts))
                    else:
                        row["value"] = child.value
                    samples.append(row)
                entry = {"type": m.kind, "help": m.help,
                         "labels": list(m.label_names), "samples": samples}
                if m.kind == "histogram":
                    entry["buckets"] = list(m.buckets)
                out[name] = entry
        return out


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


# ---------------------------------------------------------------------------
# Registry-backed stats() trees
# ---------------------------------------------------------------------------

def fold_stats(facade: str, tree: dict,
               registry: Optional[MetricsRegistry] = None) -> dict:
    """Back one facade's nested `stats()` tree with the registry.

    Every leaf is written through a `f2_stats_<dotted.path>` gauge
    (labeled by facade) and the returned tree is REBUILT from the gauge
    values — so what `stats()` hands back is, leaf for leaf, what a
    dashboard scraping the registry sees.  Gauges store raw Python
    values, so ints stay ints, floats stay floats, lists stay lists and
    the nested shape is bit-compatible with the pre-obs dicts.  Disabled
    (`obs.configure(enabled=False)`), the tree passes through untouched
    — the identical object, zero registry traffic."""
    if not _flags.ENABLED:
        return tree
    reg = registry or REGISTRY
    return _fold_node(reg, facade, (), tree)


def _fold_node(reg, facade, path, node):
    if isinstance(node, dict):
        return {k: _fold_node(reg, facade, path + (str(k),), v)
                for k, v in node.items()}
    g = reg.gauge("f2_stats_" + "_".join(path),
                  help=f"stats() leaf {'.'.join(path)}",
                  labels=("facade",))
    child = g.labels(facade=facade)
    child.set(node)
    return child.value
