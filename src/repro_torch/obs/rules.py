"""Alert/watchdog rules over the metrics registry, evaluated at the
stores' host-side fold points.

A rule is one comparison over one registered metric:

    AGG(metric_name{label=value,...}) OP NUMBER

        AGG ::= value | count | mean | rate | p50 | p95 | p99 | p999
        OP  ::= > | >= | < | <=

    p99(f2_latency_seconds{phase=e2e}) > 0.5
    rate(f2_deferral_rounds{facade=sharded,path=read}) > 100
    value(f2_host_chunks{facade=kv}) > 10000

`value` reads a counter/gauge; `count`/`mean`/`p*` read a histogram
(`p*` through `latency.quantile`); `rate` is the per-second delta of the
series (a counter's value, a histogram's observation count) between
evaluations.  Label selectors must name the child exactly; a rule whose
metric or child does not exist yet simply has no data and cannot breach.

Two rule kinds:

* `threshold` — fires after `for_count` consecutive breaching
  evaluations (debounce), resolves on the first non-breaching one.
* `burn_rate` — smooths the aggregated value with an EWMA
  (`alpha` = weight of the newest sample) before comparing, the
  classic burn-rate alert for spiky signals like deferral-round rates.

Transitions emit `alert.fired` / `alert.resolved` journal events, so
fault-injection tests pin alert *sequences* the same way they pin crash
recovery, and `/healthz` serves 503 while anything is firing.

Evaluation rides the existing fold points (`_fold_traffic`,
`_fold_fill`, the export/serve endpoints) through `maybe_evaluate()` —
a two-check no-op when disabled or ruleless, so the kill-switch
contract holds."""
from __future__ import annotations

import operator
import re
import threading
import time
from typing import Dict, List, Optional

from . import _flags
from . import journal as _journal
from . import latency as _latency
from . import metrics as _metrics


class RuleError(ValueError):
    """Malformed rule expression or aggregation/metric-kind mismatch."""


_AGGS = ("value", "count", "mean", "rate", "p50", "p95", "p99", "p999")
_OPS = {">": operator.gt, ">=": operator.ge,
        "<": operator.lt, "<=": operator.le}
_QS = {"p50": 0.5, "p95": 0.95, "p99": 0.99, "p999": 0.999}

_EXPR = re.compile(
    r"^\s*(?P<agg>" + "|".join(_AGGS) + r")\s*"
    r"\(\s*(?P<metric>[A-Za-z_][A-Za-z0-9_]*)\s*"
    r"(?:\{(?P<labels>[^}]*)\})?\s*\)\s*"
    r"(?P<op>>=|<=|>|<)\s*"
    r"(?P<thr>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*$")


def _parse_labels(text: Optional[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if not text or not text.strip():
        return out
    for part in text.split(","):
        if "=" not in part:
            raise RuleError(f"bad label selector {part!r} (want k=v)")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip().strip('"').strip("'")
    return out


class Rule:
    """One parsed rule plus its evaluation state (breach streak, EWMA,
    rate memory, firing flag)."""

    def __init__(self, name: str, expr: str, *, kind: str = "threshold",
                 for_count: int = 1, alpha: float = 0.3):
        m = _EXPR.match(expr)
        if m is None:
            raise RuleError(f"cannot parse rule expression {expr!r}")
        if kind not in ("threshold", "burn_rate"):
            raise RuleError(f"unknown rule kind {kind!r}")
        assert for_count >= 1 and 0.0 < alpha <= 1.0
        self.name = name
        self.expr = expr
        self.kind = kind
        self.for_count = int(for_count)
        self.alpha = float(alpha)
        self.agg = m.group("agg")
        self.metric = m.group("metric")
        self.labels = _parse_labels(m.group("labels"))
        self.op = m.group("op")
        self.threshold = float(m.group("thr"))
        self._cmp = _OPS[self.op]
        # evaluation state
        self.firing = False
        self.breaches = 0
        self.fired_total = 0
        self.last_value: Optional[float] = None
        self._ewma: Optional[float] = None
        self._rate_prev: Optional[tuple] = None     # (t, base_value)

    # -- series lookup ------------------------------------------------------
    def _child(self, reg: _metrics.MetricsRegistry):
        m = reg.get(self.metric)
        if m is None:
            return None, None
        if set(self.labels) != set(m.label_names):
            return m, None              # selector does not name a child
        key = tuple(str(self.labels[n]) for n in m.label_names)
        for k, child in m.samples():
            if k == key:
                return m, child
        return m, None

    def _base_value(self, m, child) -> Optional[float]:
        """The aggregated instantaneous value (before rate/EWMA)."""
        if m.kind == "histogram":
            if self.agg == "count":
                return float(child.count)
            if self.agg == "mean":
                return (child.sum / child.count) if child.count else None
            if self.agg in _QS:
                return _latency.quantile(child.edges, child.counts,
                                         _QS[self.agg])
            if self.agg == "rate":      # rate of observations
                return float(child.count)
            return None                 # value() on a histogram: no data
        # counter / gauge
        if self.agg in ("value", "rate"):
            v = child.value
            return float(v) if isinstance(v, (int, float, bool)) else None
        return None                     # p*/mean/count need a histogram

    def evaluate_value(self, reg: _metrics.MetricsRegistry,
                       now: float) -> Optional[float]:
        m, child = self._child(reg)
        if child is None:
            return None
        base = self._base_value(m, child)
        if base is None:
            return None
        if self.agg == "rate":
            prev, self._rate_prev = self._rate_prev, (now, base)
            if prev is None or now <= prev[0]:
                return None
            base = (base - prev[1]) / (now - prev[0])
        if self.kind == "burn_rate":
            self._ewma = base if self._ewma is None else (
                self.alpha * base + (1.0 - self.alpha) * self._ewma)
            return self._ewma
        return base

    def state(self) -> dict:
        return dict(name=self.name, expr=self.expr, kind=self.kind,
                    firing=self.firing, last_value=self.last_value,
                    threshold=self.threshold, fired_total=self.fired_total,
                    for_count=self.for_count)


class AlertEngine:
    """The rule set plus transition tracking.  `evaluate()` runs every
    rule against the registry, flips firing states, and journals
    `alert.fired` / `alert.resolved`; `firing()` backs `/healthz`."""

    def __init__(self):
        self._lock = threading.RLock()
        self.rules: Dict[str, Rule] = {}
        self.evaluations = 0

    def add(self, name: str, expr: str, *, kind: str = "threshold",
            for_count: int = 1, alpha: float = 0.3) -> Rule:
        rule = Rule(name, expr, kind=kind, for_count=for_count, alpha=alpha)
        with self._lock:
            self.rules[name] = rule
        return rule

    def remove(self, name: str) -> None:
        with self._lock:
            self.rules.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self.rules.clear()
            self.evaluations = 0

    def evaluate(self, registry: Optional[_metrics.MetricsRegistry] = None,
                 now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the transitions ([{rule, event,
        value}]) it caused.  No-op (empty) when obs is disabled."""
        if not _flags.ENABLED:
            return []
        reg = registry or _metrics.REGISTRY
        now = time.monotonic() if now is None else now
        transitions: List[dict] = []
        with self._lock:
            rules = list(self.rules.values())
            self.evaluations += 1
        for rule in rules:
            v = rule.evaluate_value(reg, now)
            rule.last_value = v
            breach = v is not None and rule._cmp(v, rule.threshold)
            rule.breaches = rule.breaches + 1 if breach else 0
            if breach and not rule.firing and \
                    rule.breaches >= rule.for_count:
                rule.firing = True
                rule.fired_total += 1
                _journal.emit("alert.fired", rule=rule.name, value=v,
                              threshold=rule.threshold, expr=rule.expr)
                transitions.append(dict(rule=rule.name, event="fired",
                                        value=v))
            elif rule.firing and not breach:
                rule.firing = False
                _journal.emit("alert.resolved", rule=rule.name, value=v,
                              threshold=rule.threshold)
                transitions.append(dict(rule=rule.name, event="resolved",
                                        value=v))
        return transitions

    def firing(self) -> List[dict]:
        with self._lock:
            return [r.state() for r in self.rules.values() if r.firing]

    def any_firing(self) -> bool:
        with self._lock:
            return any(r.firing for r in self.rules.values())

    def snapshot(self) -> dict:
        with self._lock:
            return dict(evaluations=self.evaluations,
                        rules=[r.state() for r in self.rules.values()])


ENGINE = AlertEngine()


def add_rule(name: str, expr: str, *, kind: str = "threshold",
             for_count: int = 1, alpha: float = 0.3) -> Rule:
    return ENGINE.add(name, expr, kind=kind, for_count=for_count,
                      alpha=alpha)


def evaluate(**kw) -> List[dict]:
    return ENGINE.evaluate(**kw)


def maybe_evaluate() -> None:
    """The fold-point hook: evaluate iff armed and any rules exist —
    two attribute checks otherwise, preserving the kill-switch
    contract."""
    if _flags.ENABLED and ENGINE.rules:
        ENGINE.evaluate()


def firing() -> List[dict]:
    return ENGINE.firing()


def reset() -> None:
    ENGINE.clear()
