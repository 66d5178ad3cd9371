"""Exporters: JSON snapshots, Prometheus text format, and the unified
benchmark envelope.

Every `BENCH_*.json` artifact goes through `write_bench_json`, which
wraps a benchmark's raw results in one shared schema:

    {"schema_version": 1, "bench": ..., "config": ..., "git_sha": ...,
     "results": ..., "metrics_snapshot": ...}

so the perf-trajectory artifacts are machine-comparable across benches
and across commits (`git_sha` is best-effort: None outside a git
checkout).  `prometheus_text` renders the registry in the Prometheus
exposition format; list-valued gauges (per-shard / per-bucket arrays)
become one series per index under an `idx` label, non-numeric gauges
are skipped."""
from __future__ import annotations

import json
import subprocess
from typing import Optional

from . import journal as _journal
from . import metrics as _metrics
from . import rules as _rules
from . import trace as _trace

SCHEMA_VERSION = 1


def metrics_snapshot(registry: Optional[_metrics.MetricsRegistry] = None
                     ) -> dict:
    return (registry or _metrics.REGISTRY).snapshot()


def snapshot() -> dict:
    """The full observability snapshot: metrics + journal + trace
    occupancy (not the events themselves; use `tracer.save` for those)."""
    return {
        "schema_version": SCHEMA_VERSION,
        "metrics": metrics_snapshot(),
        "journal": _journal.JOURNAL.snapshot(),
        "trace": {"events": len(_trace.TRACER),
                  "dropped": _trace.TRACER.dropped},
        "alerts": _rules.ENGINE.snapshot(),
    }


def save_snapshot(path: str) -> str:
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=2, default=str)
    return path


def git_sha() -> Optional[str]:
    """Best-effort commit id for bench provenance; None when git or the
    work tree is unavailable (e.g. a source tarball)."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def bench_envelope(bench: str, config: dict, results) -> dict:
    return {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "config": config,
        "git_sha": git_sha(),
        "results": results,
        "metrics_snapshot": metrics_snapshot(),
    }


def write_bench_json(path: str, bench: str, config: dict, results) -> str:
    with open(path, "w") as f:
        json.dump(bench_envelope(bench, config, results), f, indent=2,
                  default=str)
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _numeric(v) -> Optional[float]:
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def prometheus_text(registry: Optional[_metrics.MetricsRegistry] = None
                    ) -> str:
    snap = metrics_snapshot(registry)
    lines = []
    for name, m in snap.items():
        kind = m["type"]
        lines.append(f"# HELP {name} {m['help'] or name}")
        lines.append(f"# TYPE {name} {kind}")
        for s in m["samples"]:
            labels = s["labels"]
            if kind == "histogram":
                cum = 0
                for edge, c in zip(m["buckets"], s["bucket_counts"]):
                    cum += c
                    lb = dict(labels, le=f"{edge:g}")
                    lines.append(f"{name}_bucket{_fmt_labels(lb)} {cum}")
                cum += s["bucket_counts"][-1]
                lb = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_fmt_labels(lb)} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{s['sum']:g}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{s['count']}")
                continue
            v = s["value"]
            if isinstance(v, (list, tuple)):
                for i, item in enumerate(v):
                    num = _numeric(item)
                    if num is None:
                        break
                    lb = dict(labels, idx=str(i))
                    lines.append(f"{name}{_fmt_labels(lb)} {num:g}")
                continue
            num = _numeric(v)
            if num is None:
                continue                # string gauges are JSON-only
            lines.append(f"{name}{_fmt_labels(labels)} {num:g}")
    return "\n".join(lines) + "\n"
