"""One-shot text summarizer and regression differ for observability
snapshots:

    python -m repro_torch.obs.report <snapshot.json>
    python -m repro_torch.obs.report --diff A.json B.json

Summarize accepts any of the three JSON shapes this package writes — a
raw `metrics_snapshot()`, a full `export.snapshot()` (metrics +
journal), or a `BENCH_*.json` envelope (whose `metrics_snapshot` field
it summarizes, with the bench name and git sha in the header).

`--diff` compares two BENCH envelopes (A = baseline, B = candidate):
every numeric leaf under `results` prints as `a -> b (+x.x%)` by dotted
path, leaves present on only one side are called out, and differing
`config` keys are listed as drift — so CI bench artifacts from two
commits regression-diff with no extra tooling."""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def _extract(doc: dict):
    """-> (metrics_dict, journal_dict_or_None, header_lines)."""
    header = []
    if "metrics_snapshot" in doc:           # bench envelope
        header.append(f"bench: {doc.get('bench')}  "
                      f"git_sha: {doc.get('git_sha')}")
        return doc["metrics_snapshot"], None, header
    if "metrics" in doc and isinstance(doc["metrics"], dict):
        return doc["metrics"], doc.get("journal"), header
    return doc, None, header                # raw metrics snapshot


def _hist_quantile(buckets, counts, q: float) -> Optional[float]:
    """Upper-bound estimate of the q-quantile from bucket counts."""
    total = sum(counts)
    if not total:
        return None
    target = q * total
    cum = 0
    for edge, c in zip(buckets, counts):
        cum += c
        if cum >= target:
            return edge
    return float("inf")


def summarize(doc: dict) -> str:
    metrics, jrnl, lines = _extract(doc)
    counters, gauges, hists = [], [], []
    for name in sorted(metrics):
        m = metrics[name]
        kind = m.get("type")
        for s in m.get("samples", []):
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(s.get("labels", {}).items()))
            tag = f"{name}{{{lbl}}}" if lbl else name
            if kind == "histogram":
                mean = s["sum"] / s["count"] if s["count"] else 0.0
                p50 = _hist_quantile(m["buckets"], s["bucket_counts"], 0.5)
                p99 = _hist_quantile(m["buckets"], s["bucket_counts"], 0.99)
                hists.append(f"  {tag}: n={s['count']} mean={mean:.6g} "
                             f"p50<={p50} p99<={p99}")
            elif kind == "counter":
                counters.append(f"  {tag} = {s['value']}")
            else:
                v = s.get("value")
                if isinstance(v, list) and len(v) > 8:
                    v = f"[{len(v)} values, sum={sum(v):g}]" if all(
                        isinstance(x, (int, float, bool)) for x in v) else \
                        f"[{len(v)} values]"
                gauges.append(f"  {tag} = {v}")
    if counters:
        lines += ["counters:"] + counters
    if gauges:
        lines += ["gauges:"] + gauges
    if hists:
        lines += ["histograms:"] + hists
    if jrnl:
        lines.append(f"journal: {jrnl.get('total', 0)} events "
                     f"({jrnl.get('dropped', 0)} dropped)")
        by_kind: dict = {}
        for ev in jrnl.get("events", []):
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
        for kind in sorted(by_kind):
            lines.append(f"  {kind} x{by_kind[kind]}")
    if not lines:
        lines = ["(empty snapshot)"]
    return "\n".join(lines)


def _leaves(node, prefix: str = "") -> dict:
    """Flatten nested dicts/lists to {dotted.path: leaf}; list entries
    index as `path[i]`."""
    out: dict = {}
    if isinstance(node, dict):
        for k in sorted(node, key=str):
            out.update(_leaves(node[k], f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            out.update(_leaves(item, f"{prefix}[{i}]"))
    else:
        out[prefix] = node
    return out


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def diff(a: dict, b: dict) -> str:
    """Regression-diff two bench envelopes: numeric `results` leaves
    with deltas and % change, one-sided leaves, and config drift."""
    lines = [f"A: bench={a.get('bench')}  git_sha={a.get('git_sha')}",
             f"B: bench={b.get('bench')}  git_sha={b.get('git_sha')}"]
    ra, rb = _leaves(a.get("results") or {}), _leaves(b.get("results") or {})
    num, other = [], []
    for k in sorted(set(ra) | set(rb)):
        if k not in ra or k not in rb:
            side = "A" if k in ra else "B"
            other.append(f"  {k}: only in {side} "
                         f"({ra.get(k, rb.get(k))!r})")
            continue
        va, vb = ra[k], rb[k]
        if _is_num(va) and _is_num(vb):
            if va == vb:
                continue
            pct = (f" ({(vb - va) / abs(va) * 100.0:+.1f}%)" if va
                   else "")
            num.append(f"  {k}: {va:g} -> {vb:g}{pct}")
        elif va != vb:
            other.append(f"  {k}: {va!r} -> {vb!r}")
    lines.append("results:" if (num or other) else
                 "results: identical")
    lines += num + other
    ca, cb = _leaves(a.get("config") or {}), _leaves(b.get("config") or {})
    drift = [k for k in sorted(set(ca) | set(cb))
             if ca.get(k, "<absent>") != cb.get(k, "<absent>")]
    if drift:
        lines.append("config drift:")
        lines += [f"  {k}: {ca.get(k, '<absent>')!r} -> "
                  f"{cb.get(k, '<absent>')!r}" for k in drift]
    else:
        lines.append("config drift: none")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs snapshot / bench envelope, "
                    "or regression-diff two envelopes.")
    ap.add_argument("snapshot", nargs="?",
                    help="path to the JSON file (summarize mode)")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    help="diff two bench envelopes (A=baseline)")
    args = ap.parse_args(argv)
    if args.diff:
        docs = []
        for path in args.diff:
            with open(path) as f:
                docs.append(json.load(f))
        print(diff(*docs))
        return 0
    if args.snapshot is None:
        ap.error("need a snapshot path or --diff A.json B.json")
    with open(args.snapshot) as f:
        doc = json.load(f)
    print(summarize(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
