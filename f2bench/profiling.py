"""Reading one profiled sub-window of the timed loop in one pass.

Frozen from `chip_smoke.py`'s `_aggregate`, `_device_rows` and
`profile_window` (one pass over `prof.events()`, since `key_averages()`
takes tens of seconds on a large window), extended with what the benchmark's per-layer metrics read: the
device's busy time as a union of intervals, the kernels it ran, the host's
sync calls inside the facade's calls (the benchmark's own
`record_function` span, `APPLY_SPAN`, around each), and the idle gaps of
the device named by the host operation that was running in each.
"""
from __future__ import annotations

from collections import defaultdict

APPLY_SPAN = "f2bench.apply"
# host calls that wait for the device: every `.item()`, `int(tensor)`,
# `nonzero` and blocking copy ends in one of these
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# the store's kernels by library (the names the kernels are built with)
KERNELS = {
    "fused_probe": ("fused_probe_walk_kernel", "first_hop_probe_kernel"),
    "fused_write": ("write_clear_kernel", "write_group_kernel",
                    "write_sum_kernel", "write_plan_kernel",
                    "write_chain_kernel"),
}


def _on_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(t, spans) -> bool:
    return any(s <= t < e for s, e in spans)


def digest(prof, n_batches: int) -> dict:
    """One sub-window's numbers (seconds, counts), from the profiler's
    events of `n_batches` facade calls, each inside an `APPLY_SPAN`."""
    dev, host, spans = [], [], []
    for e in prof.events():
        tr = e.time_range
        if _on_device(e):
            # the span's own mark on the device's timeline is no operation
            if e.name != APPLY_SPAN and not getattr(e, "is_user_annotation",
                                                    False):
                dev.append((e.name, tr.start, tr.end))
        elif e.name == APPLY_SPAN:
            spans.append((tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    spans.sort()
    lo = spans[0][0] if spans else 0.0
    hi = spans[-1][1] if spans else 0.0
    kernel_s = defaultdict(float)
    launches = 0
    for name, s, e in dev:
        kernel_s[name] += (e - s) / 1e6
        if not _is_copy(name):
            launches += 1
    busy = _union((max(s, lo), min(e, hi)) for _, s, e in dev
                  if e > lo and s < hi)
    busy_s = sum(e - s for s, e in busy) / 1e6
    syncs = sum(1 for name, s, _ in host
                if name in SYNC_CALLS and _inside(s, spans))
    runtime = sum(1 for name, _, _ in host if name.startswith("cu"))
    gaps = _idle_gaps(busy, lo, hi, host)
    return dict(batches=n_batches, span_s=(hi - lo) / 1e6, busy_s=busy_s,
                kernel_s=dict(kernel_s), launches=launches, syncs=syncs,
                runtime_events=runtime, gaps=gaps)


def _idle_gaps(busy, lo, hi, host) -> dict:
    """Seconds of device idle time in [lo, hi), by the innermost host
    operation running at the middle of each gap ("python" where none).
    One sweep: host events nest on the thread that records them, so the
    innermost open event is the top of a stack."""
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    events = sorted(host, key=lambda h: (h[1], -h[2]))
    out, stack, j = defaultdict(float), [], 0
    for s, e in gaps:
        mid = (s + e) / 2
        while j < len(events) and events[j][1] <= mid:
            while stack and stack[-1][2] <= events[j][1]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        out[stack[-1][0] if stack else "python"] += (e - s) / 1e6
    return dict(out)


def merge(digests) -> dict:
    """The sub-windows of one run summed."""
    out = dict(batches=0, span_s=0.0, busy_s=0.0, kernel_s=defaultdict(float),
               launches=0, syncs=0, runtime_events=0, gaps=defaultdict(float))
    for d in digests:
        for k in ("batches", "span_s", "busy_s", "launches", "syncs",
                  "runtime_events"):
            out[k] += d[k]
        for k in ("kernel_s", "gaps"):
            for name, v in d[k].items():
                out[k][name] += v
    for k in ("kernel_s", "gaps"):
        out[k] = dict(out[k])
    return out


def kernel_seconds(prof_sum: dict, library: str) -> float:
    """Device seconds of one library's kernels (by name, `KERNELS`)."""
    names = KERNELS[library]
    return sum(s for k, s in prof_sum["kernel_s"].items()
               if any(n in k for n in names))


def top(d: dict, n: int = 10) -> list:
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
