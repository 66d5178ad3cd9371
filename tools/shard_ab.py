#!/usr/bin/env python3
"""The single-shard store and the sharded store side by side in one
process, on one card, in turns.

    python3 tools/shard_ab.py [--log2-keys K] [--log2-ops N] [--rounds R]
                              [--out PATH]

Builds `KV(make_f2_config(2**K))` and `ShardedKV(make_f2_config(2**K / S),
S=4, lanes=4096)` (chip_smoke.py's sharded configuration) and loads both
with the same 2**K unique keys (default 22).  Then, for R rounds (default
4), runs YCSB-A, -B and -F of 2**N ops (default 17) each through the two
stores in turns (S=1, S=4, S=4, S=1), with the pressure scheduler on: ops/s
of each run (`chip_smoke.ycsb`), the host seconds spent inside the
scheduler, and routed rounds beyond one per batch.  Then a profiler window
of 8 YCSB-A batches each with the scheduler off: kernel launches and host
syncs per batch, device-busy ms per batch, wall ms per batch, and the host
ops with the most self time; and the launches of the router alone (one
`route` + `unroute` of a batch).  Prints one JSON line per measurement and
a last line with the per-mix medians, the aggregates (total ops over total
seconds of a store's runs) and their ratios S=4 / S=1.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
            "cudaStreamSynchronize", "cudaMemcpyAsync")


def timed_ycsb(cs, kv, mix, n_ops, zipf, rng):
    """(ops/s, scheduler seconds, extra routed rounds) of one YCSB run."""
    import torch
    spent = [0.0]
    inner = kv.maybe_compact

    def scheduler():
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
    kv.maybe_compact = scheduler
    r0 = getattr(kv, "rounds", None)
    try:
        rate, _ = cs.ycsb(kv, None, mix, n_ops, zipf, rng)
    finally:
        del kv.maybe_compact
    extra = 0 if r0 is None else kv.rounds - r0 - n_ops // cs.BATCH
    return rate, spent[0], extra


def window(cs, kv, zipf, rng, n_batches=8):
    """Launches, syncs, device-busy and wall ms per YCSB-A batch, scheduler
    off, and the top host ops by self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.workload import make_ops
    batches = [make_ops(rng, "A", zipf, cs.BATCH, kv.cfg.value_width)[:3]
               for _ in range(n_batches)]
    trigger, kv.trigger = kv.trigger, 2.0
    kv.apply(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for keys, ops, vals in batches:
            st, rv = kv.apply(keys, ops, vals)
            st.cpu(), rv.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kv.trigger = trigger
    dev, host = cs._device_rows(prof)
    counts = {k: c for k, _, c in host}
    return dict(launches_per_batch=counts.get("cudaLaunchKernel", 0) / n_batches,
                syncs_per_batch={k: counts.get(k, 0) / n_batches for k in SYNC_OPS},
                device_busy_ms_per_batch=sum(d for _, d, _ in dev) / n_batches * 1e3,
                wall_ms_per_batch=wall / n_batches * 1e3,
                top_host=[dict(name=k[:60], self_ms_per_batch=s / n_batches * 1e3,
                               calls_per_batch=c / n_batches)
                          for k, s, c in host[:12]])


def router_launches(skv, zipf, rng):
    """Kernel launches of one `route` + `unroute` of a batch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import shard_router
    dev = skv.device
    keys = torch.as_tensor(zipf.sample(rng, 8192).astype(np.int32), device=dev)
    ops = torch.ones_like(keys)
    vals = torch.zeros((keys.shape[0], skv.cfg.value_width), dtype=torch.int32,
                       device=dev)
    bmap = torch.as_tensor(skv.bucket_map, device=dev)
    shard_router.route(keys, ops, vals, skv.S, skv.lanes, bucket_map=bmap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sk, so, sv, rt = shard_router.route(keys, ops, vals, skv.S, skv.lanes,
                                            bucket_map=bmap)
        shard_router.unroute(rt, so, sv)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()}.get("cudaLaunchKernel", 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log2-keys", type=int, default=22)
    p.add_argument("--log2-ops", type=int, default=17)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("shard_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import KV, ShardedKV
    from repro_torch.kernels import build
    from repro_torch.workload import Zipf, make_f2_config

    build.build_all(["fused_probe", "fused_write", "probe"])
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit(dict(phase="device", nvidia_smi=cs.nvidia_smi_line()))
    n = 1 << a.log2_keys
    V = 25
    stores = {"S1": KV(make_f2_config(n), device="cuda"),
              "S4": ShardedKV(make_f2_config(n // cs.SHARDS), cs.SHARDS,
                              lanes=cs.SHARD_LANES, device="cuda")}
    perm = np.random.default_rng(cs.SEED).permutation(n).astype(np.int32)
    for name, kv in stores.items():
        t0 = time.perf_counter()
        cs.load_keys(kv, perm, V)
        torch.cuda.synchronize()
        emit(dict(phase="load", store=name, ops_per_s=n / (time.perf_counter() - t0)))
    zipf = Zipf(n, 0.99)
    rates = {(s, m): [] for s in stores for m in "ABF"}
    for r in range(a.rounds):
        for mix in "ABF":
            for name in ("S1", "S4", "S4", "S1"):
                rng = np.random.default_rng(1000 * r + ord(mix) + len(rates[name, mix]))
                rate, sched_s, extra = timed_ycsb(cs, stores[name], mix,
                                                  1 << a.log2_ops, zipf, rng)
                rates[name, mix].append(rate)
                emit(dict(phase="ycsb", round=r, mix=mix, store=name, ops_per_s=rate,
                          scheduler_s=sched_s, extra_rounds=extra))
    rng = np.random.default_rng(7)
    for name, kv in stores.items():
        emit(dict(phase="window", store=name, **window(cs, kv, zipf, rng)))
    emit(dict(phase="router", launches_per_batch=router_launches(stores["S4"], zipf, rng)))
    med = {m: {s: float(np.median(rates[s, m])) for s in stores} for m in "ABF"}
    # all of a store's runs of a mix as one: total ops over total seconds (a
    # run's ops/s depends on whether a compaction pass fell inside it)
    agg = {m: {s: len(rates[s, m]) / sum(1 / x for x in rates[s, m]) for s in stores}
           for m in "ABF"}
    summary = dict(phase="summary", log2_keys=a.log2_keys, log2_ops=a.log2_ops,
                   rounds=a.rounds, median_ops_per_s=med, aggregate_ops_per_s=agg,
                   ratio_s4_s1={m: med[m]["S4"] / med[m]["S1"] for m in "ABF"},
                   aggregate_ratio_s4_s1={m: agg[m]["S4"] / agg[m]["S1"] for m in "ABF"})
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(records + [summary], f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
