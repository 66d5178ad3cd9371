#!/usr/bin/env python3
"""Run the F2 store's main path of one checkout of this repository.

    python3 tools/store_ab.py [ROOT] [--log2-keys K] [--log2-ops N] [--out PATH]

ROOT (default: this checkout) is a repository root whose `chip_smoke.py`
has `main_path` and `profile_window` (every tree since the store was
ported).  The script builds that tree's store kernels and runs its
`main_path` at 2**K keys (default 24, as `chip_smoke.py` runs it): the load
with its compactions, the two-phase read, the read-back and YCSB-A, -B and
-F of about 2**N ops each, every read checked.  Then it runs that tree's
`profile_window` over 8 YCSB-A batches, times that tree's `fused_probe`
kernel on each of its `probe_cases` (device ms per call, from the
profiler), and times the wrapper on the first case (B 8192 reads through
the hot index): ms per call by CUDA events, and host us per call (200
calls issued back to back, no synchronisation inside the window).  Last, a
second window of 8 YCSB-A batches with the pressure scheduler off: kernel
launches (`cudaLaunchKernel`) and host syncs per batch, device-busy ms per
batch, the device ms per batch of each kernel, copy and memset, and the
host ops with the most self time; then, without the profiler, wall ms per
batch of 32 YCSB-A batches and of 32 read-only batches (scheduler off),
and the wall seconds of one hot->cold compaction of 2**17 records.  It
prints one JSON line: the card, load and read-back ops/s, YCSB ops/s per
mix, the window's device-busy ms per batch and idle share, the store
kernels' device ms per batch, the probe's times and the second window.  To
compare two trees, run it in turns on one card (A, B, B, A): each run is
its own process, so the two trees' modules never meet.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
            "cudaStreamSynchronize", "cudaMemcpyAsync")


def quiet_window(cs, kv, n_keys, n_batches=8):
    """Launches, syncs and device ms per YCSB-A batch, scheduler off."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(cs.SEED + 3)
    zipf = Zipf(n_keys, 0.99)
    batches = [make_ops(rng, "A", zipf, cs.BATCH, kv.cfg.value_width)[:3]
               for _ in range(n_batches + 1)]
    trigger, kv.trigger = kv.trigger, 2.0
    kv.apply(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for keys, ops, vals in batches[1:]:
            st, rv = kv.apply(keys, ops, vals)
            st.cpu(), rv.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kv.trigger = trigger
    dev, host = cs._device_rows(prof)
    counts = {k: c for k, _, c in host}
    return dict(
        launches_per_batch=counts.get("cudaLaunchKernel", 0) / n_batches,
        syncs_per_batch={k: counts.get(k, 0) / n_batches for k in SYNC_OPS},
        wall_ms_per_batch=wall / n_batches * 1e3,
        device_busy_ms_per_batch=sum(d for _, d, _ in dev) / n_batches * 1e3,
        device_rows=[dict(name=k[:70], ms_per_batch=d / n_batches * 1e3,
                          calls_per_batch=c / n_batches) for k, d, c in dev],
        top_host=[dict(name=k[:60], self_ms_per_batch=d / n_batches * 1e3,
                       calls_per_batch=c / n_batches) for k, d, c in host[:20]])


def host_rates(cs, kv, n_keys, n_batches=32):
    """Wall ms per YCSB-A batch and per read-only batch with the scheduler
    off, and wall s of one hot->cold compaction of 2**17 records."""
    import numpy as np
    import torch
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(cs.SEED + 4)
    zipf = Zipf(n_keys, 0.99)
    mixed = [make_ops(rng, "A", zipf, cs.BATCH, kv.cfg.value_width)[:3]
             for _ in range(n_batches)]
    reads = [zipf.sample(rng, cs.BATCH).astype(np.int32) for _ in range(n_batches)]
    trigger, kv.trigger = kv.trigger, 2.0
    out = {}
    for name, run in (("ycsb_a", lambda: [kv.apply(*b) for b in mixed]),
                      ("read", lambda: [kv.read(k) for k in reads])):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        for st, v in res:
            st.cpu(), v.cpu()
        torch.cuda.synchronize()
        out[f"{name}_wall_ms_per_batch"] = (time.perf_counter() - t0) / n_batches * 1e3
    kv.trigger = trigger
    t0 = time.perf_counter()
    kv.compact_hot_cold(1 << 17)
    torch.cuda.synchronize()
    out["hot_cold_2e17_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?",
                   default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--log2-keys", type=int, default=24)
    p.add_argument("--log2-ops", type=int, default=21)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("store_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.workload import make_f2_config

    build.build_all(["fused_probe", "fused_write", "probe"])
    n_keys = 1 << a.log2_keys
    cfg = make_f2_config(n_keys, engine="fused")
    kv, rec = cs.main_path(cfg, "cuda", n_keys, 1 << a.log2_ops, cs.SEED)
    records = []
    cs.profile_window(kv, n_keys, cs.SEED, records)
    import numpy as np
    from repro_torch.kernels.f2_probe import ops as probe_ops
    cases = cs.probe_cases(kv, np.random.default_rng(cs.SEED + 1), n_keys)
    probe_device_ms = {
        name: cs._device_ms(lambda: probe_ops.fused_probe(*args, **kw), 20,
                            cs.KERNEL_FUNCTIONS["fused_probe"])
        for name, args, kw in cases}
    _, args, kw = cases[0]

    def call():
        probe_ops.fused_probe(*args, **kw)

    wrapper_ms = cs._time_ms(call, 200)
    quiet = quiet_window(cs, kv, n_keys)
    quiet.update(host_rates(cs, kv, n_keys))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    prof = records[-1]
    batches = prof["batches"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = dict(root=root, card=smi, n_keys=n_keys,
               load_ops_per_s=rec["load_ops_per_s"],
               readback_ops_per_s=rec["readback_ops_per_s"],
               ycsb_ops_per_s=rec["ycsb_ops_per_s"],
               window_wall_ms_per_batch=prof["wall_s"] / batches * 1e3,
               device_busy_ms_per_batch=prof["device_busy_s"] / batches * 1e3,
               device_idle_share=prof["device_idle_share"],
               store_kernels_ms_per_batch={
                   r["name"]: r["s"] / batches * 1e3 for r in prof["f2_kernels"]},
               fused_probe_wrapper_ms=wrapper_ms, fused_probe_host_us=host_us,
               fused_probe_device_ms=probe_device_ms, quiet_window=quiet)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
