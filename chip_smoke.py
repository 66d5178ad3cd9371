#!/usr/bin/env python3
"""Drive the PyTorch port of the F2 store on one CUDA GPU.

    python3 chip_smoke.py            # the full run: 2**24 keys

Phases, each printing one JSON line:

  1. device   — the card's name and power limit (and nvidia-smi's raw line);
  2. build    — both CUDA kernels compiled with nvcc for sm_90a;
  3. main     — `KV(cfg, device="cuda")` at the paper's YCSB shape (8-byte
                keys, 100-byte values, Zipf 0.99, 10% memory budget): load
                2**24 unique keys in upsert batches of 8192 with hot->cold
                compaction and chunk-log GC firing, one cold->cold pass,
                read every key back against the numpy expectation, then
                YCSB-A, -B and -F (~2**21 ops each) with every read checked;
                the kernels' launch counters are zeroed before and read
                after, and both must be > 0;
  4. kernels  — each kernel against its plain PyTorch version on the card,
                bit for bit, on the loaded store at the main path's shapes
                (B = 8192 batches, B = compact_batch compaction probes) in
                every mode the store uses, timed with CUDA events;
  5. twins    — the same op stream at 2**20 keys through engine="fused" and
                engine="fused_ref" on the card, every F2State leaf equal
                after each phase;
  6. the kernels line, the nvidia-smi line, and the final ok line.

Any mismatch, failed build or failed launch raises, and the script exits
non-zero.  It needs a CUDA device and the repository's `src/` next to it.
`--out PATH` also writes every phase's record to a JSON file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8192
SEED = 0
TWIN_LOG2_KEYS = 20
# H100 SXM data-sheet peaks (dense): HBM bytes/s and non-tensor 32-bit ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SECTOR = 32


def emit(records, rec):
    records.append(rec)
    print(json.dumps(rec), flush=True)


def val_of(keys, V):
    """The value each key is loaded with (deterministic, no storage)."""
    k = np.asarray(keys, np.int64)[:, None]
    return ((k * 2654435761 + np.arange(V) * 40503) % (2**31 - 1)).astype(np.int32)


def unmix32(h):
    """Inverse of the store's murmur3 finalizer (uint32 in, int32 keys out):
    keys whose hash is chosen, e.g. keys that all land on one slot."""
    x = np.asarray(h, np.uint64) & np.uint64(0xFFFFFFFF)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(pow(0x846CA68B, -1, 2**32))) & m
    x ^= (x >> np.uint64(15)) ^ (x >> np.uint64(30))
    x = (x * np.uint64(pow(0x7FEB352D, -1, 2**32))) & m
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def load_keys(kv, keys_perm, V):
    for b in range(0, len(keys_perm), BATCH):
        k = keys_perm[b:b + BATCH]
        st, _ = kv.upsert(k, val_of(k, V))
        if not bool((st == 1).all()):
            raise AssertionError(f"upsert batch {b // BATCH}: status != OK")


def read_back(kv, n_keys, V):
    from repro_torch import ST_OK
    for b in range(0, n_keys, BATCH):
        k = np.arange(b, min(b + BATCH, n_keys), dtype=np.int32)
        st, v = kv.read(k)
        st, v = st.cpu().numpy(), v.cpu().numpy()
        if not (np.all(st == ST_OK) and np.array_equal(v, val_of(k, V))):
            bad = np.flatnonzero((st != ST_OK) | np.any(v != val_of(k, V), 1))
            raise AssertionError(f"read-back: {bad.size} keys wrong, e.g. {k[bad[:8]]}")


def ycsb(kv, expect, workload, n_ops, zipf, rng):
    """One YCSB mix through kv.apply.  With an `expect` array every read is
    checked against it (the pre-batch values) and it is then updated.
    Returns (ops/s over apply + result transfer, the per-batch outputs)."""
    from repro_torch import OP_READ, OP_RMW, OP_UPSERT, ST_OK
    from repro_torch.workload import make_ops
    import torch
    V = kv.cfg.value_width
    t_apply = 0.0
    outs = []
    for _ in range(0, n_ops, BATCH):
        keys, ops, vals, _ = make_ops(rng, workload, zipf, BATCH, V)
        t0 = time.perf_counter()
        st, rv = kv.apply(keys, ops, vals)
        st, rv = st.cpu().numpy(), rv.cpu().numpy()
        if kv.device.type == "cuda":
            torch.cuda.synchronize()
        t_apply += time.perf_counter() - t0
        outs.append((st, rv))
        if expect is None:
            continue
        if not np.all(st[ops != 0] == ST_OK):
            raise AssertionError(f"YCSB-{workload}: a status is not OK")
        r = ops == OP_READ
        if not np.array_equal(rv[r], expect[keys[r]]):
            raise AssertionError(f"YCSB-{workload}: a read returned a wrong value")
        u = np.flatnonzero(ops == OP_UPSERT)
        if u.size:   # the last upsert of each key wins
            _, first_rev = np.unique(keys[u][::-1], return_index=True)
            last = u[::-1][first_rev]
            expect[keys[last]] = vals[last]
        m = ops == OP_RMW
        np.add.at(expect, keys[m], vals[m])
    return n_ops / t_apply, outs


def cold_cold(kv, n_keys):
    """Cold->cold never fires during the load (the cold log stays < 80%
    full), so one pass runs through the entry point the trigger uses.  It
    covers the oldest n_keys/64 records: each step appends ~compact_batch
    chunk versions and chunk-log GC only runs between batches, so a default
    10% pass would wrap the chunk log over live chunks (the reference's
    policy does the same on the same stream)."""
    kv.compact_cold_cold(n_records=max(n_keys // 64, kv.compact_batch))


def main_path(cfg, device, n_keys, n_ops, seed):
    """Load, cold->cold, read back, YCSB A/B/F; returns the KV."""
    import torch
    from repro_torch import KV
    from repro_torch.workload import Zipf
    from repro_torch.kernels.f2_probe import ops
    V = cfg.value_width
    rng = np.random.default_rng(seed)
    kv = KV(cfg, device=device)
    launches = {}

    def mark(phase):   # launch counts per phase, as deltas
        launches[phase] = {k: v - sum(d[k] for d in launches.values())
                           for k, v in ops.launches.items()}

    t0 = time.perf_counter()
    load_keys(kv, rng.permutation(n_keys).astype(np.int32), V)
    cold_cold(kv, n_keys)
    kv.check_invariants()
    if device != "cpu":
        torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    mark("load")
    t0 = time.perf_counter()
    read_back(kv, n_keys, V)
    t_read = time.perf_counter() - t0
    mark("readback")
    expect = val_of(np.arange(n_keys), V)
    zipf = Zipf(n_keys, 0.99)
    rates = {}
    for wl in "ABF":
        rates[wl], _ = ycsb(kv, expect, wl, n_ops, zipf, rng)
        mark(f"ycsb_{wl}")
    kv.check_invariants()
    return kv, dict(load_s=t_load, load_ops_per_s=n_keys / t_load,
                    readback_s=t_read, readback_ops_per_s=n_keys / t_read,
                    ycsb_ops_per_s=rates, launches_by_phase=launches,
                    compactions=dict(kv.compaction_counts),
                    io=kv.io_stats())


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_abs_err(a_out, b_out):
    import torch
    err = 0
    for a, b in zip(a_out, b_out):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


KERNEL_FUNCTIONS = {"fused_probe": ("fused_probe_kernel",),
                    "fused_write": ("write_lanes_kernel", "append_offsets_kernel",
                                    "chain_slots_kernel")}


def _device_ms(fn, reps, names):
    """Device time per call of the named CUDA functions, from the profiler
    (CUDA events around a short kernel also time the wrapper's host side,
    which can be longer than the kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and any(n in e.key for n in names))
    return us / 1e3 / reps if us else "not measured"


def probe_cases(kv, rng, n_keys):
    """(name, args, kwargs) of fused_probe at the main path's shapes."""
    import torch
    from repro_torch.core import cold_index, hybrid_log, probe_engine
    from repro_torch.core.types import IoStats
    st, cfg, dev = kv.state, kv.cfg, kv.device
    from repro_torch.workload import Zipf
    zipf = Zipf(n_keys, 0.99)
    q = np.concatenate([zipf.sample(rng, BATCH - 512),
                        n_keys + rng.integers(0, 1 << 20, 512)]).astype(np.int32)
    keys = torch.as_tensor(q, device=dev)
    act = torch.ones(BATCH, dtype=torch.bool, device=dev)
    hot, rc, cold = st.hot, st.rc, st.cold
    hot_cols = (hot.key, hot.val, hot.prev, hot.meta)
    rc_cols = (rc.key, rc.val, rc.prev, rc.meta)
    hb = hybrid_log.head_addr(hot, cfg.hot_mem)
    lower = hot.begin.expand(BATCH).contiguous()
    base = (keys, st.hot_index, lower, act, hb, *hot_cols, *rc_cols)
    kw = dict(chain_max=cfg.chain_max, rc_match=True, has_rc=True, probe_index=True)
    cases = [("read_index", base, kw),
             ("liveness_rc_match_false", base, dict(kw, rc_match=False))]
    # cold chains: heads mode, no read cache
    entries, _ = cold_index.find_entries(st.cold_idx, cfg, keys, act,
                                         IoStats.zeros(dev))
    drc = probe_engine.dummy_rc(cfg.value_width, dev)
    cold_args = (keys, entries, cold.begin.expand(BATCH).contiguous(), act,
                 hybrid_log.head_addr(cold, cfg.cold_mem),
                 cold.key, cold.val, cold.prev, cold.meta,
                 drc.key, drc.val, drc.prev, drc.meta)
    cases.append(("cold_heads", cold_args, dict(kw, has_rc=False, probe_index=False)))
    # compaction liveness (target mode) over the oldest hot and cold frontiers
    Bc = kv.compact_batch
    for name, log, cols, index_mode in (("hot_cold_target", hot, hot_cols, True),
                                        ("cold_cold_target", cold, None, False)):
        addrs = log.begin + torch.arange(Bc, dtype=torch.int32, device=dev)
        k, _, _, meta = hybrid_log.gather(log, addrs)
        m = (addrs < log.tail) & ((meta & 2) == 0)
        if index_mode:
            args = (k, st.hot_index, addrs, m, hb, *cols, *rc_cols)
            kwt = dict(kw, rc_match=False, target=addrs)
        else:
            ent, _ = cold_index.find_entries(st.cold_idx, cfg, k, m, IoStats.zeros(dev))
            args = (k, ent, addrs, m, hybrid_log.head_addr(cold, cfg.cold_mem),
                    cold.key, cold.val, cold.prev, cold.meta,
                    drc.key, drc.val, drc.prev, drc.meta)
            kwt = dict(kw, has_rc=False, probe_index=False, target=addrs)
        cases.append((name, args, kwt))
    # an odd batch
    cases.append(("odd_B77", (keys[:77], st.hot_index, lower[:77], act[:77],
                              hb, *hot_cols, *rc_cols), kw))
    return cases


def write_cases(kv, rng, n_keys):
    """(name, args, kwargs) of fused_write at the main path's shapes."""
    import torch
    from repro_torch import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT
    from repro_torch.core import hybrid_log
    st, cfg, dev = kv.state, kv.cfg, kv.device
    V = cfg.value_width
    E = cfg.hot_index_size

    def mk(keys, ops):
        keys = np.asarray(keys, np.int32)
        vals = rng.integers(-2**31, 2**31, (len(keys), V), dtype=np.int64).astype(np.int32)
        return (torch.as_tensor(keys, device=dev),
                torch.as_tensor(np.asarray(ops, np.int32), device=dev),
                torch.as_tensor(vals, device=dev))

    B = BATCH
    mixed = mk(rng.integers(0, n_keys + n_keys // 8, B),
               rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                          p=[.25, .35, .25, .15]))
    dup = mk(np.repeat(rng.integers(0, n_keys, B // 16), 16)[rng.permutation(B)],
             rng.choice([OP_UPSERT, OP_RMW, OP_DELETE], B))
    collide = unmix32(np.uint64(12345) + np.arange(B // 8, dtype=np.uint64) * np.uint64(E))
    coll = mk(np.concatenate([collide] * 8),
              rng.choice([OP_UPSERT, OP_RMW, OP_DELETE], B))
    rad = mk(np.repeat(rng.integers(0, n_keys, B // 6), 6),
             np.tile([OP_DELETE, OP_RMW, OP_RMW, OP_UPSERT, OP_DELETE, OP_RMW], B // 6))
    pure = mk(np.concatenate([rng.integers(0, n_keys, B // 2),
                              n_keys + rng.integers(0, n_keys, B // 2)]),
              np.full(B, OP_RMW))
    hot, rc = st.hot, st.rc
    tail = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    bounds = (st.hot_index, hot.begin, hybrid_log.head_addr(hot, cfg.hot_mem),
              hybrid_log.read_only_addr(hot, cfg.hot_mem, cfg.hot_mutable_frac),
              hot.tail)
    kw = dict(chain_max=cfg.chain_max)
    cases = []
    for name, (k, o, v) in (("mixed", mixed), ("duplicate_keys", dup),
                            ("all_colliding_slot", coll),
                            ("rmw_after_delete", rad), ("pure_rmw", pure)):
        cases.append((name, (k, o, v, *bounds, *tail), kw))
    k, o, v = mixed
    cases.append(("odd_B8191", (k[:8191], o[:8191], v[:8191], *bounds, *tail), kw))
    cases.append(("odd_B77", (k[:77], o[:77], v[:77], *bounds, *tail), kw))
    return cases


def probe_bound(args, kw, out):
    """Least HBM bytes of one fused_probe call on these inputs (sector
    granular): lane inputs once, one index sector per lane, three record
    sectors (key, prev, meta) per hop, the value row of each hit, the
    outputs once."""
    keys = args[0]
    V = args[6].shape[1]
    B = keys.shape[0]
    found, _, _, _, _, hops, _, _ = out
    lane_in = B * (4 + 4 + 1 + (4 if kw.get("target") is not None else 0))
    heads = B * (SECTOR if kw["probe_index"] else 4)
    walk = int(hops.sum()) * 3 * SECTOR
    hit = int(found.sum()) * -(-4 * V // SECTOR) * SECTOR
    outs = B * (1 + 4 + 4 + 4 * V + 4 + 4 + 4 + 1)
    nbytes = lane_in + heads + walk + hit + outs
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes", nbytes, 0


def write_bound(args, out):
    """Least time of one fused_write call: bytes as for the probe (lane
    inputs, index sector, walk sectors, hit rows, RC-head sectors, outputs)
    against the compares the function needs, not the kernel's all-pairs
    scan: grouping the batch by key and the appends by slot takes two
    sorts of B lanes, B * ceil(log2 B) compares each, at the non-tensor
    32-bit peak."""
    vals = args[2]
    B, V = vals.shape
    found, hops, heads = out[6], out[16], out[14]
    rc_heads = int(((heads >= 0) & ((heads & (1 << 30)) != 0)).sum())
    nbytes = (B * (4 + 4 + 4 * V + SECTOR) + int(hops.sum()) * 3 * SECTOR
              + int(found.sum()) * -(-4 * V // SECTOR) * SECTOR
              + rc_heads * 2 * SECTOR + B * (10 * 1 + 8 * 4 + 4 * V))
    n_ops = 2 * B * max(1, (B - 1).bit_length())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, n_ops)


def check_kernels(kv, n_keys, seed, records):
    """Hold each kernel bit-exact against its plain version on the loaded
    store (and time both, on a card); returns {kernel: summary of its
    main-shape case}."""
    import torch
    from repro_torch.kernels.f2_probe import ops, ref
    rng = np.random.default_rng(seed + 1)
    summary = {}
    for kname, cases, kern, plain in (
            ("fused_probe", probe_cases(kv, rng, n_keys), ops.fused_probe,
             lambda *a, **k: ref.fused_probe_body(*a, early_exit=True, **k)),
            ("fused_write", write_cases(kv, rng, n_keys), ops.fused_write,
             lambda *a, **k: ref.fused_write_body(*a, early_exit=True, **k))):
        per_case = []
        for name, args, kw in cases:
            got = kern(*args, **kw)
            want = plain(*args, **kw)
            if kv.device.type == "cuda":
                torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{kname}/{name}: max |kernel - plain| = {err}")
            rec = dict(case=name, B=int(args[0].shape[0]), max_abs_err=err)
            if kv.device.type == "cuda":
                rec["ms"] = _time_ms(lambda: kern(*args, **kw), 20)
                rec["device_ms"] = _device_ms(lambda: kern(*args, **kw), 20,
                                              KERNEL_FUNCTIONS[kname])
                rec["plain_ms"] = _time_ms(lambda: plain(*args, **kw), 3)
                if kname == "fused_probe":
                    b = probe_bound(args, kw, got)
                else:
                    b = write_bound(args, got)
                rec.update(bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
                           bound_ops=b[3])
            per_case.append(rec)
        emit(records, dict(phase="kernels", kernel=kname, cases=per_case))
        summary[kname] = per_case[0]   # the main-path case (read / mixed)
    return summary


# ---------------------------------------------------------------------------
# where the time goes: a profiler window over YCSB-A batches
# ---------------------------------------------------------------------------

def profile_window(kv, n_keys, seed, records, n_batches=8):
    """Device busy time, by kernel, over a few YCSB-A batches of the loaded
    store, against the host wall time of the same window (which includes
    the profiler's own host overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(seed + 2)
    zipf = Zipf(n_keys, 0.99)
    batches = [make_ops(rng, "A", zipf, BATCH, kv.cfg.value_width)[:3]
               for _ in range(n_batches)]
    kv.apply(*batches[0])        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for keys, ops_, vals in batches:
            st, rv = kv.apply(keys, ops_, vals)
            st.cpu(), rv.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = []
    host = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            # device-side rows only (kernels, copies, memsets): CPU-op rows
            # repeat the device time of the kernels they launch
            d = getattr(e, "self_device_time_total", None)
            if d is None:
                d = getattr(e, "self_cuda_time_total", 0)
            dev.append((e.key, d / 1e6, e.count))
        else:
            host.append((e.key, e.self_cpu_time_total / 1e6, e.count))
    busy = sum(d for _, d, _ in dev)
    dev.sort(key=lambda x: -x[1])
    host.sort(key=lambda x: -x[1])
    emit(records, dict(
        phase="profile", workload="A", batches=n_batches, batch=BATCH,
        wall_s=wall, device_busy_s=busy if dev else "not measured",
        device_idle_share=(1 - busy / wall) if dev else "not measured",
        f2_kernels=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev
                    if any(n in k for f in KERNEL_FUNCTIONS.values() for n in f)],
        top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:10]],
        top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:10]]))


# ---------------------------------------------------------------------------
# twins: the kernels' engine and the plain engine on one op stream
# ---------------------------------------------------------------------------

def twin_parity(cfg, device, n_keys, n_ops, seed, records):
    import torch
    from repro_torch import KV, interop
    from repro_torch.workload import Zipf
    twins = {e: KV(dataclasses.replace(cfg, engine=e), device=device)
             for e in ("fused", "fused_ref")}
    V = cfg.value_width

    def same_state(ctx):
        a, b = twins["fused"].state, twins["fused_ref"].state
        la, lb = interop.state_leaves(a), interop.state_leaves(b)
        if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
            raise AssertionError(f"twins diverged after {ctx}")
        if twins["fused"].compaction_counts != twins["fused_ref"].compaction_counts:
            raise AssertionError(f"twin compaction counts differ after {ctx}")

    perm = np.random.default_rng(seed).permutation(n_keys).astype(np.int32)
    for kv in twins.values():
        load_keys(kv, perm, V)
        cold_cold(kv, n_keys)
    same_state("load")
    for kv in twins.values():
        read_back(kv, n_keys, V)
    same_state("read-back")
    zipf = Zipf(n_keys, 0.99)
    for wl in "ABF":
        outs = {}
        for e, kv in twins.items():
            outs[e] = ycsb(kv, None, wl, n_ops, zipf,
                           np.random.default_rng(seed + ord(wl)))[1]
        for (s1, v1), (s2, v2) in zip(outs["fused"], outs["fused_ref"]):
            if not (np.array_equal(s1, s2) and np.array_equal(v1, v2)):
                raise AssertionError(f"twin statuses/values differ in YCSB-{wl}")
        same_state(f"YCSB-{wl}")
    for kv in twins.values():
        kv.check_invariants()
    emit(records, dict(phase="twins", n_keys=n_keys, ops_per_mix=n_ops,
                       leaves=len(interop.state_leaves(twins["fused"].state)),
                       compactions=twins["fused"].compaction_counts,
                       bit_exact=True))


# ---------------------------------------------------------------------------

def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log2-keys", type=int, default=24)
    p.add_argument("--log2-ops", type=int, default=21,
                   help="YCSB ops per mix on the main path")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.workload import make_f2_config

    records = []
    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit(records, dict(phase="device", name=name, nvidia_smi=smi,
                       count=torch.cuda.device_count(),
                       torch=torch.__version__, cuda=torch.version.cuda))

    t_build = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
             for k, v in build.build_log.items()}
    emit(records, dict(phase="build", seconds=t_build, ptxas=ptxas))

    n_keys = 1 << a.log2_keys
    cfg = make_f2_config(n_keys, engine="fused")
    ops.reset_launches()
    kv, main_rec = main_path(cfg, "cuda", n_keys, 1 << a.log2_ops, SEED)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    emit(records, dict(phase="main", n_keys=n_keys,
                       reduced=f"2**{a.log2_keys} keys for the paper's 250M",
                       config=dataclasses.asdict(cfg), launches=launches,
                       peak_mem_bytes=torch.cuda.max_memory_allocated(),
                       **main_rec))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {k}")

    summary = check_kernels(kv, n_keys, SEED, records)
    profile_window(kv, n_keys, SEED, records)
    del kv
    torch.cuda.empty_cache()
    twin_parity(make_f2_config(1 << TWIN_LOG2_KEYS), "cuda",
                1 << TWIN_LOG2_KEYS, 1 << (a.log2_ops - 4), SEED, records)

    src = {"fused_probe": "src/repro_torch/kernels/f2_probe/csrc/fused_probe.cu",
           "fused_write": "src/repro_torch/kernels/f2_probe/csrc/fused_write.cu"}
    replaces = {"fused_probe": "src/repro/kernels/f2_probe/f2_probe.py:160",
                "fused_write": "src/repro/kernels/f2_probe/f2_probe.py:247"}
    kernels = [dict(name=k, route="cuda", source=src[k], replaces=replaces[k],
                    launches=launches[k], max_abs_err=s["max_abs_err"],
                    ms=s["ms"], device_ms=s["device_ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"], library_ms=None)
               for k, s in summary.items()]
    kline = dict(kernels=kernels)
    records.append(kline)
    records.append(dict(phase="total", seconds=time.perf_counter() - t_all))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps(dict(phase="total", seconds=records[-1]["seconds"])))
    print(json.dumps(kline))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
