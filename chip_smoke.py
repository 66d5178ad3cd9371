#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU: the F2 store, then the
F2-paged serving engine with Granite-3-8B at full width.

    python3 chip_smoke.py            # the full run: 2**24 keys, 40 layers

Phases, each printing one JSON line:

  1. device   — the card's name and power limit (and nvidia-smi's raw line);
  2. build    — the three CUDA kernels compiled with nvcc for sm_90a, in
                parallel;
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
  6. serve    — Granite-3-8B (40 layers, d_model 4096, bf16 weights from
                `init_params` with SEED) through Engine(backend="paged"):
                16 requests, prompts of 16-256 tokens, 32 new tokens each,
                8 lanes, max_len 512, pages of 16 (16 hot, 272 cold);
                the paged-attention counter is zeroed before and read after
                and must be 40 x decode steps; demotions and cold reads
                must be > 0, every logit finite, every token < vocab;
  7. serve_profile — a profiler window over 8 full decodes of the loaded
                engine (8 new 16-token prompts): device busy/idle share,
                top kernels and host ops, host syncs per step;
  8. kernels  — paged_attention against its plain version on the serve
                run's live pools and table (its last state with all 8
                lanes active) and on edge cases (2e-5 float32,
                2e-2 bfloat16), timed beside its bound and
                scaled_dot_product_attention;
  9. serve_twins — the same requests through two float32 engines, 4 layers
                at full width, kernel against plain version: every decode's
                logits within TWIN_LOGITS_TOL, every token equal;
 10. the kernels line, the nvidia-smi line, and the final ok line.

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
# serving: Granite-3-8B at full width, random weights from SEED
SERVE_ARCH = "granite-3-8b"
SERVE_ENGINE = dict(max_batch=8, max_len=512, page_size=16)
SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 32
SERVE_PROMPT_MIN, SERVE_PROMPT_MAX = 16, 256
TWIN_LAYERS = 4
# float32 twins differ only in the attention's summation order (about one
# ulp per output); four layers and the tied 4096-wide logits projection
# keep that far below 1e-3 of a logit
TWIN_LOGITS_TOL = 1e-3
# H100 SXM data-sheet peaks (dense): HBM bytes/s and non-tensor 32-bit ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SECTOR = 32
L2_FLUSH_BYTES = 128 << 20          # > the H100's 50 MB L2


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
                                    "chain_slots_kernel"),
                    "paged_attention": ("paged_attention_kernel",)}


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
# serving: Granite-3-8B through the F2-paged engine
# ---------------------------------------------------------------------------

def serve_prompts(vocab_size, seed, n):
    """n prompts, lengths drawn from [SERVE_PROMPT_MIN, SERVE_PROMPT_MAX]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, int(rng.integers(
        SERVE_PROMPT_MIN, SERVE_PROMPT_MAX + 1))).astype(np.int32)
        for _ in range(n)]


def make_engine(cfg, model, device, interpret=False, keep_logits=False):
    """A paged `Engine` that also folds every decode's logits into a
    device-side finiteness flag and, with keep_logits, keeps them."""
    from repro_torch.serve.engine import Engine

    class CheckedEngine(Engine):
        def _paged_logits(self, toks, active):
            lg = super()._paged_logits(toks, active)
            f = lg.isfinite().all()
            self.finite = f if self.finite is None else self.finite & f
            if self.kept is not None:
                self.kept.append(lg)
            return lg

    eng = CheckedEngine(cfg, model, backend="paged", device=device,
                        interpret=interpret, **SERVE_ENGINE)
    eng.finite, eng.kept = None, ([] if keep_logits else None)
    return eng


def _submit(eng, prompts, new_tokens):
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_main(cfg, device, seed, records):
    """The serving main path: SERVE_REQUESTS requests through
    Engine(backend="paged") at the config's full width; the paged-attention
    launch counter is zeroed just before the run and read just after."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import transformer
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    eng = make_engine(cfg, model, device)
    _sync(device)
    t_init = time.perf_counter() - t0
    prompts = serve_prompts(cfg.vocab_size, seed, SERVE_REQUESTS)
    _submit(eng, prompts, SERVE_NEW_TOKENS)
    st = eng.pkv.state
    pa_ops.reset_launches()
    t0 = time.perf_counter()
    live = None
    while eng.queue or eng.active:         # Engine.run, keeping the last
        eng.step()                         # state with every lane active
        if len(eng.active) == eng.max_batch:
            live = tuple(t.clone() for t in (st.k_pool[0], st.v_pool[0],
                                             st.page_table, st.seq_lens))
    fin = eng.finished
    _sync(device)
    wall = time.perf_counter() - t0
    launches = pa_ops.launches["paged_attention"]
    rec = dict(
        phase="serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, engine=SERVE_ENGINE, requests=SERVE_REQUESTS,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        new_tokens_per_request=SERVE_NEW_TOKENS,
        weights_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        pool_bytes=st.k_pool.numel() * st.k_pool.element_size() * 2,
        pool_dtype=str(st.k_pool.dtype),
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card else "not measured",
        init_s=t_init, steps=eng.decode_steps, wall_s=wall,
        ms_per_step=wall / eng.decode_steps * 1e3,
        generated_tokens_per_s=SERVE_REQUESTS * SERVE_NEW_TOKENS / wall,
        demotions=eng.pkv.demotions, promotions=eng.pkv.promotions,
        cold_reads=int(st.cold_reads), launches=launches,
        live_lens=None if live is None else live[3].tolist())
    emit(records, rec)
    if on_card and launches != cfg.n_layers * eng.decode_steps:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected {cfg.n_layers} x {eng.decode_steps}")
    if not (eng.pkv.demotions > 0 and int(st.cold_reads) > 0):
        raise AssertionError("no demotion or no cold read: the tiering never ran")
    if len(fin) != SERVE_REQUESTS or not all(
            len(r.out_tokens) == SERVE_NEW_TOKENS
            and all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in fin):
        raise AssertionError("a request did not return its tokens below vocab_size")
    if not bool(eng.finite):
        raise AssertionError("non-finite logits")
    if live is None:
        raise AssertionError("no engine step had every lane active")
    return eng, rec, live


def serve_profile(eng, seed, records, n_steps=8):
    """A profiler window over n_steps decodes of the loaded engine, all
    max_batch lanes active (short prompts, to keep their prefill short):
    device busy and idle share, top device kernels, top host ops, and host
    syncs per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, eng.cfg.vocab_size, SERVE_PROMPT_MIN).astype(np.int32)
               for _ in range(eng.max_batch)]
    _submit(eng, prompts, n_steps + 4)
    eng.step()                  # admit and prefill every lane
    torch.cuda.synchronize()
    d0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.decode_steps - d0 != n_steps or len(eng.active) != eng.max_batch:
        raise AssertionError("the profile window was not n_steps full decodes")
    dev, host = [], []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            d = getattr(e, "self_device_time_total", None)
            if d is None:
                d = getattr(e, "self_cuda_time_total", 0)
            dev.append((e.key, d / 1e6, e.count))
        else:
            host.append((e.key, e.self_cpu_time_total / 1e6, e.count))
    busy = sum(d for _, d, _ in dev)
    dev.sort(key=lambda x: -x[1])
    host.sort(key=lambda x: -x[1])
    counts = {k: c for k, _, c in host}
    syncs = {k: counts.get(k, 0) / n_steps for k in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
        "aten::nonzero", "aten::_local_scalar_dense", "aten::item")}
    rec = dict(
        phase="serve_profile", steps=n_steps, lanes=eng.max_batch, wall_s=wall,
        ms_per_step=wall / n_steps * 1e3,
        device_busy_s=busy if dev else "not measured",
        device_idle_share=(1 - busy / wall) if dev else "not measured",
        launches_per_step=counts.get("cudaLaunchKernel", 0) / n_steps,
        syncs_per_step=syncs,
        paged_attention=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev
                         if "paged_attention_kernel" in k],
        top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:12]],
        top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:12]])
    emit(records, rec)
    return rec


def paged_cases(cfg, live, seed):
    """(name, (q, k_pool, v_pool, table, lengths)) of paged_attention: the
    main path's call on its live layer-0 pools, page table and lengths
    (`live`, kept by serve_main with every lane active) first, then the
    edge cases."""
    import torch
    kp, vp, page_table, seq_lens = live
    dev = kp.device
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Hkv, Dh = page_table.shape[0], cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // Hkv
    ps, mp = kp.shape[2], page_table.shape[1]
    table = page_table.clamp(min=0)
    lens = seq_lens + 1

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def full_table(b, n_pool, pages):
        return torch.randint(0, n_pool, (b, pages), generator=g, device=dev,
                             dtype=torch.int32)

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    q = rnd(B, Hkv, G, Dh, dtype=torch.bfloat16)
    n_pool = kp.shape[1]
    ft = full_table(B, n_pool, mp)
    small = dict(B=3, Hkv=2, G=4, Dh=64, ps=64, n_pool=16, mp=4)
    k3, v3 = rnd(2, 16, 64, 64), rnd(2, 16, 64, 64)
    k256, v256 = rnd(2, 12, 16, 256), rnd(2, 12, 16, 256)
    return [
        ("live", (q, kp, vp, table, lens)),
        ("live_bf16_pools", (q, kp.to(torch.bfloat16), vp.to(torch.bfloat16),
                             table, lens)),
        ("f32_kernels_shape", (rnd(3, 2, 4, 64), k3, v3,
                               full_table(3, small["n_pool"], small["mp"]),
                               i32([5, 130, 255]))),
        ("len_1", (q, kp, vp, ft, i32([1] * B))),
        ("page_boundary", (q, kp, vp, ft, i32([ps * (i + 1) for i in range(B)]))),
        ("full_table", (q, kp, vp, ft, i32([ps * mp] * B))),
        ("g1", (rnd(B, Hkv, 1, Dh, dtype=torch.bfloat16), kp, vp, table, lens)),
        ("dh256", (rnd(5, 2, 2, 256, dtype=torch.bfloat16), k256, v256,
                   full_table(5, 12, 5), i32([1, 16, 33, 64, 80]))),
        ("b_odd", (q[:5].contiguous(), kp, vp, table[:5].contiguous(),
                   lens[:5].contiguous())),
    ]


def paged_bound(q, k_pool, table, lens):
    """Least HBM bytes of one call on these inputs: the K and V rows of
    each sequence's valid pages (all max_pages pages where the length is
    <= 0), q, the table, the lengths and the output, each once."""
    B, Hkv, G, Dh = q.shape
    ps, mp = k_pool.shape[2], table.shape[1]
    ln = lens.cpu().numpy().astype(np.int64)
    pages = np.where(ln > 0, np.minimum(-(-ln // ps), mp), mp)
    kv = int(pages.sum()) * Hkv * ps * Dh * k_pool.element_size() * 2
    nbytes = kv + 2 * q.numel() * q.element_size() + table.numel() * 4 + B * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes", nbytes


def _library_call(q, k_pool, v_pool, table, lens):
    """scaled_dot_product_attention over K/V gathered dense beforehand (the
    gather, the mask and q's cast to the pools' dtype are not timed): one
    PyTorch call computing the same function, as a yardstick only."""
    import torch
    import torch.nn.functional as F
    B, Hkv, G, Dh = q.shape
    ps, mp = k_pool.shape[2], table.shape[1]
    S = ps * mp
    idx = table.long()
    k = k_pool[:, idx].transpose(0, 1).reshape(B, Hkv, S, Dh)
    v = v_pool[:, idx].transpose(0, 1).reshape(B, Hkv, S, Dh)
    mask = (torch.arange(S, device=q.device)[None] < lens[:, None])[:, None, None]
    qq = q.to(k_pool.dtype)
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def check_paged_kernel(cfg, live, seed, records):
    """paged_attention against its plain version on the card in every case
    (2e-5 where the output is float32, 2e-2 where it is bfloat16), each
    timed beside its bound and the library call; returns the live case."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref
    dev = live[0].device
    on_card = dev.type == "cuda"
    l2_flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                if on_card else None)
    per_case = []
    for name, args in paged_cases(cfg, live, seed + 3):
        got = pa_ops.paged_attention(*args)
        want = pa_ref.paged_attention_reference(*args)
        _sync(dev)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"paged_attention/{name}: {got.dtype} {got.shape} "
                                 f"vs {want.dtype} {want.shape}")
        tol = 2e-5 if got.dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"paged_attention/{name}: max |kernel - plain| = "
                                 f"{err} beyond atol = rtol = {tol}")
        q, kp, vp, table, lens = args
        rec = dict(case=name, B=q.shape[0], Hkv=q.shape[1], G=q.shape[2],
                   Dh=q.shape[3], page=kp.shape[2], max_pages=table.shape[1],
                   q_dtype=str(q.dtype), pool_dtype=str(kp.dtype),
                   max_abs_err=err, tol=tol)
        if on_card:
            lib = _library_call(*args)
            rec["ms"] = _time_ms(lambda: pa_ops.paged_attention(*args), 50)
            # device time with the L2 cache flushed before each call: on the
            # main path the other 39 layers' weights and pools pass through
            # L2 between two calls on one layer's pools
            rec["device_ms"] = _device_ms(
                lambda: (l2_flush.zero_(), pa_ops.paged_attention(*args)), 50,
                KERNEL_FUNCTIONS["paged_attention"])
            rec["plain_ms"] = _time_ms(
                lambda: pa_ref.paged_attention_reference(*args), 10)
            rec["library_ms"] = _time_ms(lib, 50)
            b = paged_bound(q, kp, table, lens)
            rec.update(bound_ms=b[0], bound_by=b[1], bound_bytes=b[2])
        per_case.append(rec)
    emit(records, dict(phase="kernels", kernel="paged_attention", cases=per_case))
    return per_case[0]


def serve_twins(cfg, device, seed, records):
    """The same requests through two engines at full width, TWIN_LAYERS
    deep, in float32, sharing weights: one runs the kernel, the other the
    plain version (`interpret=True`).  Every decode's logits must agree
    within TWIN_LOGITS_TOL and every token must be equal."""
    import torch
    from repro_torch.models import transformer
    cfg = dataclasses.replace(cfg, n_layers=TWIN_LAYERS, dtype="float32")
    model = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed + 4), device)
    twins = [make_engine(cfg, model, device, interpret=i, keep_logits=True)
             for i in (False, True)]
    prompts = serve_prompts(cfg.vocab_size, seed, SERVE_REQUESTS)
    for e in twins:
        _submit(e, prompts, SERVE_NEW_TOKENS)
    worst = torch.zeros((), device=device)     # max of |a-b| - (atol + rtol|b|)
    err = torch.zeros((), device=device)
    n_logits = 0
    t0 = time.perf_counter()
    while any(e.queue or e.active for e in twins):
        for e in twins:
            e.step()
        a, b = (e.kept for e in twins)
        if len(a) != len(b):
            raise AssertionError("the twins decoded different numbers of steps")
        for x, y in zip(a, b):
            d = (x - y).abs()
            err = torch.maximum(err, d.max())
            worst = torch.maximum(worst, (d - TWIN_LOGITS_TOL * (1 + y.abs())).max())
        n_logits += len(a)
        a.clear()
        b.clear()
    _sync(device)
    wall = time.perf_counter() - t0
    toks = [{r.rid: r.out_tokens for r in e.finished} for e in twins]
    counters = [(e.pkv.demotions, e.pkv.promotions, int(e.pkv.state.cold_reads))
                for e in twins]
    rec = dict(phase="serve_twins", arch=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=cfg.dtype, steps=n_logits,
               max_abs_logit_err=float(err), tol=TWIN_LOGITS_TOL,
               tokens_equal=toks[0] == toks[1], counters=counters[0], wall_s=wall)
    emit(records, rec)
    if float(worst) > 0:
        raise AssertionError(f"twin logits differ by {float(err)} beyond "
                             f"atol = rtol = {TWIN_LOGITS_TOL}")
    if toks[0] != toks[1] or len(toks[0]) != SERVE_REQUESTS:
        raise AssertionError("twin tokens differ")
    if counters[0] != counters[1]:
        raise AssertionError(f"twin tiering counters differ: {counters}")
    return rec


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
    from repro_torch.models.registry import get_config
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

    scfg = get_config(SERVE_ARCH)
    eng, serve_rec, live = serve_main(scfg, "cuda", SEED, records)
    launches["paged_attention"] = serve_rec["launches"]
    serve_profile(eng, SEED, records)
    summary["paged_attention"] = check_paged_kernel(scfg, live, SEED, records)
    del eng, live
    torch.cuda.empty_cache()
    serve_twins(scfg, "cuda", SEED, records)

    csrc = "src/repro_torch/kernels/{}/csrc/{}.cu"
    src = {"fused_probe": csrc.format("f2_probe", "fused_probe"),
           "fused_write": csrc.format("f2_probe", "fused_write"),
           "paged_attention": csrc.format("paged_attention", "paged_attention")}
    replaces = {"fused_probe": "src/repro/kernels/f2_probe/f2_probe.py:160",
                "fused_write": "src/repro/kernels/f2_probe/f2_probe.py:247",
                "paged_attention":
                    "src/repro/kernels/paged_attention/paged_attention.py:97"}
    kernels = [dict(name=k, route="cuda", source=src[k], replaces=replaces[k],
                    launches=launches[k], max_abs_err=s["max_abs_err"],
                    ms=s["ms"], device_ms=s["device_ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"], library_ms=s.get("library_ms"))
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
