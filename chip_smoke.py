#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU: the F2 store, single-shard,
sharded over four stores (made durable, killed and recovered), spilled 8x
to host memory through its host tier, and replicated twice with the
session service on top, the F2-paged serving engine with Granite-3-8B at
full width, Granite-3-8B's training at full width, then RWKV-6-7B's
serving, prefill and training at full width.

    python3 chip_smoke.py            # the full run: 2**24 keys, models at full width

Phases, each printing one JSON line:

  1. device   — the card's name and power limit (and nvidia-smi's raw line);
  2. build    — the seven CUDA sources compiled with nvcc for sm_90a, in
                parallel; then (build_tc) each tensor-core flash kernel's
                registers and spills from ptxas, and its HMMA / HGMMA
                instruction count from cuobjdump where the toolkit has it;
  3. kernels  — the flash-attention forward and gradient against autograd
                through their plain version at the train phase's shape and
                edge cases (forward 2e-5 f32 / 2e-2 bf16; gradients 1e-4
                f32, 2e-2 of the largest reference gradient in bf16), each
                case on its route (bf16 at Dh 16, 32, 64, 112, 128, 256 on
                the tensor-core kernels, the rest on the CUDA-core ones, as
                the per-route counters must show), key lengths Tk other than
                the query length among them (Whisper-large's cross-attention,
                causal with either longer, rows that see no key; dK and dV of
                keys no query sees exactly 0), two gradient calls bit
                for bit equal, timed beside their bounds and
                scaled_dot_product_attention; then
                the WKV forward and gradient against autograd through the
                plain recurrence at RWKV-6's train shape (B*H 128, T 4096),
                its decode shape (B*H 512, T 1, from a state), its prefill
                shape (B*H 512, T 1024) and edge cases (y and state 2e-3 abs
                and rel; each gradient 2e-3 of its largest reference
                magnitude; two forward and two gradient calls bit for bit
                equal), timed beside their bounds
                (first, while the profiler is fresh and the card's memory
                free);
  4. main     — `KV(cfg, device="cuda")` at the paper's YCSB shape (8-byte
                keys, 100-byte values, Zipf 0.99, 10% memory budget): load
                2**24 unique keys in upsert batches of 8192 with hot->cold
                compaction and chunk-log GC firing, one cold->cold pass
                inside a two-phase read of 8192 keys (`store.read_begin`
                snapshots their chain heads through the first-hop probe
                kernel; `read_finish` after the pass must read every value),
                read every key back against the numpy expectation, then
                YCSB-A, -B and -F (~2**21 ops each) with every read checked;
                the kernels' launch counters are zeroed before and read
                after, and all must be > 0;
  5. kernels  — each store kernel against its plain PyTorch version on the
                card, bit for bit and a second call bit for bit equal, on the
                loaded store at the main path's shapes (B = 8192 batches,
                B = compact_batch compaction probes) in every mode the store
                uses (fused_write also on YCSB-A's Zipf-0.99 keys and on one
                key in every lane with wrapping sums), timed with CUDA
                events and the profiler (device ms per kernel of a call);
                fused_probe also with its wrapper's host us per call;
                the first-hop probe also against fused_probe's chain heads;
  6. profile  — a profiler window over 8 YCSB-A batches;
  7. twins    — the same op stream at 2**20 keys through engine="fused" and
                engine="fused_ref" on the card, every F2State leaf equal
                after each phase;
  7a. sharded — `ShardedKV(make_f2_config(2**22), S=4, lanes=4096)` over
                the same 2**24 keys (the paper's S8.1 split per shard):
                load with masked compactions firing, a two-phase read of
                BATCH routed keys across a masked cold->cold pass (one
                first-hop probe launch for all shards), read every key back,
                YCSB-A, -B and -F (2**20 ops each by default) with every
                read checked; ops/s beside the main phase's, deferral rounds,
                compactions per shard, peak memory, and wrapper calls and
                host syncs per routed round with the scheduler off, which
                must equal a KV batch's (the kernels take all shards in one
                launch); then sharded_profile (8 YCSB-A batches);
  7b. kernels_sharded — fused_probe, fused_write and the first-hop probe
                over the loaded sharded store's shard axis (routed batches,
                compaction frontiers, one hot key in every lane of every
                shard, odd widths, S x 8192 and S x 2**18 = 2**20 probe
                lanes): bit for bit against the plain version, a second
                call, and S single-shard calls on the shards' slices; timed
                (CUDA events, profiler, L2 flushed) beside the single-shard
                bound summed over the shards;
  7b'. durable — that store wrapped in DurableKV (fsync "batch"; the
                free disk checked first, the phase fails without room):
                wrapper calls per durable round (scheduler off) asserted
                equal to a plain round's; YCSB-A, 2**18 ops durable and
                2**18 plain (the WAL detached) in four turns each, every
                read checked: ops/s of each, fsync ms per batch (median,
                max), WAL bytes per batch, device-to-host copies per logged
                batch (0 for host arrays; 1 a CUDA-tensor record, asserted);
                a blocking snapshot (capture stall, save s, bytes); 2**17
                ops, a migrate() of the first 4 of 256 buckets one shard
                on (1/64 of the keys, one MAP record), 2**16 ops; the
                wrapper abandoned (a kill);
                recover() into a fresh ShardedKV on the card (restore and
                replay s, records, peak memory); every key read back
                against the expectation; 2**17 ops into the recovered and
                the live store, statuses and values bit-equal; invariants;
  7b''. durable_twins — make_session_service(ServiceConfig(n_shards=4,
                n_replicas=2, durability=DurabilityConfig(dir,
                snapshot_every_rounds=16))) and a twin without durability
                at 2**20 keys, loaded through sessions (the cadence
                snapshots); a drop, 2**15 ops, a migration;
                rebuild_replica(1) against the twin's resync(1) (seconds,
                records; no drained record from the healthy replica, its
                rows untouched; replicas 0 and 1 read back equal); then
                `migrate.after_flip` armed, a crashed migration, recover():
                replicas byte-identical, 2**15 more ops bit-equal to the
                twin;
  7c. sharded_twins — the sharded store at 2**20 keys through "fused" and
                "fused_ref": every leaf equal after each phase, a forced
                migrate() of an edited bucket map, every key read back;
  7c'. host_tier — `KV(host_config(2**22))`: make_f2_config(2**22) with
                the host tier on, a device cold ring of 2**19 (n/8, the
                reference's spill-8x budget), chunks of 16 records, 16,384
                cache rows (2 x BATCH); 2**22 unique keys loaded in
                permuted order (spill >= 4 and a floor > 0 asserted),
                YCSB-B then YCSB-A (Zipf 0.99, 2**18 ops each) with every
                read checked, a cold->cold pass of n/64 records under the
                tier inside a two-phase read (`plan_finish` pre-faults its
                walks), a uniform read-back of 2**18 keys; load and YCSB
                ops/s, spill, demotions, promotions, prefetch hits, contract
                splits, host-store against device bytes, per batch the
                wrapper calls, `ensure` rounds, the manager's host syncs and
                H2D / D2H bytes; a profile window of 8 YCSB-B batches
                (device idle share, launches per batch, the share of wall
                time in the floor-aware walk's per-hop loop);
  7c''. host_twins — at 2**19 keys: a spilled KV and an all-device KV (both
                on the kernels) loaded and fed 2**16 uniform mixed ops
                (read/upsert/RMW/delete .5/.3/.15/.05), statuses and values
                equal batch by batch, and the spilled KV against the same
                drive on "fused_ref", every leaf and the host store equal;
                then the pair as ShardedKV(S=4), the spilled one in
                DurableKV(fsync="always") with a snapshot after the load,
                crashed at `host.mid_demote` during the mixed ops,
                recover()ed on the card, the remaining batches and every
                key bit-equal to the all-device twin;
  7d. replicated — `make_session_service(cfg, ServiceConfig(n_shards=4,
                n_replicas=2, lanes=4096, max_sessions=8,
                session_depth=1024))` over the same 2**24 keys (R*S = 8
                stores in one row axis, ~9.4 GB): fan-in load in batches of
                BATCH with a two-phase read across a masked cold->cold pass,
                fan-out read-back of every key (FANOUT_BATCH), YCSB-A, -B,
                -F by fan-in and YCSB-C by fan-out (2**19 ops each by
                default), every read checked, the replicas leaf-equal after
                the load and after YCSB; then drop_replica(1),
                RESYNC_WRITES fan-in writes, resync(1) and every key read
                back pinned to replica 1 (the resync replays every shard's
                slabs side by side); wrapper calls per fan-in and per
                fan-out round (scheduler off) must equal a KV batch's and
                a ShardedKV read round's, and host syncs per round;
  7e. sessions — 8 sessions over that store enqueue 1,024 Zipf-0.99 ops
                each (reads, upserts, RMWs) a wave and drain, 16 waves:
                every completion equals its traced round's result, every
                read the expectation folded round by round, no shard takes
                more than the pack width; rounds, slab occupancy, host
                syncs per step();
  7e'. obs    — `repro_torch.obs` armed for a window on stores earlier
                phases built (no store is built for it): the main KV
                (YCSB-A 2**18 ops a turn, off, on, on, off: ops/s each way;
                stats() off and on equal with equal leaf types; wrapper
                calls and host syncs per batch equal off and on), the
                durable store (2**17 YCSB-A ops: the fsync phase and
                f2_wal_fsync_seconds quantiles, WAL records and bytes per
                batch from the counters, equal to the file's growth), the
                spilled KV (2**17 YCSB-B ops: the promote phase's quantiles,
                f2_host_promotions_total equal to the manager's count) and
                the session service (16 waves, 2**17 ops: queue, pack, apply
                and e2e count, mean, p50, p95, p99, p999; the ticket
                lifecycle oracle: one queue, apply and e2e observation a
                collected ticket, one pack a round, every duration > 0, the
                e2e total >= queue + apply); the registry, journal and
                alerts saved under build/ (`export.save_snapshot`), then
                obs reset;
  7f. replicated_profile_fan_in / _fan_out — profiler windows over 8
                YCSB-A fan-in rounds and 8 YCSB-C fan-out rounds: launches,
                device-busy ms and host syncs per round;
  7g. kernels_replicated — as kernels_sharded over the replicated
                store's 8 rows ([8, 4096] fan-out and fan-in slabs, probe
                at [8, 8192]): plain version, second call, 8 single-row
                calls, timed;
  7h. replicated_twins — 2**20 keys loaded into a "fused" ReplicatedKV
                and a fused ShardedKV (replica 0 leaf-equal to it), a
                "fused_ref" twin copied from the loaded one; the twins
                leaf-equal (replica 0 to the ShardedKV) after YCSB-A/B/F, a
                forced migrate(), a drop, writes and a resync, the
                resynced replica read back pinned; a session wave on the
                twins, its recorded schedule replayed on the ShardedKV
                with equal statuses and values;
  8. serve    — Granite-3-8B (10 of its 40 layers, d_model 4096, bf16
                weights from `init_params` with SEED) through
                Engine(backend="paged"):
                16 requests, prompts of 16-256 tokens, 32 new tokens each,
                8 lanes, max_len 512, pages of 16 (16 hot, 272 cold);
                the paged-attention counter is zeroed before and read after
                and must be 10 x decode steps; demotions and cold reads
                must be > 0, every logit finite, every token < vocab;
  9. serve_profile — a profiler window over 8 full decodes of the loaded
                engine (8 new 16-token prompts): device busy/idle share,
                top kernels and host ops, host syncs per step;
 10. kernels  — paged_attention (its split and merge kernels) against its
                plain version on the serve run's live pools and table (its
                last state with all 8 lanes active) and on edge cases (a
                4096-key table, lengths of 0, lengths at the split
                boundaries; 2e-5 float32, 2e-2 bfloat16), a second call bit
                for bit equal, timed beside its bound and
                scaled_dot_product_attention;
 11. serve_twins — the same requests through two float32 engines, 2 layers
                at full width, kernel against plain version: every decode's
                logits within TWIN_LOGITS_TOL, every token equal;
 12. train    — Granite-3-8B at full width, 8 of its 40 layers (bf16
                weights, f32 AdamW moments, from `init_or_restore(SEED)`):
                `Trainer.run()` for 6 steps of 2 x 4096 tokens, ending in
                the trainer's blocking save of the whole state to a
                temporary directory; the flash-attention counters are zeroed
                before and read after and must be forward 2 x 8 x steps
                (remat) and gradient 8 x steps; every loss finite;
 13. train_profile — a profiler window over 2 more steps: device busy/idle
                share, launches and host syncs per step, the flash kernels'
                share of device time beside the cuBLAS GEMMs'; all of the
                flash time must lie in the tensor-core kernels;
 14. train_twins — loss_fn and its gradients, f32, 2 layers at full width,
                B 1 x T 1024, on the card and on the CPU: loss within 1e-4
                relative, each gradient leaf within 1e-3 of its largest
                magnitude;
 15. train_restart — tests/test_trainer.py's restart scenario on the card
                at reduced widths: every parameter bit-equal to a straight
                run;
 16. rwkv_serve — RWKV-6-7B (32 layers, d_model 4096, bf16 weights from
                SEED) through Engine(backend="contiguous"), 8 lanes, 16
                requests in two waves (64- then 192-token prompts), 32 new
                tokens each; the WKV forward counter must be 32 x decode
                steps; every logit finite, every token < vocab;
 17. rwkv_prefill — `prefill_step` on 8 prompts of 1024 tokens, all 32
                layers: 32 WKV forward launches, finite logits;
 18. rwkv_twins — float32, 2 layers at full width, the engine on the card
                and on the CPU: the sampled logits within TWIN_LOGITS_TOL
                (the prompt-feeding steps' within RWKV_PROMPT_TOL: early
                tokens are ill-conditioned in float32), tokens equal; at
                each prompt position the WKV kernel's y within
                RWKV_F64_RATIO times the plain recurrence's distance from
                float64 on the same inputs, and the logits' distances from
                a float64 run of the model on the CPU recorded;
                prefill's last logits against 64 decode steps on the card;
 19. rwkv_train — RWKV-6-7B at full width, 8 of its 32 layers, as train:
                WKV forward 2 x 8 x steps and gradient 8 x steps; then
                rwkv_train_profile (the WKV kernels' share of device time
                beside the GEMMs') and rwkv_train_twins (as train_twins,
                gradient leaves within RWKV_TWIN_GRAD_TOL);
 20. the kernels line, the nvidia-smi line, and the final ok line.

The kernels line has one entry for each kernel of the main paths and one
for each store kernel over the shard axis (`*_sharded`) and over the
replicated rows (`*_replicated`).  Any mismatch,
failed build or failed launch raises, and the script exits non-zero.  It needs a CUDA device and the repository's `src/` next to it.
`--out PATH` also writes every phase's record to a JSON file.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8192
SEED = 0
SHARDS = 4                                # the sharded phase: S stores ...
SHARD_LANES = 4096                        # ... with slabs of this many lanes
REPLICAS = 2                              # the replicated phases: R copies
FANOUT_BATCH = 3 * BATCH                  # fan-out read-back: ~3,072 lanes a row
PINNED_BATCH = 3 * SHARD_LANES            # a read pinned to one replica: ~3,072 a row
RESYNC_WRITES = 1 << 17                   # fan-in writes while a replica is down
MIGRATE_BATCH = 3 * SHARD_LANES           # resync's drain frontier and replay batch
DURABLE_OPS = 1 << 18                     # the durable phase: YCSB-A durable and plain ...
DURABLE_TURNS = 4                         # ... in this many turns each
DURABLE_AFTER_SNAP = 1 << 17              # ops after the snapshot (and on the twins)
DURABLE_AFTER_MIGRATE = 1 << 16           # ops after the migration, before the kill
DURABLE_READ_BATCH = 15 * 1024            # the recovered store's read-back: ~3,840 a shard
SESSIONS = 8                              # the sessions phase: 8 sessions ...
SESSION_DEPTH = 1024                      # ... of 1,024 ring slots ...
SESSION_WAVES = 16                        # ... each enqueueing a full ring a wave
TWIN_LOG2_KEYS = 20
HOST_LOG2_KEYS = 22                       # the host-tier phase: spilled 8x (cut from
                                          # 2**23 to fit the time limit, PERF.md S4)
HOST_OPS = 1 << 18                        # ... YCSB-B and -A ops each (from 2**19)
OBS_KV_OPS = 1 << 18                      # the obs windows: YCSB-A ops a turn on the main KV
OBS_SESSION_WAVES = 16                    # ... session waves drained with obs on (2**17 ops)
OBS_DURABLE_OPS = 1 << 17                 # ... durable YCSB-A ops with obs on
OBS_HOST_OPS = 1 << 17                    # ... spilled-KV YCSB-B ops with obs on
HOST_READBACK = 1 << 18                   # ... keys read back, a uniform sample (2**19)
HOST_TWIN_LOG2_KEYS = 19                  # host_twins' keys (from 2**20) ...
HOST_TWIN_OPS = 1 << 16                   # ... and mixed ops after the load (2**17)
# serving: Granite-3-8B at full width, random weights from SEED
SERVE_ARCH = "granite-3-8b"
SERVE_LAYERS = 10                         # of its 40: the host-bound decode loop
                                          # (20 until PR 22's phases needed the room)
SERVE_ENGINE = dict(max_batch=8, max_len=512, page_size=16)
SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 32
SERVE_PROMPT_MIN, SERVE_PROMPT_MAX = 16, 256
TWIN_LAYERS = 2                           # the float32 serving twins' depth (4 until
                                          # the host-tier phases needed the room)
# float32 twins differ only in the attention's summation order (about one
# ulp per output); four layers and the tied 4096-wide logits projection
# keep that far below 1e-3 of a logit
TWIN_LOGITS_TOL = 1e-3
# training: Granite-3-8B at full width, TRAIN_LAYERS of its 40 layers
TRAIN_ARCH = "granite-3-8b"
TRAIN_FULL_LAYERS = 40
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS = 6
TWIN_TRAIN_LAYERS = 2
TWIN_TRAIN_SEQ = 1024
# RWKV-6-7B at full width, random weights from SEED: serving (contiguous
# backend: equal prompt lengths within a wave), prefill, training
RWKV_ARCH = "rwkv6-7b"
RWKV_ENGINE = dict(max_batch=8)
RWKV_WAVES = ((64, 8), (192, 8))          # (prompt tokens, requests) per wave
RWKV_NEW_TOKENS = 32
RWKV_PREFILL = (8, 1024)                  # prompts x tokens
RWKV_TWIN_PROMPT, RWKV_TWIN_NEW_TOKENS = 64, 8
# The first tokens of a sequence are ill-conditioned in float32: while the
# WKV state holds few tokens, a head's y_t is close to a scalar times one
# v vector (y_0 = (sum_i u_i r_i k_i) v_0), that scalar can cancel to a
# small fraction of its terms, and rmsnorm_heads (eps 1e-6) scales the
# rounding up by as much; each layer amplifies it again.  The logits of the
# prompt-feeding steps are held to RWKV_PROMPT_TOL, the logits the engine
# samples from (the last prompt token and after, 63+ tokens of state) to
# TWIN_LOGITS_TOL; the record keeps the largest error at every position.
RWKV_PROMPT_TOL = 5e-2
# That this is float32's rounding and not the kernel's is checked against
# float64 over the prompt positions.  At each WKV call of the card's kernel
# route, the kernel's y, the plain recurrence's on the card and on the CPU
# (float32) are held against the plain recurrence in float64 on the same
# inputs: the kernel's largest distance may be at most RWKV_F64_RATIO times
# the card's plain recurrence's.  The logits of the card, of the card with
# the plain recurrence in the kernel's place and of the CPU are recorded
# against a float64 run of the whole model, not held: at the first positions
# the model amplifies y's rounding a thousand-fold and more, so which route
# lands farther there is down to a few heads' rounding.
RWKV_F64_RATIO = 10.0
# The same early tokens dominate some gradient leaves in training: the
# gradient through rmsnorm_heads of a near-zero head output is scaled by up
# to 1/sqrt(eps), and its float32 rounding with it (rwkv_train's step-0
# gradient norm is ~33,000 against ~260 five steps later).  The bonus `u`
# gathers most of it, so the RWKV-6 train twins hold each gradient leaf to
# RWKV_TWIN_GRAD_TOL of its largest magnitude; the loss keeps 1e-4.
RWKV_TWIN_GRAD_TOL = 1e-2
RWKV_TRAIN_LAYERS = 8
# H100 SXM data-sheet peaks (dense): HBM bytes/s, non-tensor 32-bit ops/s,
# bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
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
# observability windows (repro_torch.obs armed on stores other phases built)
# ---------------------------------------------------------------------------

OBS_TIMES = {}                  # window -> seconds (the obs phase's total)


def _same_tree(a, b, path=()):
    """Equal values and equal leaf types (the registry-backed stats())."""
    if type(a) is not type(b):
        raise AssertionError(f"stats() leaf {path}: {type(a)} vs {type(b)}")
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"stats() keys differ at {path}")
        for k in a:
            _same_tree(a[k], b[k], path + (k,))
    elif a != b:
        raise AssertionError(f"stats() leaf {path}: {a!r} vs {b!r}")


def obs_kv_window(kv, n_keys, seed, records):
    """The main KV (2^24 keys) with obs off and on: YCSB-A turns of
    OBS_KV_OPS ops, off, on, on, off (ops/s each way and on/off); stats()
    read off then on with no op between, equal in values and leaf types;
    wrapper calls and host syncs per batch (calls_per_round, scheduler off)
    off and on, equal.  Obs is reset here: the first window."""
    from repro_torch import obs
    from repro_torch.workload import Zipf
    t0 = time.perf_counter()
    obs.configure(enabled=False, reset=True)
    rng = np.random.default_rng(seed + 61)
    zipf = Zipf(n_keys, 0.99)
    secs = {False: 0.0, True: 0.0}
    for armed in (False, True, True, False):
        obs.configure(enabled=armed)
        r, _ = ycsb(kv, None, "A", OBS_KV_OPS, zipf, rng)
        secs[armed] += OBS_KV_OPS / r
    obs.configure(enabled=False)
    off = kv.stats()
    obs.configure(enabled=True)
    on = kv.stats()
    _same_tree(off, on)
    # the same batches from the same state both ways (a store's syncs can
    # follow its data): the state saved on the card and put back between
    from repro_torch import interop
    saved = [t.clone() for t in interop.state_leaves(kv._st)]
    obs.configure(enabled=False)
    calls_off, syncs_off = calls_per_round(kv, seed)
    for dst, src in zip(interop.state_leaves(kv._st), saved):
        dst.copy_(src)
    del saved
    obs.configure(enabled=True)
    calls_on, syncs_on = calls_per_round(kv, seed)
    obs.configure(enabled=False)
    if (calls_on, syncs_on) != (calls_off, syncs_off):
        raise AssertionError(f"obs on: calls {calls_on}, syncs {syncs_on}; off: "
                             f"calls {calls_off}, syncs {syncs_off}")
    rate = {k: 2 * OBS_KV_OPS / v for k, v in secs.items()}
    OBS_TIMES["kv"] = time.perf_counter() - t0
    emit(records, dict(phase="obs", window="kv", n_keys=n_keys, batch=BATCH,
                       ops_per_turn=OBS_KV_OPS, turns="off, on, on, off",
                       ops_per_s_off=rate[False], ops_per_s_on=rate[True],
                       on_over_off=rate[True] / rate[False],
                       stats_equal=True, calls_per_batch=calls_on,
                       host_syncs_per_batch=syncs_on,
                       seconds=OBS_TIMES["kv"]))


def obs_durable_window(dkv, expect, zipf, rng, wal_bytes_per_batch, records):
    """The durable store (DurableKV over the loaded sharded store) with obs
    on: OBS_DURABLE_OPS YCSB-A ops, every read checked; the fsync phase and
    f2_wal_fsync_seconds, and WAL records and bytes per batch from the
    counters, equal to what the segment file grew by a batch."""
    from repro_torch import obs
    t0 = time.perf_counter()
    obs.configure(enabled=True)
    wal = dkv._wal
    seq0, pos0 = wal.seq, wal._f.tell()
    reg = obs.get_registry()

    def counter(name):
        m = reg.get(name)
        return sum(c.value for _, c in m.samples()) if m is not None else 0
    rec0, bytes0 = counter("f2_wal_records_total"), counter("f2_wal_bytes_total")
    ycsb(dkv, expect, "A", OBS_DURABLE_OPS, zipf, rng)
    obs.configure(enabled=False)
    batches = OBS_DURABLE_OPS // BATCH
    n_rec = counter("f2_wal_records_total") - rec0
    n_bytes = counter("f2_wal_bytes_total") - bytes0
    if not (n_rec == wal.seq - seq0 == batches
            and n_bytes == wal._f.tell() - pos0
            and n_bytes / batches == wal_bytes_per_batch):
        raise AssertionError(f"WAL counters: {n_rec} records, {n_bytes} B for "
                             f"{batches} batches ({wal_bytes_per_batch} B a batch "
                             "by the file)")
    fsync = obs.latency.summary().get("fsync")
    hist = obs.latency.summary("f2_wal_fsync_seconds").get("")
    if not (fsync and fsync["count"] == batches and hist and hist["count"] == batches):
        raise AssertionError(f"fsync observations: {fsync}, {hist} for {batches} batches")
    OBS_TIMES["durable"] = time.perf_counter() - t0
    emit(records, dict(phase="obs", window="durable", batches=batches,
                       fsync_phase=fsync, wal_fsync_seconds=hist,
                       wal_records_per_batch=n_rec / batches,
                       wal_bytes_per_batch=n_bytes / batches,
                       seconds=OBS_TIMES["durable"]))


def obs_host_window(kv, expect, zipf, rng, records):
    """The spilled KV with obs on: OBS_HOST_OPS YCSB-B ops, every read
    checked; the promote phase's quantiles, and f2_host_promotions_total
    equal to the manager's own promotions over the window."""
    from repro_torch import obs
    t0 = time.perf_counter()
    obs.configure(enabled=True)
    reg = obs.get_registry()

    def promoted():
        m = reg.get("f2_host_promotions_total")
        return m.labels(facade="kv").value if m is not None else 0
    c0, p0 = promoted(), kv._ht.promotions
    ycsb(kv, expect, "B", OBS_HOST_OPS, zipf, rng)
    obs.configure(enabled=False)
    n = kv._ht.promotions - p0
    if not (n > 0 and promoted() - c0 == n):
        raise AssertionError(f"f2_host_promotions_total {promoted() - c0}, the "
                             f"manager's promotions {n}")
    promote = obs.latency.summary().get("promote")
    if not promote or promote["count"] <= 0:
        raise AssertionError(f"no promote observation: {promote}")
    OBS_TIMES["host"] = time.perf_counter() - t0
    emit(records, dict(phase="obs", window="host", ops=OBS_HOST_OPS,
                       promotions=n, promote_phase=promote,
                       seconds=OBS_TIMES["host"]))


def obs_sessions_window(svc, sessions, rng, zipf, expect, records):
    """The session service over the R = 2, S = 4 store with obs on:
    OBS_SESSION_WAVES waves drained (every completion and read checked),
    then the ticket lifecycle oracle: one queue, apply and e2e observation
    a collected ticket, one pack observation a round, every duration > 0,
    the e2e total >= queue + apply."""
    from repro_torch import obs
    t0 = time.perf_counter()
    obs.configure(enabled=True)
    c0, r0 = svc.collected, svc.pack_rounds
    n_ops, t_run, rounds, _ = run_session_waves(svc, sessions, rng, zipf,
                                                OBS_SESSION_WAVES, expect)
    obs.configure(enabled=False)
    s = obs.latency.summary()
    n, n_rounds = svc.collected - c0, svc.pack_rounds - r0
    if svc._clock.outstanding:
        raise AssertionError(f"{svc._clock.outstanding} tickets never collected")
    if not all(s.get(p, {}).get("count") == n for p in ("queue", "apply", "e2e")):
        raise AssertionError(f"{n} tickets collected: {s}")
    if s["pack"]["count"] != n_rounds or n != n_ops:
        raise AssertionError(f"{n_rounds} rounds, {n_ops} ops: {s}")
    for p in ("queue", "pack", "apply", "e2e"):
        if not (s[p]["mean"] > 0 and s[p]["p50"] > 0):
            raise AssertionError(f"phase {p}: {s[p]}")
    e2e = s["e2e"]["mean"] * n
    if e2e < (s["queue"]["mean"] + s["apply"]["mean"]) * n * (1 - 1e-9):
        raise AssertionError(f"e2e total {e2e} under queue + apply: {s}")
    OBS_TIMES["sessions"] = time.perf_counter() - t0
    emit(records, dict(phase="obs", window="sessions", ops=n_ops,
                       ops_per_s=n_ops / t_run, rounds=n_rounds,
                       latency={p: s[p] for p in ("queue", "pack", "apply", "e2e")},
                       seconds=OBS_TIMES["sessions"]))


def obs_finish(records):
    """The obs phase's end: the registry, journal and alert state of every
    window saved with `export.save_snapshot` under build/ (path and size
    printed), the phases' quantiles, then obs reset."""
    from repro_torch import obs
    path = os.path.join(ROOT, "build", "obs_snapshot.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    obs.export.save_snapshot(path)
    print(f"obs snapshot: {path} ({os.path.getsize(path)} bytes)", flush=True)
    emit(records, dict(phase="obs", window="all", snapshot=path,
                       snapshot_bytes=os.path.getsize(path),
                       latency=obs.latency.summary(),
                       journal_events=obs.journal.JOURNAL.total,
                       journal_kinds=collections.Counter(
                           f"{e['kind']} {e.get('facade', '')}".strip()
                           for e in obs.journal.events()),
                       trace_events=len(obs.trace.TRACER),
                       seconds_by_window=dict(OBS_TIMES),
                       seconds=sum(OBS_TIMES.values())))
    obs.configure(enabled=False, reset=True)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def load_keys(kv, keys_perm, V):
    for b in range(0, len(keys_perm), BATCH):
        k = keys_perm[b:b + BATCH]
        st, _ = kv.upsert(k, val_of(k, V))
        if not bool((st == 1).all()):
            raise AssertionError(f"upsert batch {b // BATCH}: status != OK")


def read_back(kv, n_keys, V, batch=BATCH, expect=None, **read_kw):
    """Every key read back (`kv.read(keys, **read_kw)`) in batches, each
    checked against its loaded value or `expect`."""
    from repro_torch import ST_OK
    for b in range(0, n_keys, batch):
        k = np.arange(b, min(b + batch, n_keys), dtype=np.int32)
        want = val_of(k, V) if expect is None else expect[k]
        st, v = kv.read(k, **read_kw)
        st, v = st.cpu().numpy(), v.cpu().numpy()
        if not (np.all(st == ST_OK) and np.array_equal(v, want)):
            bad = np.flatnonzero((st != ST_OK) | np.any(v != want, 1))
            raise AssertionError(f"read-back: {bad.size} keys wrong, e.g. {k[bad[:8]]}")


def fold(expect, keys, ops, vals):
    """`expect` after one batch of reads, upserts and RMWs (YCSB's ops):
    the last upsert of each key wins, RMWs add."""
    from repro_torch import OP_RMW, OP_UPSERT
    u = np.flatnonzero(ops == OP_UPSERT)
    if u.size:
        _, first_rev = np.unique(keys[u][::-1], return_index=True)
        last = u[::-1][first_rev]
        expect[keys[last]] = vals[last]
    m = ops == OP_RMW
    np.add.at(expect, keys[m], vals[m])


def ycsb(kv, expect, workload, n_ops, zipf, rng, via_read=False,
         device_inputs=False):
    """One YCSB mix through kv.apply (through kv.read with `via_read`, for
    YCSB-C), its batches as host arrays (or, with `device_inputs`, as
    tensors on kv's device).  With an `expect` array every read is checked
    against it (the pre-batch values) and it is then updated.  Returns
    (ops/s over apply + result transfer, the per-batch outputs)."""
    from repro_torch import OP_READ, ST_OK
    from repro_torch.workload import make_ops
    import torch
    V = kv.cfg.value_width
    t_apply = 0.0
    outs = []
    for _ in range(0, n_ops, BATCH):
        keys, ops, vals, _ = make_ops(rng, workload, zipf, BATCH, V)
        args = ((keys, ops, vals) if not device_inputs else
                tuple(torch.as_tensor(x, device=kv.device) for x in (keys, ops, vals)))
        t0 = time.perf_counter()
        st, rv = kv.read(args[0]) if via_read else kv.apply(*args)
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
        fold(expect, keys, ops, vals)
    return n_ops / t_apply, outs


def cold_cold(kv, n_keys):
    """Cold->cold never fires during the load (the cold log stays < 80%
    full), so one pass runs through the entry point the trigger uses.  It
    covers the oldest n_keys/64 records: each step appends ~compact_batch
    chunk versions and chunk-log GC only runs between batches, so a default
    10% pass would wrap the chunk log over live chunks (the reference's
    policy does the same on the same stream)."""
    kv.compact_cold_cold(n_records=max(n_keys // 64, kv.compact_batch))


def two_phase_begin(kv, n_keys, seed):
    """Phase 1 of the paper's two-phase read (S5.4) on BATCH loaded keys:
    `store.read_begin` snapshots their chain heads (the first-hop probe
    kernel under the fused engine) and the cold tail."""
    import torch
    from repro_torch.core import store
    keys = np.random.default_rng(seed + 7).choice(n_keys, BATCH, replace=False)
    keys = torch.as_tensor(keys.astype(np.int32), device=kv.device)
    active = torch.ones(BATCH, dtype=torch.bool, device=kv.device)
    kv.state, snap = store.read_begin(kv.cfg, kv.state, keys, active)
    return snap


def two_phase_finish(kv, snap, V):
    """Phase 2 after the cold->cold pass in between: every key must read
    back its loaded value, though the pass truncated the cold log under the
    snapshot (the num_truncs re-check)."""
    from repro_torch import ST_OK
    from repro_torch.core import store
    kv.state, st, vals = store.read_finish(kv.cfg, kv.state, snap)
    k = snap.keys.cpu().numpy()
    if not (np.all(st.cpu().numpy() == ST_OK)
            and np.array_equal(vals.cpu().numpy(), val_of(k, V))):
        raise AssertionError("two-phase read across cold->cold: a key read wrong")


def main_path(cfg, device, n_keys, n_ops, seed):
    """Load, cold->cold inside a two-phase read, read back, YCSB A/B/F;
    returns the KV."""
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
    snap = two_phase_begin(kv, n_keys, seed)
    truncs = int(kv.state.cold_truncs)
    cold_cold(kv, n_keys)
    truncs = int(kv.state.cold_truncs) - truncs
    two_phase_finish(kv, snap, V)
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
                    two_phase_keys=BATCH, truncations_under_snapshot=truncs,
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


KERNEL_FUNCTIONS = {"fused_probe": ("fused_probe_walk_kernel",),
                    "fused_write": ("write_clear_kernel", "write_group_kernel",
                                    "write_sum_kernel", "write_plan_kernel",
                                    "write_chain_kernel"),
                    "paged_attention": ("paged_attention_split_kernel",
                                        "paged_attention_merge_kernel"),
                    "flash_attention_fwd_tc": ("fa_tc_forward_kernel",),
                    "flash_attention_bwd_tc": ("fa_tc_rowdot_kernel", "fa_tc_dkdv_kernel",
                                               "fa_tc_dq_kernel"),
                    "flash_attention_fwd_simt": ("fa_forward_kernel",),
                    "flash_attention_bwd_simt": ("fa_rowdot_kernel", "fa_dkdv_kernel",
                                                 "fa_dq_kernel"),
                    "probe": ("first_hop_probe_kernel",),
                    "wkv_forward": ("wkv_fwd_split_kernel",),
                    "wkv_backward": ("wkv_dv_kernel", "wkv_drkw_kernel")}


def _host_us(fn, reps):
    """Host microseconds per call: the wall time of `reps` calls issued back
    to back, with no synchronisation inside the window (a kernel shorter
    than its wrapper never makes the host wait)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _device_ms(fn, reps, names, parts=None):
    """Device time per call of the named CUDA functions, from the profiler
    (CUDA events around a short kernel also time the wrapper's host side,
    which can be longer than the kernel): each function's mean over the
    records the profiler kept, summed over the functions (and, where
    `parts` is a dict, each function's mean put in it).  Late in a long
    process, after large profiler windows, the profiler can drop kernel
    records, so a total over `reps` would undercount; a window that kept
    no record of a function is run again, up to three windows, and then
    the result is "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_name = {n: [0.0, 0] for n in names}
        for e in _aggregate(prof):
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                for n in names:
                    if n in e.key:
                        per_name[n][0] += e.self_device_time_total
                        per_name[n][1] += e.count
        if all(c > 0 for _, c in per_name.values()):
            break
    else:
        return "not measured"
    if parts is not None:
        parts.update({n: us / c / 1e3 for n, (us, c) in per_name.items()})
    return sum(us / c for us, c in per_name.values()) / 1e3


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
    from repro_torch.workload import Zipf
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
    # YCSB-A's keys (Zipf 0.99: the hottest key fills ~5% of the lanes)
    # with the mixed case's ops
    zipf = mk(Zipf(n_keys, 0.99).sample(rng, B),
              rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B, p=[.25, .35, .25, .15]))
    # every lane one key; values near +-2^31, so the RMW sums wrap
    hot_ops = rng.choice([OP_UPSERT, OP_RMW, OP_RMW, OP_DELETE], B)
    hot_ops[-9:] = OP_RMW
    near = rng.integers(0, 97, (B, V))
    one_hot = (torch.full((B,), int(rng.integers(0, n_keys)), dtype=torch.int32, device=dev),
               torch.as_tensor(hot_ops.astype(np.int32), device=dev),
               torch.as_tensor(np.where(near < 12, -2**31 + near, 2**31 - 1 - near)
                               .astype(np.int32), device=dev))
    hot, rc = st.hot, st.rc
    tail = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    bounds = (st.hot_index, hot.begin, hybrid_log.head_addr(hot, cfg.hot_mem),
              hybrid_log.read_only_addr(hot, cfg.hot_mem, cfg.hot_mutable_frac),
              hot.tail)
    kw = dict(chain_max=cfg.chain_max)
    cases = []
    for name, (k, o, v) in (("mixed", mixed), ("duplicate_keys", dup),
                            ("all_colliding_slot", coll),
                            ("rmw_after_delete", rad), ("pure_rmw", pure),
                            ("zipf_099", zipf), ("one_hot_key", one_hot)):
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
            if _max_abs_err(got, kern(*args, **kw)) != 0:
                raise AssertionError(f"{kname}/{name}: two calls differ")
            rec = dict(case=name, B=int(args[0].shape[0]), max_abs_err=err,
                       bit_equal_twice=True)
            if kv.device.type == "cuda":
                rec["ms"] = _time_ms(lambda: kern(*args, **kw), 20)
                parts = {}
                rec["device_ms"] = _device_ms(lambda: kern(*args, **kw), 20,
                                              KERNEL_FUNCTIONS[kname], parts)
                rec["device_ms_by_kernel"] = parts
                rec["plain_ms"] = _time_ms(lambda: plain(*args, **kw), 3)
                if kname == "fused_probe":
                    rec["host_us"] = _host_us(lambda: kern(*args, **kw), 200)
                    b = probe_bound(args, kw, got)
                else:
                    b = write_bound(args, got)
                rec.update(bound_ms=b[0], bound_by=b[1], bound_bytes=b[2],
                           bound_ops=b[3])
            per_case.append(rec)
        emit(records, dict(phase="kernels", kernel=kname, cases=per_case))
        summary[kname] = per_case[0]   # the main-path case (read / mixed)
    return summary


def check_probe_kernel(kv, n_keys, seed, records):
    """The legacy first-hop probe against its plain version, bit for bit, on
    the loaded store's hot index: BATCH keys (loaded and absent ones) and an
    odd batch.  Cross-check: its (addr, is_rc) equal the chain heads that
    fused_probe resolves in index mode on the same keys, untagged, and their
    RC flags.  Timed beside its bound; returns the main case's summary."""
    import torch
    from repro_torch.core import hybrid_log
    from repro_torch.kernels.f2_probe import ops, ref
    st, cfg, dev = kv.state, kv.cfg, kv.device
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed + 8)
    q = np.concatenate([rng.integers(0, n_keys, BATCH - 512),
                        n_keys + rng.integers(0, 1 << 20, 512)]).astype(np.int32)
    keys = torch.as_tensor(q, device=dev)
    index = st.hot_index
    per_case = []
    for name, k in (("read_index", keys), ("odd_B77", keys[:77].contiguous())):
        got = ops.probe(k, index)
        want = ref.probe_reference(k, index)
        _sync(dev)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"probe/{name}: max |kernel - plain| = {err}")
        B = k.shape[0]
        rec = dict(case=name, B=B, E=index.shape[0], max_abs_err=err,
                   rc_tagged=int(got[1].sum()), null=int((got[0] == -1).sum()))
        if on_card:
            rec["ms"] = _time_ms(lambda: ops.probe(k, index), 50)
            rec["device_ms"] = _device_ms(lambda: ops.probe(k, index), 50,
                                          KERNEL_FUNCTIONS["probe"])
            rec["plain_ms"] = _time_ms(lambda: ref.probe_reference(k, index), 10)
            nbytes = B * (4 + SECTOR + 4 + 4)  # key, index sector, addr, is_rc
            rec.update(bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                       bound_bytes=nbytes)
        per_case.append(rec)
    hot, rc = st.hot, st.rc
    B = keys.shape[0]
    heads = ops.fused_probe(keys, index, hot.begin.expand(B).contiguous(),
                            torch.ones(B, dtype=torch.bool, device=dev),
                            hybrid_log.head_addr(hot, cfg.hot_mem),
                            hot.key, hot.val, hot.prev, hot.meta,
                            rc.key, rc.val, rc.prev, rc.meta, chain_max=cfg.chain_max)[2]
    addr, is_rc = ops.probe(keys, index)
    flag = ((heads >= 0) & ((heads & ref.RC_FLAG) != 0)).to(torch.int32)
    untagged = torch.where(heads >= 0, heads & ~ref.RC_FLAG, heads)
    if not (torch.equal(addr, untagged) and torch.equal(is_rc, flag)):
        raise AssertionError("probe disagrees with fused_probe's first hop")
    per_case[0]["matches_fused_probe_heads"] = True
    emit(records, dict(phase="kernels", kernel="probe", cases=per_case))
    return per_case[0]


# (name, B, H, T, D, lowest decay, initial state in and final state out):
# the train phase's call, the serve phase's decode step, rwkv_prefill's call
# (`prefill_step`: no state in or out), then tests/test_kernels.py's shapes
# and edge cases
WKV_CASES = [("train", 2, 64, 4096, 64, 0.8, False),
             ("decode", 8, 64, 1, 64, 0.5, True),
             ("prefill", 8, 64, 1024, 64, 0.8, False),
             ("kernels_0", 2, 3, 256, 64, 0.8, False),
             ("kernels_1", 1, 2, 128, 64, 0.8, False),
             ("kernels_2_d128", 2, 1, 64, 128, 0.8, True),
             ("small_w_ragged", 1, 2, 197, 32, 1e-3, True),
             ("d16", 2, 4, 70, 16, 1e-3, False)]


def wkv_bound(B, H, T, D, state, backward):
    """Least time of one call: each input read and each output written once
    (forward: r, k, v, w, u in, y out, and the states where given; gradient:
    r, k, v, w, u, dy in, dr, dk, dv, dw, du out) at HBM's rate, against
    the float32 operations at the non-tensor peak: 4 per state element and
    step forward (y's product and sum, the decay and k v^T), 12 for the
    gradient (the recomputed state, the G update and the four products dr,
    dk, dv, dw)."""
    bhtd = B * H * T * D
    if backward:
        nbytes = (5 * bhtd + H * D + 4 * bhtd + H * D) * 4
        ops_ = 12 * B * H * T * D * D
    else:
        nbytes = (5 * bhtd + H * D + (2 * B * H * D * D if state else 0)) * 4
        ops_ = 4 * B * H * T * D * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops_)


def check_wkv_kernels(device, seed, records):
    """The WKV kernels against autograd through their plain version, on the
    card, in every case: y and the final state within 2e-3 absolute and
    relative (the JAX package's tolerance), each input's gradient within
    2e-3 of its largest reference magnitude.  Each case is timed beside its
    bound (the train case's forward with the saved states its gradient
    needs, as the training path calls it).  Returns the summaries of the
    train case (forward and gradient)."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops, ref as wkv_ref
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    l2_flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                if on_card else None)
    per_case = []
    for name, B, H, T, D, w_lo, state in WKV_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        r, k, v, dy = (rnd(B, H, T, D) for _ in range(4))
        w = w_lo + (0.999 - w_lo) * torch.rand((B, H, T, D), generator=g, device=dev)
        u = rnd(H, D)
        s0 = rnd(B, H, D, D) if state else None
        ds = rnd(B, H, D, D) if state else None

        def run(fn, *ins):
            y, s = fn(*ins)
            loss = (y * dy).sum() + ((s * ds).sum() if state else 0)
            return y.detach(), None if s is None else s.detach(), \
                torch.autograd.grad(loss, ins)

        ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
        if on_card:
            y, s, grads = run(lambda *a: wkv_ops.wkv_cuda(*a, s0, state), *ins)
        else:
            y, s, grads = run(lambda *a: wkv_ops.wkv(*a, s0, state), *ins)
        rin = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
        yr, sr, want = run(lambda *a: wkv_ref.wkv_reference(*a, s0), *rin)
        _sync(dev)
        err = float((y - yr).abs().max())
        ok = torch.allclose(y, yr, atol=2e-3, rtol=2e-3)
        if state:
            err = max(err, float((s - sr).abs().max()))
            ok = ok and torch.allclose(s, sr, atol=2e-3, rtol=2e-3)
        if not ok:
            raise AssertionError(f"wkv_forward/{name}: max |kernel - plain| = {err} "
                                 "beyond atol = rtol = 2e-3")
        gerr = {}
        for gname, a, b in zip(("dr", "dk", "dv", "dw", "du"), grads, want):
            e = float((a - b).abs().max())
            gerr[gname] = e
            if e > 2e-3 * float(b.abs().max()):
                raise AssertionError(f"wkv_backward/{name}: {gname} differs from the "
                                     f"plain gradient by {e}")
        rec = dict(case=name, B=B, H=H, T=T, D=D, w_lo=w_lo, state=state,
                   max_abs_err=err, tol=2e-3, grad_max_abs_err=gerr,
                   grad_rel_err=max(gerr[n] / float(b.abs().max())
                                    for n, b in zip(gerr, want)))
        del y, s, grads, yr, sr, want, ins, rin
        if on_card:
            ckpt_on = name == "train"
            _, _, ckpt = wkv_ops.forward_cuda(r, k, v, w, u, s0, state, checkpoints=True)
            fwd = lambda: wkv_ops.forward_cuda(r, k, v, w, u, s0, state,  # noqa: E731
                                               checkpoints=ckpt_on)
            bwd = lambda: wkv_ops.backward_cuda(r, k, v, w, u, ckpt, dy, ds)  # noqa: E731
            if not all(torch.equal(a, b) for a, b in zip(bwd()[:5], bwd()[:5])):
                raise AssertionError(f"wkv_backward/{name}: two calls differ")
            rec["bwd_bit_equal_twice"] = True
            if not all(a is b or torch.equal(a, b) for a, b in zip(fwd(), fwd())):
                raise AssertionError(f"wkv_forward/{name}: two calls differ")
            rec["fwd_bit_equal_twice"] = True
            reps = 3 if T >= 4096 else 20
            rec["fwd_ms"] = _time_ms(fwd, reps)
            rec["fwd_device_ms"] = _device_ms(lambda: (l2_flush.zero_(), fwd()), reps,
                                              KERNEL_FUNCTIONS["wkv_forward"])
            rec["bwd_ms"] = _time_ms(bwd, reps)
            parts = {}
            rec["bwd_device_ms"] = _device_ms(lambda: (l2_flush.zero_(), bwd()), reps,
                                              KERNEL_FUNCTIONS["wkv_backward"], parts)
            rec["bwd_device_ms_by_kernel"] = parts
            rec["fwd_plain_ms"] = _time_ms(
                lambda: wkv_ref.wkv_reference(r, k, v, w, u, s0), 1)
            rq = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
            ry, rs = wkv_ref.wkv_reference(*rq, s0)
            rl = (ry * dy).sum() + ((rs * ds).sum() if state else 0)
            rec["bwd_plain_ms"] = _time_ms(
                lambda: torch.autograd.grad(rl, rq, retain_graph=True), 1)
            del rq, ry, rs, rl, ckpt
            for kind, back in (("fwd", False), ("bwd", True)):
                b = wkv_bound(B, H, T, D, state, back)
                rec.update({f"{kind}_bound_ms": b[0], f"{kind}_bound_by": b[1],
                            f"{kind}_bound_bytes": b[2], f"{kind}_bound_ops": b[3]})
            torch.cuda.empty_cache()
        per_case.append(rec)
    emit(records, dict(phase="kernels", kernel="wkv", cases=per_case))
    main = per_case[0]

    def pick(kind):
        return dict(max_abs_err=main["max_abs_err"] if kind == "fwd"
                    else max(main["grad_max_abs_err"].values()),
                    ms=main.get(f"{kind}_ms"), device_ms=main.get(f"{kind}_device_ms"),
                    plain_ms=main.get(f"{kind}_plain_ms"), library_ms=None,
                    bound_ms=main.get(f"{kind}_bound_ms"),
                    bound_by=main.get(f"{kind}_bound_by"))

    return {"wkv_forward": pick("fwd"), "wkv_backward": pick("bwd")}


# ---------------------------------------------------------------------------
# where the time goes: a profiler window over YCSB-A batches
# ---------------------------------------------------------------------------

class _Row:
    """One aggregated profiler row (the attributes the phases read of a
    `key_averages()` row)."""
    __slots__ = ("key", "device_type", "count", "self_device_time_total",
                 "self_cpu_time_total", "cpu_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count = 0
        self.self_device_time_total = self.self_cpu_time_total = 0.0
        self.cpu_time_total = 0.0


def _aggregate(prof):
    """`prof.key_averages()` in one pass over the recorded events: a window
    of ~170k events takes ~20 s in key_averages on the card, a few tenths
    of a second here.  Kernel rows take their durations as self device
    time; host rows their time less their children's as self time."""
    rows = {}
    for e in prof.events():
        on_dev = str(e.device_type).endswith("CUDA")
        r = rows.get((e.name, on_dev))
        if r is None:
            r = rows[(e.name, on_dev)] = _Row(e.name, e.device_type)
        r.count += 1
        t = e.time_range.elapsed_us()
        if on_dev:
            r.self_device_time_total += t
        else:
            r.cpu_time_total += t
            r.self_cpu_time_total += t - sum(c.time_range.elapsed_us()
                                             for c in e.cpu_children)
    return list(rows.values())


def _device_rows(prof, events=None):
    """(device rows, host rows) of a profile (or of its aggregated rows,
    `events`, when the caller has them) as (name, seconds, calls), largest
    first.  Device rows are kernels, copies and memsets only: CPU-op rows
    repeat the device time of the kernels they launch."""
    dev, host = [], []
    for e in (_aggregate(prof) if events is None else events):
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            d = getattr(e, "self_device_time_total", None)
            if d is None:
                d = getattr(e, "self_cuda_time_total", 0)
            dev.append((e.key, d / 1e6, e.count))
        else:
            host.append((e.key, e.self_cpu_time_total / 1e6, e.count))
    dev.sort(key=lambda x: -x[1])
    host.sort(key=lambda x: -x[1])
    return dev, host


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
    dev, host = _device_rows(prof)
    busy = sum(d for _, d, _ in dev)
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
# the sharded store: ShardedKV(S = 4) over the same keyspace
# ---------------------------------------------------------------------------

def routed(skv, keys, ops=None, fan_in=False):
    """(skeys [rows, W], sops [rows, W], route) of one batch under skv's
    map: S rows for a ShardedKV; R*S for a ReplicatedKV, the lanes spread
    over the replicas round robin as a fan-out read spreads them, or
    (`fan_in`) the S slabs repeated over the replicas as a fan-in round
    writes them."""
    import torch
    from repro_torch import OP_READ
    from repro_torch.core import shard_router
    dev = skv.device
    keys = torch.as_tensor(np.asarray(keys, np.int32), device=dev)
    ops = (torch.full(keys.shape, OP_READ, dtype=torch.int32, device=dev)
           if ops is None else torch.as_tensor(np.asarray(ops, np.int32), device=dev))
    vals = torch.zeros((keys.shape[0], skv.cfg.value_width), dtype=torch.int32,
                       device=dev)
    R = getattr(skv, "R", 1)
    bmap = torch.as_tensor(skv.bucket_map, device=dev)
    if R == 1 or fan_in:
        sk, so, _, rt = shard_router.route(keys, ops, vals, skv.S, skv.lanes,
                                           bucket_map=bmap)
        return sk.repeat(R, 1), so.repeat(R, 1), rt
    rep = torch.arange(keys.shape[0], dtype=torch.int32, device=dev) % R
    sk, so, _, rt = shard_router.route(keys, ops, vals, skv.S, skv.lanes,
                                       bucket_map=bmap, replica=rep, n_replicas=R)
    return sk, so, rt


def sharded_two_phase(skv, n_keys, seed):
    """The paper's two-phase read (S5.4) over all shards at once: BATCH
    loaded keys routed to their shards (under replication, the same slabs
    on every replica), `store.read_begin` on the stacked state (the
    first-hop probe kernel, one launch for every row), a masked cold->cold
    pass over every shard in between, `read_finish`: every key must read
    back its loaded value.  Returns the truncations under the snapshot."""
    from repro_torch import OP_READ, ST_OK
    from repro_torch.core import shard_router, store
    keys = np.random.default_rng(seed + 7).choice(n_keys, BATCH, replace=False)
    sk, so, rt = routed(skv, keys, fan_in=True)
    if bool(rt.deferred.any()):
        raise AssertionError("the two-phase batch did not fit one routed round")
    skv.state, snap = store.read_begin(skv.cfg, skv.state, sk, so == OP_READ)
    truncs = int(skv.state.cold_truncs.sum())
    skv.compact_cold_cold(n_records=max(n_keys // skv.S // 64, skv.compact_batch))
    truncs = int(skv.state.cold_truncs.sum()) - truncs
    skv.state, st, vals = store.read_finish(skv.cfg, skv.state, snap)
    st, vals = shard_router.unroute(rt, st[:skv.S], vals[:skv.S])
    if not (np.all(st.cpu().numpy() == ST_OK) and np.array_equal(
            vals.cpu().numpy(), val_of(keys, skv.cfg.value_width))):
        raise AssertionError("sharded two-phase read across cold->cold: a key read wrong")
    return truncs


def calls_per_round(kv, seed, n_batches=8, read=False, via=None, expect=None):
    """Wrapper calls per routed round (a KV batch is one round) of YCSB-A
    batches with the scheduler off (trigger 2.0: no compaction), or with
    `read` of YCSB-C batches through kv.read, and the host sync calls per
    round from a profiler window over the same kind of batches.  `via` is a
    wrapper of kv (a DurableKV) the batches go through; `expect`, if given,
    takes their writes.  Counters and trigger are restored."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(seed + 11)
    zipf = Zipf(1 << 20 if expect is None else min(1 << 20, len(expect)), 0.99)
    batches = [make_ops(rng, "C" if read else "A", zipf, BATCH,
                        kv.cfg.value_width)[:3] for _ in range(2 * n_batches)]
    if expect is not None and not read:
        for b in batches:
            fold(expect, *b)
    front = via if via is not None else kv
    run = (lambda b: front.read(b[0])) if read else (lambda b: front.apply(*b))
    trigger, kv.trigger = kv.trigger, 2.0
    saved = dict(ops.launches)
    rounds0 = getattr(kv, "rounds", None)
    ops.reset_launches()
    for b in batches[:n_batches]:
        run(b)
    torch.cuda.synchronize()
    rounds = n_batches if rounds0 is None else kv.rounds - rounds0
    calls = {k: v / rounds for k, v in ops.launches.items()}
    calls["fused_write"] /= ops.WRITE_KERNELS_PER_CALL
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r0 = getattr(kv, "rounds", 0)
        for b in batches[n_batches:]:
            run(b)
        torch.cuda.synchronize()
    rounds = n_batches if rounds0 is None else kv.rounds - r0
    counts = {e.key: e.count for e in _aggregate(prof)}
    syncs = {k: counts.get(k, 0) / rounds for k in SYNC_CALLS}
    kv.trigger = trigger
    for k, v in saved.items():
        ops.launches[k] = v + ops.launches[k]
    return calls, syncs


def sharded_main(cfg, device, n_keys, n_ops, seed, records, main_rates):
    """ShardedKV(cfg, S=SHARDS, lanes=SHARD_LANES): load n_keys unique keys
    in batches of BATCH with masked compactions firing, the two-phase read
    across a masked cold->cold pass, every key read back, YCSB-A, -B and -F
    at Zipf 0.99 with every read checked.  Returns the store, its record
    and the expected value of every key."""
    import torch
    from repro_torch import RebalanceConfig, ShardedKV
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.workload import Zipf
    V = cfg.value_width
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    # the durable phase migrates on this store: MIGRATE_BATCH records a
    # drain step and a replay batch, and 64 buckets a shard, so that its
    # first 4 buckets are 1/64 of the keys (routing is the hash's top bits
    # for any bucket count)
    skv = ShardedKV(cfg, SHARDS, lanes=SHARD_LANES, device=device,
                    rebalance_cfg=RebalanceConfig(enabled=False, buckets_per_shard=64,
                                                  migrate_batch=MIGRATE_BATCH))
    launches, rounds, batches = {}, {}, {}

    def mark(phase, n_batches):
        launches[phase] = {k: v - sum(d[k] for d in launches.values())
                           for k, v in ops.launches.items()}
        rounds[phase] = skv.rounds - sum(rounds.values())
        batches[phase] = n_batches

    ops.reset_launches()
    t0 = time.perf_counter()
    load_keys(skv, rng.permutation(n_keys).astype(np.int32), V)
    truncs = sharded_two_phase(skv, n_keys, seed)
    skv.check_invariants()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    mark("load", -(-n_keys // BATCH))
    t0 = time.perf_counter()
    read_back(skv, n_keys, V)
    t_read = time.perf_counter() - t0
    mark("readback", -(-n_keys // BATCH))
    expect = val_of(np.arange(n_keys), V)
    zipf = Zipf(n_keys, 0.99)
    rates = {}
    for wl in "ABF":
        rates[wl], _ = ycsb(skv, expect, wl, n_ops, zipf, rng)
        mark(f"ycsb_{wl}", n_ops // BATCH)
    skv.check_invariants()
    torch.cuda.synchronize()
    total = dict(ops.launches)
    rec = dict(phase="sharded", shards=SHARDS, lanes=SHARD_LANES, n_keys=n_keys,
               keys_per_shard=n_keys // SHARDS, config_per_shard=dataclasses.asdict(cfg),
               load_s=t_load, load_ops_per_s=n_keys / t_load,
               truncations_under_snapshot=truncs,
               readback_s=t_read, readback_ops_per_s=n_keys / t_read,
               ycsb_ops_per_mix=n_ops, ycsb_ops_per_s=rates,
               main_s1_ycsb_ops_per_s=main_rates,
               rounds_by_phase=rounds, batches_by_phase=batches,
               deferral_rounds={p: rounds[p] - batches[p] for p in rounds},
               launches=total, launches_by_phase=launches,
               compactions_per_shard=skv.compactions.tolist(),
               compactions_by_kind={k: v.tolist() for k, v in
                                    skv.compaction_counts.items()},
               io=skv.io_stats(), peak_mem_bytes=torch.cuda.max_memory_allocated())
    return skv, rec, expect


SYNC_CALLS = ("aten::nonzero", "aten::_local_scalar_dense", "aten::item",
              "cudaStreamSynchronize", "cudaMemcpyAsync")


def sharded_profile(skv, n_keys, seed, records, n_batches=8, read=False,
                    phase="sharded_profile", expect=None):
    """Device busy time and idle share over YCSB-A batches of the loaded
    sharded (or replicated: fan-in) store, or with `read` YCSB-C batches
    through `read` (fan-out), as `profile_window`; per routed round, the
    kernels launched (device records), the device-busy ms and the host
    sync calls.  `expect`, if given, takes the batches' writes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(seed + 3)
    zipf = Zipf(n_keys, 0.99)
    batches = [make_ops(rng, "C" if read else "A", zipf, BATCH, skv.cfg.value_width)[:3]
               for _ in range(n_batches)]
    if expect is not None and not read:     # batches[0] runs twice: idempotent
        for b in batches:
            fold(expect, *b)

    def run(b):
        return skv.read(b[0]) if read else skv.apply(*b)
    run(batches[0])
    torch.cuda.synchronize()
    r0 = skv.rounds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            st, rv = run(b)
            st.cpu(), rv.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = _device_rows(prof)
    busy = sum(d for _, d, _ in dev)
    rounds = skv.rounds - r0
    counts = {e.key: e.count for e in _aggregate(prof)}
    emit(records, dict(
        phase=phase, workload="C" if read else "A", batches=n_batches, batch=BATCH,
        rounds=rounds, wall_s=wall,
        device_busy_s=busy if dev else "not measured",
        device_idle_share=(1 - busy / wall) if dev else "not measured",
        launches_per_round=sum(c for _, _, c in dev) / rounds if dev else "not measured",
        device_busy_ms_per_round=busy / rounds * 1e3 if dev else "not measured",
        host_syncs_per_round={k: counts.get(k, 0) / rounds for k in SYNC_CALLS},
        f2_kernels=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev
                    if any(n in k for f in KERNEL_FUNCTIONS.values() for n in f)],
        top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:10]],
        top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:10]]))


def _shard_slices(args, kw, s):
    """Shard s's single-store arguments of a stacked kernel call."""
    import torch
    return (tuple(a[s] if torch.is_tensor(a) else a for a in args),
            {k: (v[s] if torch.is_tensor(v) else v) for k, v in kw.items()})


def sharded_probe_cases(skv, rng, n_keys):
    """(name, args, kwargs) of fused_probe at the sharded path's shapes:
    a routed YCSB batch ([S, W] lanes, padding inactive), the compaction
    frontiers ([S, compact_batch]) and an odd width."""
    import torch
    from repro_torch.core import cold_index, hybrid_log, probe_engine
    from repro_torch.core.types import IoStats
    from repro_torch.workload import Zipf
    st, cfg, dev = skv.state, skv.cfg, skv.device
    S = st.hot.tail.shape[0]                 # rows: R*S under replication
    q = np.concatenate([Zipf(n_keys, 0.99).sample(rng, BATCH - 512),
                        n_keys + rng.integers(0, 1 << 20, 512)]).astype(np.int32)
    keys, sops, _ = routed(skv, q)
    act = sops != 0
    W = keys.shape[1]
    hot, rc, cold = st.hot, st.rc, st.cold
    hot_cols = (hot.key, hot.val, hot.prev, hot.meta)
    rc_cols = (rc.key, rc.val, rc.prev, rc.meta)
    hb = hybrid_log.head_addr(hot, cfg.hot_mem)
    lower = hot.begin[:, None].expand(S, W).contiguous()
    base = (keys, st.hot_index, lower, act, hb, *hot_cols, *rc_cols)
    kw = dict(chain_max=cfg.chain_max, rc_match=True, has_rc=True, probe_index=True)
    cases = [("read_index", base, kw),
             ("liveness_rc_match_false", base, dict(kw, rc_match=False))]
    entries, _ = cold_index.find_entries(st.cold_idx, cfg, keys, act,
                                         IoStats.zeros(dev, (S,)))
    drc = probe_engine.dummy_rc(cfg.value_width, dev, S)
    chb = hybrid_log.head_addr(cold, cfg.cold_mem)
    cases.append(("cold_heads", (keys, entries, cold.begin[:, None].expand(S, W).contiguous(),
                                 act, chb, cold.key, cold.val, cold.prev, cold.meta,
                                 drc.key, drc.val, drc.prev, drc.meta),
                  dict(kw, has_rc=False, probe_index=False)))
    Bc = skv.compact_batch
    addrs = hot.begin[:, None] + torch.arange(Bc, dtype=torch.int32, device=dev)
    k, _, _, meta = hybrid_log.gather(hot, addrs)
    m = (addrs < hot.tail[:, None]) & ((meta & 2) == 0)
    cases.append(("hot_cold_target", (k, st.hot_index, addrs, m, hb, *hot_cols, *rc_cols),
                  dict(kw, rc_match=False, target=addrs)))
    cases.append(("odd_W77", (keys[:, :77].contiguous(), st.hot_index,
                              lower[:, :77].contiguous(), act[:, :77].contiguous(), hb,
                              *hot_cols, *rc_cols), kw))
    return cases


def sharded_write_cases(skv, rng, n_keys):
    """(name, args, kwargs) of fused_write at the sharded path's shapes:
    YCSB-A's routed keys with mixed ops, a routed mixed batch, one hot key
    in every lane of every shard (values near +-2^31, so the RMW sums wrap),
    and an odd width."""
    import torch
    from repro_torch import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT
    from repro_torch.core import hybrid_log
    from repro_torch.workload import Zipf
    st, cfg, dev = skv.state, skv.cfg, skv.device
    S = st.hot.tail.shape[0]                 # rows: R*S under replication
    V = cfg.value_width
    mix = [OP_READ, OP_UPSERT, OP_RMW, OP_DELETE]

    def mk(keys, ops_):
        sk, so, _ = routed(skv, keys, ops_, fan_in=True)
        vals = rng.integers(-2**31, 2**31, tuple(sk.shape) + (V,),
                            dtype=np.int64).astype(np.int32)
        return sk, so, torch.as_tensor(vals, device=dev)

    zipf = mk(Zipf(n_keys, 0.99).sample(rng, BATCH),
              rng.choice(mix, BATCH, p=[.25, .35, .25, .15]))
    mixed = mk(rng.integers(0, n_keys + n_keys // 8, BATCH),
               rng.choice(mix, BATCH, p=[.25, .35, .25, .15]))
    W = skv.lanes
    hot_ops = rng.choice([OP_UPSERT, OP_RMW, OP_RMW, OP_DELETE], (S, W))
    hot_ops[:, -9:] = OP_RMW
    near = rng.integers(0, 97, (S, W, V))
    one_hot = (torch.as_tensor(np.repeat(rng.integers(0, n_keys, (S, 1)), W, 1)
                               .astype(np.int32), device=dev),
               torch.as_tensor(hot_ops.astype(np.int32), device=dev),
               torch.as_tensor(np.where(near < 12, -2**31 + near, 2**31 - 1 - near)
                               .astype(np.int32), device=dev))
    hot, rc = st.hot, st.rc
    tail = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    bounds = (st.hot_index, hot.begin, hybrid_log.head_addr(hot, cfg.hot_mem),
              hybrid_log.read_only_addr(hot, cfg.hot_mem, cfg.hot_mutable_frac),
              hot.tail)
    kw = dict(chain_max=cfg.chain_max)
    cases = [(name, (k, o, v, *bounds, *tail), kw)
             for name, (k, o, v) in (("zipf_099", zipf), ("mixed", mixed),
                                     ("one_hot_key", one_hot))]
    k, o, v = mixed
    cases.append(("odd_W77", (k[:, :77].contiguous(), o[:, :77].contiguous(),
                              v[:, :77].contiguous(), *bounds, *tail), kw))
    return cases


def sharded_first_hop_cases(skv, rng, n_keys):
    """The first-hop probe over every row's index: rows x BATCH lanes (the
    sharded shape), rows x 2^20 / rows lanes, and an odd width."""
    import torch
    dev = skv.device
    S = skv.state.hot.tail.shape[0]          # rows: R*S under replication
    cases = []
    for name, w in ((f"s{S}x8192", BATCH), (f"s{S}x{(1 << 20) // S}", (1 << 20) // S),
                    ("odd_W77", 77)):
        q = np.concatenate([rng.integers(0, n_keys, (S, w - w // 16)),
                            n_keys + rng.integers(0, 1 << 20, (S, w // 16))], 1)
        cases.append((name, (torch.as_tensor(q.astype(np.int32), device=dev),
                             skv.state.hot_index), {}))
    return cases


def check_sharded_kernels(skv, n_keys, seed, records, phase="kernels_sharded"):
    """Each store kernel over the loaded sharded store's shard axis (a
    replicated store's R*S rows): one stacked call bit for bit against its
    plain version, a second call, and single-row calls on the rows' slices;
    timed by CUDA events and the profiler (L2 flushed too) beside its bound,
    the single-row bound summed over the rows.  Returns {kernel: summary of
    its main case}."""
    import torch
    from repro_torch.kernels.f2_probe import ops, ref
    rng = np.random.default_rng(seed + 21)
    l2_flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=skv.device)
    summary = {}
    for kname, cases, kern, plain in (
            ("fused_probe", sharded_probe_cases(skv, rng, n_keys), ops.fused_probe,
             lambda *a, **k: ref.fused_probe_body(*a, early_exit=True, **k)),
            ("fused_write", sharded_write_cases(skv, rng, n_keys), ops.fused_write,
             lambda *a, **k: ref.fused_write_body(*a, early_exit=True, **k)),
            ("probe", sharded_first_hop_cases(skv, rng, n_keys), ops.probe,
             ref.probe_reference)):
        per_case = []
        for name, args, kw in cases:
            got = kern(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{kname}[S]/{name}: max |kernel - plain| = {err}")
            if _max_abs_err(got, kern(*args, **kw)) != 0:
                raise AssertionError(f"{kname}[S]/{name}: two calls differ")
            S = args[0].shape[0]
            singles = [kern(*a, **k) for a, k in (_shard_slices(args, kw, s)
                                                  for s in range(S))]
            if any(_max_abs_err(tuple(x[s] for x in got), one) != 0
                   for s, one in enumerate(singles)):
                raise AssertionError(f"{kname}[S]/{name}: differs from single-shard calls")
            rec = dict(case=name, S=S, W=int(args[0].shape[1]), max_abs_err=err,
                       bit_equal_twice=True, equal_to_single_shard_calls=True)
            rec["ms"] = _time_ms(lambda: kern(*args, **kw), 20)
            parts = {}
            rec["device_ms"] = _device_ms(lambda: kern(*args, **kw), 20,
                                          KERNEL_FUNCTIONS[kname], parts)
            rec["device_ms_by_kernel"] = parts
            rec["device_ms_l2_flushed"] = _device_ms(
                lambda: (l2_flush.zero_(), kern(*args, **kw)), 20, KERNEL_FUNCTIONS[kname])
            # per single-shard call (S of them do the stacked call's work)
            rec["single_shard_call_device_ms"] = _device_ms(
                lambda: [kern(*a, **k) for a, k in (_shard_slices(args, kw, s)
                                                    for s in range(S))],
                10, KERNEL_FUNCTIONS[kname])
            rec["plain_ms"] = _time_ms(lambda: plain(*args, **kw), 3)
            bounds = []
            for s in range(S):
                a, k = _shard_slices(args, kw, s)
                out = tuple(x[s] for x in got)
                if kname == "fused_probe":
                    bounds.append(probe_bound(a, k, out))
                elif kname == "fused_write":
                    bounds.append(write_bound(a, out))
                else:
                    nb = a[0].shape[0] * (4 + SECTOR + 4 + 4)
                    bounds.append((nb / PEAK_BYTES_PER_S * 1e3, "bytes", nb, 0))
            rec.update(bound_ms=sum(b[0] for b in bounds),
                       bound_by=max(bounds)[1],
                       bound_bytes=sum(b[2] for b in bounds),
                       bound_ops=sum(b[3] for b in bounds))
            per_case.append(rec)
        emit(records, dict(phase=phase, kernel=kname, cases=per_case))
        summary[kname] = per_case[0]
    return summary


def sharded_twins(cfg, device, n_keys, n_ops, seed, records):
    """The same op stream through ShardedKV(S=SHARDS) with engine="fused"
    and engine="fused_ref" on the card: every leaf equal after each phase,
    statuses and values equal per batch, then a forced migrate() of an
    edited bucket map (a bucket of shard 0 to shard 1) and a read-back."""
    import torch
    from repro_torch import RebalanceConfig, ShardedKV, interop
    from repro_torch.workload import Zipf
    V = cfg.value_width
    twins = {e: ShardedKV(dataclasses.replace(cfg, engine=e), SHARDS,
                          lanes=SHARD_LANES, device=device,
                          rebalance_cfg=RebalanceConfig(enabled=False,
                                                        migrate_batch=SHARD_LANES))
             for e in ("fused", "fused_ref")}

    def same_state(ctx):
        la, lb = (interop.state_leaves(kv.state) for kv in twins.values())
        if not all(torch.equal(x, y) for x, y in zip(la, lb)):
            raise AssertionError(f"sharded twins diverged after {ctx}")
        a, b = twins.values()
        if not (np.array_equal(a.compactions, b.compactions) and a.rounds == b.rounds
                and np.array_equal(a.bucket_map, b.bucket_map)):
            raise AssertionError(f"sharded twin counters differ after {ctx}")

    perm = np.random.default_rng(seed).permutation(n_keys).astype(np.int32)
    for kv in twins.values():
        load_keys(kv, perm, V)
        kv.compact_cold_cold(n_records=max(n_keys // SHARDS // 64, kv.compact_batch))
    same_state("load")
    for kv in twins.values():
        read_back(kv, n_keys, V)
    same_state("read-back")
    zipf = Zipf(n_keys, 0.99)
    expect = val_of(np.arange(n_keys), V)     # checked on the kernels' twin
    for wl in "ABF":
        outs = {e: ycsb(kv, expect if e == "fused" else None, wl, n_ops, zipf,
                        np.random.default_rng(seed + ord(wl)))[1]
                for e, kv in twins.items()}
        for (s1, v1), (s2, v2) in zip(outs["fused"], outs["fused_ref"]):
            if not (np.array_equal(s1, s2) and np.array_equal(v1, v2)):
                raise AssertionError(f"sharded twin statuses/values differ in YCSB-{wl}")
        same_state(f"YCSB-{wl}")
    new_map = twins["fused"].bucket_map.copy()
    new_map[np.flatnonzero(new_map == 0)[0]] = 1
    moved = {e: kv.migrate(new_map) for e, kv in twins.items()}
    if len(set(moved.values())) != 1 or moved["fused"] <= 0:
        raise AssertionError(f"sharded twins migrated {moved}")
    same_state("migrate")
    # read-back after the migration: every key holds the value YCSB left
    for lo in range(0, n_keys, BATCH):
        k = np.arange(lo, min(lo + BATCH, n_keys), dtype=np.int32)
        for kv in twins.values():
            st, v = kv.read(k)
            if not (bool((st == 1).all()) and np.array_equal(v.cpu().numpy(), expect[k])):
                raise AssertionError("a key reads wrong after the migration")
    same_state("read-back after migrate")
    for kv in twins.values():
        kv.check_invariants()
    emit(records, dict(phase="sharded_twins", shards=SHARDS, lanes=SHARD_LANES,
                       n_keys=n_keys, ops_per_mix=n_ops, migrated_records=moved["fused"],
                       compactions_per_shard=twins["fused"].compactions.tolist(),
                       rounds=twins["fused"].rounds, bit_exact=True))


# ---------------------------------------------------------------------------
# durability: the WAL, snapshots, recover() and rebuild_replica() on the card
# ---------------------------------------------------------------------------

def _disk_record(d, need):
    """shutil.disk_usage of `d` as a record; fails when fewer than `need`
    bytes are free (the phase does not shrink to fit)."""
    du = shutil.disk_usage(d)
    if du.free < need:
        raise AssertionError(f"{d}: {du.free} bytes free, the durable phase needs {need}")
    return dict(dir=d, total_bytes=du.total, used_bytes=du.used, free_bytes=du.free,
                needed_bytes=need)


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def _state_bytes(kv):
    from repro_torch import interop
    return sum(t.numel() * t.element_size() for t in interop.state_leaves(kv.state))


def durable_main(skv, n_keys, seed, records, expect, plain_calls):
    """DurableKV over the sharded phase's loaded store (fsync "batch"):
    wrapper calls per durable round (scheduler off) asserted equal to a
    plain round's; YCSB-A, DURABLE_OPS ops durable and as many plain (the
    WAL detached), in DURABLE_TURNS turns each, every read checked; fsync ms
    per batch, WAL bytes per batch, device-to-host copies per logged batch;
    a blocking snapshot (capture stall, save seconds, bytes on disk); then
    2**17 ops (the first 8 batches as CUDA tensors: one copy a record), a
    migrate() of the first 4 of the store's 256 buckets one shard on (one
    MAP record), 2**16 ops, and the wrapper abandoned (a kill at a batch
    boundary).  recover()
    into a fresh ShardedKV on the card (restore and replay seconds, records,
    peak memory); every key read back against the expectation; 2**17 more
    ops into the recovered store and the live one (the uninterrupted twin),
    statuses and values bit-equal; invariants on both."""
    import tempfile
    import torch
    from repro_torch import DurabilityConfig, DurableKV, ShardedKV, recover
    from repro_torch.workload import Zipf, make_ops
    V = skv.cfg.value_width
    rng = np.random.default_rng(seed + 51)
    zipf = Zipf(n_keys, 0.99)
    d = tempfile.mkdtemp(prefix="f2_durable_")
    state_bytes = _state_bytes(skv)
    # a snapshot, the WAL (a MAP record of the moved buckets' records) and
    # the fresh epoch's segment
    disk = _disk_record(d, state_bytes + (1 << 30))
    emit(records, dict(phase="durable_disk", state_bytes=state_bytes, **disk))
    t_phase = time.perf_counter()
    try:
        dkv = DurableKV(skv, DurabilityConfig(dir=d, fsync="batch"))
        wal = dkv._wal
        calls, syncs = calls_per_round(skv, seed, via=dkv, expect=expect)
        if calls != plain_calls:
            raise AssertionError(f"a durable round made {calls} wrapper calls, a plain "
                                 f"round {plain_calls}")
        fsync_s = []
        sync = wal.sync

        def timed_sync():
            t0 = time.perf_counter()
            sync()
            fsync_s.append(time.perf_counter() - t0)
        wal.sync = timed_sync
        per_turn = DURABLE_OPS // DURABLE_TURNS
        durable_s = plain_s = 0.0
        wal_bytes = 0
        copies0, seq0 = wal.d2h_copies, wal.seq
        for _ in range(DURABLE_TURNS):
            pos = wal._f.tell()
            r, _ = ycsb(dkv, expect, "A", per_turn, zipf, rng)
            durable_s += per_turn / r
            wal_bytes += wal._f.tell() - pos
            skv.wal = None
            r, _ = ycsb(skv, expect, "A", per_turn, zipf, rng)
            skv.wal = wal
            plain_s += per_turn / r
        logged = wal.seq - seq0
        host_copies = wal.d2h_copies - copies0
        fsync_ms = np.array(fsync_s) * 1e3      # one group commit a durable batch
        wal.sync = sync
        obs_durable_window(dkv, expect, zipf, rng, wal_bytes / logged, records)
        t0 = time.perf_counter()
        dkv.snapshot(blocking=True)
        save_s = time.perf_counter() - t0
        capture_s = dkv.ckpt.capture_s
        snap_bytes = _dir_bytes(os.path.join(d, "snap"))
        # after the snapshot: CUDA-tensor batches, YCSB-A, a migration, YCSB-A
        copies0, seq0 = wal.d2h_copies, wal.seq
        ycsb(dkv, expect, "A", 8 * BATCH, zipf, rng, device_inputs=True)
        tensor_copies = (wal.d2h_copies - copies0) / (wal.seq - seq0)
        if tensor_copies != (skv.device.type != "cpu"):
            raise AssertionError(f"{tensor_copies} device-to-host copies a device-tensor record")
        ycsb(dkv, expect, "A", DURABLE_AFTER_SNAP - 8 * BATCH, zipf, rng)
        new_map = skv.bucket_map.copy()
        new_map[:4] = (new_map[:4] + 1) % skv.S
        pos = wal._f.tell()
        t0 = time.perf_counter()
        moved = dkv.migrate(new_map)
        migrate_s = time.perf_counter() - t0
        map_record_bytes = wal._f.tell() - pos
        ycsb(dkv, expect, "A", DURABLE_AFTER_MIGRATE, zipf, rng)
        wal_records = wal.seq
        # the kill: the wrapper is abandoned at a batch boundary (every
        # acked batch is fsync'd); skv goes on as the uninterrupted twin
        skv.wal = None
        del dkv, wal, sync
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = recover(d, lambda: ShardedKV(skv.cfg, skv.S, lanes=skv.lanes,
                                           rebalance_cfg=skv.rb, device=skv.device))
        recover_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        if rec.kv.device != skv.device or not np.array_equal(rec.kv.bucket_map, new_map):
            raise AssertionError("the recovered store is not the crashed one's shape")
        t0 = time.perf_counter()
        read_back(rec, n_keys, V, batch=DURABLE_READ_BATCH, expect=expect)
        readback_s = time.perf_counter() - t0
        twin_rng = np.random.default_rng(seed + 52)
        for _ in range(0, DURABLE_AFTER_SNAP, BATCH):
            keys, ops_, vals, _ = make_ops(twin_rng, "A", zipf, BATCH, V)
            a, b = rec.apply(keys, ops_, vals), skv.apply(keys, ops_, vals)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError("the recovered store and its twin differ")
        rec.check_invariants()
        skv.check_invariants()
        rec.close()
        info = rec.recovery
        del rec
        torch.cuda.empty_cache()
        out = dict(
            phase="durable", n_keys=n_keys, shards=skv.S, lanes=skv.lanes, fsync="batch",
            state_bytes=state_bytes, calls_per_durable_round=calls,
            calls_per_plain_round=plain_calls, host_syncs_per_durable_round=syncs,
            ycsb_ops_each=DURABLE_OPS, turns=DURABLE_TURNS,
            durable_ops_per_s=DURABLE_OPS / durable_s, plain_ops_per_s=DURABLE_OPS / plain_s,
            durable_over_plain=plain_s / durable_s,
            logged_batches=logged,
            fsync_ms_median=float(np.median(fsync_ms)), fsync_ms_max=float(fsync_ms.max()),
            wal_bytes_per_batch=wal_bytes / logged,
            host_copies_per_logged_batch=host_copies / logged,
            host_copies_per_cuda_tensor_record=tensor_copies,
            snapshot_capture_s=capture_s, snapshot_save_s=save_s,
            snapshot_bytes=snap_bytes, migrated_records=moved, migrate_s=migrate_s,
            map_record_bytes=map_record_bytes, wal_records=wal_records,
            recover_s=recover_s, restore_s=info["restore_s"], replay_s=info["replay_s"],
            records_replayed=info["records"], wal_records_replayed=info["wal_records"],
            snapshot_epoch=info["snapshot_epoch"], recover_peak_mem_bytes=peak,
            readback_s=readback_s, readback_ops_per_s=n_keys / readback_s,
            twin_ops=DURABLE_AFTER_SNAP, bit_equal=True,
            seconds=time.perf_counter() - t_phase)
        emit(records, out)
        return out
    finally:
        skv.wal = None
        shutil.rmtree(d, ignore_errors=True)


def durable_twins(cfg, device, n_keys, seed, records):
    """make_session_service(cfg, ServiceConfig(n_shards=SHARDS,
    n_replicas=REPLICAS, durability=DurabilityConfig(dir,
    snapshot_every_rounds=16))) and an uninterrupted twin without
    durability, loaded through sessions with the same history (the cadence
    hook firing); replica 1 dropped, 2**15 ops written, a migration; then
    rebuild_replica(1) on the durable store and resync(1) on the twin
    (seconds and records of each; the healthy replica serves no drained
    record, replicas 0 and 1 read back equal pinned); then
    `migrate.after_flip` armed, a migration that crashes, recover(): the
    alive replicas byte-identical, the remaining batches bit-equal against
    the twin, which ran the migration."""
    import tempfile
    import torch
    from repro_torch import OP_UPSERT, DurabilityConfig, RebalanceConfig, recover
    from repro_torch.core import replication
    from repro_torch.serve import serve_step
    from repro_torch.testing import faults
    from repro_torch.workload import Zipf, make_ops
    V = cfg.value_width
    d = tempfile.mkdtemp(prefix="f2_durable_twins_")
    t_phase = time.perf_counter()
    try:
        sc = serve_step.ServiceConfig(
            n_shards=SHARDS, n_replicas=REPLICAS, lanes=SHARD_LANES,
            rebalance_cfg=RebalanceConfig(enabled=False, migrate_batch=MIGRATE_BATCH),
            max_sessions=SESSIONS, session_depth=SESSION_DEPTH,
            store_kwargs=dict(device=device))
        svcs = [serve_step.make_session_service(cfg, dataclasses.replace(
            sc, durability=DurabilityConfig(dir=d, snapshot_every_rounds=16))),
                serve_step.make_session_service(cfg, sc)]
        dkv, twin = svcs[0].kv, svcs[1].kv
        # a snapshot and the WAL's records
        emit(records, dict(phase="durable_twins_disk", **_disk_record(d, 4 * _state_bytes(twin))))
        perm = np.random.default_rng(seed + 61).permutation(n_keys).astype(np.int32)
        sessions = [[svc.open_session() for _ in range(SESSIONS)] for svc in svcs]
        wave = SESSIONS * SESSION_DEPTH
        for lo in range(0, n_keys, wave):
            keys = perm[lo:lo + wave]
            for svc, ss in zip(svcs, sessions):
                for i, s in enumerate(ss):
                    k = keys[i * SESSION_DEPTH:(i + 1) * SESSION_DEPTH]
                    if len(k) and not (s.enqueue(k, np.full(len(k), OP_UPSERT, np.int32),
                                                 val_of(k, V)) >= 0).all():
                        raise AssertionError("a session's ring refused an op")
                for s in ss:
                    s.drain()
        if dkv.snapshots < 1:
            raise AssertionError("the cadence hook never snapshotted")
        dkv.wait()
        stores = (dkv, twin)
        for kv in stores:
            kv.drop_replica(1)
        rng = np.random.default_rng(seed + 62)
        zipf = Zipf(n_keys, 0.99)
        for _ in range(0, 1 << 15, BATCH):
            keys, ops_, vals, _ = make_ops(rng, "A", zipf, BATCH, V)
            a, b = (kv.apply(keys, ops_, vals) for kv in stores)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError("the durable store and its twin differ")
        new_map = twin.bucket_map.copy()
        new_map[np.flatnonzero(new_map == 0)[0]] = 1
        if len({kv.migrate(new_map) for kv in stores}) != 1:
            raise AssertionError("the twins migrated different record counts")
        drained = dkv.kv.resynced_records
        healthy = [t[:SHARDS].clone() for t in replication._leaves(dkv.kv.state)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuilt = dkv.rebuild_replica(1)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resynced = twin.resync(1)
        torch.cuda.synchronize()
        resync_s = time.perf_counter() - t0
        if dkv.kv.resynced_records != drained:
            raise AssertionError("the rebuild drained records from the healthy replica")
        if not all(torch.equal(a, t[:SHARDS]) for a, t in
                   zip(healthy, replication._leaves(dkv.kv.state))):
            raise AssertionError("the rebuild touched the healthy replica's rows")
        del healthy
        for lo in range(0, n_keys, PINNED_BATCH):
            k = np.arange(lo, min(lo + PINNED_BATCH, n_keys), dtype=np.int32)
            r0, r1 = dkv.kv.read(k, replica=0), dkv.kv.read(k, replica=1)
            if not (torch.equal(r0[0], r1[0]) and torch.equal(r0[1], r1[1])):
                raise AssertionError("the rebuilt replica reads differently from replica 0")
        # the crash between a migration's flip and its replay
        new_map = twin.bucket_map.copy()
        new_map[np.flatnonzero(new_map == 2)[0]] = 3
        faults.arm("migrate.after_flip")
        try:
            dkv.migrate(new_map)
            raise AssertionError("migrate.after_flip did not fire")
        except faults.InjectedCrash:
            pass
        finally:
            faults.reset()
        twin.migrate(new_map)
        dkv.wait()              # a snapshot in flight lands before the kill
        dkv.kv.wal = None
        kv_shape = dict(lanes=SHARD_LANES, n_replicas=REPLICAS,
                        rebalance_cfg=sc.rebalance_cfg, device=device)
        del svcs, sessions
        t0 = time.perf_counter()
        rec = recover(d, lambda: replication.ReplicatedKV(cfg, SHARDS, **kv_shape))
        recover_s = time.perf_counter() - t0
        if not (rec.kv.alive.all() and replication.replicas_byte_identical(rec.kv)):
            raise AssertionError("the recovered replicas are not byte-identical")
        if not np.array_equal(rec.kv.bucket_map, new_map):
            raise AssertionError("recovery did not replay the crashed migration")
        for _ in range(0, 1 << 15, BATCH):
            keys, ops_, vals, _ = make_ops(rng, "A", zipf, BATCH, V)
            a, b = rec.apply(keys, ops_, vals), twin.apply(keys, ops_, vals)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError("the recovered store and its twin differ")
        rec.check_invariants()
        twin.check_invariants()
        info = rec.recovery
        rec.close()
        out = dict(phase="durable_twins", n_keys=n_keys, shards=SHARDS, replicas=REPLICAS,
                   snapshot_every_rounds=16, snapshots=dkv.snapshots,
                   rebuild_s=rebuild_s, rebuild_records=rebuilt,
                   resync_s=resync_s, resync_records=resynced,
                   healthy_drained_records=dkv.kv.resynced_records - drained,
                   recover_s=recover_s, restore_s=info["restore_s"],
                   replay_s=info["replay_s"], records_replayed=info["records"],
                   snapshot_epoch=info["snapshot_epoch"], bit_equal=True,
                   seconds=time.perf_counter() - t_phase)
        emit(records, out)
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# replication and the session service: R = 2 copies of the S = 4 shards
# ---------------------------------------------------------------------------

def upsert_checked(kv, keys, vals, expect, **kw):
    """kv.apply of upserts, every status OK; `expect` takes the last value
    of each key."""
    from repro_torch import OP_UPSERT
    st, _ = kv.apply(keys, np.full(len(keys), OP_UPSERT, np.int32), vals, **kw)
    if not bool((st == 1).all()):
        raise AssertionError("an upsert's status is not OK")
    _, first_rev = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - first_rev
    expect[keys[last]] = vals[last]


def replicated_main(cfg, device, n_keys, n_ops, seed, records, sharded_rec):
    """ReplicatedKV(cfg, S=SHARDS, R=REPLICAS, lanes=SHARD_LANES), built by
    make_session_service: load n_keys unique keys by fan-in in batches of
    BATCH, read every key back by fan-out, YCSB-A, -B and -F through apply
    and YCSB-C through read, every read checked; replicas leaf-equal after
    the load and after the YCSB mixes; then replica 1 dropped,
    RESYNC_WRITES fan-in writes, resync(1), and every key read back pinned
    to replica 1.  Returns (the session service, its record)."""
    import torch
    from repro_torch import RebalanceConfig
    from repro_torch.core import replication
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.serve import serve_step
    from repro_torch.workload import Zipf
    V = cfg.value_width
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    # resync drains and replays MIGRATE_BATCH records a step
    svc = serve_step.make_session_service(cfg, serve_step.ServiceConfig(
        n_shards=SHARDS, n_replicas=REPLICAS, lanes=SHARD_LANES,
        rebalance_cfg=RebalanceConfig(enabled=False, migrate_batch=MIGRATE_BATCH),
        max_sessions=SESSIONS, session_depth=SESSION_DEPTH,
        store_kwargs=dict(device=device)))
    rkv = svc.kv
    launches, rounds, seconds = {}, {}, {}
    t_mark = [time.perf_counter()]

    def mark(phase):
        torch.cuda.synchronize()
        launches[phase] = {k: v - sum(d[k] for d in launches.values())
                           for k, v in ops.launches.items()}
        rounds[phase] = rkv.rounds - sum(rounds.values())
        now = time.perf_counter()
        seconds[phase], t_mark[0] = now - t_mark[0], now

    def identical(ctx):
        if not replication.replicas_byte_identical(rkv):
            raise AssertionError(f"replicas differ after {ctx}")

    ops.reset_launches()
    t_mark[0] = time.perf_counter()
    load_keys(rkv, rng.permutation(n_keys).astype(np.int32), V)
    truncs = sharded_two_phase(rkv, n_keys, seed)
    rkv.check_invariants()
    mark("load")
    identical("the load")
    t_mark[0] = time.perf_counter()
    read_back(rkv, n_keys, V, batch=FANOUT_BATCH)
    mark("fanout_readback")
    expect = val_of(np.arange(n_keys), V)
    zipf = Zipf(n_keys, 0.99)
    rates = {}
    t_mark[0] = time.perf_counter()
    for wl in "ABFC":
        rates[wl], _ = ycsb(rkv, expect, wl, n_ops, zipf, rng, via_read=wl == "C")
        mark(f"ycsb_{wl}")
    identical("YCSB")
    rkv.drop_replica(1)
    t_mark[0] = time.perf_counter()
    for _ in range(0, RESYNC_WRITES, BATCH):
        keys = rng.integers(0, n_keys, BATCH).astype(np.int32)
        upsert_checked(rkv, keys, rng.integers(0, 127, (BATCH, V)).astype(np.int32),
                       expect)
    mark("dropped_writes")
    n_resync = rkv.resync(1)
    mark("resync")
    read_back(rkv, n_keys, V, batch=PINNED_BATCH, expect=expect, replica=1)
    mark("pinned_readback")
    rkv.check_invariants()
    rec = dict(
        phase="replicated", shards=SHARDS, replicas=REPLICAS, lanes=SHARD_LANES,
        n_keys=n_keys, config_per_shard=dataclasses.asdict(cfg),
        load_ops_per_s=n_keys / seconds["load"],
        fanout_readback_ops_per_s=n_keys / seconds["fanout_readback"],
        fanout_batch=FANOUT_BATCH, truncations_under_snapshot=truncs,
        ycsb_ops_per_mix=n_ops, ycsb_ops_per_s=rates,
        sharded_load_ops_per_s=sharded_rec["load_ops_per_s"],
        sharded_readback_ops_per_s=sharded_rec["readback_ops_per_s"],
        sharded_ycsb_ops_per_s=sharded_rec["ycsb_ops_per_s"],
        dropped_writes=RESYNC_WRITES, resync_records=n_resync,
        resync_s=seconds["resync"], migrate_batch=MIGRATE_BATCH,
        resync_rounds_run=rkv.resync_rounds,
        pinned_readback_ops_per_s=n_keys / seconds["pinned_readback"],
        pinned_batch=PINNED_BATCH, seconds_by_phase=seconds,
        rounds_by_phase=rounds, launches=dict(ops.launches),
        launches_by_phase=launches,
        compactions_per_store=rkv.compactions.tolist(),
        replica_stats=rkv.replica_stats(), io=rkv.io_stats(),
        replicas_leaf_equal_after=["load", "YCSB"],
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    return svc, rec, expect


def session_wave(rng, zipf, n_sessions, V):
    """One wave's batches: SESSION_DEPTH Zipf ops (reads, upserts, RMWs) a
    session."""
    from repro_torch import OP_READ, OP_RMW, OP_UPSERT
    out = []
    for _ in range(n_sessions):
        keys = zipf.sample(rng, SESSION_DEPTH).astype(np.int32)
        ops_ = rng.choice([OP_READ, OP_UPSERT, OP_RMW], SESSION_DEPTH,
                          p=[.5, .25, .25]).astype(np.int32)
        out.append((keys, ops_, rng.integers(0, 127, (SESSION_DEPTH, V))
                    .astype(np.int32)))
    return out


def run_session_waves(svc, sessions, rng, zipf, n_waves, expect):
    """`n_waves` waves: every session enqueues its batch, then each drains.
    Every completion equals its round's result, and every round's reads
    equal `expect` folded round by round in lane order (the traced
    schedule), which takes the writes.  Returns (ops, drain seconds,
    rounds, reads checked)."""
    import torch
    from repro_torch import OP_READ, OP_UPSERT, ST_OK
    svc.trace_schedule = True
    r0, t_run = svc.pack_rounds, 0.0
    tickets, statuses, values = [], [], []
    for _ in range(n_waves):
        batches = session_wave(rng, zipf, len(sessions), svc.V)
        t0 = time.perf_counter()
        for s, b in zip(sessions, batches):
            if not (s.enqueue(*b) >= 0).all():
                raise AssertionError("a session's ring refused an op")
        for s in sessions:
            tk, st, v = s.drain()
            tickets.append(tk), statuses.append(st), values.append(v)
        torch.cuda.synchronize()
        t_run += time.perf_counter() - t0
    rounds = svc.pack_rounds - r0
    schedule, svc.schedule, svc.trace_schedule = svc.schedule, [], False
    tk = np.concatenate(tickets)
    t_base = int(tk.min())
    n_ops = len(sessions) * SESSION_DEPTH * n_waves
    res_st = np.full(n_ops, -1, np.int32)
    res_v = np.zeros((n_ops, svc.V), np.int32)
    res_st[tk - t_base] = np.concatenate(statuses)
    res_v[tk - t_base] = np.concatenate(values)
    if (not (np.sort(tk) - t_base == np.arange(n_ops)).all()
            or not (res_st == ST_OK).all()):
        raise AssertionError("a session op was lost or failed")
    checked = 0
    for sess, valid, bkeys, bops, bvals, st, rv, tkt in schedule:
        valid = valid.cpu().numpy()
        k, o, v = (x.cpu().numpy()[valid] for x in (bkeys, bops, bvals))
        st, rv, tkt = (x.cpu().numpy()[valid] for x in (st, rv, tkt))
        if not (np.array_equal(res_st[tkt - t_base], st)
                and np.array_equal(res_v[tkt - t_base], rv)):
            raise AssertionError("a completion differs from its round's result")
        r = o == OP_READ
        if not np.array_equal(rv[r], expect[k[r]]):
            raise AssertionError("a session read returned a wrong value")
        checked += int(r.sum())
        for i in np.flatnonzero(~r):          # writes, in lane order
            expect[k[i]] = v[i] if o[i] == OP_UPSERT else expect[k[i]] + v[i]
    return n_ops, t_run, rounds, checked


def sessions_main(svc, n_keys, seed, records, expect):
    """The session service over the loaded replicated store: SESSIONS
    sessions each enqueue SESSION_DEPTH Zipf-0.99 ops (reads, upserts and
    RMWs) a wave and drain, SESSION_WAVES waves (`run_session_waves`: every
    completion and every read checked); no shard ever takes more than the
    pack width.  Then a profiler window counts host syncs per step()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.workload import Zipf
    rng = np.random.default_rng(seed + 31)
    V = svc.V
    zipf = Zipf(n_keys, 0.99)
    sessions = [svc.open_session() for _ in range(SESSIONS)]
    n_ops, t_run, rounds, checked = run_session_waves(svc, sessions, rng, zipf,
                                                      SESSION_WAVES, expect)
    if svc.max_fill > svc.W:
        raise AssertionError(f"a shard took {svc.max_fill} lanes of {svc.W}")
    obs_sessions_window(svc, sessions, rng, zipf, expect, records)
    # host syncs per step(), scheduler off (as calls_per_round): one
    # profiled step after each of 4 more waves
    steps, counts = 4, dict.fromkeys(SYNC_CALLS, 0)
    trigger, svc.kv.trigger = svc.kv.trigger, 2.0
    for _ in range(steps):
        for s, b in zip(sessions, session_wave(rng, zipf, len(sessions), V)):
            s.enqueue(*b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            svc.step()
            torch.cuda.synchronize()
        for e in _aggregate(prof):
            if e.key in counts:
                counts[e.key] += e.count
        for s in sessions:
            s.drain()
    svc.kv.trigger = trigger
    for s in sessions:
        s.close()
    rec = dict(phase="sessions", sessions=SESSIONS, session_depth=SESSION_DEPTH,
               waves=SESSION_WAVES, ops=n_ops, ops_per_s=n_ops / t_run, seconds=t_run,
               rounds=rounds, rounds_per_wave=rounds / SESSION_WAVES,
               slab_occupancy=svc.slab_occupancy(), max_fill=svc.max_fill,
               pack_lanes=svc.W, reads_checked=checked,
               profiled_steps=steps,
               host_syncs_per_step={k: c / steps for k, c in counts.items()},
               stats=svc.stats()["sessions"])
    emit(records, rec)
    return rec


def replicated_twins(cfg, device, n_keys, n_ops, seed, records):
    """ReplicatedKV(S=SHARDS, R=REPLICAS) with engine="fused" and
    "fused_ref" on the card, and a fused ShardedKV fed the same fan-in
    stream: replica 0 leaf-equal to the ShardedKV after the load; the
    "fused_ref" twin starts as a copy of the loaded "fused" one (the
    kernels against their plain versions over the 8 rows are
    kernels_replicated's), and the twins stay leaf-equal after every later
    phase (YCSB A/B/F, a forced migrate(), a drop, writes and resync, a
    session wave), replica 0 equal to the ShardedKV until the session
    wave; every key read back pinned to the resynced replica; then the
    session schedule recorded on the kernels' twin (trace_schedule)
    replayed on the ShardedKV round by round, statuses and values equal."""
    import copy
    import torch
    from repro_torch import RebalanceConfig, ReplicatedKV, ShardedKV, interop
    from repro_torch.core import replication
    from repro_torch.serve.sessions import KVSessionService
    from repro_torch.workload import Zipf
    V = cfg.value_width
    rb = RebalanceConfig(enabled=False, migrate_batch=MIGRATE_BATCH)
    fused = ReplicatedKV(dataclasses.replace(cfg, engine="fused"), SHARDS,
                         n_replicas=REPLICAS, lanes=SHARD_LANES, device=device,
                         rebalance_cfg=rb)
    flat = ShardedKV(cfg, SHARDS, lanes=SHARD_LANES, device=device, rebalance_cfg=rb)

    def same(ctx, with_flat=True):
        a, b = twins.values()
        la, lb = interop.state_leaves(a.state), interop.state_leaves(b.state)
        if not all(torch.equal(x, y) for x, y in zip(la, lb)):
            raise AssertionError(f"replicated twins diverged after {ctx}")
        if not (np.array_equal(a.compactions, b.compactions) and a.rounds == b.rounds):
            raise AssertionError(f"replicated twin counters differ after {ctx}")
        if with_flat:
            rep0 = interop.state_leaves(replication.replicated_view(a.state, REPLICAS))
            if not all(torch.equal(x[0], y) for x, y in
                       zip(rep0, interop.state_leaves(flat.state))):
                raise AssertionError(f"replica 0 differs from the ShardedKV after {ctx}")

    rng = np.random.default_rng(seed + 41)
    perm = rng.permutation(n_keys).astype(np.int32)
    for kv in (fused, flat):
        load_keys(kv, perm, V)
    plain = copy.deepcopy(fused)
    plain.cfg = dataclasses.replace(cfg, engine="fused_ref")
    twins = {"fused": fused, "fused_ref": plain}
    stores = [fused, plain, flat]
    same("load")
    zipf = Zipf(n_keys, 0.99)
    expect = val_of(np.arange(n_keys), V)
    for wl in "ABF":
        outs = [ycsb(kv, expect if kv is twins["fused"] else None, wl, n_ops, zipf,
                     np.random.default_rng(seed + ord(wl)))[1] for kv in stores]
        for per_store in zip(*outs):
            if not all(np.array_equal(x[0], per_store[0][0]) and
                       np.array_equal(x[1], per_store[0][1]) for x in per_store):
                raise AssertionError(f"replicated twin statuses/values differ in YCSB-{wl}")
        same(f"YCSB-{wl}")
    new_map = flat.bucket_map.copy()
    new_map[np.flatnonzero(new_map == 0)[0]] = 1
    moved = [kv.migrate(new_map) for kv in stores]
    if len(set(moved)) != 1 or moved[0] <= 0:
        raise AssertionError(f"replicated twins migrated {moved}")
    same("migrate")
    for kv in twins.values():
        kv.drop_replica(1)
    for _ in range(0, n_keys // 16, BATCH):
        keys = rng.integers(0, n_keys, BATCH).astype(np.int32)
        vals = rng.integers(0, 127, (BATCH, V)).astype(np.int32)
        upsert_checked(twins["fused"], keys, vals, expect)
        for kv in stores[1:]:
            kv.apply(keys, np.full(BATCH, 2, np.int32), vals)
    same("dropped writes")
    resynced = {e: kv.resync(1) for e, kv in twins.items()}
    if len(set(resynced.values())) != 1:
        raise AssertionError(f"replicated twins resynced {resynced}")
    same("resync")
    for kv in twins.values():
        read_back(kv, n_keys, V, batch=PINNED_BATCH, expect=expect, replica=1)
    same("pinned read-back")
    svcs = {e: KVSessionService(kv, max_sessions=SESSIONS, session_depth=256)
            for e, kv in twins.items()}
    svcs["fused"].trace_schedule = True
    sess = {e: [svc.open_session() for _ in range(SESSIONS)] for e, svc in svcs.items()}
    for i in range(SESSIONS):
        keys = zipf.sample(rng, 256).astype(np.int32)
        ops_ = rng.choice([1, 2, 3], 256).astype(np.int32)
        vals = rng.integers(0, 127, (256, V)).astype(np.int32)
        for e in svcs:
            sess[e][i].enqueue(keys, ops_, vals)
    for e in svcs:
        for s in sess[e]:
            s.drain()
    same("sessions", with_flat=False)
    replayed = 0
    for _, valid, bkeys, bops, bvals, st, rv, _ in svcs["fused"].schedule:
        fst, frv, _, deferred = flat.apply_round(bkeys, bops, bvals)
        flat.maybe_rebalance()
        if bool(deferred.any()) or not (torch.equal(fst, st) and torch.equal(frv, rv)):
            raise AssertionError("the ShardedKV replay of the session schedule differs")
        replayed += 1
    same("the session replay")
    for kv in stores:
        kv.check_invariants()
    emit(records, dict(phase="replicated_twins", shards=SHARDS, replicas=REPLICAS,
                       lanes=SHARD_LANES, n_keys=n_keys, ops_per_mix=n_ops,
                       migrated_records=moved[0], resync_records=resynced["fused"],
                       resync_rounds_run=twins["fused"].resync_rounds,
                       session_rounds_replayed=replayed,
                       compactions_per_store=twins["fused"].compactions.tolist(),
                       bit_exact=True))


# ---------------------------------------------------------------------------
# the host tier: a store whose cold log outgrows its device ring 8x
# ---------------------------------------------------------------------------

def host_config(n_keys, engine="fused", spilled=True):
    """make_f2_config(n_keys) with the host tier on: the device cold ring an
    eighth of the keys (the reference's `spill-8x` budget,
    benchmarks/bench_memory.py), chunks of 16 records, a chunk cache of
    2 x BATCH rows (its cache contract for batches of BATCH).  The cold-cold
    trigger's host log budget is 16 rings, so that a loaded store (~7
    rings) stays under it and its one cold->cold pass is the bounded one,
    as on the main path (a default 10% pass wraps the chunk log in both
    packages).  With `spilled` False, the all-device twin: the tier off,
    make_f2_config's cold ring (2 n), which never demotes."""
    from repro_torch.workload import make_f2_config
    cfg = make_f2_config(n_keys, engine=engine)
    if not spilled:
        return cfg
    return dataclasses.replace(cfg, host_tier=True, cold_capacity=n_keys // 8,
                               host_chunk_records=16, host_cache_chunks=2 * BATCH,
                               host_resident_frac=0.5, host_prefetch=1,
                               host_log_factor=16.0)


def _host_counters(kv):
    from repro_torch.kernels.f2_probe import ops
    ht = kv._ht
    return dict(fused_probe=ops.launches["fused_probe"],
                fused_write=ops.launches["fused_write"] / ops.WRITE_KERNELS_PER_CALL,
                ensure_rounds=ht.ensure_rounds, host_syncs=ht.syncs,
                h2d_bytes=ht.h2d_bytes, d2h_bytes=ht.d2h_bytes,
                promotions=ht.promotions, demotions=ht.demotions)


def _per_batch(before, after, n):
    return {k: (after[k] - before[k]) / n for k in after}


def host_spill(kv):
    """The live cold span over the device cold ring (the largest shard's)."""
    c = kv.state.cold
    return float((c.tail - c.begin).max()) / kv.cfg.cold_capacity


def host_profile(kv, n_keys, seed, expect, n_batches=8):
    """A profiler window over YCSB-B batches of the spilled store: device
    idle share, launches per batch, host syncs per batch, and the share of
    the window's wall time spent in the floor-aware walk's per-hop loop
    (`host_tier.walk`, each call timed on the host's clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import host_tier
    from repro_torch.workload import Zipf, make_ops
    rng = np.random.default_rng(seed + 5)
    zipf = Zipf(n_keys, 0.99)
    batches = [make_ops(rng, "B", zipf, BATCH, kv.cfg.value_width)[:3]
               for _ in range(n_batches)]
    for b in batches:
        fold(expect, *b)
    kv.apply(*batches[0])       # warm (idempotent: its upserts are folded)
    torch.cuda.synchronize()
    walk, walk_s = host_tier.walk, [0.0, 0]

    def timed_walk(*a, **k):
        t0 = time.perf_counter()
        try:
            return walk(*a, **k)
        finally:
            walk_s[0] += time.perf_counter() - t0
            walk_s[1] += 1
    host_tier.walk = timed_walk
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                st, rv = kv.apply(*b)
                st.cpu(), rv.cpu()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        host_tier.walk = walk
    events = _aggregate(prof)
    dev, host = _device_rows(prof, events)
    busy = sum(d for _, d, _ in dev)
    counts = {e.key: e.count for e in events}
    return dict(workload="B", batches=n_batches, wall_s=wall,
                device_busy_s=busy if dev else "not measured",
                device_idle_share=(1 - busy / wall) if dev else "not measured",
                launches_per_batch=sum(c for _, _, c in dev) / n_batches
                if dev else "not measured",
                walk_host_s=walk_s[0], walk_share_of_wall=walk_s[0] / wall,
                walk_calls=walk_s[1],
                host_syncs_per_batch={k: counts.get(k, 0) / n_batches for k in SYNC_CALLS},
                top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:8]],
                top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:8]])


def host_main(device, n_keys, n_ops, seed, records):
    """`KV(host_config(n_keys))` on the card: load n_keys unique keys in
    permuted order, YCSB-B then YCSB-A (Zipf 0.99) with every read checked,
    one cold->cold pass (n/64 records) under the tier inside a two-phase
    read, a uniform read-back sample; counters per batch, a profile window."""
    import torch
    from repro_torch import KV, ST_OK
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.workload import Zipf
    cfg = host_config(n_keys)
    V = cfg.value_width
    rng = np.random.default_rng(seed + 41)
    t_phase = time.perf_counter()
    parts = {}
    kv = KV(cfg, device=device)
    ops.reset_launches()
    c0 = _host_counters(kv)
    t0 = time.perf_counter()
    load_keys(kv, rng.permutation(n_keys).astype(np.int32), V)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    c_load = _host_counters(kv)
    n_load = n_keys // BATCH
    spill = host_spill(kv)
    floor = int(kv.state.cold.floor)
    if not (spill >= 4 and floor > 0):
        raise AssertionError(f"the host-tier store spilled {spill:.2f}x, floor {floor}")
    expect = val_of(np.arange(n_keys), V)
    zipf = Zipf(n_keys, 0.99)
    rates, per_mix = {}, {}
    t0 = time.perf_counter()
    for wl in "BA":
        c_a = _host_counters(kv)
        rates[wl], _ = ycsb(kv, expect, wl, n_ops, zipf, rng)
        per_mix[wl] = _per_batch(c_a, _host_counters(kv), n_ops // BATCH)
    parts["ycsb_s"] = time.perf_counter() - t0
    # a cold->cold pass under the tier inside a two-phase read
    t0 = time.perf_counter()
    keys = rng.choice(n_keys, BATCH, replace=False).astype(np.int32)
    snap = kv.read_begin(keys)
    truncs = int(kv.state.cold_truncs)
    t0 = time.perf_counter()
    kv.compact_cold_cold(n_records=max(n_keys // 64, kv.compact_batch))
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t0
    st, v = kv.read_finish(snap)
    if not (int(kv.state.cold_truncs) > truncs and bool((st == ST_OK).all())
            and np.array_equal(v.cpu().numpy(), expect[keys])):
        raise AssertionError("two-phase read across the host-tier cold->cold pass")
    parts["two_phase_s"] = time.perf_counter() - t0
    # a uniform read-back sample
    sample = rng.choice(n_keys, min(HOST_READBACK, n_keys), replace=False).astype(np.int32)
    t0 = time.perf_counter()
    for lo in range(0, len(sample), BATCH):
        k = sample[lo:lo + BATCH]
        st, v = kv.read(k)
        if not (bool((st == ST_OK).all()) and np.array_equal(v.cpu().numpy(), expect[k])):
            raise AssertionError("host-tier read-back: a key reads wrong")
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    kv.check_invariants()
    launches = dict(ops.launches)
    obs_host_window(kv, expect, zipf, rng, records)
    t0 = time.perf_counter()
    prof = host_profile(kv, n_keys, seed, expect)
    parts["profile_s"] = time.perf_counter() - t0
    kv.check_invariants()
    st = kv._ht.stats()
    emit(records, dict(
        phase="host_tier", n_keys=n_keys, config=dataclasses.asdict(cfg),
        reduced=(f"2**{n_keys.bit_length() - 1} keys for the paper's 250M (2**23 "
                 f"until the time limit asked for less), YCSB {n_ops} ops a mix "
                 f"and a read-back of {len(sample)} keys (2**19 each)"),
        load_s=t_load, load_ops_per_s=n_keys / t_load,
        ycsb_ops_per_s=rates, spill=spill, floor=floor,
        spill_after=host_spill(kv), cold_cold_s=t_cc,
        readback_keys=len(sample), readback_ops_per_s=len(sample) / t_read,
        host=st, host_store_bytes=kv._ht.host_bytes(),
        device_state_bytes=_state_bytes(kv),
        memory_model=kv.memory_model_bytes(),
        per_load_batch=_per_batch(c0, c_load, n_load), per_ycsb_batch=per_mix,
        launches=launches, profile=prof, seconds_by_part=parts,
        seconds=time.perf_counter() - t_phase))
    for k in ("fused_probe", "fused_write"):
        if launches[k] <= 0:
            raise AssertionError(f"the host-tier path never launched {k}")
    if not (st["demotions_total"] > 0 and st["promotions_total"] > 0):
        raise AssertionError(f"the host tier never moved a chunk: {st}")
    return launches


def _same_leaves(a, b, ctx):
    import torch
    from repro_torch import interop
    la, lb = interop.state_leaves(a), interop.state_leaves(b)
    if not all(torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"leaves differ: {ctx}")


def _same_host(a, b, ctx):
    ea, eb = a.export_snapshot(), b.export_snapshot()
    if a.stats() != b.stats() or not all(np.array_equal(ea[k], eb[k]) for k in ea):
        raise AssertionError(f"host stores differ: {ctx}")


def _mixed_batches(rng, n_keys, n_ops, V):
    from repro_torch import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT
    for _ in range(0, n_ops, BATCH):
        keys = rng.integers(0, n_keys, BATCH).astype(np.int32)
        ops_ = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], BATCH,
                          p=[.5, .3, .15, .05]).astype(np.int32)
        yield keys, ops_, rng.integers(0, 127, (BATCH, V)).astype(np.int32)


def _drive_equal(stores, batches, ctx):
    """The same batches into every store; statuses and values equal the
    first's batch by batch."""
    for i, b in enumerate(batches):
        outs = [s.apply(*b) for s in stores]
        for o in outs[1:]:
            if not all(bool((x == y).all()) for x, y in zip(outs[0], o)):
                raise AssertionError(f"{ctx}: batch {i} differs")


def host_twins(device, n_keys, n_ops, seed, records):
    """(1) a spilled KV and an all-device KV, both on the kernels, loaded
    with n_keys keys then fed uniform mixed batches (read/upsert/RMW/delete
    .5/.3/.15/.05, n_ops ops): statuses and values equal batch by batch;
    (2) the spilled KV on "fused" against the same drive on "fused_ref":
    every leaf and the host store equal; (3) the pair of (1) as
    ShardedKV(S=SHARDS), the spilled one in DurableKV(fsync="always") with
    a snapshot after the load; (4) that store crashed at `host.mid_demote`
    during the mixed batches, recover()ed on the card, then the remaining
    batches and every key bit-equal to the all-device twin."""
    import tempfile
    import torch
    from repro_torch import KV, DurabilityConfig, DurableKV, ShardedKV, recover
    from repro_torch.testing import faults
    V = host_config(n_keys).value_width
    t_phase = time.perf_counter()
    rec = dict(phase="host_twins", n_keys=n_keys, ops=n_ops,
               reduced=f"2**{n_keys.bit_length() - 1} keys and {n_ops} mixed ops "
                       f"(2**20 and 2**17 until the time limit asked for less)")
    perm = np.random.default_rng(seed + 51).permutation(n_keys).astype(np.int32)
    load = [(perm[lo:lo + BATCH], np.full(len(perm[lo:lo + BATCH]), 2, np.int32),
             val_of(perm[lo:lo + BATCH], V)) for lo in range(0, n_keys, BATCH)]
    mixed = list(_mixed_batches(np.random.default_rng(seed + 52), n_keys, n_ops, V))

    t0 = time.perf_counter()
    kvs = [KV(host_config(n_keys), device=device),
           KV(host_config(n_keys, spilled=False), device=device),
           KV(host_config(n_keys, engine="fused_ref"), device=device)]
    _drive_equal(kvs, load + mixed, "spilled KV against the all-device KV")
    _same_leaves(kvs[0]._st, kvs[2]._st, "KV fused against fused_ref")
    _same_host(kvs[0]._ht, kvs[2]._ht, "KV fused against fused_ref")
    rec["kv"] = dict(spill=host_spill(kvs[0]), host=kvs[0]._ht.stats(),
                     seconds=time.perf_counter() - t0)
    if not rec["kv"]["spill"] >= 4:
        raise AssertionError(f"the twins' KV spilled {rec['kv']['spill']:.2f}x")
    for kv in kvs:
        kv.check_invariants()
    del kvs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="f2_host_twins_")
    try:
        def make():
            return ShardedKV(host_config(n_keys // SHARDS), SHARDS, lanes=SHARD_LANES,
                             device=device)
        dkv = DurableKV(make(), DurabilityConfig(dir=d, fsync="always"))
        twin = ShardedKV(host_config(n_keys // SHARDS, spilled=False), SHARDS,
                         lanes=SHARD_LANES, device=device)
        _drive_equal([dkv, twin], load, "spilled ShardedKV against the all-device one")
        dkv.snapshot(blocking=True)
        snap_chunks = dkv.kv._ht.host_chunks()
        faults.arm("host.mid_demote")
        crashed = None
        try:
            for i, b in enumerate(mixed):
                try:
                    a = dkv.apply(*b)
                except faults.InjectedCrash:
                    crashed = i
                    break
                w = twin.apply(*b)
                if not all(bool((x == y).all()) for x, y in zip(a, w)):
                    raise AssertionError(f"sharded twins: mixed batch {i} differs")
        finally:
            faults.reset()
        if crashed is None:
            raise AssertionError("host.mid_demote never fired in the mixed batches")
        twin.apply(*mixed[crashed])      # the crashed batch's WAL record replays
        dkv.ckpt.wait()
        t1 = time.perf_counter()
        r = recover(d, make)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t1
        _drive_equal([r, twin], mixed[crashed + 1:], "recovered against the twin")
        for lo in range(0, n_keys, BATCH):
            k = np.arange(lo, min(lo + BATCH, n_keys), dtype=np.int32)
            a, w = r.read(k), twin.read(k)
            if not all(bool((x == y).all()) for x, y in zip(a, w)):
                raise AssertionError("recovered store: a key reads unlike the twin")
        r.check_invariants()
        rec["sharded_durable"] = dict(
            spill=host_spill(r.kv), snapshot_host_chunks=snap_chunks,
            crashed_at_mixed_batch=crashed, recover_s=t_rec, recovery=r.recovery,
            host=r.kv._ht.stats(), seconds=time.perf_counter() - t0)
        if not snap_chunks > 0:
            raise AssertionError("the snapshot held no host chunk")
        r.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec.update(bit_exact=True, seconds=time.perf_counter() - t_phase)
    emit(records, rec)


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
    from repro_torch.models.registry import get_config
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
        reduced=f"n_layers {get_config(SERVE_ARCH).n_layers} -> {cfg.n_layers}",
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
    dev, host = _device_rows(prof)
    busy = sum(d for _, d, _ in dev)
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
                         if any(n in k for n in KERNEL_FUNCTIONS["paged_attention"])],
        top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:12]],
        top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:12]])
    emit(records, rec)
    return rec


def paged_cases(cfg, live, seed):
    """(name, (q, k_pool, v_pool, table, lengths)) of paged_attention: the
    main path's call on its live layer-0 pools, page table and lengths
    (`live`, kept by serve_main with every lane active) first, then the
    edge cases: among them a long table (256 pages of 16, lengths 1 to 4096
    over the batch, many splits live), lengths of 0 over a table of more
    than one split, and lengths at the split boundaries."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops
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
    long_pages = 256
    long_table = full_table(B, n_pool, long_pages)
    long_lens = i32(np.linspace(1, ps * long_pages, B).round().astype(np.int64).tolist())
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    span = pa_ops.splits(B * Hkv, mp, sms)[0] * ps
    bounds = [span * (i // 2 + 1) + (i % 2) * (1 if i % 4 == 1 else -1) for i in range(B)]
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
        ("long_4096", (q, kp, vp, long_table, long_lens)),
        ("len_0_multi_split", (q, kp, vp, ft, i32([0, 5, 0, ps * mp, 0, 1, 0, 0][:B]))),
        ("split_boundaries", (q, kp, vp, ft, i32([min(x, ps * mp) for x in bounds]))),
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
    (2e-5 where the output is float32, 2e-2 where it is bfloat16), a second
    call bit-equal to the first, each timed beside its bound and the
    library call; returns the live case."""
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
        bitwise = torch.equal(got, pa_ops.paged_attention(*args))
        if not bitwise:
            raise AssertionError(f"paged_attention/{name}: two calls on the same "
                                 "inputs differ")
        q, kp, vp, table, lens = args
        rec = dict(case=name, B=q.shape[0], Hkv=q.shape[1], G=q.shape[2],
                   Dh=q.shape[3], page=kp.shape[2], max_pages=table.shape[1],
                   q_dtype=str(q.dtype), pool_dtype=str(kp.dtype),
                   max_abs_err=err, tol=tol, bitwise_equal=bitwise)
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
               reduced=f"n_layers 40 -> {cfg.n_layers} (4 until PR 22's phases)",
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
# training: Granite-3-8B at full width through the Trainer
# ---------------------------------------------------------------------------

def train_config():
    """Granite-3-8B at full width, TRAIN_LAYERS deep."""
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def train_main(cfg, device, seed, records, phase="train", kernel_ops=None,
               full_layers=TRAIN_FULL_LAYERS):
    """The training main path: `Trainer.run()` for TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens, ending in the trainer's blocking save of
    the whole state to a temporary directory (removed after).  The counters
    of the sequence kernel (`kernel_ops`: flash attention by default, the
    WKV kernels for RWKV-6) are zeroed just before the run and read just
    after: forward 2 x layers x steps (each block is recomputed in the
    backward pass), gradient layers x steps.  Returns (trainer, state,
    record)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.optim.adamw import AdamWConfig
    kernel_ops = kernel_ops or fa_ops
    from repro_torch.train.trainer import Trainer, TrainerConfig
    on_card = torch.device(device).type == "cuda"
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
                             ckpt_dir=ckpt_dir, log_every=1)
        pipe = TokenPipeline(cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=seed)
        tr = Trainer(cfg, AdamWConfig(total_steps=TRAIN_STEPS), tcfg, pipe,
                     device=device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = tr.init_or_restore(seed)
        _sync(device)
        t_init = time.perf_counter() - t0
        if int(state.step) != 0:
            raise AssertionError("the trainer restored a checkpoint it never wrote")
        save_s = []
        save = tr.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            save(*a, **kw)
            save_s.append(time.perf_counter() - t)

        tr.ckpt.save = timed_save
        kernel_ops.reset_launches()
        t0 = time.perf_counter()
        state = tr.run(state)
        wall = time.perf_counter() - t0
        launches = dict(kernel_ops.launches)
        log = tr.metrics_log
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt_dir) for f in fs)
        committed = tr.ckpt.latest_step()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dts = [r["dt_s"] for r in log]
    steady = sorted(dts[1:]) or dts
    ms = steady[len(steady) // 2] * 1e3
    n_params = sum(p.numel() for p in state.params.parameters())
    state_bytes = sum(t.numel() * t.element_size() for t in
                      [*state.params.parameters(), *state.opt.mu.values(),
                       *state.opt.nu.values()])
    rec = dict(
        phase=phase, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        padded_vocab=cfg.padded_vocab, dtype=cfg.dtype,
        reduced=f"n_layers {full_layers} -> {cfg.n_layers}",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, params=n_params,
        state_bytes=state_bytes, init_s=t_init, wall_s=wall,
        ms_per_step_median=ms, step_ms=[d * 1e3 for d in dts],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
        losses=[r["loss"] for r in log], grad_norms=[r["grad_norm"] for r in log],
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card else "not measured",
        save_s=save_s, checkpoint_bytes=ckpt_bytes, checkpoint_step=committed,
        launches=launches)
    emit(records, rec)
    L = cfg.n_layers
    fwd, bwd = launches            # the forward and the gradient counter
    if on_card and (launches[fwd], launches[bwd]) != (2 * L * TRAIN_STEPS, L * TRAIN_STEPS):
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"forward 2 x {L} x {TRAIN_STEPS}, gradient {L} x {TRAIN_STEPS}")
    if len(log) != TRAIN_STEPS or not np.isfinite(rec["losses"] + rec["grad_norms"]).all():
        raise AssertionError(f"losses {rec['losses']}, grad norms {rec['grad_norms']}")
    if committed != TRAIN_STEPS or not save_s:
        raise AssertionError(f"the final checkpoint was not committed ({committed})")
    return tr, state, rec


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


FLASH_KERNELS = ("flash_attention_fwd_tc", "flash_attention_bwd_tc",
                 "flash_attention_fwd_simt", "flash_attention_bwd_simt")


def train_profile(tr, state, records, n_steps=2, phase="train_profile",
                  label="flash", kernels=FLASH_KERNELS,
                  expect=("flash_attention_fwd_tc", "flash_attention_bwd_tc"),
                  kernel_ops=None):
    """A profiler window over n_steps train steps of the loaded trainer (the
    pipeline's next batches): device busy and idle share, kernel launches
    and host syncs per step, the top device kernels, and the sequence
    kernels' (`kernels`, recorded under `label`) share of device time
    beside the cuBLAS GEMMs'.  Fails unless all of the sequence kernels'
    device time lies in the `expect` entries of KERNEL_FUNCTIONS, each of
    them with some (for flash: the tensor-core route alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa_ops
    kernel_ops = kernel_ops or fa_ops
    step = int(state.step)
    batches = [{k: torch.as_tensor(v, device=tr.device)
                for k, v in tr.pipeline.batch_at(step + i).items()}
               for i in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = tr._step(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = _device_rows(prof)
    busy = sum(d for _, d, _ in dev)
    counts = {k: c for k, _, c in host}
    names = sum((KERNEL_FUNCTIONS[k] for k in kernels), ())
    seq_s = sum(d for k, d, _ in dev if any(n in k for n in names))
    per_entry = {e: sum(d for k, d, _ in dev if any(n in k for n in KERNEL_FUNCTIONS[e]))
                 for e in kernels}
    gemm = sum(d for k, d, _ in dev if any(n in k.lower() for n in GEMM_NAMES))
    rec = dict(
        phase=phase, steps=n_steps, wall_s=wall,
        ms_per_step=wall / n_steps * 1e3,
        device_busy_s=busy if dev else "not measured",
        device_idle_share=(1 - busy / wall) if dev else "not measured",
        launches_per_step=counts.get("cudaLaunchKernel", 0) / n_steps,
        stream_syncs_per_step=counts.get("cudaStreamSynchronize", 0) / n_steps,
        **{f"{label}_device_s": seq_s,
           f"{label}_share": seq_s / busy if busy else "not measured"},
        gemm_device_s=gemm, gemm_share=gemm / busy if busy else "not measured",
        **{f"{label}_kernels": [dict(name=k[:80], s=d, calls=c) for k, d, c in dev
                                if any(n in k for n in names)]},
        **{f"{label}_device_s_by_entry": per_entry},
        top_device=[dict(name=k[:80], s=d, calls=c) for k, d, c in dev[:12]],
        top_host=[dict(name=k[:80], self_s=d, calls=c) for k, d, c in host[:12]],
        launch_counters=dict(kernel_ops.launches))
    emit(records, rec)
    if dev and (any(per_entry[e] <= 0 for e in expect)
                or any(per_entry[e] > 0 for e in kernels if e not in expect)):
        raise AssertionError(f"{phase}: {label} device time by kernel {per_entry}; "
                             f"expected it all in {expect}")
    return state, rec


def flash_cases():
    """(name, BH, G, Tq, Tk, Dh, dtype, causal, window, B) of the flash
    kernels: the train phase's call first, then the edge cases."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    Hkv = 8
    T = TRAIN_SEQ
    cases = [("train", TRAIN_BATCH * Hkv, 4, T, T, 128, bf, True, 0, TRAIN_BATCH),
             ("train_f32_b1", Hkv, 4, T, T, 128, f32, True, 0, 1)]
    # tests/test_kernels.py's shapes (B, Hq, Hkv, T, Dh, causal, window)
    for i, (B, Hq, hk, T, Dh, causal, window) in enumerate((
            (2, 4, 2, 256, 64, True, 0), (1, 2, 1, 128, 128, True, 64),
            (2, 2, 2, 256, 64, False, 0), (1, 8, 1, 512, 64, True, 0))):
        for dt in (f32, bf):
            cases.append((f"kernels_{i}_{str(dt)[6:]}", B * hk, Hq // hk, T, T, Dh, dt,
                          causal, window, B))
    cases += [("dh256", 2 * 2, 2, 512, 512, 256, f32, True, 0, 2),
              ("ragged_t1000", 1 * 8, 4, 1000, 1000, 128, bf, True, 0, 1),
              ("window_edge_in_block", 1 * 8, 4, 1024, 1024, 128, f32, True, 100, 1)]
    # the tensor-core route's shapes: GLM-4-9B's G 16 (2 KV heads), Kimi's
    # Dh 112 (G 8), Gemma-7B's Dh 256 (G 1), T 1 and 17, a window edge inside
    # a 128-key tile, the reduced configs' Dh 16, Dh 128 non-causal with a
    # window
    cases += [("g16_bf16", 1 * 2, 16, 1024, 1024, 128, bf, True, 0, 1),
              ("dh112_bf16", 1 * 8, 8, 1024, 1024, 112, bf, True, 0, 1),
              ("dh256_bf16", 1 * 16, 1, 1024, 1024, 256, bf, True, 0, 1),
              ("t1_bf16", 2 * 8, 4, 1, 1, 128, bf, True, 0, 2),
              ("t17_bf16", 2 * 8, 4, 17, 17, 128, bf, True, 0, 2),
              ("window_edge_in_tile_bf16", 1 * 8, 4, 1024, 1024, 128, bf, True, 100, 1),
              ("dh16_bf16", 8 * 2, 2, 32, 32, 16, bf, True, 0, 8),
              ("noncausal_window_bf16", 1 * 8, 4, 1000, 1000, 128, bf, False, 300, 1)]
    # query and key lengths that differ, on both routes: Whisper-large's
    # cross-attention (20 heads of 64, 448 decoder tokens over 1500 encoder
    # frames, B 2; bf16 on mma.sync, and float32), causal with Tq > Tk and
    # with Tk > Tq (keys past Tq: exact-zero dK, dV) at Dh 128 (wgmma), and a
    # window with Tq > Tk whose rows at and past Tk - 1 + window see no key
    cases += [("whisper_cross_bf16", 2 * 20, 1, 448, 1500, 64, bf, False, 0, 2),
              ("whisper_cross_f32", 2 * 20, 1, 448, 1500, 64, f32, False, 0, 2),
              ("causal_q1000_k300_bf16", 1 * 8, 4, 1000, 300, 128, bf, True, 0, 1),
              ("causal_window_q200_k1000_bf16", 1 * 8, 4, 200, 1000, 128, bf, True, 40, 1),
              ("blind_rows_q300_k64_bf16", 1 * 8, 4, 300, 64, 128, bf, True, 16, 1),
              ("blind_rows_q300_k64_f32", 1 * 8, 4, 300, 64, 64, f32, True, 16, 1)]
    return cases


def _valid_pairs(Tq, Tk, causal, window):
    """(query, key) pairs the mask keeps."""
    i = np.arange(Tq)[:, None]
    j = np.arange(Tk)[None, :]
    m = np.ones((Tq, Tk), bool)
    if causal:
        m &= i >= j
    if window > 0:
        m &= (i - j) < window
    return int(m.sum())


def flash_bound(BH, G, Tq, Tk, Dh, dtype, causal, window, backward):
    """Least time of one call on these inputs: the multiply-adds of the
    pairs the mask keeps (forward: q.k and p.v; gradient: the recomputed
    q.k, dO.v, p^T dO, dS k and dS^T q, five products) at the dtype's peak,
    against each input read and each output written once at HBM's rate."""
    import torch
    esz = 2 if dtype == torch.bfloat16 else 4
    pairs = _valid_pairs(Tq, Tk, causal, window) * BH * G
    flops = (10 if backward else 4) * pairs * Dh
    q_bytes = BH * G * Tq * Dh * esz
    kv_bytes = 2 * BH * Tk * Dh * esz
    lse = BH * G * Tq * 4
    if backward:    # q, k, v, o, dO, lse in; dq, dk, dv out
        nbytes = 3 * q_bytes + kv_bytes + lse + q_bytes + kv_bytes
    else:           # q, k, v in; o, lse out
        nbytes = q_bytes + kv_bytes + q_bytes + lse
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_OPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            nbytes, flops)


def check_flash_kernels(device, seed, records):
    """The flash kernels against autograd through their plain version, on
    the card, in every case: forward within 2e-5 (float32) / 2e-2
    (bfloat16) of the plain version on the same inputs; gradients within
    1e-4 (float32, abs and rel) or 2e-2 of the largest reference gradient
    (bfloat16, the reference run in float32 on the same bfloat16 inputs).
    Each case runs on the route `ops.route` picks, which the per-route
    counters must confirm, and its gradient is taken twice and must be
    bitwise equal.  Each case is timed beside its bound and
    scaled_dot_product_attention.  Returns the train case's (forward,
    gradient) summaries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    l2_flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                if on_card else None)
    per_case = []
    for name, BH, G, T, Tk, Dh, dt, causal, window, B in flash_cases():
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dt) for s in
                       ((BH, G, T, Dh), (BH, 1, Tk, Dh), (BH, 1, Tk, Dh), (BH, G, T, Dh)))
        route = fa_ops.route(dt, Dh)
        if (route == "tc") != (dt == torch.bfloat16 and Dh in (16, 32, 64, 112, 128, 256)):
            raise AssertionError(f"flash/{name}: route {route} for {dt} at Dh {Dh}")
        bitwise = None
        if on_card:
            fa_ops.reset_launches()
            o, lse = fa_ops.forward_cuda(q, k, v, causal, window)
            dq, dk, dv = fa_ops.backward_cuda(q, k, v, o, lse, do, causal, window)
            again = fa_ops.backward_cuda(q, k, v, o, lse, do, causal, window)
            bitwise = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
            del again
            counts = {k_: n for k_, n in fa_ops.route_launches.items() if n}
            if counts != {f"flash_attention_fwd_{route}": 1,
                          f"flash_attention_bwd_{route}": 2}:
                raise AssertionError(f"flash/{name}: route launches {counts}, "
                                     f"expected the {route} route")
            if not bitwise:
                raise AssertionError(f"flash_attention_bwd/{name}: two gradient calls on "
                                     "the same inputs differ")
        else:
            qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fa_ref.mha_reference(*qkv, causal=causal, window=window)
            dq, dk, dv = torch.autograd.grad(o, qkv, do)
            o = o.detach()
        want = fa_ref.mha_reference(q, k, v, causal=causal, window=window)
        r = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref_grads = torch.autograd.grad(
            fa_ref.mha_reference(*r, causal=causal, window=window), r, do.float())
        _sync(dev)
        tol = 2e-5 if dt == torch.float32 else 2e-2
        err = float((o.float() - want.float()).abs().max())
        if o.dtype != want.dtype or not torch.allclose(o.float(), want.float(),
                                                       atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention_fwd/{name}: max |kernel - plain| "
                                 f"= {err} beyond atol = rtol = {tol}")
        gerr = {}
        for gname, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads):
            e = float((got.float() - ref).abs().max())
            gerr[gname] = e
            if dt == torch.float32:
                ok = torch.allclose(got, ref, atol=1e-4, rtol=1e-4)
            else:
                # an identically zero gradient (dq and dk at T 1: the softmax
                # over one key has no derivative) is held to the largest of
                # the three reference gradients
                scale = (float(ref.abs().max())
                         or max(float(r_.abs().max()) for r_ in ref_grads))
                ok = e <= 2e-2 * scale
            if got.dtype != dt or not ok:
                raise AssertionError(f"flash_attention_bwd/{name}: {gname} differs "
                                     f"from the plain gradient by {e}")
        if causal and Tk > T and (dk[:, :, T:].count_nonzero() or dv[:, :, T:].count_nonzero()):
            raise AssertionError(f"flash_attention_bwd/{name}: dk or dv of keys that no "
                                 "query sees is not zero")
        rec = dict(case=name, route=route, BH=BH, G=G, T=T, Tk=Tk, Dh=Dh, dtype=str(dt),
                   causal=causal, window=window, max_abs_err=err, tol=tol,
                   grad_max_abs_err=gerr, grad_bitwise_equal=bitwise)
        del want, r, ref_grads, dq, dk, dv
        if on_card:
            fwd = lambda: fa_ops.forward_cuda(q, k, v, causal, window)  # noqa: E731
            bwd = lambda: fa_ops.backward_cuda(q, k, v, o, lse, do, causal, window)  # noqa: E731
            reps = 3 if T >= 4096 else 10
            rec["fwd_ms"] = _time_ms(fwd, reps)
            rec["fwd_device_ms"] = _device_ms(lambda: (l2_flush.zero_(), fwd()), reps,
                                              KERNEL_FUNCTIONS[f"flash_attention_fwd_{route}"])
            rec["bwd_ms"] = _time_ms(bwd, reps)
            rec["bwd_device_ms"] = _device_ms(lambda: (l2_flush.zero_(), bwd()), reps,
                                              KERNEL_FUNCTIONS[f"flash_attention_bwd_{route}"])
            if name == "train":        # the gradient's three kernels apart
                rec["bwd_device_ms_by_kernel"] = {
                    n: _device_ms(lambda: (l2_flush.zero_(), bwd()), reps, (n,))
                    for n in KERNEL_FUNCTIONS[f"flash_attention_bwd_{route}"]}
            rec["fwd_plain_ms"] = _time_ms(
                lambda: fa_ref.mha_reference(q, k, v, causal=causal, window=window), 2)
            rq = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ro = fa_ref.mha_reference(*rq, causal=causal, window=window)
            rec["bwd_plain_ms"] = _time_ms(
                lambda: torch.autograd.grad(ro, rq, do, retain_graph=True), 2)
            del ro, rq
            # the library call, in the model layout it would be given
            Hkv = BH // B
            lq, lk, lv = (t.reshape(B, -1, t.shape[2], Dh) for t in (q, k, v))
            lib = dict(enable_gqa=True)
            if window > 0:
                i = torch.arange(T, device=dev)[:, None]
                j = torch.arange(Tk, device=dev)[None, :]
                m = (i - j) < window
                lib["attn_mask"] = m & (i >= j) if causal else m
            else:
                lib["is_causal"] = causal
            rec["fwd_library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(lq, lk, lv, **lib), reps)
            lt = [t.clone().requires_grad_(True) for t in (lq, lk, lv)]
            lo = F.scaled_dot_product_attention(*lt, **lib)
            ldo = do.reshape(B, Hkv * G, T, Dh)
            rec["bwd_library_ms"] = _time_ms(
                lambda: torch.autograd.grad(lo, lt, ldo, retain_graph=True), reps)
            del lo, lt
            for kind, back in (("fwd", False), ("bwd", True)):
                b = flash_bound(BH, G, T, Tk, Dh, dt, causal, window, back)
                rec.update({f"{kind}_bound_ms": b[0], f"{kind}_bound_by": b[1],
                            f"{kind}_bound_bytes": b[2], f"{kind}_bound_flops": b[3]})
        per_case.append(rec)
        del q, k, v, do, o
        if on_card:
            torch.cuda.empty_cache()
    emit(records, dict(phase="kernels", kernel="flash_attention", cases=per_case))
    main = per_case[0]

    def pick(kind):
        return dict(max_abs_err=main["max_abs_err"] if kind == "fwd"
                    else max(main["grad_max_abs_err"].values()),
                    ms=main.get(f"{kind}_ms"), device_ms=main.get(f"{kind}_device_ms"),
                    plain_ms=main.get(f"{kind}_plain_ms"),
                    library_ms=main.get(f"{kind}_library_ms"),
                    bound_ms=main.get(f"{kind}_bound_ms"),
                    bound_by=main.get(f"{kind}_bound_by"))

    return {"flash_attention_fwd": pick("fwd"), "flash_attention_bwd": pick("bwd")}


def _train_twin_model(cfg, device, seed):
    import torch
    from repro_torch.models import transformer
    model = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    if cfg.family == "ssm":
        randomise_rwkv(model, seed)
    return model


def train_twins(device, seed, records, base=None, phase="train_twins", grad_tol=1e-3):
    """The port's loss_fn and its gradients at full width (of `base`, the
    train phase's config by default), TWIN_TRAIN_LAYERS deep, in float32,
    B 1 x T TWIN_TRAIN_SEQ, one set of weights: on the card (the kernels)
    and on the CPU (the plain versions).  The losses must agree within 1e-4
    relative and each gradient leaf within `grad_tol` of its largest
    magnitude."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(base or train_config(), n_layers=TWIN_TRAIN_LAYERS,
                              dtype="float32")
    card = _train_twin_model(cfg, device, seed + 5)
    cpu = _train_twin_model(cfg, "cpu", 0)
    cpu.load_state_dict(card.state_dict())
    toks = np.random.default_rng(seed + 6).integers(
        0, cfg.vocab_size, (1, TWIN_TRAIN_SEQ + 1)).astype(np.int32)
    out = {}
    for where, model in (("card", card), ("cpu", cpu)):
        params = ts.trainable(model)
        dev = next(iter(params.values())).device
        t0 = time.perf_counter()
        loss = transformer.loss_fn(cfg, model, {"tokens": torch.as_tensor(toks, device=dev)})
        grads = torch.autograd.grad(loss, list(params.values()))
        _sync(dev)
        out[where] = (float(loss.detach()), dict(zip(params, grads)),
                      time.perf_counter() - t0)
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["card"], out["cpu"]
    rel = {n: float((g_card[n].cpu() - gc).abs().max()) / (float(gc.abs().max()) or 1.0)
           for n, gc in g_cpu.items()}
    worst_name = max(rel, key=rel.get)
    worst = rel[worst_name]
    rec = dict(phase=phase, arch=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=cfg.dtype, seq=TWIN_TRAIN_SEQ,
               loss_card=l_card, loss_cpu=l_cpu,
               loss_rel_err=abs(l_card - l_cpu) / abs(l_cpu),
               worst_grad_rel_err=worst, worst_grad_leaf=worst_name,
               grad_tol=grad_tol, worst_leaves=sorted(rel.items(), key=lambda x: -x[1])[:6],
               leaves=len(g_cpu), card_s=s_card, cpu_s=s_cpu)
    emit(records, rec)
    if not (np.isfinite(l_card) and rec["loss_rel_err"] <= 1e-4):
        raise AssertionError(f"twin losses {l_card} (card) and {l_cpu} (CPU)")
    if worst > grad_tol:
        raise AssertionError(f"gradient {worst_name} differs by {worst} of its "
                             "largest magnitude")
    return rec


def train_restart(device, records):
    """tests/test_trainer.py::test_restart_is_bit_exact on the card, at the
    reduced widths: a run that fails at step 6, restarted from its step-4
    checkpoint, ends bit-equal to a straight run."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(TRAIN_ARCH).reduced()
    root = tempfile.mkdtemp(prefix="chip_smoke_restart_")

    def mk(d, fail_at=None):
        return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=50),
                       TrainerConfig(total_steps=10, ckpt_every=4,
                                     ckpt_dir=os.path.join(root, d), log_every=100,
                                     fail_at_step=fail_at),
                       TokenPipeline(cfg.vocab_size, batch=8, seq_len=32, seed=7),
                       device=device)

    try:
        tr = mk("a", fail_at=6)
        try:
            tr.run()
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        tr.ckpt.wait()
        restored_from = tr.ckpt.latest_step()
        state = mk("a").run()
        straight = mk("b").run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    diff = [n for (n, a), (_, b) in zip(state.params.named_parameters(),
                                        straight.params.named_parameters())
            if not torch.equal(a, b)]
    rec = dict(phase="train_restart", arch=cfg.name, restored_from=restored_from,
               step=int(state.step), leaves=len(list(state.params.parameters())),
               leaves_differing=diff, bit_exact=not diff)
    emit(records, rec)
    if restored_from != 4 or int(state.step) != 10 or diff:
        raise AssertionError(f"restart not bit-exact: {rec}")
    return rec


# ---------------------------------------------------------------------------
# RWKV-6-7B: serving, prefill and training through the WKV kernels
# ---------------------------------------------------------------------------

def rwkv_config():
    from repro_torch.models.registry import get_config
    return get_config(RWKV_ARCH)


def randomise_rwkv(model, seed):
    """Token-shift mixes in [0, 1), bonus ~ N(0, 0.5), decay logits in
    [-3, 1): the initialisation's 0 / 0 / -6 would hide the token shift and
    the bonus term (a parity check then sees less of the model)."""
    import torch
    dev = model.embed.table.device
    g = torch.Generator(device=dev).manual_seed(seed)
    for blk in model.blocks:
        p = blk.rwkv
        for t, draw in ((p.mu, lambda x: torch.rand(x.shape, generator=g, device=dev)),
                        (p.mu_c, lambda x: torch.rand(x.shape, generator=g, device=dev)),
                        (p.u, lambda x: 0.5 * torch.randn(x.shape, generator=g, device=dev)),
                        (p.w0, lambda x: -3 + 4 * torch.rand(x.shape, generator=g,
                                                             device=dev))):
            t.data.copy_(draw(t))


def make_rwkv_engine(cfg, model, device, keep_logits=False):
    """A contiguous-backend `Engine` that folds every decode's logits into a
    device-side finiteness flag and, with keep_logits, keeps them (with
    the sequence position the step decoded)."""
    from repro_torch.serve.engine import Engine

    class CheckedEngine(Engine):
        def _contiguous_logits(self, toks):
            pos = int(self.cache["len"][0]) if self.kept is not None else 0
            lg = super()._contiguous_logits(toks)
            f = lg.isfinite().all()
            self.finite = f if self.finite is None else self.finite & f
            if self.kept is not None:
                self.kept.append((pos, lg))
            return lg

    eng = CheckedEngine(cfg, model, backend="contiguous", device=device, **RWKV_ENGINE)
    eng.finite, eng.kept = None, ([] if keep_logits else None)
    return eng


def rwkv_prompts(vocab_size, seed, waves):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, plen).astype(np.int32)
            for plen, n in waves for _ in range(n)]


def rwkv_serve(cfg, device, seed, records):
    """The RWKV-6 serving main path: the RWKV_WAVES requests through
    Engine(backend="contiguous") at the config's full width, each making
    RWKV_NEW_TOKENS tokens; the WKV forward counter is zeroed just before
    the run and read just after, and must be layers x decode steps.
    Returns (model, record)."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import transformer
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    eng = make_rwkv_engine(cfg, model, device)
    _sync(device)
    t_init = time.perf_counter() - t0
    prompts = rwkv_prompts(cfg.vocab_size, seed, RWKV_WAVES)
    _submit(eng, prompts, RWKV_NEW_TOKENS)
    wkv_ops.reset_launches()
    t0 = time.perf_counter()
    fin = eng.run()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(wkv_ops.launches)
    n_req = len(prompts)
    rec = dict(
        phase="rwkv_serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, engine=RWKV_ENGINE, waves=RWKV_WAVES, requests=n_req,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        new_tokens_per_request=RWKV_NEW_TOKENS,
        weights_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        state_bytes=sum(t.numel() * t.element_size() for t in eng.cache.values()),
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card else "not measured",
        init_s=t_init, steps=eng.decode_steps, wall_s=wall,
        ms_per_step=wall / eng.decode_steps * 1e3,
        generated_tokens_per_s=n_req * RWKV_NEW_TOKENS / wall, launches=launches)
    emit(records, rec)
    if on_card and launches["wkv_forward"] != cfg.n_layers * eng.decode_steps:
        raise AssertionError(f"wkv_forward launched {launches['wkv_forward']} times, "
                             f"expected {cfg.n_layers} x {eng.decode_steps}")
    if len(fin) != n_req or not all(
            len(r.out_tokens) == RWKV_NEW_TOKENS
            and all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in fin):
        raise AssertionError("a request did not return its tokens below vocab_size")
    if not bool(eng.finite):
        raise AssertionError("non-finite logits")
    return model, rec


def rwkv_prefill(cfg, model, device, seed, records):
    """The prefill main path: `prefill_step` on RWKV_PREFILL prompts at the
    config's full depth; the WKV forward counter must read one launch per
    layer.  A second, uncounted call is timed warm."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.serve import serve_step
    n, T = RWKV_PREFILL
    toks = torch.as_tensor(np.random.default_rng(seed + 9).integers(
        1, cfg.vocab_size, (n, T)).astype(np.int32), device=device)
    wkv_ops.reset_launches()
    t0 = time.perf_counter()
    lg = serve_step.prefill_step(cfg, model, {"tokens": toks})
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(wkv_ops.launches)
    finite = bool(lg.isfinite().all())
    t0 = time.perf_counter()
    serve_step.prefill_step(cfg, model, {"tokens": toks})
    _sync(device)
    warm = time.perf_counter() - t0
    rec = dict(phase="rwkv_prefill", arch=cfg.name, n_layers=cfg.n_layers,
               prompts=n, prompt_tokens=T, wall_s=wall, warm_wall_s=warm,
               tokens_per_s=n * T / warm, launches=launches,
               logits_shape=list(lg.shape), finite=finite)
    emit(records, rec)
    if torch.device(device).type == "cuda" and launches["wkv_forward"] != cfg.n_layers:
        raise AssertionError(f"prefill launched wkv_forward {launches['wkv_forward']} "
                             f"times, expected {cfg.n_layers}")
    if not finite or tuple(lg.shape) != (n, cfg.padded_vocab):
        raise AssertionError(f"prefill logits {tuple(lg.shape)}, finite={finite}")
    return rec


def rwkv_prompt_logits(cfg, model, prompts, plain_wkv=False):
    """The logits [P, n, V] of `model` (on its device, in cfg.dtype) fed the
    n prompts' P tokens one decode step at a time, as the engine feeds a
    prompt; with plain_wkv, the plain recurrence runs in the WKV kernel's
    place on a CUDA device."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops, ref as wkv_ref
    from repro_torch.models import transformer
    dev = model.embed.table.device
    tk = torch.as_tensor(np.stack(prompts), device=dev)
    cache = transformer.init_cache(cfg, len(prompts), 0, device=dev)
    kernel = wkv_ops.wkv_cuda
    if plain_wkv:
        wkv_ops.wkv_cuda = lambda r, k, v, w, u, state=None, need_state=False: (
            lambda y, s: (y, s if need_state else None))(
                *wkv_ref.wkv_reference(r, k, v, w, u, state))
    out = []
    try:
        with torch.no_grad():
            for t in range(tk.shape[1]):
                lg, cache = transformer.decode_step(cfg, model, cache, tk[:, t])
                out.append(lg)
    finally:
        wkv_ops.wkv_cuda = kernel
    return torch.stack(out)


def wkv_f64_distances(cfg, model, prompts):
    """Feeding the prompts through `model` on the card (the WKV kernel), at
    each WKV call: max |y - y64| of the kernel's y, of the plain recurrence
    on the card and of the plain recurrence on the CPU in float32, where y64
    is the plain recurrence in float64 on the same inputs; the largest over
    the layers at each prompt position."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops, ref as wkv_ref
    P = len(prompts[0])
    dist = {"kernel": [0.0] * P, "card_plain": [0.0] * P, "cpu": [0.0] * P}
    calls = [0]
    wkv = wkv_ops.wkv

    def measured(r, k, v, w, u, state=None, need_state=False):
        y, s = wkv(r, k, v, w, u, state, need_state)
        pos = calls[0] // cfg.n_layers
        calls[0] += 1
        args = [t.float() for t in (r, k, v, w, u)] + [state]
        y64 = wkv_ref.wkv_reference(*(None if t is None else t.cpu().double()
                                      for t in args))[0]
        for route, yy in (("kernel", y), ("card_plain", wkv_ref.wkv_reference(*args)[0]),
                          ("cpu", wkv_ref.wkv_reference(*(None if t is None else t.cpu()
                                                          for t in args))[0])):
            dist[route][pos] = max(dist[route][pos],
                                   float((yy.cpu().double() - y64).abs().max()))
        return y, s

    wkv_ops.wkv = measured
    try:
        rwkv_prompt_logits(cfg, model, prompts)
    finally:
        wkv_ops.wkv = wkv
    return dist


def rwkv_twins(device, seed, records):
    """RWKV-6 at full width, TWIN_LAYERS deep, float32, one set of weights
    (token shift, bonus and decay randomised): the contiguous engine on the
    card (the kernels) and on the CPU (the plain recurrence) on the same
    RWKV_TWIN_PROMPT-token prompts, the logits sampled from within
    TWIN_LOGITS_TOL, those of the prompt-feeding steps within
    RWKV_PROMPT_TOL, and every token equal; at every prompt position, the
    WKV kernel's y within RWKV_F64_RATIO times the plain recurrence's
    distance from float64 on the same inputs, and the logits' distances
    from a float64 run of the model recorded; then, on the card,
    prefill_step's last logits against RWKV_TWIN_PROMPT decode_steps over
    the same prompts (the kernel's sequence mode against its T = 1 mode)."""
    import copy
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(rwkv_config(), n_layers=TWIN_LAYERS, dtype="float32")
    card = _train_twin_model(cfg, device, seed + 10)
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu.load_state_dict(card.state_dict())
    twins = [make_rwkv_engine(cfg, m, d, keep_logits=True)
             for m, d in ((card, device), (cpu, "cpu"))]
    n = RWKV_ENGINE["max_batch"]
    prompts = rwkv_prompts(cfg.vocab_size, seed + 11, ((RWKV_TWIN_PROMPT, n),))
    t0 = time.perf_counter()
    f64 = rwkv_prompt_logits(dataclasses.replace(cfg, dtype="float64"),
                             copy.deepcopy(cpu).to(torch.float64), prompts)
    f64_s = time.perf_counter() - t0
    d64 = {"card": [0.0] * RWKV_TWIN_PROMPT, "cpu": [0.0] * RWKV_TWIN_PROMPT}
    wkv64 = None
    if torch.device(device).type == "cuda":
        plain = rwkv_prompt_logits(cfg, card, prompts, plain_wkv=True).cpu().double()
        d64["card_plain_wkv"] = (plain - f64).abs().amax(dim=(1, 2)).tolist()
        del plain
        wkv64 = wkv_f64_distances(cfg, card, prompts)
    for e in twins:
        _submit(e, prompts, RWKV_TWIN_NEW_TOKENS)
    err = [0.0] * (RWKV_TWIN_PROMPT + RWKV_TWIN_NEW_TOKENS)   # by position
    worst, steps = -1.0, 0
    t0 = time.perf_counter()
    while any(e.queue or e.active for e in twins):
        for e in twins:
            e.step()
        a, b = (e.kept for e in twins)
        if len(a) != len(b):
            raise AssertionError("the twins decoded different numbers of steps")
        for (pos, x), (_, y) in zip(a, b):
            d = (x.cpu() - y).abs()
            tol = TWIN_LOGITS_TOL if pos >= RWKV_TWIN_PROMPT - 1 else RWKV_PROMPT_TOL
            err[pos] = max(err[pos], float(d.max()))
            worst = max(worst, float((d - tol * (1 + y.abs())).max()))
            if pos < RWKV_TWIN_PROMPT:
                for route, z in (("card", x.cpu()), ("cpu", y)):
                    d64[route][pos] = max(d64[route][pos],
                                          float((z.double() - f64[pos]).abs().max()))
        steps += len(a)
        a.clear()
        b.clear()
    wall = time.perf_counter() - t0
    toks = [{r.rid: r.out_tokens for r in e.finished} for e in twins]
    # sequence mode against step mode, on the card
    tk = torch.as_tensor(np.stack(prompts), device=device)
    pre = serve_step.prefill_step(cfg, card, {"tokens": tk})
    cache = transformer.init_cache(cfg, n, 0, device=device)
    for t in range(RWKV_TWIN_PROMPT):
        lg, cache = serve_step.decode_step(cfg, card, cache, tk[:, t])
    seq_err = float((pre - lg).abs().max())
    seq_worst = float(((pre - lg).abs() - TWIN_LOGITS_TOL * (1 + lg.abs())).max())
    rec = dict(phase="rwkv_twins", arch=cfg.name, n_layers=cfg.n_layers,
               reduced=f"n_layers 32 -> {cfg.n_layers} (4 until PR 22's phases)",
               d_model=cfg.d_model, dtype=cfg.dtype, steps=steps,
               max_abs_logit_err=max(err[RWKV_TWIN_PROMPT - 1:]), tol=TWIN_LOGITS_TOL,
               prompt_max_abs_logit_err=max(err[:RWKV_TWIN_PROMPT - 1]),
               prompt_tol=RWKV_PROMPT_TOL, max_abs_logit_err_by_position=err,
               tokens_equal=toks[0] == toks[1],
               prefill_vs_decode_max_abs_err=seq_err, wall_s=wall,
               f64_max_abs_logit_err_by_position=d64, f64_s=f64_s,
               f64_card_over_cpu=max(d64["card"]) / max(max(d64["cpu"]), 1e-30),
               wkv_f64_max_abs_err_by_position=wkv64 or "not measured",
               wkv_f64_kernel_over_plain=(
                   max(wkv64["kernel"]) / max(max(wkv64["card_plain"]), 1e-30)
                   if wkv64 else "not measured"),
               f64_ratio_limit=RWKV_F64_RATIO)
    emit(records, rec)
    if worst > 0:
        raise AssertionError(f"twin logits differ beyond their tolerance: {err}")
    if wkv64 and max(wkv64["kernel"]) > RWKV_F64_RATIO * max(wkv64["card_plain"]):
        raise AssertionError(f"the WKV kernel's y sits {max(wkv64['kernel'])} from "
                             f"float64, the plain recurrence's on the same card "
                             f"{max(wkv64['card_plain'])}: a WKV kernel fault")
    if toks[0] != toks[1] or len(toks[0]) != n:
        raise AssertionError("twin tokens differ")
    if seq_worst > 0:
        raise AssertionError(f"prefill and {RWKV_TWIN_PROMPT} decode steps differ by "
                             f"{seq_err}")
    return rec


# ---------------------------------------------------------------------------

def _short_name(mangled):
    """`fa_tc_forward_kernel<64>` from its mangled name."""
    m = re.search(r"(fa_tc_[a-z_]+)(?:ILi(\d+)E)?", mangled)
    if not m:
        return mangled[:80]
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def tc_kernel_report(build):
    """Registers and spill bytes of the tensor-core flash kernels from the
    build's ptxas output, and the count of HMMA / HGMMA instructions in each
    from `cuobjdump -sass` where the toolkit has it."""
    rows, cur = {}, None
    log = build.build_log.get("flash_attention_tc")
    if log is None:
        rows["ptxas"] = "not built in this process: no ptxas output"
    for ln in (log or "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = rows.setdefault(_short_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(exe):
        sass = subprocess.run([exe, "-sass", str(build.lib_path("flash_attention_tc"))],
                              capture_output=True, text=True, timeout=300).stdout
        cur = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                cur = rows.setdefault(_short_name(m.group(1)), {})
                cur.update(hmma=0, hgmma=0)
            elif cur is not None and "HGMMA" in ln:
                cur["hgmma"] += 1
            elif cur is not None and "HMMA" in ln:
                cur["hmma"] += 1
    else:
        for r in rows.values():
            r.update(hmma="cuobjdump not found", hgmma="cuobjdump not found")
    return rows


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log2-keys", type=int, default=24)
    p.add_argument("--log2-ops", type=int, default=21,
                   help="YCSB ops per mix on the main path (the sharded "
                        "path runs half as many, the replicated path a "
                        "quarter, the twins 1/16 and the replicated twins "
                        "1/64)")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    records = []
    try:
        return run_all(a, records)
    finally:            # every phase's record so far, also when one failed
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
            with open(a.out, "w") as f:
                json.dump(records, f, indent=1)


def run_all(a, records):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.f2_probe import ops
    from repro_torch.models.registry import get_config
    from repro_torch.workload import make_f2_config

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
    emit(records, dict(phase="build_tc", kernels=tc_kernel_report(build)))
    # first, while the profiler has recorded nothing else in this process
    # (see _device_ms) and the card's memory is free for the plain version
    flash_summary = check_flash_kernels("cuda", SEED, records)
    torch.cuda.empty_cache()
    wkv_summary = check_wkv_kernels("cuda", SEED, records)
    torch.cuda.empty_cache()

    n_keys = 1 << a.log2_keys
    cfg = make_f2_config(n_keys, engine="fused")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()       # the store's peak, not the checks'
    kv, main_rec = main_path(cfg, "cuda", n_keys, 1 << a.log2_ops, SEED)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    emit(records, dict(phase="main", n_keys=n_keys,
                       reduced=f"2**{a.log2_keys} keys for the paper's 250M",
                       config=dataclasses.asdict(cfg), launches=dict(launches),
                       peak_mem_bytes=torch.cuda.max_memory_allocated(),
                       **main_rec))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {k}")

    summary = check_kernels(kv, n_keys, SEED, records)
    summary["probe"] = check_probe_kernel(kv, n_keys, SEED, records)
    profile_window(kv, n_keys, SEED, records)
    main_calls, main_syncs = calls_per_round(kv, SEED)
    obs_kv_window(kv, n_keys, SEED, records)
    del kv
    torch.cuda.empty_cache()
    twin_parity(make_f2_config(1 << TWIN_LOG2_KEYS), "cuda",
                1 << TWIN_LOG2_KEYS, 1 << (a.log2_ops - 4), SEED, records)
    torch.cuda.empty_cache()

    # the sharded store over the same keyspace, S = 4 on one card
    scfg_store = make_f2_config(n_keys // SHARDS, engine="fused")
    skv, srec, sexpect = sharded_main(scfg_store, "cuda", n_keys, 1 << (a.log2_ops - 1),
                                      SEED, records, main_rec["ycsb_ops_per_s"])
    s_calls, s_syncs = calls_per_round(skv, SEED, expect=sexpect)
    s_read_calls, s_read_syncs = calls_per_round(skv, SEED, read=True)
    srec.update(calls_per_round=s_calls, main_s1_calls_per_batch=main_calls,
                host_syncs_per_round=s_syncs, main_s1_host_syncs_per_batch=main_syncs,
                calls_per_read_round=s_read_calls, host_syncs_per_read_round=s_read_syncs)
    emit(records, srec)
    for k, n in srec["launches"].items():
        if n <= 0:
            raise AssertionError(f"the sharded path never launched {k}")
    if s_calls != main_calls:
        raise AssertionError(f"a sharded round made {s_calls} wrapper calls, a KV batch "
                             f"{main_calls}: the kernels did not take all shards at once")
    sharded_profile(skv, n_keys, SEED, records, expect=sexpect)
    s_summary = check_sharded_kernels(skv, n_keys, SEED, records)
    # durability on the loaded store, then on replicated twins
    t_dur = {"durable": time.perf_counter()}
    durable_main(skv, n_keys, SEED, records, sexpect, s_calls)
    t_dur["durable"] = time.perf_counter() - t_dur["durable"]
    del skv, sexpect
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    durable_twins(make_f2_config((1 << TWIN_LOG2_KEYS) // SHARDS), "cuda",
                  1 << TWIN_LOG2_KEYS, SEED, records)
    t_dur["durable_twins"] = time.perf_counter() - t0
    emit(records, dict(phase="durability_seconds", total=sum(t_dur.values()), **t_dur))
    torch.cuda.empty_cache()
    sharded_twins(make_f2_config((1 << TWIN_LOG2_KEYS) // SHARDS), "cuda",
                  1 << TWIN_LOG2_KEYS, 1 << (a.log2_ops - 4), SEED, records)
    torch.cuda.empty_cache()

    # the host tier: a KV whose cold log spills 8x to host memory, then the
    # spilled stores against all-device twins and their plain engine
    t_host = {"host_tier": time.perf_counter()}
    host_launches = host_main("cuda", 1 << HOST_LOG2_KEYS, HOST_OPS, SEED, records)
    t_host["host_tier"] = time.perf_counter() - t_host["host_tier"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host_twins("cuda", 1 << HOST_TWIN_LOG2_KEYS, HOST_TWIN_OPS, SEED, records)
    t_host["host_twins"] = time.perf_counter() - t0
    emit(records, dict(phase="host_seconds", total=sum(t_host.values()), **t_host))
    for k, n in host_launches.items():
        launches[k] += n
    torch.cuda.empty_cache()

    # replication and the session service over the same keyspace: R x S
    # stores in one row axis, built by make_session_service
    t_new = {"replicated": time.perf_counter()}
    svc, rrec, expect = replicated_main(scfg_store, "cuda", n_keys, 1 << (a.log2_ops - 2),
                                        SEED, records, srec)
    t_new["replicated"] = time.perf_counter() - t_new["replicated"]
    t0 = time.perf_counter()
    sessions_main(svc, n_keys, SEED, records, expect)
    t_new["sessions"] = time.perf_counter() - t0
    obs_finish(records)
    t0 = time.perf_counter()
    rkv = svc.kv
    r_calls, r_syncs = calls_per_round(rkv, SEED)
    r_read_calls, r_read_syncs = calls_per_round(rkv, SEED, read=True)
    rrec.update(calls_per_fan_in_round=r_calls, host_syncs_per_fan_in_round=r_syncs,
                calls_per_fan_out_round=r_read_calls,
                host_syncs_per_fan_out_round=r_read_syncs,
                fanout_padding=dict(rows=REPLICAS * SHARDS, lanes_per_row=SHARD_LANES,
                                    slab_lanes=REPLICAS * SHARDS * SHARD_LANES,
                                    batch_lanes=BATCH))
    emit(records, rrec)
    if r_calls != main_calls:
        raise AssertionError(f"a fan-in round made {r_calls} wrapper calls, a KV batch "
                             f"{main_calls}: the kernels did not take all R*S rows at once")
    if r_read_calls != s_read_calls:
        raise AssertionError(f"a fan-out round made {r_read_calls} wrapper calls, a "
                             f"ShardedKV read round {s_read_calls}")
    for k, n in rrec["launches"].items():
        if n <= 0:
            raise AssertionError(f"the replicated path never launched {k}")
    t_new["replicated_calls"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_profile(rkv, n_keys, SEED, records, phase="replicated_profile_fan_in")
    sharded_profile(rkv, n_keys, SEED, records, read=True,
                    phase="replicated_profile_fan_out")
    r_summary = check_sharded_kernels(rkv, n_keys, SEED, records,
                                      phase="kernels_replicated")
    t_new["profiles_and_kernels_replicated"] = time.perf_counter() - t0
    del svc, rkv, expect
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    replicated_twins(make_f2_config((1 << TWIN_LOG2_KEYS) // SHARDS), "cuda",
                     1 << TWIN_LOG2_KEYS, 1 << (a.log2_ops - 6), SEED, records)
    t_new["replicated_twins"] = time.perf_counter() - t0
    emit(records, dict(phase="replication_seconds", total=sum(t_new.values()), **t_new))
    torch.cuda.empty_cache()

    scfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    eng, serve_rec, live = serve_main(scfg, "cuda", SEED, records)
    launches["paged_attention"] = serve_rec["launches"]
    serve_profile(eng, SEED, records)
    summary["paged_attention"] = check_paged_kernel(scfg, live, SEED, records)
    del eng, live
    torch.cuda.empty_cache()
    serve_twins(scfg, "cuda", SEED, records)
    torch.cuda.empty_cache()

    tr, state, train_rec = train_main(train_config(), "cuda", SEED, records)
    launches.update(train_rec["launches"])
    train_profile(tr, state, records)
    del tr, state
    torch.cuda.empty_cache()
    summary.update(flash_summary)
    train_twins("cuda", SEED, records)
    torch.cuda.empty_cache()
    train_restart("cuda", records)
    torch.cuda.empty_cache()

    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    rcfg = rwkv_config()
    model, rserve = rwkv_serve(rcfg, "cuda", SEED, records)
    rprefill = rwkv_prefill(rcfg, model, "cuda", SEED, records)
    del model
    torch.cuda.empty_cache()
    rwkv_twins("cuda", SEED, records)
    torch.cuda.empty_cache()
    tr, state, rtrain = train_main(
        dataclasses.replace(rcfg, n_layers=RWKV_TRAIN_LAYERS), "cuda", SEED, records,
        phase="rwkv_train", kernel_ops=wkv_ops, full_layers=rcfg.n_layers)
    train_profile(tr, state, records, phase="rwkv_train_profile", label="wkv",
                  kernels=("wkv_forward", "wkv_backward"),
                  expect=("wkv_forward", "wkv_backward"), kernel_ops=wkv_ops)
    del tr, state
    torch.cuda.empty_cache()
    train_twins("cuda", SEED, records, base=rcfg, phase="rwkv_train_twins",
                grad_tol=RWKV_TWIN_GRAD_TOL)
    launches["wkv_forward"] = (rserve["launches"]["wkv_forward"]
                               + rprefill["launches"]["wkv_forward"]
                               + rtrain["launches"]["wkv_forward"])
    launches["wkv_backward"] = rtrain["launches"]["wkv_backward"]
    summary.update(wkv_summary)

    csrc = "src/repro_torch/kernels/{}/csrc/{}.cu"
    src = {"fused_probe": csrc.format("f2_probe", "fused_probe"),
           "fused_write": csrc.format("f2_probe", "fused_write"),
           "probe": csrc.format("f2_probe", "probe"),
           "wkv_forward": csrc.format("rwkv6_wkv", "wkv6"),
           "wkv_backward": csrc.format("rwkv6_wkv", "wkv6"),
           "paged_attention": csrc.format("paged_attention", "paged_attention"),
           "flash_attention_fwd": csrc.format("flash_attention", "flash_attention_tc"),
           "flash_attention_bwd": csrc.format("flash_attention", "flash_attention_tc")}
    fa = "src/repro/kernels/flash_attention/flash_attention.py:85"
    wkv = "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:55"
    replaces = {"fused_probe": "src/repro/kernels/f2_probe/f2_probe.py:160",
                "fused_write": "src/repro/kernels/f2_probe/f2_probe.py:247",
                "probe": "src/repro/kernels/f2_probe/f2_probe.py:76",
                "wkv_forward": wkv,
                "wkv_backward": wkv + " (its gradient: JAX's autodiff of "
                                      "src/repro/models/rwkv6.py:77)",
                "paged_attention":
                    "src/repro/kernels/paged_attention/paged_attention.py:97",
                "flash_attention_fwd": fa,
                "flash_attention_bwd": fa + " (its gradient: JAX's autodiff of "
                                            "src/repro/models/layers.py:109)"}
    kernels = [dict(name=k, route="cuda", source=src[k], replaces=replaces[k],
                    launches=launches[k], max_abs_err=s["max_abs_err"],
                    ms=s["ms"], device_ms=s["device_ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=s["bound_by"], library_ms=s.get("library_ms"))
               for k, s in summary.items()]
    # the same three kernels over the sharded phase's shard axis (S = 4 in
    # one launch); launches are the sharded phase's wrapper counters
    kernels += [dict(name=f"{k}_{axis}", route="cuda", source=src[k],
                     replaces=replaces[k], launches=rec["launches"][k],
                     max_abs_err=s["max_abs_err"], ms=s["ms"], device_ms=s["device_ms"],
                     plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                     bound_by=s["bound_by"], library_ms=None)
                for axis, rec, summ in (("sharded", srec, s_summary),
                                        ("replicated", rrec, r_summary))
                for k, s in summ.items()]
    for e in kernels:
        if not e["launches"] > 0:
            raise AssertionError(f"the main paths never launched {e['name']}")
    kline = dict(kernels=kernels)
    records.append(kline)
    records.append(dict(phase="total", seconds=time.perf_counter() - t_all))
    print(json.dumps(dict(phase="total", seconds=records[-1]["seconds"])))
    print(json.dumps(kline))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
