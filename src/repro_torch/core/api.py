"""User-facing store facade: the batched operations, the background
compaction policy (trigger % / compact % of the paper's S5.2
Configuration), and the modeled memory/I-O reporting.

Two modes:
  mode="f2"      — tiered hot/cold logs, two-level cold index, read cache,
                   lookup-based compactions (the paper's system).
  mode="faster"  — single HybridLog + flat index, no read-cache admission;
                   compaction either "scan" (FASTER's original: full-log
                   sequential scan + O(live-set) temp table) or "lookup"
                   (the paper's replacement for its memory-constrained
                   baselines).

The store runs on the CUDA device unless the caller passes another
`device`; its state is updated in place batch by batch (see `store`).  It
holds its state as a stack of one store (leaves [1, ...], see `types`), so
the store's functions take it as it is; `KV.state` is that store's leaves
without the shard axis (views, so in-place updates show through).

With `F2Config.host_tier` a `host_tier.HostTier` manages the demoted cold
chunks: `apply` pre-faults every chunk its batch would touch
(`store.plan_fetch`), `read` promotes and retries the lanes that missed (and
splits a batch whose walks outgrow the chunk cache), the compactions demote
for ring headroom before every step and run cold-cold steps as the
resumable protocol of `compaction`.

Observability (`repro_torch.obs`, off by default): the compactions are
spanned, journaled (`compaction.*`) and counted (`f2_compactions_total`),
`stats()` is folded through the registry (`fold_stats`) and `chain_hops`
feeds the `f2_chain_hops` histogram, at the reference's points; disabled,
each site is one flag check.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from . import cold_index, compaction, host_tier, store
from .types import BLOCK_BYTES, OP_DELETE, OP_RMW, OP_UPSERT, F2Config, tree_map

COMPACTION_KINDS = ("hot_cold", "cold_cold", "single_log", "chunk_gc")


def resolve_device(device=None, owner: str = "repro_torch.KV") -> torch.device:
    """None means "cuda"; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on a CUDA device by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return dev


def check_host_tier(cfg: F2Config, mode: str, compact_batch: int) -> None:
    """The facades' host-tier contract: F2 mode, and a chunk cache that
    holds a cold-cold step's pinned frontier plus room for its walks."""
    if mode != "f2":
        raise ValueError("host_tier requires mode='f2'")
    if cfg.host_cache_chunks * cfg.host_chunk_records < \
            compact_batch + 4 * cfg.host_chunk_records:
        raise ValueError(
            "host_cache_chunks * host_chunk_records must cover compact_batch "
            "plus chain headroom (>= compact_batch + 4 * host_chunk_records)")


class KV:
    _obs_facade = "kv"      # the label of every metric this facade folds

    def __init__(self, cfg: F2Config, mode: str = "f2", trigger: float = 0.8,
                 compact_frac: float = 0.1, compact_batch: int = 2048,
                 faster_compaction: str = "scan", device=None):
        if mode not in ("f2", "faster"):
            raise ValueError(f"unknown mode {mode!r}")
        if faster_compaction not in ("scan", "lookup"):
            raise ValueError(f"unknown faster_compaction {faster_compaction!r}")
        if mode == "faster" and cfg.rc_capacity < 1:
            raise ValueError("mode='faster' needs rc_capacity >= 1 "
                             "(the arrays exist; admission is off)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.trigger = trigger
        self.compact_frac = compact_frac
        self.compact_batch = compact_batch
        self.faster_compaction = faster_compaction
        self._st = store.create(cfg, self.device, n_shards=1)
        self.compactions = 0
        # per-kind counts (the reference keeps these in its metrics registry)
        self.compaction_counts = dict.fromkeys(COMPACTION_KINDS, 0)
        self.temp_table_peak_bytes = 0   # scan-based memory overhead (Fig 7)
        self.frontier_bytes = compact_batch * cfg.record_bytes  # lookup-based
        self._admit = mode == "f2" and cfg.rc_capacity > 1
        self._ht = None
        if cfg.host_tier:
            check_host_tier(cfg, mode, compact_batch)
            self._ht = host_tier.HostTier(cfg, 1, self.device,
                                          obs_facade=self._obs_facade)

    @property
    def state(self):
        """The store's leaves without the shard axis."""
        return tree_map(lambda t: t.squeeze(0), self._st)

    @state.setter
    def state(self, st):
        self._st = tree_map(lambda t: t.unsqueeze(0), st)

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    # -- batched operations --------------------------------------------------
    def apply(self, keys, ops, vals=None):
        """Mixed batch of ops; returns (status[B], read_vals[B, V]) tensors
        on the store's device."""
        keys, ops = self._i32(keys), self._i32(ops)
        if vals is None:
            vals = torch.zeros((keys.shape[0], self.cfg.value_width),
                               dtype=torch.int32, device=self.device)
        else:
            vals = self._i32(vals)
        if self._ht is not None:
            # pre-fault every host chunk this batch would touch: writes
            # cannot defer mid-step, so the committed apply must run clean
            heads = store.fetch_heads(self.cfg, self._st, keys[None], ops[None])
            self._st = self._ht.ensure(self._st, lambda st: store.plan_fetch(
                self.cfg, st, keys[None], ops[None], heads))
        self._st, status, rvals = store.apply(self.cfg, self._st, keys[None],
                                              ops[None], vals[None],
                                              admit_rc=self._admit)
        if self._ht is not None:
            self._ht.end_batch()
        self.maybe_compact()
        return status[0], rvals[0]

    def upsert(self, keys, vals):
        return self.apply(keys, np.full(len(keys), OP_UPSERT, np.int32), vals)

    def read(self, keys):
        keys = self._i32(keys)
        active = torch.ones((keys.shape[0],), dtype=torch.bool,
                            device=self.device)
        if self._ht is not None:
            return self._read_host_lanes(keys, active)
        self._st, status, vals = store.read_batch(self.cfg, self._st,
                                                  keys[None], active[None],
                                                  admit_rc=self._admit)
        return status[0], vals[0]

    def _read_host_lanes(self, keys, active):
        """The host-tier read loop over one subset of lanes: lanes that need
        an absent chunk come back ST_NONE; their chunks are promoted
        (partial, pinned) and only those lanes run again.  When the subset's
        pinned walks outgrow the chunk cache (`CacheThrash`) the pins are
        dropped and the unserved lanes retry as two halves; only a one-lane
        subset raises (it first retries alone with the whole cache)."""
        ht = self._ht
        b = keys.shape[0]
        n_active = int(active.sum())
        status = torch.zeros((b,), dtype=torch.int32, device=self.device)
        vals = torch.zeros((b, self.cfg.value_width), dtype=torch.int32,
                           device=self.device)
        remaining = active
        for _ in range(ht.max_rounds):
            self._st, st_r, v_r, missed = store.read_batch_host(
                self.cfg, self._st, keys[None], remaining[None],
                admit_rc=self._admit)
            hmiss = missed[0] >= 0
            served = remaining & ~hmiss
            status = torch.where(served, st_r[0], status)
            vals = torch.where(served[:, None], v_r[0], vals)
            remaining = remaining & hmiss
            needs = ht.collect(missed)
            if not ht.any_missing(needs):
                break
            # partial: promote what fits now and pin it; parked lanes go
            # round again (their walks restart from the chain head)
            try:
                self._st = ht.promote(self._st, needs, partial=True)
            except host_tier.CacheThrash:
                if n_active <= 1:
                    raise
                unserved = torch.nonzero(remaining).flatten().cpu().numpy()
                ht.end_batch()
                ht.note_contract_split()
                parts = (np.array_split(unserved, 2) if len(unserved) > 1
                         else [unserved])
                for half in parts:
                    hmask = np.zeros(b, np.bool_)
                    hmask[half] = True
                    hj = torch.as_tensor(hmask, device=self.device)
                    st_h, v_h = self._read_host_lanes(keys, hj)
                    status = torch.where(hj, st_h, status)
                    vals = torch.where(hj[:, None], v_h, vals)
                return status, vals
        else:
            raise RuntimeError("host tier: read deferral did not converge")
        ht.end_batch()
        return status, vals

    def read_begin(self, keys):
        """Phase 1 of a two-phase read (`store.read_begin`): snapshot the
        keys' chain heads, the cold tail and the truncation count."""
        keys = self._i32(keys)
        active = torch.ones(keys.shape, dtype=torch.bool, device=self.device)
        self._st, snap = store.read_begin(self.cfg, self._st, keys[None],
                                          active[None])
        return snap

    def read_finish(self, snap):
        """Phase 2 (`store.read_finish`); with the host tier its cold walks'
        chunks are pre-faulted first (`store.plan_finish`).  Returns
        (status[B], values[B, V])."""
        if self._ht is not None:
            self._st = self._ht.ensure(self._st, lambda st: store.plan_finish(
                self.cfg, st, snap))
        self._st, status, vals = store.read_finish(self.cfg, self._st, snap)
        if self._ht is not None:
            self._ht.end_batch()
        return status[0], vals[0]

    def rmw(self, keys, deltas):
        return self.apply(keys, np.full(len(keys), OP_RMW, np.int32), deltas)

    def delete(self, keys):
        return self.apply(keys, np.full(len(keys), OP_DELETE, np.int32))

    # -- compaction policy (paper S5.2 Configuration) ------------------------
    def hot_fill(self) -> float:
        s = self._st.hot
        return int(s.tail - s.begin) / self.cfg.hot_capacity

    def cold_fill(self) -> float:
        s = self._st.cold
        return int(s.tail - s.begin) / self.cfg.cold_capacity

    def chunklog_fill(self) -> float:
        ci = self._st.cold_idx
        return int(ci.tail - ci.begin) / self.cfg.chunklog_capacity

    def maybe_compact(self):
        if self.mode == "faster":
            if self.hot_fill() > self.trigger:
                self.compact_single_log()
            return
        if self.hot_fill() > self.trigger:
            self.compact_hot_cold()
        # with the host tier, demotion relieves the ring: a spilled store's
        # span stays above cold_capacity, so cold-cold GC fires on the span
        # against the host log budget
        cold_budget = self.cfg.host_log_factor if self._ht is not None else 1.0
        if self.cold_fill() / cold_budget > self.trigger:
            self.compact_cold_cold()
        if self.chunklog_fill() > self.trigger:
            self.compact_chunklog()

    def compact_chunklog(self):
        """Chunk-log GC: relocate live chunks out of the oldest half."""
        with obs.span("compact.chunk_gc", cat="compaction"):
            ci, stats = cold_index.compact_chunklog(self._st.cold_idx, self.cfg,
                                                    self._st.stats)
            self._st = self._st._replace(cold_idx=ci, stats=stats)
        self.compaction_counts["chunk_gc"] += 1
        self._note_compaction("chunk_gc")

    def _note_compaction(self, kind: str, **fields):
        obs.journal.emit(f"compaction.{kind}", facade=self._obs_facade,
                         **fields)
        obs.count("f2_compactions_total", facade=self._obs_facade, kind=kind)

    def _region(self, log_tail, log_begin):
        n = int(log_tail - log_begin)
        return max(min(int(n * self.compact_frac), n), self.compact_batch)

    def _span(self, log, n_records):
        begin, tail = int(log.begin), int(log.tail)
        n = n_records or self._region(tail, begin)
        return begin, min(n, tail - begin)

    def compact_hot_cold(self, n_records: Optional[int] = None):
        """Copying phase over the oldest records, then truncation."""
        begin, n = self._span(self._st.hot, n_records)
        until = self._i32([begin + n])
        with obs.span("compact.hot_cold", cat="compaction", records=n):
            for start in range(begin, begin + n, self.compact_batch):
                if self._ht is not None:
                    # a step appends <= compact_batch cold records: demote
                    # first
                    self._st = self._ht.demote_if_needed(
                        self._st,
                        self.compact_batch + self.cfg.host_chunk_records)
                self._st, _ = compaction.hot_cold_step(
                    self.cfg, self._st, self._i32([start]), until,
                    self.compact_batch)
            self._st = compaction.hot_truncate(self.cfg, self._st, until)
        self.compactions += 1
        self.compaction_counts["hot_cold"] += 1
        self._note_compaction("hot_cold", records=n)

    def compact_cold_cold(self, n_records: Optional[int] = None):
        begin, n = self._span(self._st.cold, n_records)
        until = self._i32([begin + n])
        with obs.span("compact.cold_cold", cat="compaction", records=n):
            for start in range(begin, begin + n, self.compact_batch):
                if self._ht is not None:
                    self._ccstep_host(self._i32([start]), until)
                else:
                    self._st, _ = compaction.cold_cold_step(
                        self.cfg, self._st, self._i32([start]), until,
                        self.compact_batch)
            self._st = compaction.cold_truncate(self.cfg, self._st, until)
            if self._ht is not None:
                self._ht.end_batch()
                self._st = self._ht.gc(self._st)
        self.compactions += 1
        self.compaction_counts["cold_cold"] += 1
        self._note_compaction("cold_cold", records=n)

    def _ccstep_host(self, start, until):
        """One cold-cold step under the host tier: demote for headroom, pin
        the frontier's chunks, drain the resumable liveness walk (parked
        lanes promote partially, unpinned, and resume), then commit."""
        ht, cfg, cb = self._ht, self.cfg, self.compact_batch
        ht.end_batch()
        # survivors append at the tail while the frontier reads demoted
        # chunks, so make headroom first
        self._st = ht.demote_if_needed(self._st, cb + cfg.host_chunk_records)
        # pin the below-floor frontier chunks for the whole step: `ensure`
        # pins only what it installs, and the commit reads the frontier again
        cold = self._st.cold
        b, t, f = (int(x) for x in torch.cat([cold.begin, cold.tail,
                                              cold.floor]).tolist())
        shift = host_tier.chunk_shift(cfg)
        lo = max(int(start), b)
        hi = min(int(until), t, int(start) + cb, f)
        if lo < hi:
            ht.pin_chunks([set(range(lo >> shift, ((hi - 1) >> shift) + 1))])
        self._st = ht.ensure(self._st, lambda st: compaction.plan_cc_frontier(
            cfg, st, start, until, cb))
        carry = compaction.cc_walk_init(cfg, self._st, start, until, cb)
        self._st, carry = compaction.cc_walk_round(cfg, self._st, start, until,
                                                   carry, cb)
        for _ in range(cb * cfg.chain_max + 8):
            needs = ht.collect(carry.missed)
            if not ht.any_missing(needs):
                break
            self._st = ht.promote(self._st, needs, partial=True, pin=False)
            self._st, carry = compaction.cc_walk_round(cfg, self._st, start,
                                                       until, carry, cb)
        else:
            raise RuntimeError("host tier: cold-cold walk did not converge")
        self._st, _ = compaction.cc_commit(cfg, self._st, start, until, carry,
                                           cb)

    def compact_single_log(self, n_records: Optional[int] = None):
        begin, n = self._span(self._st.hot, n_records)
        until = self._i32([begin + n])
        live_total = 0
        with obs.span("compact.single_log", cat="compaction", records=n):
            for start in range(begin, begin + n, self.compact_batch):
                self._st, n_live = compaction.single_log_lookup_step(
                    self.cfg, self._st, self._i32([start]), until,
                    self.compact_batch,
                    charge_walk_io=self.faster_compaction == "lookup")
                live_total += int(n_live)
            if self.faster_compaction == "scan":
                # full-log sequential liveness scan + temp hash table memory
                self._st = compaction.charge_full_scan(self.cfg, self._st)
                self.temp_table_peak_bytes = max(
                    self.temp_table_peak_bytes,
                    live_total * (self.cfg.record_bytes + 16))
            self._st = compaction.hot_truncate(self.cfg, self._st, until)
        self.compactions += 1
        self.compaction_counts["single_log"] += 1
        self._note_compaction("single_log", records=n)

    # -- reporting ------------------------------------------------------------
    def io_stats(self) -> dict:
        s = self._st.stats
        return dict(read_bytes=int(s.read_blocks) * BLOCK_BYTES,
                    write_bytes=int(s.write_blocks) * BLOCK_BYTES,
                    read_ops=int(s.read_ops),
                    mem_hits=int(s.mem_hits))

    def _stats_tree(self) -> dict:
        """The raw nested telemetry tree (`io`, and `host` with the host
        tier; the flat store has no shards, replicas or sessions)."""
        t = dict(io=self.io_stats())
        if self._ht is not None:
            t["host"] = self._ht.stats()
        return t

    def stats(self) -> dict:
        """`_stats_tree()`, folded through the metrics registry when
        observability is on (every leaf an `f2_stats_*` gauge labeled by
        facade, the tree rebuilt from them: equal values and types)."""
        return obs.fold_stats(self._obs_facade, self._stats_tree())

    def chain_hops(self, keys) -> np.ndarray:
        """Per-lane hash-chain record touches for a probe of `keys` (pure:
        no state change, no modeled I/O charged); observed into the
        `f2_chain_hops` histogram when observability is on."""
        hops = store.probe_hops(self.cfg, self._st, self._i32(keys)[None])
        hops = hops[0].cpu().numpy()
        obs.observe("f2_chain_hops", hops, buckets=obs.COUNT_BUCKETS,
                    help="hash-chain record touches per probe lane",
                    facade=self._obs_facade)
        return hops

    def memory_model_bytes(self) -> dict:
        """In-memory footprint of each component under the paper's geometry
        (8 B index entries, record_bytes records, 256 B chunks)."""
        c = self.cfg
        f2 = self.mode == "f2"
        out = dict(
            hot_index=c.hot_index_size * 8,
            hot_log_mem=c.hot_mem * c.record_bytes,
            read_cache=(c.rc_capacity if f2 else 0) * c.record_bytes,
            cold_log_mem=(c.cold_mem if f2 else 0) * c.record_bytes,
            chunk_index=(c.n_chunks if f2 else 0) * 8,
            chunklog_mem=(c.chunklog_mem if f2 else 0) * c.chunk_bytes,
            host_chunk_cache=(c.host_cache_chunks * c.host_chunk_records
                              * c.record_bytes if c.host_tier else 0),
        )
        out["total"] = sum(out.values())
        if self._ht is not None:
            # host-resident chunks are not device memory: reported beside
            # the device total, not summed into it
            out["host_store_bytes"] = self._ht.host_bytes()
        return out

    def check_invariants(self):
        st = self._st
        if bool(st.hot.overflowed):
            raise AssertionError("hot log ring overflow")
        if bool(st.cold.overflowed):
            raise AssertionError("cold log ring overflow")
        if bool(st.cold_idx.overflowed):
            raise AssertionError("chunk log overwrote live chunk")
        if bool(st.walk_exhausted):
            raise AssertionError("hash chain exceeded chain_max")
        if int(st.hot.begin) > int(st.hot.tail) or \
                int(st.cold.begin) > int(st.cold.tail):
            raise AssertionError("log BEGIN passed TAIL")
        if self.cfg.host_tier:
            check_host_invariants(self.cfg, st)


def check_host_invariants(cfg: F2Config, st) -> None:
    """Per store of a stacked state: no chunk miss on a committed path, the
    floor chunk-aligned inside [0, tail], resident chunk ids unique."""
    c = cfg.host_chunk_records
    miss = st.host.missed_in_step.cpu().numpy()
    floor, tail = (x.cpu().numpy() for x in (st.cold.floor, st.cold.tail))
    chunks = st.host.chunk.cpu().numpy()
    for s in range(chunks.shape[0]):
        if miss[s]:
            raise AssertionError(f"shard {s}: host chunk miss on a committed "
                                 "path (pre-fault bug)")
        if floor[s] % c or not 0 <= floor[s] <= tail[s]:
            raise AssertionError(f"shard {s}: floor {floor[s]} not "
                                 "chunk-aligned inside [0, tail]")
        ids = chunks[s][chunks[s] >= 0]
        if np.unique(ids).size != ids.size:
            raise AssertionError(f"shard {s}: a chunk resident in two rows")
