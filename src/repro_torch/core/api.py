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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cold_index, compaction, store
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


class KV:
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
        self._st, status, rvals = store.apply(self.cfg, self._st, keys[None],
                                              ops[None], vals[None],
                                              admit_rc=self._admit)
        self.maybe_compact()
        return status[0], rvals[0]

    def upsert(self, keys, vals):
        return self.apply(keys, np.full(len(keys), OP_UPSERT, np.int32), vals)

    def read(self, keys):
        keys = self._i32(keys)
        active = torch.ones((keys.shape[0],), dtype=torch.bool,
                            device=self.device)
        self._st, status, vals = store.read_batch(self.cfg, self._st,
                                                  keys[None], active[None],
                                                  admit_rc=self._admit)
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
        if self.cold_fill() > self.trigger:
            self.compact_cold_cold()
        if self.chunklog_fill() > self.trigger:
            self.compact_chunklog()

    def compact_chunklog(self):
        """Chunk-log GC: relocate live chunks out of the oldest half."""
        ci, stats = cold_index.compact_chunklog(self._st.cold_idx, self.cfg,
                                                self._st.stats)
        self._st = self._st._replace(cold_idx=ci, stats=stats)
        self.compaction_counts["chunk_gc"] += 1

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
        for start in range(begin, begin + n, self.compact_batch):
            self._st, _ = compaction.hot_cold_step(
                self.cfg, self._st, self._i32([start]), until,
                self.compact_batch)
        self._st = compaction.hot_truncate(self.cfg, self._st, until)
        self.compactions += 1
        self.compaction_counts["hot_cold"] += 1

    def compact_cold_cold(self, n_records: Optional[int] = None):
        begin, n = self._span(self._st.cold, n_records)
        until = self._i32([begin + n])
        for start in range(begin, begin + n, self.compact_batch):
            self._st, _ = compaction.cold_cold_step(
                self.cfg, self._st, self._i32([start]), until,
                self.compact_batch)
        self._st = compaction.cold_truncate(self.cfg, self._st, until)
        self.compactions += 1
        self.compaction_counts["cold_cold"] += 1

    def compact_single_log(self, n_records: Optional[int] = None):
        begin, n = self._span(self._st.hot, n_records)
        until = self._i32([begin + n])
        live_total = 0
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

    # -- reporting ------------------------------------------------------------
    def io_stats(self) -> dict:
        s = self._st.stats
        return dict(read_bytes=int(s.read_blocks) * BLOCK_BYTES,
                    write_bytes=int(s.write_blocks) * BLOCK_BYTES,
                    read_ops=int(s.read_ops),
                    mem_hits=int(s.mem_hits))

    def stats(self) -> dict:
        """The nested telemetry tree (`io`; the flat store has no shards,
        replicas or sessions)."""
        return dict(io=self.io_stats())

    def chain_hops(self, keys) -> np.ndarray:
        """Per-lane hash-chain record touches for a probe of `keys` (pure:
        no state change, no modeled I/O charged)."""
        hops = store.probe_hops(self.cfg, self._st, self._i32(keys)[None])
        return hops[0].cpu().numpy()

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
            host_chunk_cache=0,
        )
        out["total"] = sum(out.values())
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
