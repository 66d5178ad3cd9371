"""Live shard rebalancing: occupancy-driven resharding of a running
`ShardedKV`.

Hash partitioning spreads keys uniformly, but skewed traffic (paper S1, S3:
Zipf workloads) can still pile onto one shard when the hot set clusters in
hash space.  Load moves at the granularity of a **bucket -> shard
indirection table** in front of the router (`shard_router.bucket_of`), one
1/n_buckets slice of the hash space at a time, never key by key.

  stats   — per-bucket placed-lane counts are taken on the device in each
            routed round and folded into a host-side EWMA; `ShardStats` is
            the one struct of occupancy, fills, traffic and imbalance.
  plan    — `plan_moves`: while the most-loaded shard is above
            threshold x mean, move its heaviest bucket that still helps to
            the least-loaded shard (numpy, deterministic).
  migrate — drain the moving buckets' live records from the source shards
            (the compaction liveness walk over the cold then the hot log),
            purge every source copy (META_INVALID), flip the map, and
            replay the drained records as routed writes.

The drain and purge steps are masked like the scheduler's compactions: a
shard with `do` False has an empty frontier (its arrays are not touched)
and `select_shards` keeps its scalars, so a shard no migration involves
stays byte-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import compaction, cold_index, hybrid_log, probe_engine, shard_router
from .store import F2State, merge_walk_io
from .types import META_INVALID, META_TOMBSTONE, F2Config, count, take


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Knobs of the occupancy-driven rebalancer.

    `enabled=False` still keeps the indirection table and the stats, so
    `rebalance()`/`migrate()` can be driven by hand; only the automatic
    trigger after each batch is off."""

    enabled: bool = True
    buckets_per_shard: int = 8     # n_buckets = S * this (power of 2)
    threshold: float = 1.25        # trigger: max/mean shard traffic EWMA
    check_every: int = 8           # scheduler cadence, in routed rounds
    decay: float = 0.9             # per-round traffic EWMA decay
    min_traffic: float = 64.0      # no moves planned on noise-level totals
    max_moves: int = 0             # bucket moves per pass (0 = n_buckets)
    migrate_batch: int = 256       # drain frontier / replay batch width
    fill_weight: float = 0.0       # blend of log occupancy into the load

    def __post_init__(self):
        b = self.buckets_per_shard
        if not (b >= 1 and (b & (b - 1)) == 0):
            raise ValueError(f"buckets_per_shard={b} not a power of 2")
        if not (self.threshold >= 1.0 and 0.0 <= self.decay < 1.0
                and self.check_every >= 1 and self.migrate_batch >= 1
                and 0.0 <= self.fill_weight <= 1.0):
            raise ValueError(f"invalid RebalanceConfig {self}")


@dataclasses.dataclass
class ShardStats:
    """Per-shard and per-bucket occupancy and traffic: what
    `ShardedKV.shard_stats()` reports and `maybe_rebalance` plans from."""

    hot_fill: np.ndarray        # float [S] hot-log occupancy fraction
    cold_fill: np.ndarray       # float [S] cold-log occupancy fraction
    chunklog_fill: np.ndarray   # float [S] chunk-log occupancy fraction
    records: np.ndarray         # int64 [S] live-region records (hot+cold)
    occupancy: np.ndarray       # int64 [S] placed lanes, last routed round
    routed_lanes: np.ndarray    # int64 [S] placed lanes, cumulative
    traffic_ewma: np.ndarray    # float [n_buckets] per-bucket traffic EWMA
    shard_traffic: np.ndarray   # float [S] EWMA aggregated by current map
    imbalance: float            # max/mean of shard_traffic (1.0 = balanced)
    bucket_map: np.ndarray      # int32 [n_buckets] current indirection

    def to_dict(self) -> dict:
        """JSON-friendly view."""
        return dict(
            hot_fill=np.round(self.hot_fill, 4).tolist(),
            cold_fill=np.round(self.cold_fill, 4).tolist(),
            chunklog_fill=np.round(self.chunklog_fill, 4).tolist(),
            records=self.records.tolist(),
            occupancy=self.occupancy.tolist(),
            routed_lanes=self.routed_lanes.tolist(),
            shard_traffic=np.round(self.shard_traffic, 2).tolist(),
            imbalance=round(float(self.imbalance), 4),
            bucket_map=self.bucket_map.tolist(),
        )


def shard_loads(traffic: np.ndarray, bucket_map: np.ndarray,
                n_shards: int) -> np.ndarray:
    """Per-shard load under a map: bucket traffic summed by assignment."""
    return np.bincount(np.asarray(bucket_map, np.int64),
                       weights=np.asarray(traffic, np.float64),
                       minlength=n_shards)


def imbalance_of(loads: np.ndarray) -> float:
    mean = float(np.mean(loads))
    return float(np.max(loads)) / mean if mean > 0 else 1.0


def blend_fill_signal(traffic: np.ndarray, bucket_map: np.ndarray,
                      fill: np.ndarray, weight: float) -> np.ndarray:
    """Fold per-shard log occupancy into the per-bucket load signal:
    t' = (1-w)*t + w*fill_implied, where the fill (rescaled to the traffic
    total) is spread over a shard's buckets by their traffic (uniformly
    when the shard saw none).  weight 0 returns `traffic` unchanged."""
    traffic = np.asarray(traffic, np.float64)
    if weight <= 0.0:
        return traffic
    bucket_map = np.asarray(bucket_map, np.int64)
    fill = np.asarray(fill, np.float64)
    S = fill.shape[0]
    total = traffic.sum()
    if total <= 0 or fill.sum() <= 0:
        return traffic
    load = shard_loads(traffic, bucket_map, S)
    n_of = np.bincount(bucket_map, minlength=S)            # buckets per shard
    share = np.where(load[bucket_map] > 0,
                     traffic / np.maximum(load[bucket_map], 1e-300),
                     1.0 / np.maximum(n_of[bucket_map], 1))
    fill_scaled = fill / fill.sum() * total                # [S], sums to total
    return (1.0 - weight) * traffic + weight * fill_scaled[bucket_map] * share


def plan_moves(traffic: np.ndarray, bucket_map: np.ndarray, n_shards: int,
               threshold: float = 1.25, max_moves: int = 0,
               min_traffic: float = 0.0, fill: Optional[np.ndarray] = None,
               fill_weight: float = 0.0) -> Optional[np.ndarray]:
    """Deterministic greedy resharding plan, or None when balanced.

    While the most-loaded shard exceeds `threshold * mean`, move its
    heaviest bucket whose load is below the src-dst gap (so the pair's
    maximum falls) to the least-loaded shard; ties break on the lowest
    bucket.  With `fill_weight > 0` the load is `blend_fill_signal`'s."""
    traffic = np.asarray(traffic, np.float64)
    bucket_map = np.asarray(bucket_map, np.int32)
    if fill is not None and fill_weight > 0.0:
        traffic = blend_fill_signal(traffic, bucket_map, fill, fill_weight)
    if traffic.sum() < max(min_traffic, 1e-12):
        return None
    load = shard_loads(traffic, bucket_map, n_shards)
    mean = load.sum() / n_shards
    new_map = bucket_map.copy()
    cap = max_moves if max_moves > 0 else len(bucket_map)
    moves = 0
    while moves < cap:
        src = int(np.argmax(load))
        dst = int(np.argmin(load))
        gap = load[src] - load[dst]
        if load[src] <= threshold * mean or gap <= 0:
            break
        cand = np.flatnonzero(new_map == src)
        w = traffic[cand]
        ok = (w > 0) & (w < gap)
        if not ok.any():
            break
        b = int(cand[int(np.argmax(np.where(ok, w, -1.0)))])
        new_map[b] = dst
        load[src] -= traffic[b]
        load[dst] += traffic[b]
        moves += 1
    return new_map if moves else None


# ---------------------------------------------------------------------------
# Masked migration steps over a stacked state
# ---------------------------------------------------------------------------

def select_shards(do: torch.Tensor, new, old):
    """The per-shard masked update of a stacked state after a step that
    touched no array row of a shard with `do` False: every per-shard scalar
    ([S] leaf) takes `new` where `do`, `old` elsewhere; the arrays are
    `new`'s (updated in place, their idle rows unchanged)."""
    if isinstance(new, torch.Tensor):
        return torch.where(do, new, old) if new.ndim == 1 else new
    vals = [select_shards(do, a, b) for a, b in zip(new, old)]
    return type(new)(*vals)


def _empty_idle(start, until, do):
    """`until` with the frontier of every shard with `do` False emptied."""
    return torch.where(do, until, start)


def drain_hot_step(cfg: F2Config, B: int, n_buckets: int, state: F2State,
                   start: torch.Tensor, until: torch.Tensor,
                   move: torch.Tensor, do: torch.Tensor):
    """One drain frontier [start, start+B) a shard over the hot log: the
    hot->cold liveness verdict (the chain's newest log record must be this
    record) and the live records of moving buckets (`move` bool [S, nb]).

    Returns (state, keys [S, B], vals [S, B, V], tomb [S, B], take [S, B]):
    `take` marks collected lanes; live tombstones are collected too (they
    replay as Deletes, to keep shadowing older cold values).  State changes
    are I/O accounting only, for the shards with `do`."""
    addrs, m, k, v, meta = compaction._frontier(
        state.hot, start, _empty_idle(start, until, do), B)
    stats = compaction._charge_sequential_read(state.stats, count(m),
                                               cfg.record_bytes)
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res = probe_engine.probe(cfg, k, state.hot, addrs, hot_head, m,
                             index=state.hot_index, rc=state.rc,
                             rc_match=False, target=addrs)
    stats = merge_walk_io(stats, res)
    live = m & res.found & (res.addr == addrs)
    moving = take(move, shard_router.bucket_of(k, n_buckets))
    took = live & moving & do[:, None]
    new_state = state._replace(
        stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    state = select_shards(do, new_state, state)
    tomb = took & ((meta & META_TOMBSTONE) != 0)
    return state, k, v, tomb, took


def drain_cold_step(cfg: F2Config, B: int, n_buckets: int, state: F2State,
                    start: torch.Tensor, until: torch.Tensor,
                    move: torch.Tensor, do: torch.Tensor):
    """Cold-log drain frontier (the cold->cold liveness verdict).  Live
    cold tombstones are not collected: the destination holds nothing for a
    migrating key, so absence already reads as deleted.  Returns (state,
    keys, vals, take)."""
    addrs, m, k, v, meta = compaction._frontier(
        state.cold, start, _empty_idle(start, until, do), B)
    stats = compaction._charge_sequential_read(state.stats, count(m),
                                               cfg.record_bytes)
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, k, m, stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res = probe_engine.probe(cfg, k, state.cold, addrs, cold_head, m,
                             heads=entries, rc=None, target=addrs)
    stats = merge_walk_io(stats, res)
    live = m & res.found & (res.addr == addrs)
    live = live & ((meta & META_TOMBSTONE) == 0)
    moving = take(move, shard_router.bucket_of(k, n_buckets))
    took = live & moving & do[:, None]
    new_state = state._replace(
        stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    state = select_shards(do, new_state, state)
    return state, k, v, took


def purge_step(cfg: F2Config, n_buckets: int, state: F2State,
               move: torch.Tensor, do: torch.Tensor) -> F2State:
    """Invalidate every source-resident record of the moving buckets: one
    masked meta sweep over the hot log, the cold log and the read cache, in
    place.  Chain walks skip META_INVALID records and continue via `prev`,
    frontiers drop them, and appends rewrite a slot's meta wholesale, so a
    purged version is never observed again, even if its bucket returns."""
    for col in (state.hot, state.cold, state.rc):
        hit = take(move, shard_router.bucket_of(col.key, n_buckets))
        hit = hit & do[:, None]
        col.meta.bitwise_or_(hit.to(torch.int32) * META_INVALID)
    return state
