"""ConditionalInsert + lookup-based compaction (paper S5.1-S5.2), and the
scan-based FASTER baseline the paper compares against.

ConditionalInsert(R, START): append R to the target log iff no record with a
matching key exists in (START, TAIL] of the source log.  The liveness probe
is a bounded chain walk from the *current* index head with lower bound
START+1 (or the `target=` mode of the probe engine for the compactions);
a whole frontier is processed in one call, so the paper's CAS-failure /
restart loop becomes deterministic intra-batch chaining.

Compaction = copying phase (ConditionalInsert every record of the frontier)
+ truncation phase (advance BEGIN, then invalidate index entries below it).
The frontier is a fixed-width batch, so the memory overhead is O(B), not
O(live set).  Host-tier variants (resumable cold-cold walks) are not ported.

Every step takes a stacked state (see `store`): `start`/`until` are [S], one
frontier a shard.  A shard whose frontier is empty (`until <= start`) is left
with its arrays untouched and its counters charged nothing, which is how the
sharded scheduler masks a step to some shards; the truncations take a `do`
mask of their own.  `conditional_insert_hot` and the three steps also
take one store's state without the shard axis (`store.entry`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cold_index, groups, hybrid_log, probe_engine, read_cache
from .store import F2State, cold_probe, entry, hot_slots, merge_walk_io
from .types import (META_INVALID, META_TOMBSTONE, NULL_ADDR, RC_FLAG,
                    F2Config, IoStats, count, excl_cumsum, is_rc, rc_untag,
                    records_to_blocks)


def _frontier(log: hybrid_log.LogState, start: torch.Tensor,
              until: torch.Tensor, B: int):
    """Gather B records a shard at [start, start+B), masked to < until and
    valid."""
    addrs = start[:, None] + torch.arange(B, dtype=torch.int32,
                                          device=log.key.device)
    m = ((addrs < until[:, None]) & (addrs < log.tail[:, None])
         & (addrs >= log.begin[:, None]))
    k, v, _, meta = hybrid_log.gather(log, addrs)
    m = m & ((meta & META_INVALID) == 0)
    return addrs, m, k, v, meta


def _charge_sequential_read(stats: IoStats, n_records: torch.Tensor,
                            record_bytes: int) -> IoStats:
    """The frontier scan itself: sequential stable-tier page reads (one I/O
    op per 32 KiB read-ahead page)."""
    blocks = records_to_blocks(n_records, record_bytes)
    return stats.add_reads(blocks, torch.div(blocks + 7, 8,
                                             rounding_mode="floor"))


def _chain_append(log: hybrid_log.LogState, live, gid, k, v,
                  metas, first_prev):
    """Append the live lanes at `log`'s tail, chaining lanes that share a
    group id (hash slot) in batch order; the first of a group continues
    `first_prev`.  Returns (log, new_addrs, is_last-of-group)."""
    ginfo = groups.group_info(live, gid)
    new_addrs = torch.where(live, log.tail[:, None] + excl_cumsum(live),
                            NULL_ADDR).to(torch.int32)
    pred_addr = groups.select_at_pos(new_addrs, ginfo.pred)
    prevs = torch.where(ginfo.pred >= 0, pred_addr, first_prev).to(torch.int32)
    log, _ = hybrid_log.append(log, live, k, v, prevs, metas)
    return log, new_addrs, live & ginfo.is_last


def _detach_rc_head(state: F2State, mask, heads):
    """Effective chain continuation behind each head (skipping an RC head),
    and the read cache with the masked lanes' RC heads invalidated."""
    head_is_rc = is_rc(heads)
    _, _, rc_p, _ = read_cache.gather(state.rc, rc_untag(heads))
    eff_prev = torch.where(head_is_rc, rc_p, heads)
    rc = read_cache.invalidate(state.rc, mask & head_is_rc, rc_untag(heads))
    return eff_prev, rc


def _publish(index: torch.Tensor, mask, slots, new_addrs):
    s, w = mask.nonzero(as_tuple=True)
    index[s, slots[s, w]] = new_addrs[s, w]
    return index


# ---------------------------------------------------------------------------
# ConditionalInsert as a standalone primitive (paper S5.1)
# ---------------------------------------------------------------------------

@entry
def conditional_insert_hot(cfg: F2Config, state: F2State, mask: torch.Tensor,
                           keys: torch.Tensor, vals: torch.Tensor,
                           start_addrs: torch.Tensor
                           ) -> Tuple[F2State, torch.Tensor]:
    """Append (key, val) to the hot-log tail iff no record with a matching
    key exists in (start_addr, TAIL] of the hot log; returns (state, ok[B])
    where ok=False means the insert aborted (a newer record exists)."""
    slots = hot_slots(cfg, keys)
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res = probe_engine.probe(cfg, keys, state.hot, start_addrs + 1, hot_head,
                             mask, index=state.hot_index, rc=state.rc,
                             rc_match=False)
    stats = merge_walk_io(state.stats, res)
    ok = mask & ~res.found
    eff_prev, rc = _detach_rc_head(state, ok, res.heads)
    hot, new_addrs, last = _chain_append(state.hot, ok, slots, keys, vals,
                                         torch.zeros_like(keys), eff_prev)
    hot_index = _publish(state.hot_index, last, slots, new_addrs)
    hot, stats = hybrid_log.charge_flush(hot, stats, cfg.hot_mem,
                                         cfg.record_bytes)
    state = state._replace(
        hot=hot, hot_index=hot_index, rc=rc, stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    return state, ok


# ---------------------------------------------------------------------------
# Hot -> Cold compaction (paper S5.2 "Hot-Cold Compaction")
# ---------------------------------------------------------------------------

@entry
def hot_cold_step(cfg: F2Config, state: F2State, start: torch.Tensor,
                  until: torch.Tensor, B: int) -> Tuple[F2State, torch.Tensor]:
    """Process one frontier of the hot log; live records (including live
    tombstones, which must shadow older cold versions) are upserted into the
    cold log.  Returns (state, n_copied)."""
    addrs, m, k, v, meta = _frontier(state.hot, start, until, B)
    stats = _charge_sequential_read(state.stats, count(m), cfg.record_bytes)
    # liveness in target mode: a lane whose index entry already points at
    # this record resolves by address compare (zero hops, zero I/O)
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res = probe_engine.probe(cfg, k, state.hot, addrs, hot_head, m,
                             index=state.hot_index, rc=state.rc,
                             rc_match=False, target=addrs)
    stats = merge_walk_io(stats, res)
    live = m & res.found & (res.addr == addrs)

    # upsert into the cold log (cold records are older by design, paper S5.2)
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, k, live,
                                             stats)
    g, _, _ = cold_index.slot_coords(cfg, k)
    cold, new_addrs, last = _chain_append(state.cold, live, g, k, v,
                                          meta & META_TOMBSTONE, entries)
    ci, stats = cold_index.update_entries(state.cold_idx, cfg, last, k,
                                          new_addrs, stats,
                                          charge_rmw_read=False)
    cold, stats = hybrid_log.charge_flush(cold, stats, cfg.cold_mem,
                                          cfg.record_bytes)
    state = state._replace(
        cold=cold, cold_idx=ci, stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    return state, count(live)


def hot_truncate(cfg: F2Config, state: F2State, until: torch.Tensor,
                 do=None) -> F2State:
    """Truncation phase: advance BEGIN and invalidate hot-index entries that
    point below it (RC-tagged heads survive — replicas remain readable).
    `do` (bool [S]) leaves the index of the other shards untouched (the
    caller keeps their scalars)."""
    hot = hybrid_log.truncate(state.hot, until)
    a = state.hot_index
    dangling = (a >= 0) & ((a & RC_FLAG) == 0) & (a < hot.begin[:, None])
    if do is not None:
        dangling = dangling & do[:, None]
    a.masked_fill_(dangling, NULL_ADDR)
    hot = hot._replace(flushed_upto=torch.maximum(hot.flushed_upto, hot.begin))
    return state._replace(hot=hot, hot_truncs=state.hot_truncs + 1)


# ---------------------------------------------------------------------------
# Cold -> Cold compaction (paper S5.2 "Cold-Cold Compaction")
# ---------------------------------------------------------------------------

@entry
def cold_cold_step(cfg: F2Config, state: F2State, start: torch.Tensor,
                   until: torch.Tensor, B: int) -> Tuple[F2State, torch.Tensor]:
    """ConditionalInsert live cold records to the cold tail.  Live tombstones
    are dropped entirely (everything older dies with the truncation)."""
    addrs, m, k, v, meta = _frontier(state.cold, start, until, B)
    stats = _charge_sequential_read(state.stats, count(m), cfg.record_bytes)
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, k, m, stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res = cold_probe(cfg, state, k, addrs, cold_head, m, entries, target=addrs)
    stats = merge_walk_io(stats, res)
    live = m & res.found & (res.addr == addrs)
    live = live & ((meta & META_TOMBSTONE) == 0)      # drop dead keys for good
    g, _, _ = cold_index.slot_coords(cfg, k)
    cold, new_addrs, last = _chain_append(state.cold, live, g, k, v,
                                          torch.zeros_like(meta), entries)
    ci, stats = cold_index.update_entries(state.cold_idx, cfg, last, k,
                                          new_addrs, stats,
                                          charge_rmw_read=False)
    cold, stats = hybrid_log.charge_flush(cold, stats, cfg.cold_mem,
                                          cfg.record_bytes)
    state = state._replace(
        cold=cold, cold_idx=ci, stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    return state, count(live)


def cold_truncate(cfg: F2Config, state: F2State, until: torch.Tensor) -> F2State:
    """Cold truncation; index entries below BEGIN are invalidated lazily by
    the walk guard (addr < begin terminates a chain).  num_truncs
    (cold_truncs) increments for the S5.4 anomaly fix."""
    cold = hybrid_log.truncate(state.cold, until)
    cold = cold._replace(flushed_upto=torch.maximum(cold.flushed_upto,
                                                    cold.begin))
    return state._replace(cold=cold, cold_truncs=state.cold_truncs + 1)


# ---------------------------------------------------------------------------
# Single-log compaction primitives (FASTER baseline + Fig 7 comparison)
# ---------------------------------------------------------------------------

@entry
def single_log_lookup_step(cfg: F2Config, state: F2State, start: torch.Tensor,
                           until: torch.Tensor, B: int,
                           charge_walk_io: bool = True
                           ) -> Tuple[F2State, torch.Tensor]:
    """F2's lookup-based compaction applied to a *single* log: live records
    of the frontier are ConditionalInserted at the hot-log tail.  With
    charge_walk_io=False this is FASTER's scan-based step: the verdict is
    the same, the cost is the full-log scan charged by charge_full_scan()."""
    addrs, m, k, v, meta = _frontier(state.hot, start, until, B)
    stats = _charge_sequential_read(state.stats, count(m), cfg.record_bytes)
    slots = hot_slots(cfg, k)
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res = probe_engine.probe(cfg, k, state.hot, addrs, hot_head, m,
                             index=state.hot_index, rc=state.rc,
                             rc_match=False, target=addrs)
    if charge_walk_io:
        stats = merge_walk_io(stats, res)
    live = m & res.found & (res.addr == addrs)
    live = live & ((meta & META_TOMBSTONE) == 0)      # single log: drop dead
    eff_prev, rc = _detach_rc_head(state, live, res.heads)
    hot, new_addrs, last = _chain_append(state.hot, live, slots, k, v,
                                         torch.zeros_like(meta), eff_prev)
    hot_index = _publish(state.hot_index, last, slots, new_addrs)
    hot, stats = hybrid_log.charge_flush(hot, stats, cfg.hot_mem,
                                         cfg.record_bytes)
    state = state._replace(
        hot=hot, hot_index=hot_index, rc=rc, stats=stats,
        walk_exhausted=state.walk_exhausted | torch.any(res.exhausted, -1))
    return state, count(live)


def charge_full_scan(cfg: F2Config, state: F2State) -> F2State:
    """Sequential read of [BEGIN, TAIL) — scan-based liveness cost."""
    n = (state.hot.tail - state.hot.begin).clamp_min(0)
    return state._replace(stats=_charge_sequential_read(state.stats, n,
                                                        cfg.record_bytes))
