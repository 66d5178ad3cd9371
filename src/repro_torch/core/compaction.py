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
O(live set).  With the host tier the cold frontier and its liveness walks
read below-floor records through the chunk cache; the facades then run
each cold-cold step as a resumable protocol (`plan_cc_frontier`,
`cc_walk_init`, `cc_walk_round`, `cc_commit`, below), because a step's
walks may need more chunks than the cache holds at once.

Every step takes a stacked state (see `store`): `start`/`until` are [S], one
frontier a shard.  A shard whose frontier is empty (`until <= start`) is left
with its arrays untouched and its counters charged nothing, which is how the
sharded scheduler masks a step to some shards; the truncations take a `do`
mask of their own.  `conditional_insert_hot` and the three steps also
take one store's state without the shard axis (`store.entry`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import (cold_index, groups, host_tier, hybrid_log, probe_engine,
               read_cache)
from .store import (F2State, cold_probe, entry, fold_host, hot_slots,
                    merge_walk_io)
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


def _cold_frontier(cfg: F2Config, state: F2State, start: torch.Tensor,
                   until: torch.Tensor, B: int):
    """The cold log's frontier, floor-aware: with the host tier the frontier
    usually lies below the floor (the oldest records compact first), so its
    records resolve through the chunk cache.  Returns `_frontier`'s tuple
    plus (missed [S, B] chunk ids, touch [S, R]); both None with the tier
    off."""
    if not cfg.host_tier:
        return _frontier(state.cold, start, until, B) + (None, None)
    cold = state.cold
    addrs = start[:, None] + torch.arange(B, dtype=torch.int32,
                                          device=cold.key.device)
    m = ((addrs < until[:, None]) & (addrs < cold.tail[:, None])
         & (addrs >= cold.begin[:, None]))
    k, v, _, meta, missing, crow = host_tier.gather_translated(
        cfg, cold, state.host, addrs)
    missed = torch.where(m & missing, addrs >> host_tier.chunk_shift(cfg), -1)
    m = m & ~missing
    r_rows = state.host.chunk.shape[-1]
    touch = host_tier.count_touches(
        torch.zeros((addrs.shape[0], r_rows + 1), dtype=torch.int32,
                    device=addrs.device), crow, m)[:, :r_rows]
    m = m & ((meta & META_INVALID) == 0)
    return addrs, m, k, v, meta, missed, touch


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

def _cc_append(cfg: F2Config, state: F2State, stats: IoStats, live, k, v,
               meta, entries, exhausted_any) -> Tuple[F2State, torch.Tensor]:
    """The cold-cold commit tail: append the live frontier records at the
    cold tail, chained within the batch, and splice the cold index."""
    g, _, _ = cold_index.slot_coords(cfg, k)
    cold, new_addrs, last = _chain_append(state.cold, live, g, k, v,
                                          torch.zeros_like(meta), entries)
    ci, stats = cold_index.update_entries(state.cold_idx, cfg, last, k,
                                          new_addrs, stats,
                                          charge_rmw_read=False)
    cold, stats = hybrid_log.charge_flush(cold, stats, cfg.cold_mem,
                                          cfg.record_bytes)
    state = state._replace(cold=cold, cold_idx=ci, stats=stats,
                           walk_exhausted=state.walk_exhausted | exhausted_any)
    return state, count(live)


@entry
def cold_cold_step(cfg: F2Config, state: F2State, start: torch.Tensor,
                   until: torch.Tensor, B: int) -> Tuple[F2State, torch.Tensor]:
    """ConditionalInsert live cold records to the cold tail.  Live tombstones
    are dropped entirely (everything older dies with the truncation).  With
    the host tier this one-shot step must find every chunk resident (the
    facades run the resumable protocol below), so a miss latches the
    tripwire."""
    addrs, m, k, v, meta, miss_f, touch_f = _cold_frontier(cfg, state, start,
                                                           until, B)
    stats = _charge_sequential_read(state.stats, count(m), cfg.record_bytes)
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, k, m, stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res = cold_probe(cfg, state, k, addrs, cold_head, m, entries, target=addrs)
    stats = merge_walk_io(stats, res)
    if cfg.host_tier:
        state = fold_host(cfg, state, touch_f + res.touch,
                          torch.maximum(miss_f, res.missed), latch_miss=True)
    live = m & res.found & (res.addr == addrs)
    live = live & ((meta & META_TOMBSTONE) == 0)      # drop dead keys for good
    return _cc_append(cfg, state, stats, live, k, v, meta, entries,
                      torch.any(res.exhausted, -1))


def cold_truncate(cfg: F2Config, state: F2State, until: torch.Tensor) -> F2State:
    """Cold truncation; index entries below BEGIN are invalidated lazily by
    the walk guard (addr < begin terminates a chain).  num_truncs
    (cold_truncs) increments for the S5.4 anomaly fix."""
    cold = hybrid_log.truncate(state.cold, until)
    cold = cold._replace(flushed_upto=torch.maximum(cold.flushed_upto,
                                                    cold.begin))
    return state._replace(cold=cold, cold_truncs=state.cold_truncs + 1)


# ---------------------------------------------------------------------------
# The resumable cold-cold step (host tier on)
#
# A step's chunk working set (the frontier's chunks and every chunk its
# liveness walks pass) has no bound, so it cannot all be pinned in the
# cache.  The facades run each step in three parts instead:
#
#   1. ensure the frontier's chunks (at most B/C + 1 rows, pinned);
#   2. walk the liveness chains in rounds (`cc_walk_round`): a lane that
#      needs an absent chunk parks, the facade promotes the parked chunks
#      (partial, unpinned, so passed chunks can be evicted again), and the
#      next round resumes every lane from its carried cursor;
#   3. commit (`cc_commit`): the frontier again, the carried walk I/O merged
#      into IoStats once, and the one-shot step's append tail.
#
# Hop and I/O accounting equal the one-shot step's: each chain address is
# gathered and charged once (a parked lane charges nothing for the absent
# chunk), and `hops < chain_max` bounds the walk like the one-shot loop.
# Every function takes [S] frontiers; an idle shard gets an empty one.
# ---------------------------------------------------------------------------

class CcWalkCarry(NamedTuple):
    """Per-lane walk cursor carried across promote rounds."""
    cur: torch.Tensor     # int32 [S, B] next address to examine
    done: torch.Tensor    # bool  [S, B] key match found
    faddr: torch.Tensor   # int32 [S, B] matched address
    hops: torch.Tensor    # int32 [S, B] chain hops used (<= chain_max)
    io_b: torch.Tensor    # int32 [S] stable-tier block reads so far
    io_o: torch.Tensor    # int32 [S] read ops so far
    mem_h: torch.Tensor   # int32 [S] memory-tier hits so far
    missed: torch.Tensor  # int32 [S, B] chunk the lane is parked on (-1 walks)


def plan_cc_frontier(cfg: F2Config, state: F2State, start: torch.Tensor,
                     until: torch.Tensor, B: int) -> torch.Tensor:
    """Absent host chunks holding the frontier itself, missed [S, B] (pure):
    the facade ensures and pins these before the walk rounds."""
    return _cold_frontier(cfg, state, start, until, B)[5]


def _cc_walk_ctx(cfg: F2Config, state: F2State, start, until, B: int):
    """(addrs, mask, keys, entries, walk_active) of one step, recomputed a
    round; fixed while the frontier's chunks stay pinned."""
    addrs, m, keys, _, _, _, _ = _cold_frontier(cfg, state, start, until, B)
    entries, _ = cold_index.find_entries(state.cold_idx, cfg, keys, m,
                                         state.stats)
    fast = m & (entries == addrs)
    return addrs, m, keys, entries, m & ~fast


def cc_walk_init(cfg: F2Config, state: F2State, start: torch.Tensor,
                 until: torch.Tensor, B: int) -> CcWalkCarry:
    """A fresh carry: every walk lane starts at its chain head (pure)."""
    entries = _cc_walk_ctx(cfg, state, start, until, B)[3]
    S = entries.shape[0]
    dev = entries.device
    zeros = torch.zeros((S,), dtype=torch.int32, device=dev)
    return CcWalkCarry(
        cur=entries, done=torch.zeros_like(entries, dtype=torch.bool),
        faddr=torch.full_like(entries, NULL_ADDR),
        hops=torch.zeros_like(entries), io_b=zeros, io_o=zeros.clone(),
        mem_h=zeros.clone(), missed=torch.full_like(entries, -1))


def cc_walk_round(cfg: F2Config, state: F2State, start: torch.Tensor,
                  until: torch.Tensor, carry: CcWalkCarry, B: int
                  ) -> Tuple[F2State, CcWalkCarry]:
    """One bounded round of the resumable liveness walk.  Parked lanes check
    their chunk again (the facade promoted between rounds) and resume;
    lanes that meet an absent chunk park on it.  Cache traffic folds into
    the eviction signals a round; the walk's I/O sums wait in the carry for
    `cc_commit`."""
    r_rows = state.host.chunk.shape[-1]
    addrs, _, keys, _, walk_active = _cc_walk_ctx(cfg, state, start, until, B)
    hb = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    cur, done, faddr, hops, io, mem, missed, touch = host_tier.walk(
        cfg, state.cold, state.host, keys, addrs, hb, walk_active, carry.cur,
        carry.done, carry.faddr, carry.hops, max_hops=True)
    state = fold_host(cfg, state, touch[:, :r_rows], missed, latch_miss=False)
    return state, CcWalkCarry(cur=cur, done=done, faddr=faddr, hops=hops,
                              io_b=carry.io_b + io, io_o=carry.io_o + io,
                              mem_h=carry.mem_h + mem, missed=missed)


def cc_commit(cfg: F2Config, state: F2State, start: torch.Tensor,
              until: torch.Tensor, carry: CcWalkCarry, B: int
              ) -> Tuple[F2State, torch.Tensor]:
    """Commit one resumable cold-cold step from a drained carry: liveness,
    appends and IoStats equal to `cold_cold_step`'s."""
    addrs, m, k, v, meta, miss_f, touch_f = _cold_frontier(cfg, state, start,
                                                           until, B)
    stats = _charge_sequential_read(state.stats, count(m), cfg.record_bytes)
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, k, m, stats)
    fast = m & (entries == addrs)
    walk_active = m & ~fast
    stats = stats.add_reads(carry.io_b, carry.io_o).add_mem_hits(carry.mem_h)
    found = (carry.done & walk_active) | fast
    res_addr = torch.where(fast, entries, carry.faddr)
    in_range = (carry.cur != NULL_ADDR) & (carry.cur >= addrs)
    exhausted = walk_active & ~carry.done & in_range
    # an undrained carry (a lane still parked) latches the tripwire
    state = fold_host(cfg, state, touch_f, torch.maximum(miss_f, carry.missed),
                      latch_miss=True)
    live = m & found & (res_addr == addrs)
    live = live & ((meta & META_TOMBSTONE) == 0)
    return _cc_append(cfg, state, stats, live, k, v, meta, entries,
                      torch.any(exhausted, -1))


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
