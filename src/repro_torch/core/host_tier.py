"""Host-resident cold tier: larger-than-memory operation for the cold log.

The cold HybridLog's ring is the device-resident window.  This module adds
a third tier below it: whole chunks of `host_chunk_records` cold records
are demoted off the device into a host chunk store, and the device keeps a
small associative chunk cache (`host_cache_chunks` rows a shard) over the
demoted region.  The split point is `LogState.floor`:

    [begin, floor)  -> host tier (the manager's chunk store)
    [floor, tail)   -> device ring

    chunk id = addr >> log2(host_chunk_records)

Records below `floor` never change: in-place updates only happen in the
hot log's mutable region, and cold-cold compaction appends survivors at
the tail.  So a demoted chunk needs no write-back, an eviction is a drop,
and a demote -> promote round trip is byte-identical.

Movement between host and device happens only at the facades' fold points
(their plan / promote loops), never inside a store step:

* reads: `store.read_batch_host` reports each lane's first absent chunk as
  `missed`; the facade promotes it and runs the lane again.
* writes: the facade runs the pure `store.plan_fetch` first and promotes
  every chunk the batch would touch (writes cannot defer mid-step).
* compaction: the cold-cold frontier is pre-faulted and its liveness walk
  resumes across promotions (`compaction.cc_walk_round`); a demotion check
  before every step keeps the ring from overflowing.

The device side takes stacked states (leaves [S, ...], see `types`).  The
`HostTier` manager keeps the reference's containers and arithmetic (the
victim order, the float64 miss EWMA, the prefetch order), so its choices
are the reference's bit for bit; only the device traffic is PyTorch's.  Its
host store lives in slabs of rows (pinned when the store is on a CUDA
device) with a chunk id -> row map per shard: a promotion gathers its
chunks into a pinned staging buffer and installs them after one
non-blocking host-to-device copy, a demotion copies a span device-to-host
in a few large slabs.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from ..testing import faults
from . import hybrid_log
from .types import META_INVALID, NULL_ADDR, F2Config, i32, take


def chunk_shift(cfg: F2Config) -> int:
    """log2(host_chunk_records): addr >> shift is the chunk id."""
    c = cfg.host_chunk_records
    assert c > 0 and (c & (c - 1)) == 0, c
    return c.bit_length() - 1


class HostCacheState(NamedTuple):
    """The device chunk cache over demoted chunks (R rows x C records a
    shard).  Record columns are flat ([S, R*C]) so gathers are the log's.
    `chunk[s, r]` names the chunk in row r (-1 = empty); `tick` / `hits`
    feed the eviction policy; `missed_in_step` latches when a committed
    step saw an absent chunk (the facade pre-faults, so it must stay
    False).  1 row of 1 record while the tier is off."""
    chunk: torch.Tensor           # int32 [S, R] resident chunk id, -1 empty
    key: torch.Tensor             # int32 [S, R*C]
    val: torch.Tensor             # int32 [S, R*C, V]
    prev: torch.Tensor            # int32 [S, R*C]
    meta: torch.Tensor            # int32 [S, R*C]
    tick: torch.Tensor            # int32 [S, R] clock at last touch/install
    hits: torch.Tensor            # int32 [S, R] lifetime record touches
    clock: torch.Tensor           # int32 [S], bumped per fold
    missed_in_step: torch.Tensor  # bool [S]


def create(cfg: F2Config, device, lead=()) -> HostCacheState:
    r = cfg.host_cache_chunks if cfg.host_tier else 1
    c = cfg.host_chunk_records if cfg.host_tier else 1
    lead = tuple(lead)

    def full(shape, v):
        return torch.full(lead + shape, v, dtype=torch.int32, device=device)
    return HostCacheState(
        chunk=full((r,), -1), key=full((r * c,), -1),
        val=full((r * c, cfg.value_width), 0), prev=full((r * c,), NULL_ADDR),
        meta=full((r * c,), 0), tick=full((r,), 0), hits=full((r,), 0),
        clock=i32(0, device, lead),
        missed_in_step=torch.zeros(lead, dtype=torch.bool, device=device))


def chunk_lookup(cfg: F2Config, cold: hybrid_log.LogState,
                 host: HostCacheState) -> Tuple[torch.Tensor, int]:
    """(table [S, n + 1], n): the cache row of each chunk id below n (-1
    when absent), built once a pass, so a lane finds its row in one gather
    instead of the reference's [B, R] match (resident ids are unique, so
    the row is the same).  n covers every chunk below a floor and every
    resident chunk; ids at or past it (ring addresses) map to -1."""
    S, r_rows = host.chunk.shape
    n = int(torch.maximum(cold.floor.max() >> chunk_shift(cfg),
                          host.chunk.max() + 1))
    table = torch.full((S, n + 1), -1, dtype=torch.int32, device=host.chunk.device)
    ids = torch.where(host.chunk >= 0, host.chunk, n).long()
    table.scatter_(1, ids, torch.arange(r_rows, dtype=torch.int32,
                                        device=ids.device).expand(S, r_rows))
    table[:, n] = -1
    return table, n


def gather_translated(cfg: F2Config, cold: hybrid_log.LogState,
                      host: HostCacheState, addr: torch.Tensor):
    """(key, val, prev, meta, missing, crow) at cold-log addresses [S, W]
    across the floor: addresses >= floor resolve from the ring, the others
    from the chunk cache.  `missing` marks below-floor addresses whose
    chunk is absent; `crow` is the serving cache row (R when served from
    the ring or missing)."""
    return _gather(cfg, cold, host, addr.clamp_min(0))[:6]


def _gather(cfg, cold, host, a):
    """`gather_translated` at addresses a >= 0; also returns the chunk ids."""
    r_rows = host.chunk.shape[-1]
    table, n = chunk_lookup(cfg, cold, host)
    cid = a >> chunk_shift(cfg)
    in_ring = a >= cold.floor[:, None]
    row = take(table, cid.clamp_max(n))
    use_cache = (row >= 0) & ~in_ring
    slot = hybrid_log.slot_of(cold, a)
    fidx = (row * cfg.host_chunk_records + (a & (cfg.host_chunk_records - 1))
            ).clamp_min(0)
    k = torch.where(use_cache, take(host.key, fidx), take(cold.key, slot))
    p = torch.where(use_cache, take(host.prev, fidx), take(cold.prev, slot))
    m = torch.where(use_cache, take(host.meta, fidx), take(cold.meta, slot))
    v = torch.where(use_cache[..., None], take(host.val, fidx),
                    take(cold.val, slot))
    return (k, v, p, m, ~in_ring & (row < 0), torch.where(use_cache, row, r_rows),
            cid)


def count_touches(touch: torch.Tensor, rows: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """touch [S, R+1] += 1 at each masked lane's row (column R takes the
    rest; callers slice it off): the reference's drop-mode scatter-add."""
    S, r1 = touch.shape
    idx = torch.where(mask, rows, r1 - 1)
    flat = (torch.arange(S, device=rows.device, dtype=torch.int32)[:, None]
            * r1 + idx).reshape(-1)
    touch.view(-1).index_add_(0, flat, torch.ones_like(flat))
    return touch


class HostProbeResult(NamedTuple):
    """`probe_engine.ProbeResult` plus the host tier's miss and traffic."""
    found: torch.Tensor      # bool  [S, B]
    addr: torch.Tensor       # int32 [S, B]
    heads: torch.Tensor      # int32 [S, B]
    value: torch.Tensor      # int32 [S, B, V]
    meta: torch.Tensor       # int32 [S, B]
    hops: torch.Tensor       # int32 [S, B]
    io_blocks: torch.Tensor  # int32 [S]
    io_ops: torch.Tensor     # int32 [S]
    mem_hits: torch.Tensor   # int32 [S]
    exhausted: torch.Tensor  # bool  [S, B]
    missed: torch.Tensor     # int32 [S, B] first absent chunk hit (-1 none)
    touch: torch.Tensor      # int32 [S, R] cache-row record touches


def walk(cfg: F2Config, cold: hybrid_log.LogState, host: HostCacheState,
         keys, lower, head_boundary, walk_active, cur, done, faddr, hops,
         max_hops: bool = False):
    """The floor-aware chain walk shared by `probe_cold` and the resumable
    cold-cold rounds: up to chain_max hops from `cur` for the lanes of
    `walk_active` not yet `done`.  A lane that needs an absent chunk stops
    there with `missed` = its id.  With `max_hops` a lane also stops once
    `hops` reaches chain_max (a walk resumed across rounds).  Returns
    (cur, done, faddr, hops, io [S], mem [S], missed [S, B], touch [S, R+1]
    with column R to drop).

    Every other hop (every hop on the CPU) it checks whether any lane still
    walks; the hops after that change nothing, so stopping is exact."""
    r_rows = host.chunk.shape[-1]
    cap = hybrid_log.capacity_of(cold)
    c = cfg.host_chunk_records
    shift = chunk_shift(cfg)
    table, n = chunk_lookup(cfg, cold, host)
    # key, prev and meta of the ring and then of the cache in one table, so
    # a hop is one gather wherever its record lives; `start` is each chunk
    # id's first record in it (-1 when the chunk is absent)
    kpm = torch.cat([torch.stack([cold.key, cold.prev, cold.meta], -1),
                     torch.stack([host.key, host.prev, host.meta], -1)], 1)
    start = torch.where(table >= 0, cap + table * c, -1)
    every = 1 if keys.device.type == "cpu" else 2
    hb = head_boundary[:, None]
    floor = cold.floor[:, None]
    ready = walk_active & ~done
    missed = torch.full_like(cur, -1)
    hops0, hops = hops, hops.clone()
    ios = torch.zeros_like(hops)
    starts_hit = []
    for i in range(cfg.chain_max):
        # lower >= 0, so cur >= lower also excludes NULL_ADDR
        searching = ready & (cur >= lower)
        if max_hops:
            searching &= hops < cfg.chain_max
        if i % every == 0 and not bool(searching.any()):
            break
        a = cur.clamp_min(0)
        cid = a >> shift
        below = a < floor
        first = take(start, cid.clamp_max(n))
        use_cache = below & (first >= 0)
        missing = below & (first < 0)
        k, p, m = take(kpm, torch.where(use_cache, first + (a & (c - 1)),
                                        a & (cap - 1))).unbind(-1)
        newly = searching & missing
        missed = torch.where(newly, cid, missed)
        live = searching ^ newly                 # newly is part of searching
        key_match = live & ((m & META_INVALID) == 0) & (k == keys)
        ios.add_(live & (cur < hb))
        hops.add_(live)
        starts_hit.append(torch.where(live & use_cache, first, -1))
        faddr = torch.where(key_match, cur, faddr)
        done = done | key_match
        ready = ready ^ (key_match | newly)      # both are part of ready
        cur = torch.where(live ^ key_match, p, cur)
    S = cur.shape[0]
    touch = torch.zeros((S, r_rows + 1), dtype=torch.int32, device=cur.device)
    if starts_hit:
        f = torch.stack(starts_hit, -1).reshape(S, -1)
        count_touches(touch, (f - cap) >> shift, f >= 0)
    io = ios.sum(dim=-1, dtype=torch.int32)
    mem = (hops - hops0).sum(dim=-1, dtype=torch.int32) - io
    return cur, done, faddr, hops, io, mem, missed, touch


def probe_cold(cfg: F2Config, keys: torch.Tensor, cold: hybrid_log.LogState,
               host: HostCacheState, lower: torch.Tensor,
               head_boundary: torch.Tensor, active: torch.Tensor,
               heads: torch.Tensor, target: Optional[torch.Tensor] = None
               ) -> HostProbeResult:
    """Floor-aware cold-chain walk: `probe_engine.probe(heads=...)` with
    translated gathers.  A lane that needs an absent chunk stops with
    `missed` = that chunk id (its results are garbage until the facade
    promotes the chunk and probes again).  Without misses the result is
    the ring-only probe's, modeled I/O included.  Plain PyTorch, a few ops
    a hop, as `chain.walk`."""
    S, B = keys.shape
    dev = keys.device
    r_rows = host.chunk.shape[-1]
    if target is not None:
        fast = active & (heads == target)
        walk_active = active & ~fast
    else:
        fast = torch.zeros_like(active)
        walk_active = active
    cur, done, faddr, hops, io, mem, missed, touch = walk(
        cfg, cold, host, keys, lower, head_boundary, walk_active, heads,
        torch.zeros((S, B), dtype=torch.bool, device=dev),
        torch.full((S, B), NULL_ADDR, dtype=torch.int32, device=dev),
        torch.zeros((S, B), dtype=torch.int32, device=dev))
    in_range_end = (cur != NULL_ADDR) & (cur >= lower)
    exhausted = walk_active & ~done & in_range_end & (missed < 0)
    found = (done & walk_active) | fast
    addr = torch.where(fast, heads, faddr)
    # the value gather at the found address can cross the floor too (target
    # mode's fast lanes never walked), so its misses fold in
    _, v2, _, m2, miss2, crow2, cid2 = _gather(
        cfg, cold, host, torch.where(found, addr, 0).clamp_min(0))
    missed = torch.where(found & miss2, cid2, missed)
    found = found & ~miss2
    count_touches(touch, crow2, found)
    return HostProbeResult(
        found=found, addr=addr, heads=heads,
        value=torch.where(found[..., None], v2, 0),
        meta=torch.where(found, m2, 0), hops=hops, io_blocks=io,
        io_ops=io.clone(), mem_hits=mem, exhausted=exhausted,
        missed=missed, touch=touch[:, :r_rows])


def fold_touch(host: HostCacheState, touch: torch.Tensor,
               any_missed) -> HostCacheState:
    """Fold one pass's cache traffic into the eviction signals (rows
    updated in place): touched rows take the current clock as their tick,
    hits accumulate, the clock advances and the miss tripwire latches."""
    host.tick.copy_(torch.where(touch > 0, host.clock[:, None], host.tick))
    host.hits.add_(touch)
    return host._replace(clock=host.clock + 1,
                         missed_in_step=host.missed_in_step | any_missed)


# ---------------------------------------------------------------------------
# state-level steps (on any state with .cold / .host, so that this module
# does not import store.py); they update the state's tensors in place
# ---------------------------------------------------------------------------

def install_rows(state, shard: torch.Tensor, rows: torch.Tensor,
                 cids: torch.Tensor, keyb: torch.Tensor, valb: torch.Tensor,
                 prevb: torch.Tensor, metab: torch.Tensor):
    """Write n promoted chunks ([n] shard, row, id; [n, C] / [n, C, V]
    records) into their cache rows; installed rows take tick = clock and
    zero hits.  A shard's rows are distinct."""
    host = state.host
    n, c = keyb.shape
    s, r = shard.long(), rows.long()
    host.chunk[s, r] = cids
    fidx = (r[:, None] * c + torch.arange(c, device=r.device)).reshape(-1)
    sf = s.repeat_interleave(c)
    host.key[sf, fidx] = keyb.reshape(-1)
    host.val[sf, fidx] = valb.reshape(n * c, -1)
    host.prev[sf, fidx] = prevb.reshape(-1)
    host.meta[sf, fidx] = metab.reshape(-1)
    host.tick[s, r] = host.clock[s]
    host.hits[s, r] = 0
    return state


def install_chunks(state, cids: torch.Tensor, rows: torch.Tensor,
                   keyb: torch.Tensor, valb: torch.Tensor, prevb: torch.Tensor,
                   metab: torch.Tensor, mask: torch.Tensor):
    """The reference's install signature: slabs [S, P] / [S, P, C] /
    [S, P, C, V]; unmasked slots are dropped."""
    s, i = mask.nonzero(as_tuple=True)
    return install_rows(state, s, rows[s, i], cids[s, i], keyb[s, i],
                        valb[s, i], prevb[s, i], metab[s, i])


def extract_chunks(cfg: F2Config, max_chunks: int, state,
                   first_chunk: torch.Tensor):
    """`max_chunks` consecutive ring-resident chunks a shard from
    `first_chunk` [S] as [S, K, C] / [S, K, C, V] slabs (chunks past a
    shard's real range gather ring garbage the caller ignores)."""
    c = cfg.host_chunk_records
    addrs = (first_chunk[:, None] * c
             + torch.arange(max_chunks * c, dtype=torch.int32,
                            device=first_chunk.device))
    k, v, p, m = hybrid_log.gather(state.cold, addrs)
    S = addrs.shape[0]
    return (k.reshape(S, max_chunks, c), v.reshape(S, max_chunks, c, -1),
            p.reshape(S, max_chunks, c), m.reshape(S, max_chunks, c))


def demote_commit(state, new_floor: torch.Tensor):
    """Advance the demotion frontier (after the host copies are made)."""
    cold = state.cold
    return state._replace(
        cold=cold._replace(floor=torch.maximum(cold.floor, new_floor)))


def drop_dead_rows(cfg: F2Config, state):
    """Empty the cache rows whose chunk fell wholly below cold BEGIN."""
    host = state.host
    dead = ((host.chunk >= 0)
            & ((host.chunk + 1) * cfg.host_chunk_records
               <= state.cold.begin[:, None]))
    host.chunk.masked_fill_(dead, -1)
    return state


def clear_miss_flag(state):
    return state._replace(host=state.host._replace(
        missed_in_step=torch.zeros_like(state.host.missed_in_step)))


# ---------------------------------------------------------------------------
# the host chunk store
# ---------------------------------------------------------------------------

class _Slabs:
    """Host rows of C * (3 + V) int32 words (key | prev | meta | val), in
    slabs allocated as needed (pinned for a CUDA store); freed rows are
    reused."""

    def __init__(self, c: int, v: int, pin: bool):
        self.c, self.v = c, v
        self.width = c * (3 + v)
        self.pin = pin
        self.rows_per_slab = int(np.clip(
            1 << int(np.log2(max(1, (64 << 20) // (4 * self.width)))),
            256, 1 << 16))
        self.slabs: List[np.ndarray] = []
        self._tensors: List[torch.Tensor] = []     # keep pinned slabs alive
        self.free: List[int] = []
        self.n_rows = 0

    def alloc(self, n: int) -> np.ndarray:
        k = min(n, len(self.free))
        rows = self.free[len(self.free) - k:]
        del self.free[len(self.free) - k:]
        fresh = n - k
        while len(self.slabs) * self.rows_per_slab < self.n_rows + fresh:
            t = torch.empty((self.rows_per_slab, self.width), dtype=torch.int32,
                            pin_memory=self.pin)
            self._tensors.append(t)
            self.slabs.append(t.numpy())
        rows += range(self.n_rows, self.n_rows + fresh)
        self.n_rows += fresh
        return np.asarray(rows, np.int64)

    def release(self, rows: Sequence[int]) -> None:
        self.free.extend(int(r) for r in rows)

    def get(self, rows: np.ndarray, out: np.ndarray) -> None:
        """out[i] = row rows[i]."""
        sl, off = np.divmod(np.asarray(rows, np.int64), self.rows_per_slab)
        for j in np.unique(sl):
            m = sl == j
            out[m] = self.slabs[j][off[m]]

    def put(self, rows: np.ndarray, data: np.ndarray) -> None:
        sl, off = np.divmod(np.asarray(rows, np.int64), self.rows_per_slab)
        for j in np.unique(sl):
            m = sl == j
            self.slabs[j][off[m]] = data[m]

    def row(self, r: int) -> np.ndarray:
        return self.slabs[r // self.rows_per_slab][r % self.rows_per_slab]


class ShardStore:
    """One shard's demoted chunks: a mapping chunk id -> (key [C], val [C, V],
    prev [C], meta [C]) (copies), over the shared slabs."""

    def __init__(self, slabs: _Slabs):
        self._slabs = slabs
        self.rows: Dict[int, int] = {}

    def __contains__(self, cid) -> bool:
        return cid in self.rows

    def __iter__(self) -> Iterator[int]:
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, cid: int):
        c, v = self._slabs.c, self._slabs.v
        w = self._slabs.row(self.rows[cid])
        return (w[:c].copy(), w[3 * c:].reshape(c, v).copy(),
                w[c:2 * c].copy(), w[2 * c:3 * c].copy())

    def put(self, cids: Sequence[int], data: np.ndarray) -> None:
        """Store rows data[i] ([n, width]) as chunks cids[i]."""
        cids = [int(x) for x in cids]
        new = [x for x in cids if x not in self.rows]   # others: rewritten
        self.rows.update(zip(new, self._slabs.alloc(len(new)).tolist()))
        self._slabs.put(np.asarray([self.rows[x] for x in cids], np.int64),
                        data)

    def drop(self, cids: Sequence[int]) -> None:
        self._slabs.release([self.rows.pop(int(x)) for x in cids])


# ---------------------------------------------------------------------------
# host-side manager
# ---------------------------------------------------------------------------

# the arrays of `HostTier.export_snapshot`, in order
SNAPSHOT_KEYS = ("host_shard", "host_ids", "host_key", "host_val",
                 "host_prev", "host_meta")

# EWMA decay per promote round for the per-chunk miss-traffic signal
_EWMA_DECAY = 0.8

# records a demotion copies device-to-host at a time
DEMOTE_SLAB_RECORDS = 1 << 17


class CacheThrash(RuntimeError):
    """The chunk cache cannot hold a promotion demand: every row is pinned
    or protected.  The facades' read loops catch it and split the batch
    into cache-sized slices (`note_contract_split`); it escapes only when
    one lane's own walk needs more than the cache."""


class HostTier:
    """The host chunk store and its placement policy for one facade of
    `n_shards` stacked stores on `device`: the pin set of in-flight rounds,
    the miss EWMAs that drive prefetch, the promotion and demotion
    counters.  Its device traffic goes through the state-level steps above.

    Beyond the reference's counters it counts its own device traffic:
    `ensure_rounds` (plan passes run by `ensure`), `syncs` (device reads it
    waits for), `h2d_bytes` and `d2h_bytes`."""

    def __init__(self, cfg: F2Config, n_shards: int, device):
        assert cfg.host_tier
        self.cfg = cfg
        self.lead = n_shards             # stores (shards) it manages
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._slabs = _Slabs(cfg.host_chunk_records, cfg.value_width, self._pin)
        ln = self.lead
        self.store: List[ShardStore] = [ShardStore(self._slabs) for _ in range(ln)]
        self.pinned: List[Set[int]] = [set() for _ in range(ln)]
        self.prefetched: List[Set[int]] = [set() for _ in range(ln)]
        self.ewma: List[Dict[int, float]] = [dict() for _ in range(ln)]
        self.promotions = 0
        self.demotions = 0
        self.prefetch_hits = 0
        self.contract_splits = 0
        self.ensure_rounds = 0
        self.syncs = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # every round either finishes or pins at least one new chunk, and
        # pins are capped by the cache rows
        self.max_rounds = cfg.host_cache_chunks + cfg.chain_max + 8
        self._stage: Optional[torch.Tensor] = None     # promotion staging
        self._stage_done: Optional[torch.cuda.Event] = None
        self._dstage: Optional[torch.Tensor] = None    # demotion staging

    # -- device reads ----------------------------------------------------------
    def _np(self, *xs: torch.Tensor) -> np.ndarray:
        """Stacked [len(xs), S, ...] host copy of same-shaped device tensors,
        in one transfer."""
        self.syncs += 1
        t = torch.stack([x.to(torch.int32) for x in xs])
        return t.cpu().numpy()

    # -- miss collection -------------------------------------------------------
    def collect(self, missed: torch.Tensor) -> List[Set[int]]:
        """Per-shard demand sets from a `missed` output [S, W] (-1 = none)."""
        arr = self._np(missed)[0].reshape(self.lead, -1)
        return [set(np.unique(row[row >= 0]).tolist()) for row in arr]

    def any_missing(self, needs: Sequence[Set[int]]) -> bool:
        return any(len(s) for s in needs)

    def note_contract_split(self) -> None:
        """A facade split one batch into cache-sized slices after a
        `CacheThrash`: counted, so that an undersized cache shows."""
        self.contract_splits += 1

    def pin_chunks(self, needs: Sequence[Set[int]]) -> None:
        """Pin chunk ids (per shard) until `end_batch` without promoting."""
        for s in range(self.lead):
            self.pinned[s].update(needs[s])

    # -- promotion -------------------------------------------------------------
    def promote(self, state, needs: Sequence[Set[int]], *,
                partial: bool = False, pin: bool = True):
        """Install the demanded chunks (plus prefetch extras), evicting by
        (empty, tick, hits, row) among unprotected rows.  The demand's
        resident chunks are protected; `pin=True` also pins the satisfied
        demand until `end_batch`.  With `partial=True` the install shrinks
        to the rows available (at least one), otherwise the whole demand
        must fit.  Raises KeyError for a chunk never demoted and
        `CacheThrash` when the cache cannot hold the demand."""
        cfg = self.cfg
        res_chunk, res_hits, res_tick = self._np(state.host.chunk, state.host.hits,
                                                 state.host.tick)
        self._absorb_prefetch_hits(res_chunk, res_hits)

        plan: List[Tuple[List[int], List[int]]] = []   # per shard: rows, ids
        total = 0
        for s in range(self.lead):
            demand = sorted(needs[s])
            ew = self.ewma[s]
            for cid in demand:
                ew[cid] = ew.get(cid, 0.0) * _EWMA_DECAY + 1.0
            chunks = res_chunk[s]
            resident = set(chunks[chunks >= 0].tolist())
            todo = [cid for cid in demand if cid not in resident]
            for cid in todo:
                if cid not in self.store[s]:
                    raise KeyError(
                        f"chunk {cid} (shard {s}) demanded but never demoted")
            protect = self.pinned[s] | set(demand)
            # prefetch rides along on real installs only
            extras = (self._prefetch_extras(s, demand, resident, todo)
                      if todo else [])
            victims = self._pick_victims(s, chunks, res_tick[s], res_hits[s],
                                         len(todo), len(extras), protect,
                                         partial)
            left_out = set()
            if partial and len(victims) < len(todo):
                left_out = set(todo[len(victims):])
                todo = todo[:len(victims)]
                extras = []
            cids = (todo + extras)[:len(victims)]
            plan.append((victims[:len(cids)], cids))       # rows, ids
            total += len(cids)
            if pin:
                # the demand stays protected, so no victim row held any of
                # it: the satisfied demand is all of it but what was left out
                self.pinned[s].update(cid for cid in demand
                                      if cid not in left_out)
            self.prefetched[s].update(extras)

        if total:
            faults.maybe_crash("host.mid_promote")
            state = self._install(state, plan, total)
            self.promotions += total
        return state

    def _install(self, state, plan, total: int):
        """Gather the assigned chunks into the staging buffer (3 header
        words a chunk: shard, row, id; then its records), copy it to the
        device in one non-blocking copy, and scatter it into the cache."""
        c, v = self.cfg.host_chunk_records, self.cfg.value_width
        width = self._slabs.width
        if self._stage_done is not None:
            self._stage_done.synchronize()      # the last copy has landed
        if self._stage is None or self._stage.shape[0] < total:
            self._stage = torch.empty((max(total, 64), width + 3),
                                      dtype=torch.int32, pin_memory=self._pin)
        buf = self._stage[:total]
        host = buf.numpy()
        i = 0
        for s, (rows, cids) in enumerate(plan):
            n = len(cids)
            if not n:
                continue
            host[i:i + n, 0] = s
            host[i:i + n, 1] = rows
            host[i:i + n, 2] = cids
            srows = np.fromiter(map(self.store[s].rows.__getitem__, cids),
                                np.int64, n)
            self._slabs.get(srows, host[i:i + n, 3:])
            i += n
        dev = buf.to(self.device, non_blocking=True)
        if self._pin:
            self._stage_done = torch.cuda.Event()
            self._stage_done.record()
        self.h2d_bytes += buf.numel() * 4
        recs = dev[:, 3:]
        return install_rows(state, dev[:, 0], dev[:, 1], dev[:, 2],
                            recs[:, :c], recs[:, 3 * c:].reshape(total, c, v),
                            recs[:, c:2 * c], recs[:, 2 * c:3 * c])

    def _prefetch_extras(self, s: int, demand: List[int],
                         resident: Set[int], todo: List[int]) -> List[int]:
        """Up to host_prefetch * len(demand) warm-up chunks: the demand's
        neighbors first (cid + 1, then cid - 1, in demand order), then the
        hottest absent chunks by miss EWMA, (-ewma, id) ascending."""
        budget = self.cfg.host_prefetch * len(demand)
        if budget <= 0:
            return []
        chosen: List[int] = []
        taken = set(todo)
        stored = self.store[s].rows

        def fill(cands) -> bool:
            for cid in cands:
                if cid not in taken and cid not in resident and cid in stored:
                    chosen.append(cid)
                    taken.add(cid)
                    if len(chosen) >= budget:
                        return True
            return False

        if fill(c for cid in demand for c in (cid + 1, cid - 1)):
            return chosen
        ew = self.ewma[s]
        if ew:
            # the reference walks every EWMA entry; once the budget is full
            # the rest take nothing, so stop there
            ids = np.fromiter(ew.keys(), np.int64, len(ew))
            vals = np.fromiter(ew.values(), np.float64, len(ew))
            fill(int(ids[j]) for j in np.lexsort((ids, -vals)))
        return chosen

    def _pick_victims(self, s: int, chunks: np.ndarray, ticks: np.ndarray,
                      hits: np.ndarray, n_demand: int, n_extra: int,
                      protect: Set[int], partial: bool) -> List[int]:
        """Rows to overwrite: empty rows first, then unprotected rows by
        (tick, hits, row) ascending (a stable sort of tick * 2^32 + hits,
        both non-negative int32).  A full demand must fit; a partial one
        shrinks but must make progress; prefetch extras shrink to the
        leftovers."""
        chunks = np.asarray(chunks)
        empty = np.flatnonzero(chunks < 0)
        cand = chunks >= 0
        if protect:
            cand &= ~np.isin(chunks, np.fromiter(protect, np.int64, len(protect)))
        ev = np.flatnonzero(cand)
        key = (np.asarray(ticks, np.int64)[ev] << 32) | np.asarray(hits, np.int64)[ev]
        order = np.concatenate([empty, ev[np.argsort(key, kind="stable")]]).tolist()
        short = len(order) < n_demand
        if (short and not partial) or (partial and n_demand and not order):
            raise CacheThrash(
                f"chunk cache thrash: shard {s} needs {n_demand} rows but "
                f"only {len(order)} are evictable "
                f"(host_cache_chunks={self.cfg.host_cache_chunks}, "
                f"pinned={len(self.pinned[s])}) — raise host_cache_chunks")
        return order[:n_demand + (0 if short else n_extra)]

    def _absorb_prefetch_hits(self, res_chunk: np.ndarray,
                              res_hits: np.ndarray) -> None:
        """Count a prefetched chunk as a hit the first time its row shows
        traffic; forget evicted ones."""
        for s in range(self.lead):
            pf = self.prefetched[s]
            if not pf:
                continue
            chunks = res_chunk[s]
            arr = np.fromiter(pf, np.int64, len(pf))
            # the row of each chunk id (-1 absent), as a dense map
            rowof = np.full(int(max(chunks.max(), arr.max())) + 1, -1, np.int64)
            live = np.flatnonzero(chunks >= 0)
            rowof[chunks[live]] = live
            row = rowof[arr]
            present = row >= 0
            hit = present & (res_hits[s][row] > 0)
            self.prefetch_hits += int(hit.sum())
            pf -= set(arr[hit | ~present].tolist())

    def ensure(self, state, plan: Callable):
        """Drive `plan` (a pure pass over `state` returning missed [S, W]) to
        a clean fixpoint, promoting between rounds."""
        for _ in range(self.max_rounds):
            self.ensure_rounds += 1
            needs = self.collect(plan(state))
            if not self.any_missing(needs):
                return state
            state = self.promote(state, needs)
        raise RuntimeError("host tier: plan/promote loop did not converge")

    def end_batch(self) -> None:
        """Release the pins taken for the current facade round."""
        for s in range(self.lead):
            self.pinned[s].clear()

    # -- demotion --------------------------------------------------------------
    def demote_if_needed(self, state, slack: int):
        """Demote cold chunks to the host store when the ring-resident region
        plus `slack` upcoming appends would not fit the ring: whole chunks
        [floor_eff, new_floor) are copied to the host, then the new floor
        is published on the device (a crash between the two is the
        `host.mid_demote` point)."""
        cfg = self.cfg
        c = cfg.host_chunk_records
        cap = cfg.cold_capacity
        begins, tails, floors = (
            a.astype(np.int64) for a in self._np(state.cold.begin,
                                                  state.cold.tail,
                                                  state.cold.floor))
        new_floors = floors.copy()
        spans: List[Tuple[int, int]] = []        # per shard: (first, n) chunks
        total = 0
        for s in range(self.lead):
            begin, tail, floor = int(begins[s]), int(tails[s]), int(floors[s])
            floor_eff = max(floor, (begin // c) * c)
            if (tail - floor_eff) + slack <= cap:
                spans.append((0, 0))
                continue
            target = int(cfg.host_resident_frac * cap)
            want = ((tail - target) // c) * c
            new_floor = max(floor_eff, min(want, (tail // c) * c))
            n = (new_floor - floor_eff) // c
            spans.append((floor_eff // c, n))
            new_floors[s] = new_floor
            total += n
        if not total:
            return state
        per = max(1, DEMOTE_SLAB_RECORDS // c)
        for s, (first, n) in enumerate(spans):
            for off in range(0, n, per):
                k = min(per, n - off)
                self._demote_slab(state, s, first + off, k)
        faults.maybe_crash("host.mid_demote")
        state = demote_commit(state, torch.as_tensor(
            new_floors.astype(np.int32), device=self.device))
        self.demotions += total
        return state

    def _demote_slab(self, state, s: int, first: int, n: int) -> None:
        """Chunks [first, first + n) of shard s: gathered from the ring into
        one packed [n, C * (3 + V)] tensor, copied to the host once, stored."""
        c = self.cfg.host_chunk_records
        cold = state.cold
        addrs = first * c + torch.arange(n * c, dtype=torch.int32,
                                         device=self.device)
        slot = hybrid_log.slot_of(cold, addrs)
        packed = torch.cat([cold.key[s, slot].view(n, c),
                            cold.prev[s, slot].view(n, c),
                            cold.meta[s, slot].view(n, c),
                            cold.val[s, slot].reshape(n, -1)], dim=1)
        if self._dstage is None or self._dstage.shape[0] < n:
            self._dstage = torch.empty((n, packed.shape[1]), dtype=torch.int32,
                                       pin_memory=self._pin)
        dst = self._dstage[:n]
        dst.copy_(packed)
        self.syncs += 1
        self.d2h_bytes += dst.numel() * 4
        self.store[s].put(range(first, first + n), dst.numpy())

    def gc(self, state):
        """After a truncation: forget host chunks wholly below cold BEGIN and
        drop their cache rows on the device."""
        begins = self._np(state.cold.begin)[0].astype(np.int64)
        c = self.cfg.host_chunk_records
        changed = False
        for s in range(self.lead):
            st = self.store[s]
            if not len(st):
                continue
            ids = np.fromiter(st.rows.keys(), np.int64, len(st))
            dead = ids[(ids + 1) * c <= int(begins[s])].tolist()
            if dead:
                st.drop(dead)
                for cid in dead:
                    self.ewma[s].pop(cid, None)
                    self.prefetched[s].discard(cid)
                changed = True
        if changed:
            state = drop_dead_rows(self.cfg, state)
        return state

    # -- durability ------------------------------------------------------------
    def export_snapshot(self) -> Dict[str, np.ndarray]:
        """The host store as fixed-key arrays (rows by shard, then chunk id;
        the device cache is a replica and is not exported)."""
        cfg = self.cfg
        c, v = cfg.host_chunk_records, cfg.value_width
        items = [(s, cid) for s in range(self.lead)
                 for cid in sorted(self.store[s])]
        n = len(items)
        data = np.empty((n, self._slabs.width), np.int32)
        self._slabs.get(np.asarray([self.store[s].rows[cid] for s, cid in items],
                                   np.int64), data)
        return {
            "host_shard": np.asarray([s for s, _ in items], np.int32).reshape(n),
            "host_ids": np.asarray([cid for _, cid in items], np.int32).reshape(n),
            "host_key": data[:, :c].copy(),
            "host_val": data[:, 3 * c:].reshape(n, c, v).copy(),
            "host_prev": data[:, c:2 * c].copy(),
            "host_meta": data[:, 2 * c:3 * c].copy(),
        }

    def import_snapshot(self, meta: Dict[str, np.ndarray]) -> None:
        """Rebuild the host store from `export_snapshot`'s arrays; resets
        pins, prefetch and EWMA state."""
        ln = self.lead
        self._slabs = _Slabs(self.cfg.host_chunk_records, self.cfg.value_width,
                             self._pin)
        self.store = [ShardStore(self._slabs) for _ in range(ln)]
        self.pinned = [set() for _ in range(ln)]
        self.prefetched = [set() for _ in range(ln)]
        self.ewma = [dict() for _ in range(ln)]
        shards = np.asarray(meta["host_shard"], np.int64)
        ids = np.asarray(meta["host_ids"], np.int64)
        n = shards.shape[0]
        c = self.cfg.host_chunk_records
        data = np.concatenate([
            np.asarray(meta["host_key"], np.int32).reshape(n, c),
            np.asarray(meta["host_prev"], np.int32).reshape(n, c),
            np.asarray(meta["host_meta"], np.int32).reshape(n, c),
            np.asarray(meta["host_val"], np.int32).reshape(n, -1)], axis=1)
        for s in range(ln):
            m = shards == s
            if m.any():
                self.store[s].put(ids[m].tolist(), data[m])

    # -- reporting -------------------------------------------------------------
    def host_chunks(self) -> int:
        return sum(len(d) for d in self.store)

    def host_bytes(self) -> int:
        cfg = self.cfg
        return self.host_chunks() * cfg.host_chunk_records * 4 * (3 + cfg.value_width)

    def stats(self) -> Dict[str, int]:
        return {
            "chunks": self.host_chunks(),
            "promotions_total": self.promotions,
            "demotions_total": self.demotions,
            "prefetch_hits_total": self.prefetch_hits,
            "contract_splits_total": self.contract_splits,
        }
