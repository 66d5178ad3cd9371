"""F2Store: the tiered key-value store (paper S4-S7) on PyTorch tensors.

All operations are *batched*: a call takes B lanes of (op, key, value) and
returns (new_state, statuses, values).  Linearization of an `apply` batch:
all Reads observe the pre-batch snapshot, then writes apply in
batch-position order; per-key write order is resolved by the write engine —
the deterministic replacement for CAS winner order.

State is a NamedTuple of tensors whose leaves mirror the JAX package's
`F2State` one to one.  **Updates are in place**: the functions here scatter
into the log, read-cache, index and chunk tensors of the state they are
given (the counterpart of the reference's `donate_argnums`) and return a
state whose scalar leaves are new tensors.  A caller that needs the old
state afterwards clones it first.  Every scatter reads what it needs from
the pre-update tensors before its first write, in the reference's order.

With `F2Config.host_tier` the cold log's records below `cold.floor` live in
a host chunk store and the cold walks resolve them through the device chunk
cache `F2State.host` (`core.host_tier`): a walk that needs an absent chunk
reports it (`missed`) instead of reading it.  `read_batch_host` returns
those misses for the facade's promote-and-retry loop; `plan_fetch` and
`plan_finish` are pure passes that name the chunks a batch would touch, so
the facade promotes them before the committed step.  With the tier off
`F2State.host` is an inert 1 x 1 cache and the walks are the probe
engine's.

The shard axis (see `types`): every function takes a stacked state of S
stores (`create(cfg, device, n_shards=S)`; leaves [S, ...], lane batches
[S, W]) and runs all S in one pass (`api.KV` holds a stack of one).  The
two-phase read (`read_begin`, `read_finish`) also takes one store's state
and [B] lanes, which `shard_entry` lifts.  The rows of a stacked state are
independent stores: every scatter, count and comparison stays in its row.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import (cold_index, host_tier, hybrid_log, probe_engine, read_cache,
               write_engine)
from .host_tier import HostCacheState
from .types import (META_TOMBSTONE, NULL_ADDR, OP_DELETE, OP_NOOP, OP_READ,
                    OP_RMW, OP_UPSERT, ST_CREATED, ST_NONE, ST_NOT_FOUND,
                    ST_OK, F2Config, IoStats, i32, is_rc, lanes, rc_untag,
                    shard_entry, slot_of_keys, take)

# one store's state (scalar hot tail) is lifted to the shard axis
entry = shard_entry(lambda cfg, state, *a, **k: state.hot.tail.ndim == 0)


class F2State(NamedTuple):
    hot: hybrid_log.LogState
    hot_index: torch.Tensor        # int32 [S, E] chain heads (maybe RC-tagged)
    rc: read_cache.RCState
    cold: hybrid_log.LogState
    cold_idx: cold_index.ColdIndexState
    stats: IoStats
    hot_truncs: torch.Tensor       # int32 [S]: hot-log truncation counter
    cold_truncs: torch.Tensor      # int32 [S]: num_truncs of paper S5.4
    walk_exhausted: torch.Tensor   # bool [S]: some chain walk hit chain_max (guard)
    host: HostCacheState           # chunk cache (inert with the tier off)


def create(cfg: F2Config, device, n_shards=None) -> F2State:
    """An empty store: one store's leaves (no shard axis) by default, S
    stacked stores with `n_shards=S`."""
    device = torch.device(device)
    lead = () if n_shards is None else (n_shards,)
    return F2State(
        hot=hybrid_log.create(cfg.hot_capacity, cfg.value_width, device, lead),
        hot_index=torch.full(lead + (cfg.hot_index_size,), NULL_ADDR,
                             dtype=torch.int32, device=device),
        rc=read_cache.create(cfg.rc_capacity, cfg.value_width, device, lead),
        cold=hybrid_log.create(cfg.cold_capacity, cfg.value_width, device,
                               lead),
        cold_idx=cold_index.create(cfg, device, lead),
        stats=IoStats.zeros(device, lead),
        hot_truncs=i32(0, device, lead),
        cold_truncs=i32(0, device, lead),
        walk_exhausted=torch.zeros(lead, dtype=torch.bool, device=device),
        host=host_tier.create(cfg, device, lead),
    )


def hot_slots(cfg: F2Config, keys: torch.Tensor) -> torch.Tensor:
    return slot_of_keys(keys, cfg.hot_index_size)


def merge_walk_io(stats: IoStats, res) -> IoStats:
    """res: a ProbeResult or WritePlan (same I/O fields)."""
    return stats.add_reads(res.io_blocks, res.io_ops).add_mem_hits(res.mem_hits)


def cold_probe(cfg: F2Config, state: F2State, keys, lower_c, cold_head,
               active, entries, target=None):
    """Cold-chain probe from cold-index entries (no read cache): the probe
    engine's `ProbeResult`, or with the host tier the floor-aware walk's
    `host_tier.HostProbeResult` (also `missed` and `touch`)."""
    if cfg.host_tier:
        return host_tier.probe_cold(cfg, keys, state.cold, state.host,
                                    lower_c, cold_head, active, entries,
                                    target=target)
    return probe_engine.probe(cfg, keys, state.cold, lower_c, cold_head,
                              active, heads=entries, rc=None, target=target)


def fold_host(cfg: F2Config, state: F2State, touch, missed,
              latch_miss: bool) -> F2State:
    """Fold a cold pass's cache traffic (`touch` [S, R]) into the eviction
    signals.  On committed paths (`latch_miss`) a miss (`missed` [S, B])
    also latches the `missed_in_step` tripwire: the facade should have
    pre-faulted."""
    if not cfg.host_tier:
        return state
    any_missed = ((missed >= 0).any(dim=-1) if latch_miss
                  else torch.zeros_like(state.host.missed_in_step))
    return state._replace(host=host_tier.fold_touch(state.host, touch,
                                                    any_missed))


def fold_probe(cfg: F2Config, state: F2State, res, latch_miss: bool) -> F2State:
    """`fold_host` of a `cold_probe` result (nothing with the tier off)."""
    if not cfg.host_tier:
        return state
    return fold_host(cfg, state, res.touch, res.missed, latch_miss)


def _exhausted(state: F2State, *results) -> torch.Tensor:
    out = state.walk_exhausted
    for r in results:
        out = out | torch.any(r.exhausted, dim=-1)
    return out


# ---------------------------------------------------------------------------
# Read path (paper S5.3 Read + S7.2 with read cache)
# ---------------------------------------------------------------------------

def _read_core(cfg: F2Config, state: F2State, keys: torch.Tensor,
               active: torch.Tensor, admit_rc: bool, latch_miss: bool):
    """The read body: (state, status[S, B], values[S, B, V], missed[S, B]
    or None with the tier off).  A lane whose cold walk missed a host chunk
    reports ST_NONE and takes no read-cache admission."""
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    lower = lanes(state.hot.begin, keys)
    res_h = probe_engine.probe(cfg, keys, state.hot, lower, hot_head, active,
                               index=state.hot_index, rc=state.rc,
                               rc_match=True)
    heads = res_h.heads
    stats = merge_walk_io(state.stats, res_h)

    hit_rc = res_h.found & is_rc(res_h.addr)
    hit_log = res_h.found & ~hit_rc
    tomb_hot = hit_log & ((res_h.meta & META_TOMBSTONE) != 0)
    ok_hot = hit_rc | (hit_log & ~tomb_hot)

    # --- cold phase for hot misses (tombstones terminate the search) --------
    cold_active = active & ~res_h.found
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, keys,
                                             cold_active, stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    lower_c = lanes(state.cold.begin, keys)
    res_c = cold_probe(cfg, state, keys, lower_c, cold_head, cold_active,
                       entries)
    stats = merge_walk_io(stats, res_c)
    state = fold_probe(cfg, state, res_c, latch_miss)
    missed = res_c.missed if cfg.host_tier else None
    not_found = active if missed is None else active & (missed < 0)
    tomb_cold = res_c.found & ((res_c.meta & META_TOMBSTONE) != 0)
    ok_cold = res_c.found & ~tomb_cold

    vals = torch.where(ok_hot[..., None], res_h.value,
                       torch.where(ok_cold[..., None], res_c.value, 0))
    found = ok_hot | ok_cold
    status = torch.where(found, ST_OK,
                         torch.where(not_found, ST_NOT_FOUND, ST_NONE)
                         ).to(torch.int32)

    rc, hot_index = state.rc, state.hot_index
    if cfg.rc_capacity and admit_rc:
        # --- read-cache admission: stable-tier hits get replicated ----------
        admit = ((hit_log & ~tomb_hot & (res_h.addr < hot_head[:, None]))
                 | (ok_cold & (res_c.addr < cold_head[:, None])))
        admit = admit & ~is_rc(heads)            # one RC record per chain
        # --- second chance: RC hits in the read-only region re-insert -------
        _, _, p_rc, _ = read_cache.gather(rc, rc_untag(res_h.addr))
        rc_ro = read_cache.read_only_addr(rc, cfg.rc_mutable_frac)[:, None]
        sc = hit_rc & (rc_untag(res_h.addr) < rc_ro)
        rc = read_cache.invalidate(rc, sc, rc_untag(res_h.addr))
        ins = admit | sc
        ins_prev = torch.where(sc, p_rc, heads)   # continuation into hot log
        rc, hot_index, _ = read_cache.insert(rc, hot_index, ins, keys, vals,
                                             ins_prev)

    state = state._replace(rc=rc, hot_index=hot_index, stats=stats,
                           walk_exhausted=_exhausted(state, res_h, res_c))
    return state, status, vals, missed


def read_batch(cfg: F2Config, state: F2State, keys: torch.Tensor,
               active: torch.Tensor, admit_rc: bool = True
               ) -> Tuple[F2State, torch.Tensor, torch.Tensor]:
    """Returns (state, status[S, B], values[S, B, V]).  With the host tier
    a miss latches the tripwire (committed paths pre-fault)."""
    state, status, vals, _ = _read_core(cfg, state, keys, active, admit_rc,
                                        latch_miss=True)
    return state, status, vals


def read_batch_host(cfg: F2Config, state: F2State, keys: torch.Tensor,
                    active: torch.Tensor, admit_rc: bool = True):
    """A host-tier read round: `read_batch`, but misses defer instead of
    latching; also returns missed[S, B] for the facade's promote-and-retry
    loop."""
    return _read_core(cfg, state, keys, active, admit_rc, latch_miss=False)


def probe_hops(cfg: F2Config, state: F2State, keys: torch.Tensor) -> torch.Tensor:
    """Per-lane chain-walk record touches for a read probe of `keys` (hot
    walk plus the cold continuation for hot misses).  Pure telemetry: no
    state change, no admission, no modeled I/O charged."""
    active = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res_h = probe_engine.probe(cfg, keys, state.hot, lanes(state.hot.begin, keys),
                               hot_head, active, index=state.hot_index,
                               rc=state.rc, rc_match=True)
    cold_active = active & ~res_h.found
    entries, _ = cold_index.find_entries(state.cold_idx, cfg, keys,
                                         cold_active, state.stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res_c = cold_probe(cfg, state, keys, lanes(state.cold.begin, keys),
                       cold_head, cold_active, entries)
    return res_h.hops + res_c.hops


# ---------------------------------------------------------------------------
# Write path: Upsert / RMW / Delete (paper S5.3, Algorithm 1)
# ---------------------------------------------------------------------------

def write_batch(cfg: F2Config, state: F2State, keys: torch.Tensor,
                ops: torch.Tensor, vals: torch.Tensor
                ) -> Tuple[F2State, torch.Tensor]:
    """Returns (state, status[B]).  RMW semantics: integer vector add with
    initial value 0 (YCSB-F counter update); intra-batch RMWs to one key
    accumulate after the last Upsert/Delete.

    The mutate pipeline runs as one write-engine pass; this function
    resolves cold base values for pure-RMW misses and applies the plan."""
    wmask = (ops == OP_UPSERT) | (ops == OP_RMW) | (ops == OP_DELETE)
    plan = write_engine.plan(cfg, keys, ops, vals, state.hot,
                             state.hot_index, state.rc)
    stats = merge_walk_io(state.stats, plan)

    # --- cold base values for pure-RMW groups that missed the hot log -------
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, keys,
                                             plan.need_cold, stats)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res_c = cold_probe(cfg, state, keys, lanes(state.cold.begin, keys),
                       cold_head, plan.need_cold, entries)
    stats = merge_walk_io(stats, res_c)
    # writes cannot defer mid-step: the facade pre-faulted with plan_fetch,
    # so a miss here latches the tripwire
    state = fold_probe(cfg, state, res_c, latch_miss=True)
    cold_ok = res_c.found & ((res_c.meta & META_TOMBSTONE) == 0)
    use_cold = plan.need_cold & cold_ok
    final_val = plan.val_nocold + torch.where(use_cold[..., None], res_c.value, 0)
    created = plan.created_nocold & ~use_cold

    # --- apply the plan: in-place scatter, RC detach, append, publish -------
    new_meta = torch.where(plan.final_tomb, META_TOMBSTONE, 0).to(torch.int32)
    hot = hybrid_log.update_in_place(state.hot, plan.in_place, plan.addr,
                                     final_val, new_meta)
    # appends detach the RC head; in-place updates only invalidate a
    # matching-key replica (it just went stale)
    rc = read_cache.invalidate(state.rc, plan.rc_inval, rc_untag(plan.heads))
    hot, _ = hybrid_log.append(hot, plan.append, keys, final_val, plan.prevs,
                               new_meta)
    # publish: the last lane of each slot run swings the index entry
    s, w = plan.publish.nonzero(as_tuple=True)
    state.hot_index[s, plan.slots[s, w]] = plan.new_addrs[s, w]
    hot, stats = hybrid_log.charge_flush(hot, stats, cfg.hot_mem,
                                         cfg.record_bytes)

    # --- statuses broadcast back to every lane of the group -----------------
    grp_created = (plan.rep_pos >= 0) & take(created, plan.rep_pos.clamp_min(0))
    status = torch.where(wmask, torch.where((ops == OP_RMW) & grp_created,
                                            ST_CREATED, ST_OK),
                         ST_NONE).to(torch.int32)
    state = state._replace(hot=hot, rc=rc, stats=stats,
                           walk_exhausted=_exhausted(state, plan, res_c))
    return state, status


# ---------------------------------------------------------------------------
# Mixed batches
# ---------------------------------------------------------------------------

def apply(cfg: F2Config, state: F2State, keys: torch.Tensor,
          ops: torch.Tensor, vals: torch.Tensor, admit_rc: bool = True
          ) -> Tuple[F2State, torch.Tensor, torch.Tensor]:
    """Mixed op batch: Reads observe the pre-batch snapshot, then writes
    apply in batch order.  Returns (state, status[S, B],
    read_vals[S, B, V])."""
    state, rstatus, rvals = read_batch(cfg, state, keys, active=(ops == OP_READ),
                                       admit_rc=admit_rc)
    state, wstatus = write_batch(cfg, state, keys, ops, vals)
    return state, torch.where(ops == OP_READ, rstatus, wstatus), rvals


# ---------------------------------------------------------------------------
# Two-phase reads (false-absence anomaly, paper S5.4)
# ---------------------------------------------------------------------------

class ReadSnapshot(NamedTuple):
    keys: torch.Tensor
    active: torch.Tensor
    hot_heads: torch.Tensor
    cold_entries: torch.Tensor
    cold_tail: torch.Tensor
    num_truncs: torch.Tensor


@entry
def read_begin(cfg: F2Config, state: F2State, keys: torch.Tensor,
               active: torch.Tensor) -> Tuple[F2State, ReadSnapshot]:
    """Phase 1: snapshot chain heads + (TAIL, num_truncs) per paper S5.4."""
    entries, stats = cold_index.find_entries(state.cold_idx, cfg, keys,
                                             active, state.stats)
    snap = ReadSnapshot(keys=keys, active=active,
                        hot_heads=probe_engine.index_heads(cfg, state.hot_index, keys),
                        cold_entries=entries,
                        cold_tail=state.cold.tail.clone(),
                        num_truncs=state.cold_truncs.clone())
    return state._replace(stats=stats), snap


@entry
def read_finish(cfg: F2Config, state: F2State, snap: ReadSnapshot
                ) -> Tuple[F2State, torch.Tensor, torch.Tensor]:
    """Phase 2: walk from the snapshot.  If a lane misses and truncation(s)
    occurred since phase 1, re-traverse only the newly-compacted tail
    segment (snap.cold_tail, TAIL] from the *current* index — the paper's
    num_truncs fix for the false-absence anomaly.  All three walks run on
    the probe engine in heads mode."""
    keys, active = snap.keys, snap.active
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res_h = probe_engine.probe(cfg, keys, state.hot, lanes(state.hot.begin, keys),
                               hot_head, active, heads=snap.hot_heads,
                               rc=state.rc, rc_match=True)
    stats = merge_walk_io(state.stats, res_h)
    hit_rc = res_h.found & is_rc(res_h.addr)
    hit_log = res_h.found & ~hit_rc
    tomb_hot = hit_log & ((res_h.meta & META_TOMBSTONE) != 0)
    ok_hot = hit_rc | (hit_log & ~tomb_hot)

    cold_active = active & ~res_h.found
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    res_c = cold_probe(cfg, state, keys, lanes(state.cold.begin, keys),
                       cold_head, cold_active, snap.cold_entries)
    stats = merge_walk_io(stats, res_c)
    state = fold_probe(cfg, state, res_c, latch_miss=True)

    # --- the anomaly fix: recheck the new tail segment on miss ---------------
    truncated_since = state.cold_truncs != snap.num_truncs
    retry = cold_active & ~res_c.found & truncated_since[:, None]
    entries2, stats = cold_index.find_entries(state.cold_idx, cfg, keys,
                                              retry, stats)
    res_r = cold_probe(cfg, state, keys, lanes(snap.cold_tail, keys), cold_head,
                       retry, entries2)
    stats = merge_walk_io(stats, res_r)
    state = fold_probe(cfg, state, res_r, latch_miss=True)

    cold_found = res_c.found | res_r.found
    v_cold = torch.where(res_c.found[..., None], res_c.value, res_r.value)
    m_cold = torch.where(res_c.found, res_c.meta, res_r.meta)
    ok_cold = cold_found & ((m_cold & META_TOMBSTONE) == 0)
    vals = torch.where(ok_hot[..., None], res_h.value,
                       torch.where(ok_cold[..., None], v_cold, 0))
    found = ok_hot | ok_cold
    status = torch.where(found, ST_OK,
                         torch.where(active, ST_NOT_FOUND, ST_NONE)
                         ).to(torch.int32)
    return state._replace(stats=stats), status, vals


# ---------------------------------------------------------------------------
# Host-tier pre-fault planning (core.host_tier); pure: no state change
# ---------------------------------------------------------------------------

def fetch_heads(cfg: F2Config, state: F2State, keys: torch.Tensor,
                ops: torch.Tensor):
    """`plan_fetch`'s cold-walk inputs (cold_active, entries) [S, B]: the
    hot probe and the cold-index lookup, which depend on no host-tier leaf,
    so a facade's plan -> promote loop computes them once."""
    active = ops != OP_NOOP
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res_h = probe_engine.probe(cfg, keys, state.hot,
                               lanes(state.hot.begin, keys), hot_head, active,
                               index=state.hot_index, rc=state.rc,
                               rc_match=False)
    cold_active = active & ~res_h.found
    entries, _ = cold_index.find_entries(state.cold_idx, cfg, keys,
                                         cold_active, state.stats)
    return cold_active, entries


def plan_fetch(cfg: F2Config, state: F2State, keys: torch.Tensor,
               ops: torch.Tensor, heads=None) -> torch.Tensor:
    """Which absent host chunks would `apply(keys, ops)` touch?  missed[S, B]
    chunk ids (-1 = none); writes nothing, charges no I/O.  `heads` is
    `fetch_heads(cfg, state, keys, ops)` when the caller has it.

    The cold-active set is a superset of the committed batch's: the hot
    probe skips read-cache replicas (`rc_match=False`, as the write path's
    locate walk), and every op that misses the hot log plans a cold walk,
    not just the pure-RMW groups.  A round shows only each lane's first
    absent chunk, so the facade loops plan -> promote (`HostTier.ensure`)."""
    cold_active, entries = (fetch_heads(cfg, state, keys, ops) if heads is None
                            else heads)
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    return host_tier.probe_cold(cfg, keys, state.cold, state.host,
                                lanes(state.cold.begin, keys), cold_head,
                                cold_active, entries).missed


@entry
def plan_finish(cfg: F2Config, state: F2State, snap: ReadSnapshot
                ) -> torch.Tensor:
    """The pre-fault pass of `read_finish`: its snapshot-head cold walk in
    pure form; missed[S, B]."""
    keys, active = snap.keys, snap.active
    hot_head = hybrid_log.head_addr(state.hot, cfg.hot_mem)
    res_h = probe_engine.probe(cfg, keys, state.hot,
                               lanes(state.hot.begin, keys), hot_head, active,
                               heads=snap.hot_heads, rc=state.rc,
                               rc_match=False)
    cold_active = active & ~res_h.found
    cold_head = hybrid_log.head_addr(state.cold, cfg.cold_mem)
    return host_tier.probe_cold(cfg, keys, state.cold, state.host,
                                lanes(state.cold.begin, keys), cold_head,
                                cold_active, snap.cold_entries).missed
