"""Deterministic batch router for the sharded store (`ShardedKV`).

One B-lane op batch becomes S fixed-width per-shard sub-batches:

    lane i  --hash(key)-->  bucket  --indirection-->  shard  --sort-->  slab

The route is a pure function of the batch and the bucket map, so a replayed
batch routes identically, and the sharded store can be held bit for bit
against S independent single-shard stores (and against the reference's
router, lane for lane).

  1. bucket id = top log2(n_buckets) bits of the key hash; shard id =
     `bucket_map[bucket]`.  Under `default_bucket_map` that is the top
     log2(S) hash bits (`shard_of`).  The indexes use the hash's low bits,
     so bucket choice and in-shard slot placement stay independent.
  2. a lane's position in its shard's slab is its rank among the shard's
     lanes (the position a stable sort by shard id gives it, inactive lanes
     last), so a shard's lanes keep their batch order (equal keys share a
     shard).  The rank is a running count per shard: no sort.
  3. each shard gets a slab of `lanes` lanes; unfilled lanes are padding
     (OP_NOOP, key 0, value 0).  Active lanes past a shard's capacity are
     deferred to a later round (`ShardedKV.apply`).  A dropped lane's
     destination is S*W: the slabs are scattered into an S*W + 1 buffer
     whose last row is dropped.
  4. `unroute` gathers the per-shard results back into batch order; lanes
     not placed this round read ST_NONE and zeros.

Replication (`core.replication`) folds its replica axis into the row axis:
`route(..., replica=rep, n_replicas=R)` sends each lane to row
`rep * S + shard` of R*S slabs, its position the rank among the lanes of
that (replica, shard), which is the slab a per-replica route gives it.
`assign_replicas` picks each fan-out read lane's replica (numpy), and
`pack_from_pool` packs the session layer's rings into one routed round.

Everything but `assign_replicas` runs on the batch's device with no host
synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .types import OP_NOOP, ST_NONE, hash32


def _check_pow2(n: int, what: str) -> None:
    if not (n >= 1 and (n & (n - 1)) == 0):
        raise ValueError(f"{what}={n} not a power of 2")


def shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Key -> shard id in [0, n_shards): the hash's top log2(S) bits.
    Equals `bucket_map[bucket_of(keys, nb)]` under `default_bucket_map`."""
    _check_pow2(n_shards, "n_shards")
    return bucket_of(keys, n_shards)


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Key -> bucket id in [0, n_buckets): the hash's top log2(n_buckets)
    bits, int32.  The first log2(S) of them are the default shard."""
    _check_pow2(n_buckets, "n_buckets")
    if n_buckets == 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    bits = n_buckets.bit_length() - 1
    return (hash32(keys) >> (32 - bits)).to(torch.int32)


def default_bucket_map(n_shards: int, n_buckets: int) -> np.ndarray:
    """The identity indirection: bucket b -> shard (b's top log2(S) bits)."""
    if not (n_buckets >= n_shards and n_buckets % n_shards == 0):
        raise ValueError(f"n_buckets={n_buckets} is not a multiple of "
                         f"n_shards={n_shards}")
    per = n_buckets // n_shards
    return (np.arange(n_buckets, dtype=np.int32) // per).astype(np.int32)


def bucket_moves(old_map: np.ndarray, new_map: np.ndarray,
                 n_shards: int) -> np.ndarray:
    """bool [S, n_buckets] mask of the (source shard, bucket) pairs whose
    placement changes from `old_map` to `new_map`: a migration's drain and
    purge mask."""
    old_map = np.asarray(old_map, np.int32)
    new_map = np.asarray(new_map, np.int32)
    if old_map.shape != new_map.shape:
        raise ValueError(f"maps differ in shape: {old_map.shape} {new_map.shape}")
    changed = np.flatnonzero(new_map != old_map)
    move = np.zeros((n_shards, old_map.shape[0]), bool)
    move[old_map[changed], changed] = True
    return move


class Route(NamedTuple):
    """Everything needed to invert a routing decision, per original lane."""

    shard: torch.Tensor      # int32 [B] shard id (= n_shards for inactive lanes)
    bucket: torch.Tensor     # int32 [B] bucket id (every lane; rebalancer stats)
    dest: torch.Tensor       # int32 [B] flat slab index (= S*W when unplaced)
    placed: torch.Tensor     # bool  [B] lane landed in a slab this round
    deferred: torch.Tensor   # bool  [B] active but over its shard's capacity
    counts: torch.Tensor     # int32 [S] active lanes per shard (incl. deferred)
    occupancy: torch.Tensor  # int32 [S] placed lanes per shard (= min(counts, W))
    mask: torch.Tensor       # bool  [S, W] slab occupancy masks


def shards_of(keys: torch.Tensor, n_shards: int,
              bucket_map: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket, shard) of each key as `route` assigns them: under a bucket
    map, shard = bucket_map[bucket]; without one, the bucket is the shard."""
    if bucket_map is None:
        return bucket_of(keys, n_shards), shard_of(keys, n_shards)
    bucket = bucket_of(keys, bucket_map.shape[0])
    return bucket, bucket_map[bucket].to(torch.int32)


def route(keys: torch.Tensor, ops: torch.Tensor, vals: torch.Tensor,
          n_shards: int, lanes: int,
          bucket_map: Optional[torch.Tensor] = None,
          replica: Optional[torch.Tensor] = None, n_replicas: int = 1,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Route]:
    """keys, ops int32 [B], vals int32 [B, V] -> (skeys [S, W], sops [S, W],
    svals [S, W, V], route), bit-exact with the reference's `route`.

    Lanes whose op is OP_NOOP never occupy capacity.  With `bucket_map=None`
    the shard is `shard_of` and `Route.bucket` is at shard granularity.
    With `replica` (int32 [B], each lane's replica in [0, n_replicas)) the
    slabs are R*S rows, lane i going to row replica[i] * S + its shard: the
    Route's `shard`, `counts`, `occupancy` and `mask` are then per row, and
    row r*S + s holds what the reference's route of replica r's lanes alone
    (the others NOOP) puts in shard s."""
    B = keys.shape[0]
    W = lanes
    dev = keys.device
    i32 = torch.int32
    active = ops != OP_NOOP
    bucket, sid_act = shards_of(keys, n_shards, bucket_map)
    S = n_shards
    if replica is not None:
        sid_act = replica.to(i32) * n_shards + sid_act
        S = n_shards * n_replicas
    sid = torch.where(active, sid_act, S).to(i32)

    # a lane's slab position is its rank among its shard's lanes, in lane
    # order: the position a stable sort by shard gives it (the reference's
    # argsort), taken from a running count per shard, with no sort
    hit = (sid[:, None] == torch.arange(S + 1, dtype=i32, device=dev)).to(i32)
    rank = torch.cumsum(hit, 0, dtype=i32)
    counts_full = rank[-1] if B else torch.zeros((S + 1,), dtype=i32, device=dev)
    counts = counts_full[:S]
    pos = rank.gather(1, sid[:, None].to(torch.int64))[:, 0] - 1
    placed = (sid < S) & (pos < W)
    dest = torch.where(placed, sid * W + pos, S * W).to(i32)

    # scatter into S*W + 1 rows: dropped lanes all land in the last, dropped
    V = vals.shape[1]
    skeys = torch.zeros((S * W + 1,), dtype=i32, device=dev)
    sops = torch.full((S * W + 1,), OP_NOOP, dtype=i32, device=dev)
    svals = torch.zeros((S * W + 1, V), dtype=i32, device=dev)
    skeys[dest] = keys
    sops[dest] = ops
    svals[dest] = vals
    occupancy = torch.clamp(counts, max=W)
    mask = (torch.arange(W, dtype=i32, device=dev)[None, :]
            < occupancy[:, None])
    rt = Route(shard=sid, bucket=bucket, dest=dest, placed=placed,
               deferred=active & ~placed, counts=counts,
               occupancy=occupancy, mask=mask)
    return (skeys[:S * W].view(S, W), sops[:S * W].view(S, W),
            svals[:S * W].view(S, W, V), rt)


def unroute(rt: Route, sstatus: torch.Tensor, svals: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sstatus [S, W], svals [S, W, V] -> (status [B], vals [B, V]) in the
    original lane order; lanes not placed this round read ST_NONE / 0."""
    flat_st = sstatus.reshape(-1)
    flat_v = svals.reshape(-1, svals.shape[-1])
    idx = torch.clamp(rt.dest, max=flat_st.shape[0] - 1)
    status = torch.where(rt.placed, flat_st[idx], ST_NONE).to(torch.int32)
    vals = torch.where(rt.placed[:, None], flat_v[idx], 0).to(torch.int32)
    return status, vals


def pack_from_pool(keys: torch.Tensor, ops: torch.Tensor, vals: torch.Tensor,
                   ticket: torch.Tensor, pending: torch.Tensor, n_shards: int,
                   lanes: int, bucket_map: torch.Tensor):
    """Cross-session batch packing (the session layer's scheduler): from N
    session rings of C slots (keys, ops, ticket int32 [N, C], vals [N, C, V],
    pending bool [N, C]) select at most `lanes` pending ops per shard for one
    routed round, lane for lane as the reference's `pack_from_pool`.

    Selection is oldest-ticket-first per shard (two stable argsorts: by
    ticket, then by shard), closed under per-session prefixes (an op is
    packed only if every older pending op of its session is), and the
    batch lists the accepted ops in ascending ticket order, padded with
    OP_NOOP lanes.  The oldest pending op is always packed (global FIFO:
    nothing starves), and a session's ops take ascending lanes, which the
    router's per-shard rank keeps in order inside each slab.

    Returns (bkeys [S*W], bops [S*W], bvals [S*W, V], sess [S*W],
    slot [S*W], valid [S*W], fill [S]): `sess`/`slot` locate each lane's
    ring slot (-1 on padding), `valid` marks real lanes, `fill` counts
    packed lanes per shard.  No host synchronisation."""
    N, C = keys.shape
    S, W = n_shards, lanes
    B, NC = S * W, N * C
    dev = keys.device
    i32 = torch.int32
    imax = int(np.iinfo(np.int32).max)
    k_f = keys.reshape(NC)
    o_f = ops.reshape(NC)
    v_f = vals.reshape(NC, vals.shape[-1])
    t_f = ticket.reshape(NC)
    p_f = pending.reshape(NC)
    bucket = bucket_of(k_f, bucket_map.shape[0])
    sid = torch.where(p_f, bucket_map[bucket].to(i32), S).to(i32)
    tkt = torch.where(p_f, t_f, imax).to(i32)

    # rank every pending op within its shard by ticket: the W lowest
    # tickets of each shard fit this round
    o1 = torch.argsort(tkt, stable=True)
    order = o1[torch.argsort(sid[o1], stable=True)]
    sid_sorted = sid[order]
    counts_full = torch.zeros((S + 1,), dtype=i32, device=dev).index_add_(
        0, sid, torch.ones_like(sid))
    offsets = torch.cumsum(counts_full, 0, dtype=i32) - counts_full
    pos_sorted = torch.arange(NC, dtype=i32, device=dev) - offsets[sid_sorted]
    fits_sorted = (sid_sorted < S) & (pos_sorted < W)
    fits = torch.zeros((NC,), dtype=torch.bool, device=dev)
    fits[order] = fits_sorted

    # per-session FIFO prefix closure: a slot is packed only if every older
    # pending slot of its session fits (a running AND in ticket order along
    # each ring; non-pending slots sort last)
    ordc = torch.argsort(tkt.view(N, C), dim=1, stable=True)
    fits_c = torch.gather(fits.view(N, C), 1, ordc)
    closed = torch.cumsum((~fits_c).to(i32), 1) == 0
    accepted = torch.zeros((N, C), dtype=torch.bool, device=dev).scatter_(
        1, ordc, closed).view(NC) & p_f

    # emit: accepted lanes in ascending ticket order, then NOOP padding
    tkt_acc = torch.where(accepted, t_f, imax).to(i32)
    sel = torch.argsort(tkt_acc, stable=True)[:min(B, NC)].to(i32)
    valid = accepted[sel]
    pad = B - sel.shape[0]
    if pad:
        sel = torch.cat([sel, torch.zeros((pad,), dtype=i32, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    bkeys = torch.where(valid, k_f[sel], 0).to(i32)
    bops = torch.where(valid, o_f[sel], OP_NOOP).to(i32)
    bvals = torch.where(valid[:, None], v_f[sel], 0).to(i32)
    sess = torch.where(valid, sel // C, -1).to(i32)
    slot = torch.where(valid, sel % C, -1).to(i32)
    fidx = torch.where(accepted, sid, S).to(i32)
    fill = torch.zeros((S + 1,), dtype=i32, device=dev).index_add_(
        0, fidx, torch.ones_like(fidx))[:S]
    return bkeys, bops, bvals, sess, slot, valid, fill


REPLICA_POLICIES = ("round_robin", "least_loaded")


def assign_replicas(n_lanes: int, alive: np.ndarray, counter: int = 0,
                    policy: str = "round_robin",
                    loads: Optional[np.ndarray] = None) -> np.ndarray:
    """Each fan-out read lane's replica, int32 [n_lanes]: always an alive
    one, a pure function of the inputs (numpy, as the reference's).

    `round_robin` stripes lanes over the alive replicas, rotated by the
    batch counter; `least_loaded` is weighted round robin on the inverse of
    the per-replica load EWMA: quotas by largest remainder, interleaved by
    virtual finish time."""
    if policy not in REPLICA_POLICIES:
        raise ValueError(f"unknown replica policy {policy!r}")
    alive_ids = np.flatnonzero(np.asarray(alive, bool))
    if alive_ids.size < 1:
        raise ValueError("no alive replica to serve reads")
    n = alive_ids.size
    lane = np.arange(n_lanes)
    if policy == "round_robin" or loads is None or n == 1:
        return alive_ids[(lane + counter) % n].astype(np.int32)
    w = 1.0 / (np.maximum(np.asarray(loads, np.float64)[alive_ids], 0) + 1.0)
    share = w / w.sum()
    quota = np.floor(share * n_lanes).astype(np.int64)
    frac = share * n_lanes - quota
    order = np.argsort(-frac, kind="stable")       # ties -> lowest id first
    quota[order[:n_lanes - int(quota.sum())]] += 1
    reps = np.repeat(alive_ids, quota)
    vt = (np.concatenate([(np.arange(q) + 1) / q for q in quota if q > 0])
          if n_lanes else np.zeros(0))
    return reps[np.argsort(vt, kind="stable")].astype(np.int32)
