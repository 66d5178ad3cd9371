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

Everything runs on the batch's device with no host synchronisation.
`pack_from_pool` (sessions) and `assign_replicas` (replication) are not
ported yet.
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


def route(keys: torch.Tensor, ops: torch.Tensor, vals: torch.Tensor,
          n_shards: int, lanes: int,
          bucket_map: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Route]:
    """keys, ops int32 [B], vals int32 [B, V] -> (skeys [S, W], sops [S, W],
    svals [S, W, V], route), bit-exact with the reference's `route`.

    Lanes whose op is OP_NOOP never occupy capacity.  With `bucket_map=None`
    the shard is `shard_of` and `Route.bucket` is at shard granularity."""
    B = keys.shape[0]
    S, W = n_shards, lanes
    dev = keys.device
    i32 = torch.int32
    active = ops != OP_NOOP
    if bucket_map is None:
        bucket = bucket_of(keys, S)
        sid_act = shard_of(keys, S)
    else:
        bucket = bucket_of(keys, bucket_map.shape[0])
        sid_act = bucket_map[bucket].to(i32)
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
