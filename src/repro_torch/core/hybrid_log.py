"""HybridLog: an append-only record log over a ring buffer.

The log owns four non-decreasing logical addresses (paper Fig 3):

    begin <= head <= read_only <= tail

`head` and `read_only` are derived from `tail` given the static in-memory
budget (`mem`) and mutable fraction, like FASTER's HeadOffsetLagAddress.
Flushing is implicit: records that leave the in-memory window when `tail`
advances are charged as sequential stable-tier writes by the I/O model.

Scatters update the record columns in place.  A masked-out lane writes
nothing: the (shard, lane) pairs of the set lanes are selected with
`nonzero`, which is what the reference's out-of-range "drop" scatters
express.  Every function takes the shard axis (see `types`); the
scatters and `gather` also take one shard's log without it
(`shard_entry`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .types import (META_INVALID, META_TOMBSTONE, NULL_ADDR, IoStats, count,
                    excl_cumsum, i32, records_to_blocks, shard_entry, take)

# one shard's log (scalar `tail`) is lifted to the shard axis
_entry = shard_entry(lambda log, *a, **k: log.tail.ndim == 0)

class LogState(NamedTuple):
    key: torch.Tensor           # int32 [S, capacity]
    val: torch.Tensor           # int32 [S, capacity, value_width]
    prev: torch.Tensor          # int32 [S, capacity] logical addr of previous chain rec
    meta: torch.Tensor          # int32 [S, capacity] bitfield
    begin: torch.Tensor         # int32 [S]
    tail: torch.Tensor          # int32 [S]
    flushed_upto: torch.Tensor  # int32 [S]: stable-tier write accounting mark
    overflowed: torch.Tensor    # bool [S]: live region exceeded capacity
    floor: torch.Tensor         # int32 [S]: host-tier demotion frontier:
                                # [begin, floor) lives in the host chunk
                                # store (core.host_tier), the ring holds
                                # [floor, tail); 0 with the tier off


def create(capacity: int, value_width: int, device, lead=()) -> LogState:
    """An empty log; `lead` is () for one shard, (S,) for a stacked one."""
    lead = tuple(lead)

    def full(shape, v):
        return torch.full(lead + shape, v, dtype=torch.int32, device=device)
    return LogState(
        key=full((capacity,), -1),
        val=full((capacity, value_width), 0),
        prev=full((capacity,), NULL_ADDR),
        meta=full((capacity,), 0),
        begin=i32(0, device, lead),
        tail=i32(0, device, lead),
        flushed_upto=i32(0, device, lead),
        overflowed=torch.zeros(lead, dtype=torch.bool, device=device),
        floor=i32(0, device, lead),
    )


def capacity_of(log: LogState) -> int:
    return log.key.shape[-1]


def head_addr(log: LogState, mem: int) -> torch.Tensor:
    """First in-memory address (everything below is stable tier)."""
    return torch.maximum(log.begin, log.tail - mem)


def read_only_addr(log: LogState, mem: int, mutable_frac: float) -> torch.Tensor:
    mutable = max(1, int(mem * mutable_frac))
    return torch.maximum(log.begin, log.tail - mutable)


def slot_of(log: LogState, addr: torch.Tensor) -> torch.Tensor:
    return addr & (capacity_of(log) - 1)


@_entry
def gather(log: LogState, addr: torch.Tensor):
    """Gather (key, val, prev, meta) at logical addresses [S, W].  Callers
    mask lanes whose addr is invalid; the physical index is clamped so the
    gather itself is always in bounds."""
    slot = slot_of(log, addr.clamp_min(0))
    return (take(log.key, slot), take(log.val, slot), take(log.prev, slot),
            take(log.meta, slot))


@_entry
def append(log: LogState, mask: torch.Tensor, keys: torch.Tensor,
           vals: torch.Tensor, prevs: torch.Tensor, metas: torch.Tensor
           ) -> Tuple[LogState, torch.Tensor]:
    """Append masked lanes at the tail; returns (log, new_addrs).

    Slots come from an exclusive prefix sum over the mask (the batched
    fetch-add tail allocation), so they are distinct unless one batch
    appends more than the ring holds; that case sets `overflowed`, which is
    what callers check, not the ring content."""
    cap = capacity_of(log)
    offs = excl_cumsum(mask)
    new_addrs = torch.where(mask, log.tail[:, None] + offs, NULL_ADDR)
    s, w = mask.nonzero(as_tuple=True)
    slot = new_addrs[s, w] & (cap - 1)
    log.key[s, slot] = keys[s, w]
    log.val[s, slot] = vals[s, w]
    log.prev[s, slot] = prevs[s, w]
    log.meta[s, slot] = metas[s, w]
    log = log._replace(tail=log.tail + count(mask))
    ring_base = torch.maximum(log.begin, log.floor)
    log = log._replace(
        overflowed=log.overflowed | ((log.tail - ring_base) > cap))
    return log, new_addrs


def charge_flush(log: LogState, stats: IoStats, mem: int, record_bytes: int
                 ) -> Tuple[LogState, IoStats]:
    """Charge sequential stable-tier writes for records that left the
    in-memory window since the last call (implicit flushing)."""
    h = head_addr(log, mem)
    newly = (h - torch.maximum(log.flushed_upto, log.begin)).clamp_min(0)
    stats = stats.add_writes(records_to_blocks(newly, record_bytes))
    return log._replace(flushed_upto=torch.maximum(log.flushed_upto, h)), stats


@_entry
def update_in_place(log: LogState, mask: torch.Tensor, addrs: torch.Tensor,
                    vals: torch.Tensor, metas: torch.Tensor) -> LogState:
    s, w = mask.nonzero(as_tuple=True)
    slot = slot_of(log, addrs[s, w].clamp_min(0))
    log.val[s, slot] = vals[s, w]
    log.meta[s, slot] = metas[s, w]
    return log


def _set_meta_bit(log: LogState, mask, addrs, bit: int) -> LogState:
    s, w = mask.nonzero(as_tuple=True)
    slot = slot_of(log, addrs[s, w].clamp_min(0))
    log.meta[s, slot] = log.meta[s, slot] | bit
    return log


@_entry
def invalidate(log: LogState, mask: torch.Tensor, addrs: torch.Tensor) -> LogState:
    """Set the INVALID bit on masked records (e.g. failed CAS cleanup)."""
    return _set_meta_bit(log, mask, addrs, META_INVALID)


@_entry
def set_tombstone_in_place(log: LogState, mask: torch.Tensor,
                           addrs: torch.Tensor) -> LogState:
    return _set_meta_bit(log, mask, addrs, META_TOMBSTONE)


def truncate(log: LogState, new_begin: torch.Tensor) -> LogState:
    """Advance BEGIN (the destructive phase of compaction)."""
    return log._replace(begin=torch.maximum(log.begin, new_begin))
