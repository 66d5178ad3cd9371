"""HybridLog: an append-only record log over a ring buffer.

The log owns four non-decreasing logical addresses (paper Fig 3):

    begin <= head <= read_only <= tail

`head` and `read_only` are derived from `tail` given the static in-memory
budget (`mem`) and mutable fraction, like FASTER's HeadOffsetLagAddress.
Flushing is implicit: records that leave the in-memory window when `tail`
advances are charged as sequential stable-tier writes by the I/O model.

Scatters update the record columns in place.  A masked-out lane writes
nothing: the index tensors are filtered with the mask (`idx[mask]`), which
is what the reference's out-of-range "drop" scatters express.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .types import (META_INVALID, META_TOMBSTONE, NULL_ADDR, IoStats, count,
                    excl_cumsum, i32, records_to_blocks)


class LogState(NamedTuple):
    key: torch.Tensor           # int32 [capacity]
    val: torch.Tensor           # int32 [capacity, value_width]
    prev: torch.Tensor          # int32 [capacity] logical addr of previous chain rec
    meta: torch.Tensor          # int32 [capacity] bitfield
    begin: torch.Tensor         # int32 scalar
    tail: torch.Tensor          # int32 scalar
    flushed_upto: torch.Tensor  # int32 scalar: stable-tier write accounting mark
    overflowed: torch.Tensor    # bool scalar: live region exceeded capacity
    floor: torch.Tensor         # int32 scalar: host-tier frontier, always 0 here


def create(capacity: int, value_width: int, device) -> LogState:
    return LogState(
        key=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        val=torch.zeros((capacity, value_width), dtype=torch.int32,
                        device=device),
        prev=torch.full((capacity,), NULL_ADDR, dtype=torch.int32,
                        device=device),
        meta=torch.zeros((capacity,), dtype=torch.int32, device=device),
        begin=i32(0, device),
        tail=i32(0, device),
        flushed_upto=i32(0, device),
        overflowed=torch.tensor(False, device=device),
        floor=i32(0, device),
    )


def capacity_of(log: LogState) -> int:
    return log.key.shape[0]


def head_addr(log: LogState, mem: int) -> torch.Tensor:
    """First in-memory address (everything below is stable tier)."""
    return torch.maximum(log.begin, log.tail - mem)


def read_only_addr(log: LogState, mem: int, mutable_frac: float) -> torch.Tensor:
    mutable = max(1, int(mem * mutable_frac))
    return torch.maximum(log.begin, log.tail - mutable)


def slot_of(log: LogState, addr: torch.Tensor) -> torch.Tensor:
    return addr & (capacity_of(log) - 1)


def gather(log: LogState, addr: torch.Tensor):
    """Gather (key, val, prev, meta) at logical addresses.  Callers mask
    lanes whose addr is invalid; the physical index is clamped so the
    gather itself is always in bounds."""
    slot = slot_of(log, addr.clamp_min(0))
    return log.key[slot], log.val[slot], log.prev[slot], log.meta[slot]


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
    new_addrs = torch.where(mask, log.tail + offs, NULL_ADDR)
    sel = mask.nonzero().squeeze(1)
    slot = new_addrs[sel] & (cap - 1)
    log.key[slot] = keys[sel]
    log.val[slot] = vals[sel]
    log.prev[slot] = prevs[sel]
    log.meta[slot] = metas[sel]
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


def update_in_place(log: LogState, mask: torch.Tensor, addrs: torch.Tensor,
                    vals: torch.Tensor, metas: torch.Tensor) -> LogState:
    sel = mask.nonzero().squeeze(1)
    slot = slot_of(log, addrs[sel].clamp_min(0))
    log.val[slot] = vals[sel]
    log.meta[slot] = metas[sel]
    return log


def _set_meta_bit(log: LogState, mask, addrs, bit: int) -> LogState:
    sel = mask.nonzero().squeeze(1)
    slot = slot_of(log, addrs[sel].clamp_min(0))
    log.meta[slot] = log.meta[slot] | bit
    return log


def invalidate(log: LogState, mask: torch.Tensor, addrs: torch.Tensor) -> LogState:
    """Set the INVALID bit on masked records (e.g. failed CAS cleanup)."""
    return _set_meta_bit(log, mask, addrs, META_INVALID)


def set_tombstone_in_place(log: LogState, mask: torch.Tensor,
                           addrs: torch.Tensor) -> LogState:
    return _set_meta_bit(log, mask, addrs, META_TOMBSTONE)


def truncate(log: LogState, new_begin: torch.Tensor) -> LogState:
    """Advance BEGIN (the destructive phase of compaction)."""
    return log._replace(begin=torch.maximum(log.begin, new_begin))
