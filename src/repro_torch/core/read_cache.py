"""Second-chance FIFO read cache (paper S7).

An in-memory record ring.  Records are *replicas* of stable-tier records in
the hot or cold log; the hot hash index may point at an RC record (tagged
with RC_FLAG), whose `prev` field continues the chain into the hot log.
Invariants (paper S7.1/7.2):

  * at most one RC record per hash chain, and it is always the chain head;
  * an RC record always replicates the most recent value of its key;
  * hot-log records never point into the RC (appends skip + detach RC heads).

Eviction is the ring overwrite itself: before a slot is reused, any index
entry still pointing at the dying logical address is swung back to the
record's `prev`.  Second chance = a hit in the RC read-only region is
re-inserted at the tail.  Scatters update the columns and the index in
place, in the reference's order (repair, write replicas, publish).  The
functions take the shard axis (see `types`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import groups
from .types import (META_INVALID, NULL_ADDR, count, excl_cumsum, i32, rc_tag,
                    shard_entry, slot_of_keys, take)

# one shard's cache (scalar `tail`) is lifted to the shard axis
_entry = shard_entry(lambda rc, *a, **k: rc.tail.ndim == 0)


class RCState(NamedTuple):
    key: torch.Tensor    # int32 [S, R]
    val: torch.Tensor    # int32 [S, R, V]
    prev: torch.Tensor   # int32 [S, R] underlying *hot-log* chain continuation
    meta: torch.Tensor   # int32 [S, R]
    tail: torch.Tensor   # int32 [S] (logical)


def create(capacity: int, value_width: int, device, lead=()) -> RCState:
    c = max(capacity, 1)
    lead = tuple(lead)

    def full(shape, v):
        return torch.full(lead + shape, v, dtype=torch.int32, device=device)
    return RCState(key=full((c,), -1), val=full((c, value_width), 0),
                   prev=full((c,), NULL_ADDR), meta=full((c,), 0),
                   tail=i32(0, device, lead))


def capacity_of(rc: RCState) -> int:
    return rc.key.shape[-1]


def read_only_addr(rc: RCState, mutable_frac: float) -> torch.Tensor:
    mutable = max(1, int(capacity_of(rc) * mutable_frac))
    return (rc.tail - mutable).clamp_min(0)


@_entry
def gather(rc: RCState, addr: torch.Tensor):
    """Gather by *untagged* logical rc address [S, W]."""
    slot = addr.clamp_min(0) & (capacity_of(rc) - 1)
    return (take(rc.key, slot), take(rc.val, slot), take(rc.prev, slot),
            take(rc.meta, slot))


@_entry
def invalidate(rc: RCState, mask: torch.Tensor, addr: torch.Tensor) -> RCState:
    s, w = mask.nonzero(as_tuple=True)
    slot = addr[s, w].clamp_min(0) & (capacity_of(rc) - 1)
    rc.meta[s, slot] = rc.meta[s, slot] | META_INVALID
    return rc


@_entry
def insert(rc: RCState, index_addr: torch.Tensor, mask: torch.Tensor,
           keys: torch.Tensor, vals: torch.Tensor, prevs: torch.Tensor
           ) -> Tuple[RCState, torch.Tensor, torch.Tensor]:
    """Batched RC insert with ring-overwrite eviction repair.

    Deduplicates to one insert per hash slot (the one-RC-per-chain rule) and
    drops admissions past the ring capacity (the repair below reads the
    pre-batch ring, so the ring must not wrap within one batch).  Returns
    (rc, index_addr, new_rc_addrs_tagged); `index_addr` is updated in place.
    """
    E = index_addr.shape[-1]
    cap = capacity_of(rc)
    slots = slot_of_keys(keys, E)
    info = groups.group_info(mask, slots)
    mask = mask & info.is_first
    offs = excl_cumsum(mask)
    mask = mask & (offs < cap)
    new_addr = torch.where(mask, rc.tail[:, None] + offs, NULL_ADDR)
    s, w = mask.nonzero(as_tuple=True)
    n_sel = new_addr[s, w]
    phys = n_sel & (cap - 1)

    # --- eviction repair for the logical addresses being overwritten -------
    dying = n_sel - cap
    old_key = rc.key[s, phys]
    old_prev = rc.prev[s, phys]
    old_islot = slot_of_keys(old_key, E)
    do_repair = (dying >= 0) & (index_addr[s, old_islot] == rc_tag(dying))
    r = do_repair.nonzero().squeeze(1)
    index_addr[s[r], old_islot[r]] = old_prev[r]

    # --- write the replicas -------------------------------------------------
    rc.key[s, phys] = keys[s, w]
    rc.val[s, phys] = vals[s, w]
    rc.prev[s, phys] = prevs[s, w]
    rc.meta[s, phys] = 0
    rc = rc._replace(tail=rc.tail + count(mask))

    # --- publish as chain heads ---------------------------------------------
    index_addr[s, slots[s, w]] = rc_tag(n_sel)
    tagged = torch.where(mask, rc_tag(new_addr), NULL_ADDR)
    return rc, index_addr, tagged
