"""Two-level cold-log hash index (paper S6).

Level 1: an in-memory array `chunk_addr[n_chunks]` mapping chunk-id -> the
logical address of that chunk's latest version in the *hash-chunk log*.
Level 2: the hash-chunk log itself, a ring of fixed 256 B chunks of
`chunk_slots` (32) hash entries.  Chunks mostly live on the stable tier; a
small in-memory window absorbs chunk RMWs.

Entry lookup for key k:   g = hash(k) mod (n_chunks*chunk_slots)
                          chunk_id = g / chunk_slots, offset = g % chunk_slots
Reading an entry = 1 chunk read (one 4 KiB block I/O when stable-resident).
Modifying entries = chunk RMW: in place when the chunk version sits in the
chunk log's mutable window, else read-modify-append of a new version.
Batched updates to the same chunk coalesce into one new version.
`compact_chunklog` relocates the chunks level 1 still references.
The functions take the shard axis (see `types`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import groups
from .types import (NULL_ADDR, F2Config, IoStats, count, excl_cumsum, i32,
                    records_to_blocks, shard_entry, slot_of_keys, take)

# one shard's index (scalar `tail`) is lifted to the shard axis
_entry = shard_entry(lambda ci, *a, **k: ci.tail.ndim == 0)


class ColdIndexState(NamedTuple):
    chunk_addr: torch.Tensor    # int32 [S, n_chunks] -> chunk-log logical addr
    chunks: torch.Tensor        # int32 [S, chunklog_capacity, chunk_slots]
    chunk_ids: torch.Tensor     # int32 [S, chunklog_capacity] owner chunk id per slot
    tail: torch.Tensor          # int32 [S]
    begin: torch.Tensor         # int32 [S]
    flushed_upto: torch.Tensor  # int32 [S]
    overflowed: torch.Tensor    # bool [S]: a live chunk was overwritten (bug guard)


def create(cfg: F2Config, device, lead=()) -> ColdIndexState:
    lead = tuple(lead)

    def full(shape, v):
        return torch.full(lead + shape, v, dtype=torch.int32, device=device)
    return ColdIndexState(
        chunk_addr=full((cfg.n_chunks,), NULL_ADDR),
        chunks=full((cfg.chunklog_capacity, cfg.chunk_slots), NULL_ADDR),
        chunk_ids=full((cfg.chunklog_capacity,), -1),
        tail=i32(0, device, lead),
        begin=i32(0, device, lead),
        flushed_upto=i32(0, device, lead),
        overflowed=torch.zeros(lead, dtype=torch.bool, device=device),
    )


def _mem_head(ci: ColdIndexState, cfg: F2Config) -> torch.Tensor:
    return torch.maximum(ci.begin, ci.tail - cfg.chunklog_mem)


def slot_coords(cfg: F2Config, keys: torch.Tensor):
    """(global_slot, chunk_id, offset) for each key."""
    g = slot_of_keys(keys, cfg.cold_index_slots)
    return g, g // cfg.chunk_slots, g % cfg.chunk_slots


def _flush(ci: ColdIndexState, cfg: F2Config, stats: IoStats):
    """Implicit flush accounting for chunk versions leaving the window."""
    h = _mem_head(ci, cfg)
    newly = (h - torch.maximum(ci.flushed_upto, ci.begin)).clamp_min(0)
    stats = stats.add_writes(records_to_blocks(newly, cfg.chunk_bytes))
    return ci._replace(flushed_upto=torch.maximum(ci.flushed_upto, h)), stats


@_entry
def find_entries(ci: ColdIndexState, cfg: F2Config, keys: torch.Tensor,
                 active: torch.Tensor, stats: IoStats
                 ) -> Tuple[torch.Tensor, IoStats]:
    """Cold-chain heads for keys [S, W]; charges one chunk I/O per active
    lookup whose chunk version is stable-resident."""
    _, cid, off = slot_coords(cfg, keys)
    caddr = take(ci.chunk_addr, cid)
    present = active & (caddr != NULL_ADDR)
    phys = caddr.clamp_min(0) & (cfg.chunklog_capacity - 1)
    entry = torch.where(present, take(ci.chunks, phys, off), NULL_ADDR)
    is_io = present & (caddr < _mem_head(ci, cfg)[:, None])
    n = count(is_io)
    stats = stats.add_reads(n, n).add_mem_hits(count(present & ~is_io))
    return entry, stats


@_entry
def update_entries(ci: ColdIndexState, cfg: F2Config, mask: torch.Tensor,
                   keys: torch.Tensor, new_addrs: torch.Tensor,
                   stats: IoStats, charge_rmw_read: bool = True
                   ) -> Tuple[ColdIndexState, IoStats]:
    """Batched chunk RMW (in place on the chunk-log tensors).  Lanes
    updating the same chunk coalesce into one new chunk version; chunks in
    the mutable window are updated in place (no new version)."""
    cap = cfg.chunklog_capacity
    S = keys.shape[0]
    _, cid, off = slot_coords(cfg, keys)
    info = groups.group_info(mask, cid)
    is_rep = mask & info.is_first
    cur = take(ci.chunk_addr, cid)
    mem_head = _mem_head(ci, cfg)[:, None]
    in_place = (cur != NULL_ADDR) & (cur >= mem_head)

    # --- representatives of non-in-place chunks append a new version --------
    appends = is_rep & ~in_place
    new_caddr = torch.where(appends, ci.tail[:, None] + excl_cumsum(appends),
                            NULL_ADDR)
    n_app = count(appends)
    if charge_rmw_read:
        n_r = count(appends & (cur != NULL_ADDR) & (cur < mem_head))
        stats = stats.add_reads(n_r, n_r)

    old_phys = cur.clamp_min(0) & (cap - 1)
    new_phys = new_caddr.clamp_min(0) & (cap - 1)
    # overwriting a still-live chunk version would corrupt: flag it
    dying_owner = take(ci.chunk_ids, new_phys)
    owner_addr = take(ci.chunk_addr, dying_owner.clamp_min(0))
    owner_live = ((dying_owner >= 0) & (owner_addr >= 0)
                  & ((owner_addr & (cap - 1)) == new_phys)
                  & (owner_addr < new_caddr))
    overflow = torch.any(appends & owner_live, dim=-1)

    # copy old content (or empty) into the new physical rows; every read of
    # the pre-batch tensors happens before the first write
    s, w = appends.nonzero(as_tuple=True)
    old_content = torch.where((cur[s, w] != NULL_ADDR)[:, None],
                              ci.chunks[s, old_phys[s, w]], NULL_ADDR)
    ci.chunks[s, new_phys[s, w]] = old_content
    ci.chunk_ids[s, new_phys[s, w]] = cid[s, w]
    ci.chunk_addr[s, cid[s, w]] = new_caddr[s, w]

    # --- scatter the individual entries -------------------------------------
    # map chunk_id -> row chosen for this batch (new version or in place)
    row_of_chunk = torch.full((S, cfg.n_chunks), -1, dtype=torch.int32,
                              device=keys.device)
    rep_row = torch.where(in_place, old_phys, new_phys)
    s, w = is_rep.nonzero(as_tuple=True)
    row_of_chunk[s, cid[s, w]] = rep_row[s, w]
    lane_row = take(row_of_chunk, cid.clamp_max(cfg.n_chunks - 1))
    do_write = mask & (lane_row >= 0)
    s, w = do_write.nonzero(as_tuple=True)
    flat = lane_row[s, w].to(torch.int64) * cfg.chunk_slots + off[s, w]
    ci.chunks.view(S, -1)[s, flat] = new_addrs[s, w]

    ci = ci._replace(tail=ci.tail + n_app, overflowed=ci.overflowed | overflow)
    return _flush(ci, cfg, stats)


@_entry
def compact_chunklog(ci: ColdIndexState, cfg: F2Config, stats: IoStats,
                     frac: float = 0.5, do=None
                     ) -> Tuple[ColdIndexState, IoStats]:
    """Relocate live chunks out of the oldest `frac` of the chunk log, then
    truncate.  Liveness of a chunk version = level 1 still points at it.
    The cut is computed in float32, as in the reference.  `do` (bool [S])
    restricts the pass to some shards: the others' chunk tensors are not
    touched (the caller keeps their scalars)."""
    cap = cfg.chunklog_capacity
    span = ((ci.tail - ci.begin).to(torch.float32) * frac).to(torch.int32)
    until = ci.begin + span.clamp_min(1)
    addr = ci.chunk_addr
    live = (addr != NULL_ADDR) & (addr < until[:, None])   # needs relocation
    if do is not None:
        live = live & do[:, None]
    n = count(live)
    new_addr = torch.where(live, ci.tail[:, None] + excl_cumsum(live), addr)
    n_io = count(live & (addr < _mem_head(ci, cfg)[:, None]))
    stats = stats.add_reads(n_io, n_io)

    s, j = live.nonzero(as_tuple=True)
    content = ci.chunks[s, addr[s, j].clamp_min(0) & (cap - 1)]
    new_phys = new_addr[s, j] & (cap - 1)
    ci.chunks[s, new_phys] = content
    ci.chunk_ids[s, new_phys] = j.to(torch.int32)
    ci.chunk_addr.copy_(new_addr)
    ci = ci._replace(tail=ci.tail + n, begin=until,
                     flushed_upto=torch.maximum(ci.flushed_upto, until))
    return _flush(ci, cfg, stats)
