"""Bounded, vectorized hash-chain traversal (the unfused oracle walk).

The walker follows `prev` pointers from a batch of chain heads, looking for
the first (= most recent) record matching each lane's key.  Addresses may be
RC-tagged (replica in the read cache); the walker resolves both stores and
can be told to skip RC replicas (`rc_match=False`: liveness checks during
compaction only consider *log* records).

Every hop that lands on a stable-tier log address (addr < head) is charged
one 4 KiB block read.  The walk runs a fixed `chain_max` steps with per-lane
active masks, like the reference's fori_loop; it is the `"unfused"` engine
and the oracle the fused engines are tested against.  Lanes are [S, B]
(see `types`), the I/O counters [S].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import hybrid_log, read_cache
from .types import META_INVALID, NULL_ADDR, count, is_rc, rc_untag, shard_entry


class WalkResult(NamedTuple):
    found: torch.Tensor      # bool [B] a matching, valid record was found
    addr: torch.Tensor       # int32 [B] its address (RC-tagged if in the RC)
    io_blocks: torch.Tensor  # int32 [S]: stable-tier blocks read
    io_ops: torch.Tensor     # int32 [S]: random read ops issued
    mem_hits: torch.Tensor   # int32 [S]: in-memory record touches
    truncated: torch.Tensor  # bool [B] walk ended by hitting addr < lower bound
    exhausted: torch.Tensor  # bool [B] chain_max hops without resolution
    hops: torch.Tensor       # int32 [B] per-lane record touches


def _in_range(cur, cur_is_rc, lower):
    return torch.where(cur_is_rc, cur != NULL_ADDR,
                       (cur != NULL_ADDR) & (cur >= lower))


@shard_entry(lambda keys, *a, **k: keys.ndim == 1)
def walk(keys: torch.Tensor, heads: torch.Tensor, log: hybrid_log.LogState,
         lower: torch.Tensor, head_boundary: torch.Tensor,
         active: torch.Tensor, chain_max: int,
         rc: Optional[read_cache.RCState] = None,
         rc_match: bool = True) -> WalkResult:
    S, B = keys.shape
    dev = keys.device
    cur = heads.clone()
    done = torch.zeros((S, B), dtype=torch.bool, device=dev)
    faddr = torch.full((S, B), NULL_ADDR, dtype=torch.int32, device=dev)
    io_b = torch.zeros((S,), dtype=torch.int32, device=dev)
    mem_h = torch.zeros((S,), dtype=torch.int32, device=dev)
    trunc = torch.zeros((S, B), dtype=torch.bool, device=dev)
    hops = torch.zeros((S, B), dtype=torch.int32, device=dev)
    head_boundary = head_boundary[:, None]
    for _ in range(chain_max):
        cur_is_rc = is_rc(cur)
        log_addr = torch.where(cur_is_rc, NULL_ADDR, cur)
        live = active & ~done & _in_range(cur, cur_is_rc, lower)
        trunc = trunc | (active & ~done & ~cur_is_rc & (cur != NULL_ADDR)
                         & (cur < lower))

        k, _, p, m = hybrid_log.gather(log, log_addr.clamp_min(0))
        if rc is not None:
            k_r, _, p_r, m_r = read_cache.gather(rc, rc_untag(cur))
            k = torch.where(cur_is_rc, k_r, k)
            p = torch.where(cur_is_rc, p_r, p)
            m = torch.where(cur_is_rc, m_r, m)

        valid = (m & META_INVALID) == 0
        key_match = live & valid & (k == keys)
        if not rc_match:
            key_match = key_match & ~cur_is_rc
        is_io = live & ~cur_is_rc & (cur < head_boundary)
        io_b = io_b + count(is_io)
        mem_h = mem_h + count(live & ~is_io)
        hops = hops + live.to(torch.int32)

        faddr = torch.where(key_match, cur, faddr)
        done = done | key_match
        nxt = torch.where(live & ~key_match, p, cur)
        cur = torch.where(done | ~live, cur, nxt)
    exhausted = active & ~done & _in_range(cur, is_rc(cur), lower)
    return WalkResult(found=done & active, addr=faddr, io_blocks=io_b,
                      io_ops=io_b.clone(), mem_hits=mem_h,
                      truncated=trunc & ~done, exhausted=exhausted, hops=hops)
