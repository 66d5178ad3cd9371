"""Probe engine dispatch: one interface for every bounded chain walk.

Every walk in the store (hot-index probe on reads, the liveness probe of
ConditionalInsert and of the compactions, the cold-chain walk) is the same
primitive: slot hash / chain head -> bounded prev-pointer walk with a
per-lane address lower bound -> read-cache hit check -> value resolution.
`F2Config.engine` selects the backend; all return the same `ProbeResult`
bit for bit:

    "unfused"    — `chain.walk` + separate gathers (the oracle).
    "fused_ref"  — the plain single-pass version (`kernels/f2_probe/ref.py`).
    "fused_cuda" — the CUDA kernel; raises for tensors not on a CUDA device.
    "fused"      — the CUDA kernel for CUDA tensors, the plain single pass
                   for CPU tensors.

`index_heads` is the first hop alone (slot hash -> index entry), which the
two-phase read snapshots: with the "fused_cuda" backend it runs the
legacy first-hop probe kernel.

The columns stay in device memory at any store size: the reference's VMEM
budget has no counterpart here.  `target=` is the liveness mode of
lookup-based compaction: a lane whose chain head equals its target address
is found at the target with zero hops and zero modeled I/O.

Lanes are [S, B] over a stacked store (see `types`): one backend call, and
with the kernel one launch, serves every shard.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..kernels.f2_probe import ops as probe_ops
from ..kernels.f2_probe import ref as _ref
from . import chain, hybrid_log, read_cache
from .types import (META_INVALID, META_TOMBSTONE, NULL_ADDR, OP_DELETE,
                    OP_RMW, OP_UPSERT, RC_FLAG, F2Config, hash32, is_rc,
                    rc_untag, shard_entry, slot_of_keys, take)

# the kernel package re-declares the address/meta/op constants and the slot
# hash (it is import-standalone); fail loudly if they drift
assert (_ref.RC_FLAG, _ref.NULL_ADDR, _ref.META_INVALID, _ref.META_TOMBSTONE,
        _ref.OP_UPSERT, _ref.OP_RMW, _ref.OP_DELETE) == (
    RC_FLAG, NULL_ADDR, META_INVALID, META_TOMBSTONE, OP_UPSERT, OP_RMW,
    OP_DELETE)
_drift_keys = torch.tensor([0, 1, -1, 0x7FEB352D, 12345], dtype=torch.int32)
assert torch.equal(hash32(_drift_keys), _ref._mix(_drift_keys)), \
    "kernels/f2_probe/ref._mix diverged from types.hash32"


class ProbeResult(NamedTuple):
    found: torch.Tensor      # bool  [S, B] matching, valid record found
    addr: torch.Tensor       # int32 [S, B] its address (RC-tagged for replicas)
    heads: torch.Tensor      # int32 [S, B] resolved chain heads (index entries)
    value: torch.Tensor      # int32 [S, B, V] record value (0 when not found)
    meta: torch.Tensor       # int32 [S, B] record meta bitfield (0 when not found)
    hops: torch.Tensor       # int32 [S, B] per-lane record touches
    io_blocks: torch.Tensor  # int32 [S]: stable-tier blocks read
    io_ops: torch.Tensor     # int32 [S]: random read ops issued
    mem_hits: torch.Tensor   # int32 [S]: in-memory record touches
    exhausted: torch.Tensor  # bool  [S, B] chain_max hops without resolution


def resolve(engine: str, device: torch.device) -> str:
    """The backend that runs for tensors on `device`: "unfused",
    "fused_ref" or "fused_cuda"."""
    if engine == "fused":
        return "fused_cuda" if device.type == "cuda" else "fused_ref"
    if engine == "fused_cuda" and device.type != "cuda":
        raise ValueError(f"engine='fused_cuda' needs CUDA tensors, got {device}")
    if engine not in ("unfused", "fused_ref", "fused_cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


@functools.lru_cache(maxsize=16)
def dummy_rc(value_width: int, device: torch.device,
             n_shards=None) -> read_cache.RCState:
    """1-record read-cache columns for walks without an RC ([S, 1] with
    `n_shards`), built once per width, device and S (never written, and
    never dereferenced: without an RC no address carries the RC tag)."""
    lead = () if n_shards is None else (n_shards,)
    return read_cache.create(1, value_width, device, lead)


@shard_entry(lambda cfg, keys, *a, **k: keys.ndim == 1)
def probe(cfg: F2Config, keys: torch.Tensor, log: hybrid_log.LogState,
          lower: torch.Tensor, head_boundary: torch.Tensor,
          active: torch.Tensor, *, index: Optional[torch.Tensor] = None,
          heads: Optional[torch.Tensor] = None,
          rc: Optional[read_cache.RCState] = None, rc_match: bool = True,
          target: Optional[torch.Tensor] = None,
          engine: Optional[str] = None) -> ProbeResult:
    """One probe pass.  Exactly one of `index` (fuse the hot-index slot hash
    + gather: read path, ConditionalInsert) / `heads` (start from resolved
    entries: cold-index chains) is given."""
    if (index is None) == (heads is None):
        raise ValueError("give exactly one of index= / heads=")
    engine = resolve(cfg.engine if engine is None else engine, keys.device)
    if engine == "unfused":
        return _probe_unfused(cfg, keys, log, lower, head_boundary, active,
                              index=index, heads=heads, rc=rc,
                              rc_match=rc_match, target=target)
    has_rc = rc is not None
    rcs = rc if has_rc else dummy_rc(log.val.shape[-1], keys.device,
                                     keys.shape[0])
    probe_index = index is not None
    # lane bounds are often one scalar expanded over the batch
    args = (keys, index if probe_index else heads, lower.contiguous(), active,
            head_boundary, log.key, log.val, log.prev, log.meta,
            rcs.key, rcs.val, rcs.prev, rcs.meta)
    kw = dict(chain_max=cfg.chain_max, rc_match=rc_match, has_rc=has_rc,
              probe_index=probe_index, target=target)
    if engine == "fused_cuda":
        out = probe_ops.fused_probe(*args, **kw)
    else:
        out = _ref.fused_probe_body(*args, early_exit=True, **kw)
    found, addr, heads_out, value, meta, hops, ios, exhausted = out
    n_io = ios.sum(dim=-1, dtype=torch.int32)
    return ProbeResult(found=found, addr=addr, heads=heads_out, value=value,
                       meta=meta, hops=hops, io_blocks=n_io, io_ops=n_io,
                       mem_hits=hops.sum(dim=-1, dtype=torch.int32) - n_io,
                       exhausted=exhausted)


@shard_entry(lambda cfg, index, keys: keys.ndim == 1)
def index_heads(cfg: F2Config, index: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The (RC-tagged) index entries [S, B] of the keys' slots.  The kernel
    returns each head untagged with its RC flag; tagging it again gives the
    entry back bit for bit."""
    if resolve(cfg.engine, keys.device) == "fused_cuda":
        addr, rc = probe_ops.probe_cuda(keys.contiguous(), index)
        return torch.where(rc != 0, addr | RC_FLAG, addr)
    return take(index, slot_of_keys(keys, index.shape[-1]))


def _probe_unfused(cfg, keys, log, lower, head_boundary, active, *, index,
                   heads, rc, rc_match, target=None) -> ProbeResult:
    """Walk then gather (the seed read path), kept bit-exact as the oracle.
    The `target` fast path pre-filters the walk: fast lanes never walk, so
    they charge no hops and no I/O."""
    if heads is None:
        heads = take(index, slot_of_keys(keys, index.shape[-1]))
    if target is not None:
        fast = active & (heads == target)
        walk_active = active & ~fast
    else:
        fast = torch.zeros_like(active)
        walk_active = active
    res = chain.walk(keys, heads, log, lower, head_boundary, walk_active,
                     cfg.chain_max, rc=rc, rc_match=rc_match)
    found = res.found | fast
    addr = torch.where(fast, heads, res.addr)
    hit_rc = found & is_rc(addr)
    hit_log = found & ~hit_rc
    _, v_log, _, m_log = hybrid_log.gather(log, torch.where(hit_log, addr, 0))
    value = torch.where(hit_log[..., None], v_log, 0)
    meta = torch.where(hit_log, m_log, 0)
    if rc is not None:
        _, v_rc, _, m_rc = read_cache.gather(rc, rc_untag(addr))
        value = torch.where(hit_rc[..., None], v_rc, value)
        meta = torch.where(hit_rc, m_rc, meta)
    return ProbeResult(found=found, addr=addr, heads=heads, value=value,
                       meta=meta, hops=res.hops, io_blocks=res.io_blocks,
                       io_ops=res.io_ops, mem_hits=res.mem_hits,
                       exhausted=res.exhausted)

