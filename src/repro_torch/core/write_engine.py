"""Write engine dispatch: the mutate path as one engine pass.

`store.write_batch` is, per batch: per-key linearization (last-set
selection + RMW accumulation), a hot-log locate walk that skips read-cache
replicas, in-place-vs-RCU classification against the mutable boundary,
intra-batch chain offsets, and append/index-publish preparation.  This
module produces all of it as a `WritePlan`, with the same backends and the
same `F2Config.engine` knob as `probe_engine`:

    "unfused"    — `groups` argsort linearization + `chain.walk` (the oracle).
    "fused_ref"  — the plain single pass (B x B group masks).
    "fused_cuda" — the CUDA kernel (three launches, no B x B masks).
    "fused"      — the kernel for CUDA tensors, the plain pass for CPU ones.

The engine emits a plan rather than mutating state, so the log/RC/index
updates stay in `store.write_batch`, and the cold-log base lookup for
pure-RMW groups composes outside the pass.  All backends return the same
plan bit for bit.  Lanes are [S, B] over a stacked store (see `types`);
the fields below are commented per shard.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.f2_probe import ops as probe_ops
from ..kernels.f2_probe import ref as _ref
from . import chain, groups, hybrid_log, probe_engine, read_cache
from .types import (META_TOMBSTONE, NULL_ADDR, OP_DELETE, OP_RMW, OP_UPSERT,
                    F2Config, excl_cumsum, is_rc, lanes, rc_untag, shard_entry,
                    slot_of_keys, take)

_BIG = 2**30


class WritePlan(NamedTuple):
    """Everything write_batch needs to apply a mutate batch.  Per-lane
    fields are fully masked, so backends compare bit for bit."""
    rep: torch.Tensor             # bool  [B] one mutating lane per key group
    rep_pos: torch.Tensor         # int32 [B] batch position of my group's rep (-1)
    val_nocold: torch.Tensor      # int32 [B, V] final value sans cold base
    final_tomb: torch.Tensor      # bool  [B] rep writes a tombstone
    need_cold: torch.Tensor       # bool  [B] pure-RMW miss: resolve cold base
    created_nocold: torch.Tensor  # bool  [B] RMW creates unless cold supplies base
    found: torch.Tensor           # bool  [B] locate walk found a live log record
    addr: torch.Tensor            # int32 [B] its address (NULL when not found)
    in_place: torch.Tensor        # bool  [B] mutable-region in-place update
    append: torch.Tensor          # bool  [B] RCU append at the tail
    new_addrs: torch.Tensor       # int32 [B] assigned append addresses (NULL)
    prevs: torch.Tensor           # int32 [B] chain prev per append (intra-batch)
    slots: torch.Tensor           # int32 [B] hot-index slot per lane
    publish: torch.Tensor         # bool  [B] last append of its slot run
    heads: torch.Tensor           # int32 [B] resolved index heads (may be RC)
    rc_inval: torch.Tensor        # bool  [B] invalidate the RC head replica
    hops: torch.Tensor            # int32 [B] per-lane walk record touches
    io_blocks: torch.Tensor       # int32 scalar: stable-tier blocks read
    io_ops: torch.Tensor          # int32 scalar: random read ops issued
    mem_hits: torch.Tensor        # int32 scalar: in-memory record touches
    exhausted: torch.Tensor       # bool  [B] chain_max hops without resolution


@shard_entry(lambda cfg, keys, *a, **k: keys.ndim == 1)
def plan(cfg: F2Config, keys: torch.Tensor, ops: torch.Tensor,
         vals: torch.Tensor, log: hybrid_log.LogState, index: torch.Tensor,
         rc: read_cache.RCState, *, engine: Optional[str] = None) -> WritePlan:
    """One write-plan pass over a mutate batch (backend per cfg.engine)."""
    engine = probe_engine.resolve(cfg.engine if engine is None else engine,
                                  keys.device)
    if engine == "unfused":
        return _plan_unfused(cfg, keys, ops, vals, log, index, rc)
    hb = hybrid_log.head_addr(log, cfg.hot_mem)
    ro = hybrid_log.read_only_addr(log, cfg.hot_mem, cfg.hot_mutable_frac)
    args = (keys, ops, vals, index, log.begin, hb, ro, log.tail,
            log.key, log.val, log.prev, log.meta,
            rc.key, rc.val, rc.prev, rc.meta)
    if engine == "fused_cuda":
        out = probe_ops.fused_write(*args, chain_max=cfg.chain_max)
    else:
        out = _ref.fused_write_body(*args, chain_max=cfg.chain_max,
                                    early_exit=True)
    (rep, rep_pos, val_nocold, final_tomb, need_cold, created_nocold,
     found, addr, in_place, append, new_addrs, prevs, slots, publish,
     heads, rc_inval, hops, ios, exhausted) = out
    n_io = ios.sum(dim=-1, dtype=torch.int32)
    return WritePlan(rep=rep, rep_pos=rep_pos, val_nocold=val_nocold,
                     final_tomb=final_tomb, need_cold=need_cold,
                     created_nocold=created_nocold, found=found, addr=addr,
                     in_place=in_place, append=append, new_addrs=new_addrs,
                     prevs=prevs, slots=slots, publish=publish, heads=heads,
                     rc_inval=rc_inval, hops=hops, io_blocks=n_io,
                     io_ops=n_io,
                     mem_hits=hops.sum(dim=-1, dtype=torch.int32) - n_io,
                     exhausted=exhausted)


def _plan_unfused(cfg, keys, ops, vals, log, index, rc) -> WritePlan:
    """The seed write path's computation as a plan: argsort linearization +
    `chain.walk` + separate gathers.  Kept bit-exact as the oracle."""
    B = keys.shape[-1]
    wmask = (ops == OP_UPSERT) | (ops == OP_RMW) | (ops == OP_DELETE)
    is_set = (ops == OP_UPSERT) | (ops == OP_DELETE)
    pos = torch.arange(B, dtype=torch.int32, device=keys.device)

    # --- per-key linearization (group by key) -------------------------------
    info, last_set_pos = groups.segment_reduce_last_set(wmask, keys, is_set, B)
    has_set = last_set_pos >= 0
    set_val = groups.select_at_pos(vals, last_set_pos)
    set_op = groups.select_at_pos(ops, last_set_pos)
    set_is_del = has_set & (set_op == OP_DELETE)
    rmw_after = wmask & (ops == OP_RMW) & (pos > last_set_pos)
    rmw_sum = groups.segment_sum_where(vals, rmw_after, info.run_id, B)
    rmw_cnt = groups.segment_sum_where(rmw_after.to(torch.int32), rmw_after,
                                       info.run_id, B)
    rep = wmask & info.is_first
    first_pos = groups.segment_min(torch.where(wmask, pos, _BIG), info.run_id, B)
    seg = torch.where(info.run_id >= 0, info.run_id, B - 1).to(torch.int64)
    rep_pos = torch.where(wmask, take(first_pos, seg), -1).to(torch.int32)

    # --- locate the most recent *log* record (skip RC replicas) -------------
    slots = slot_of_keys(keys, cfg.hot_index_size)
    heads = take(index, slots)
    hot_head = hybrid_log.head_addr(log, cfg.hot_mem)
    ro_addr = hybrid_log.read_only_addr(log, cfg.hot_mem,
                                        cfg.hot_mutable_frac)[:, None]
    lower = lanes(log.begin, keys)
    res = chain.walk(keys, heads, log, lower, hot_head, rep, cfg.chain_max,
                     rc=rc, rc_match=False)
    found = res.found
    _, fval, _, fmeta = hybrid_log.gather(log, torch.where(found, res.addr, 0))
    found_tomb = found & ((fmeta & META_TOMBSTONE) != 0)
    found_mut = found & (res.addr >= ro_addr)

    # --- base value for pure-RMW groups -------------------------------------
    pure_rmw = rep & ~has_set & (rmw_cnt > 0)
    base_hot = pure_rmw & found & ~found_tomb
    need_cold = pure_rmw & ~found
    created_nocold = pure_rmw & ~base_hot

    base = torch.where(base_hot[..., None], fval, 0)
    val_nocold = torch.where(
        (has_set & ~set_is_del)[..., None], set_val + rmw_sum,
        torch.where((has_set & set_is_del & (rmw_cnt > 0))[..., None],
                    rmw_sum, base + rmw_sum))
    val_nocold = torch.where(rep[..., None], val_nocold, 0).to(torch.int32)
    final_tomb = rep & has_set & set_is_del & (rmw_cnt == 0)

    # --- in-place (mutable region) vs RCU append ----------------------------
    in_place = rep & found_mut
    append = rep & ~in_place
    head_is_rc = is_rc(heads)
    rc_k, _, rc_p, _ = read_cache.gather(rc, rc_untag(heads))
    eff_prev = torch.where(head_is_rc, rc_p, heads)
    rc_inval = (append & head_is_rc) | (in_place & head_is_rc & (rc_k == keys))

    # --- intra-batch chaining by hash slot ----------------------------------
    ginfo = groups.group_info(append, slots)
    new_addrs = torch.where(append, log.tail[:, None] + excl_cumsum(append),
                            NULL_ADDR).to(torch.int32)
    pred_addr = groups.select_at_pos(new_addrs, ginfo.pred)
    prevs = torch.where(append, torch.where(ginfo.pred >= 0, pred_addr,
                                            eff_prev),
                        NULL_ADDR).to(torch.int32)
    publish = append & ginfo.is_last
    return WritePlan(rep=rep, rep_pos=rep_pos, val_nocold=val_nocold,
                     final_tomb=final_tomb, need_cold=need_cold,
                     created_nocold=created_nocold, found=found,
                     addr=res.addr, in_place=in_place, append=append,
                     new_addrs=new_addrs, prevs=prevs, slots=slots,
                     publish=publish, heads=heads, rc_inval=rc_inval,
                     hops=res.hops, io_blocks=res.io_blocks,
                     io_ops=res.io_ops, mem_hits=res.mem_hits,
                     exhausted=res.exhausted)
