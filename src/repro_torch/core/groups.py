"""Deterministic intra-batch linearization helpers.

A batch of B operations is linearized by *batch position*: these helpers
compute, per lane, its group structure (lanes sharing a hash slot or key)
with one stable argsort — the batched, deterministic replacement for CAS
retry loops.  Segment reductions are `scatter_reduce` / `index_add_`.

All helpers take a bool `mask` (inactive lanes never group with anything)
and int32 `gid` group ids, and return per-lane tensors in batch order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 2**30
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


class GroupInfo(NamedTuple):
    pred: torch.Tensor      # int32 [B]: previous masked lane in my group, -1 if none
    is_first: torch.Tensor  # bool  [B]: first masked lane of my group
    is_last: torch.Tensor   # bool  [B]: last masked lane of my group
    run_id: torch.Tensor    # int32 [B]: dense group index (sorted order), -1 if unmasked
    order: torch.Tensor     # int32 [B]: the stable sort permutation (masked first)


def group_info(mask: torch.Tensor, gid: torch.Tensor) -> GroupInfo:
    B = gid.shape[0]
    dev = gid.device
    skey = torch.where(mask, gid, _BIG).to(torch.int32)
    order = torch.argsort(skey, stable=True)        # masked lanes first, grouped
    g_s = skey[order]
    m_s = mask[order]
    f = torch.zeros((1,), dtype=torch.bool, device=dev)
    same_prev = torch.cat([f, g_s[1:] == g_s[:-1]]) & m_s
    same_next = torch.cat([g_s[:-1] == g_s[1:], f]) & m_s
    order32 = order.to(torch.int32)
    pred_s = torch.where(same_prev, torch.roll(order32, 1), -1)
    first_s = m_s & ~same_prev
    last_s = m_s & ~same_next
    run_id_s = torch.where(m_s, torch.cumsum(first_s.to(torch.int32), 0) - 1,
                           -1).to(torch.int32)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(B, device=dev)
    return GroupInfo(pred=pred_s[inv], is_first=first_s[inv],
                     is_last=last_s[inv], run_id=run_id_s[inv], order=order32)


def _segment_ids(run_id: torch.Tensor, n_segments: int) -> torch.Tensor:
    return torch.where(run_id >= 0, run_id, n_segments - 1).to(torch.int64)


def segment_reduce_last_set(mask: torch.Tensor, gid: torch.Tensor,
                            is_set: torch.Tensor, n_segments: int):
    """Per group: batch position of the last set op (-1 if none).
    Returns (GroupInfo, last_set_pos_per_lane)."""
    info = group_info(mask, gid)
    B = gid.shape[0]
    pos = torch.arange(B, dtype=torch.int32, device=gid.device)
    seg = _segment_ids(info.run_id, n_segments)
    contrib = torch.where(mask & is_set, pos, -1).to(torch.int32)
    last_set = torch.full((n_segments,), _I32_MIN, dtype=torch.int32,
                          device=gid.device).scatter_reduce(
        0, seg, contrib, "amax", include_self=True)
    last_set = last_set.clamp_min(-1)
    return info, torch.where(mask, last_set[seg], -1).to(torch.int32)


def segment_min(values: torch.Tensor, run_id: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Per-segment int32 minimum (INT32_MAX for empty segments)."""
    seg = _segment_ids(run_id, n_segments)
    return torch.full((n_segments,), _I32_MAX, dtype=torch.int32,
                      device=values.device).scatter_reduce(
        0, seg, values.to(torch.int32), "amin", include_self=True)


def segment_sum_where(values: torch.Tensor, mask: torch.Tensor,
                      run_id: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Per-lane gather of its group's masked sum (shape-preserving).  Sums
    run in int64 and wrap back to int32, as the reference's int32 sums do."""
    seg = _segment_ids(run_id, n_segments)
    m = mask[:, None] if values.ndim > 1 else mask
    mv = torch.where(m, values, 0).to(torch.int64)
    sums = torch.zeros((n_segments,) + tuple(values.shape[1:]),
                       dtype=torch.int64, device=values.device)
    sums.index_add_(0, seg, mv)
    out = sums[seg].to(torch.int32)
    keep = run_id >= 0
    return torch.where(keep[:, None] if values.ndim > 1 else keep, out, 0)


def select_at_pos(values: torch.Tensor, target_pos: torch.Tensor) -> torch.Tensor:
    """Gather values[target_pos] per lane; target_pos may be -1 (returns 0s)."""
    out = values[target_pos.clamp_min(0)]
    cond = target_pos >= 0
    return torch.where(cond[:, None] if values.ndim > 1 else cond, out, 0)
