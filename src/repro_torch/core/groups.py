"""Deterministic intra-batch linearization helpers.

A batch of B operations is linearized by *batch position*: these helpers
compute, per lane, its group structure (lanes sharing a hash slot or key)
with one stable argsort — the batched, deterministic replacement for CAS
retry loops.  Segment reductions are `scatter_reduce` / `scatter_add_`.

All helpers take a bool `mask` (inactive lanes never group with anything)
and int32 `gid` group ids of shape [S, B] (each shard's lanes group among
themselves; one shard's [B] lanes are lifted), and return per-lane tensors
in batch order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import shard_entry, take

_BIG = 2**30
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# one shard's lanes ([B] mask) are lifted to the shard axis
_entry = shard_entry(lambda mask, *a, **k: mask.ndim == 1)


class GroupInfo(NamedTuple):
    pred: torch.Tensor      # int32 [S, B]: previous masked lane in my group, -1 if none
    is_first: torch.Tensor  # bool  [S, B]: first masked lane of my group
    is_last: torch.Tensor   # bool  [S, B]: last masked lane of my group
    run_id: torch.Tensor    # int32 [S, B]: dense group index (sorted order), -1 if unmasked
    order: torch.Tensor     # int32 [S, B]: the stable sort permutation (masked first)


@_entry
def group_info(mask: torch.Tensor, gid: torch.Tensor) -> GroupInfo:
    S, B = gid.shape
    dev = gid.device
    skey = torch.where(mask, gid, _BIG).to(torch.int32)
    order = torch.argsort(skey, dim=1, stable=True)  # masked lanes first, grouped
    g_s = torch.gather(skey, 1, order)
    m_s = torch.gather(mask, 1, order)
    f = torch.zeros((S, 1), dtype=torch.bool, device=dev)
    same_prev = torch.cat([f, g_s[:, 1:] == g_s[:, :-1]], 1) & m_s
    same_next = torch.cat([g_s[:, :-1] == g_s[:, 1:], f], 1) & m_s
    order32 = order.to(torch.int32)
    pred_s = torch.where(same_prev, torch.roll(order32, 1, dims=1), -1)
    first_s = m_s & ~same_prev
    last_s = m_s & ~same_next
    run_id_s = torch.where(m_s, torch.cumsum(first_s.to(torch.int32), 1) - 1,
                           -1).to(torch.int32)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(B, device=dev).expand(S, B))
    return GroupInfo(pred=torch.gather(pred_s, 1, inv),
                     is_first=torch.gather(first_s, 1, inv),
                     is_last=torch.gather(last_s, 1, inv),
                     run_id=torch.gather(run_id_s, 1, inv), order=order32)


def _segment_ids(run_id: torch.Tensor, n_segments: int) -> torch.Tensor:
    return torch.where(run_id >= 0, run_id, n_segments - 1).to(torch.int64)


@_entry
def segment_reduce_last_set(mask: torch.Tensor, gid: torch.Tensor,
                            is_set: torch.Tensor, n_segments: int):
    """Per group: batch position of the last set op (-1 if none).
    Returns (GroupInfo, last_set_pos_per_lane)."""
    info = group_info(mask, gid)
    S, B = gid.shape
    pos = torch.arange(B, dtype=torch.int32, device=gid.device)
    seg = _segment_ids(info.run_id, n_segments)
    contrib = torch.where(mask & is_set, pos, -1).to(torch.int32)
    last_set = torch.full((S, n_segments), _I32_MIN, dtype=torch.int32,
                          device=gid.device).scatter_reduce(
        1, seg, contrib, "amax", include_self=True)
    last_set = last_set.clamp_min(-1)
    return info, torch.where(mask, torch.gather(last_set, 1, seg),
                             -1).to(torch.int32)


@shard_entry(lambda values, run_id, *a, **k: run_id.ndim == 1)
def segment_min(values: torch.Tensor, run_id: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Per-segment int32 minimum (INT32_MAX for empty segments), [S, n]."""
    seg = _segment_ids(run_id, n_segments)
    return torch.full((run_id.shape[0], n_segments), _I32_MAX,
                      dtype=torch.int32, device=values.device).scatter_reduce(
        1, seg, values.to(torch.int32), "amin", include_self=True)


@shard_entry(lambda values, mask, *a, **k: mask.ndim == 1)
def segment_sum_where(values: torch.Tensor, mask: torch.Tensor,
                      run_id: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Per-lane gather of its group's masked sum (shape-preserving: values
    [S, B] or [S, B, V]).  Sums run in int64 and wrap back to int32, as the
    reference's int32 sums do."""
    seg = _segment_ids(run_id, n_segments)
    wide = values.ndim > 2
    m = mask[..., None] if wide else mask
    mv = torch.where(m, values, 0).to(torch.int64)
    idx = seg[..., None].expand(mv.shape) if wide else seg
    sums = torch.zeros((mv.shape[0], n_segments) + tuple(mv.shape[2:]),
                       dtype=torch.int64, device=values.device)
    sums.scatter_add_(1, idx, mv)
    out = torch.gather(sums, 1, idx).to(torch.int32)
    keep = run_id >= 0
    return torch.where(keep[..., None] if wide else keep, out, 0)


@shard_entry(lambda values, target_pos: target_pos.ndim == 1)
def select_at_pos(values: torch.Tensor, target_pos: torch.Tensor) -> torch.Tensor:
    """Gather values[s, target_pos] per lane; target_pos may be -1 (0s)."""
    out = take(values, target_pos.clamp_min(0))
    cond = target_pos >= 0
    return torch.where(cond[..., None] if values.ndim > 2 else cond, out, 0)
