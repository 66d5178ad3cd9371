"""Plain PyTorch versions of the flash-attention kernels.

`mha_reference` is the JAX package's `flash_attention/ref.py::
mha_reference`, with p rounded to v's dtype before the p.v product as the
kernels and the TPU kernel round it.  Autograd through it is the plain
version of the gradient kernels.

`blockwise_attention` is the reference's model attention
(`src/repro/models/layers.py:109-180`): query heads grouped by KV head,
an online softmax over KV blocks of BLOCK_KV with a ragged Tk padded to
the block.  The dry-run runs it on `meta` tensors, one block counted
ceil(Tk / BLOCK_KV) times, so its FLOPs and temporaries are the
reference's loop's."""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
BLOCK_KV = 1024       # the reference's key block (`block_kv`)


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: [BH, G, Tq, Dh]; k/v: [BH, 1, Tk, Dh] -> [BH, G, Tq, Dh] in q's
    dtype.  Scores and the softmax are float32; masked positions (causal:
    query >= key; window > 0: query - key < window) take the finite NEG_INF.
    The scores are scaled by `scale`, Dh^-0.5 by default (a head dim padded
    with zero columns keeps its own)."""
    Tq, Dh = q.shape[2], q.shape[3]
    Tk = k.shape[2]
    scale = Dh ** -0.5 if scale is None else scale
    s = torch.einsum("bgqd,bokd->bgqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    kv_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    p = p.to(v.dtype).float()
    return torch.einsum("bgqk,bokd->bgqd", p, v.float()).to(q.dtype)


def _kv_step(Tq, Tk, block, scale, causal, window, q_offset, ik):
    """The reference's `kv_step` for key block `ik`: (qg, kb, vb, m, l, acc)
    -> (m, l, acc)."""
    def step(qg, kb, vb, m, l, acc):
        dev = qg.device
        s = torch.matmul(qg, kb.transpose(-1, -2)).float() * scale
        q_pos = q_offset + torch.arange(Tq, device=dev)[:, None]
        kv_pos = ik * block + torch.arange(block, device=dev)[None, :]
        mask = (kv_pos < Tk).expand(Tq, block)
        if causal:
            mask = mask & (q_pos >= kv_pos)
        if window > 0:
            mask = mask & ((q_pos - kv_pos) < window)
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(vb.dtype), vb).float()
        return m_new, l, acc
    return step


def blockwise_attention(qg, kg, vg, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, by_trip_count: bool = False):
    """qg: [B, Hkv, G, Tq, Dh]; kg/vg: [B, Hkv, 1, Tk, Dh] -> [B, Hkv, G, Tq,
    Dh] in qg's dtype, as the reference's model attention computes it (key
    blocks of BLOCK_KV, read at each call): the products in the inputs'
    dtype, then float32; p rounded to v's dtype; keys past Tk (the padding
    of the last block) masked to NEG_INF.  Query
    row i sits at position q_offset + i (a shard of a sequence split over
    devices).  `by_trip_count` runs the first block's step once, counted
    ceil(Tk / block) times (`launch.step_trace.scan_by_trip_count`: the
    dry-run's shapes-only tensors), instead of every block."""
    Tq, Dh = qg.shape[-2], qg.shape[-1]
    Tk = kg.shape[-2]
    block = min(BLOCK_KV, Tk)
    nk = -(-Tk // block)
    scale = Dh ** -0.5
    lead = tuple(qg.shape[:-1])
    m = torch.full(lead, NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros(lead, dtype=torch.float32, device=qg.device)
    acc = torch.zeros(tuple(qg.shape), dtype=torch.float32, device=qg.device)
    if by_trip_count:
        from ...launch import step_trace
        step = _kv_step(Tq, Tk, block, scale, causal, window, q_offset, 0)
        m, l, acc = step_trace.scan_by_trip_count(
            step, nk, qg, kg[..., :block, :], vg[..., :block, :], m, l, acc)
    else:
        pad = nk * block - Tk
        if pad:                      # a ragged Tk, as the reference pads it
            kg, vg = (F.pad(t, (0, 0, 0, pad)) for t in (kg, vg))
        for ik in range(nk):
            blk = slice(ik * block, (ik + 1) * block)
            step = _kv_step(Tq, Tk, block, scale, causal, window, q_offset, ik)
            m, l, acc = step(qg, kg[..., blk, :], vg[..., blk, :], m, l, acc)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(qg.dtype)
