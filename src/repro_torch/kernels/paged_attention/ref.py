"""Plain PyTorch version of the paged-attention decode kernel: gather the
pages densely, then attend (the JAX package's `paged_attention/ref.py`)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths):
    """q: [B, Hkv, G, Dh]; k/v_pool: [Hkv, n_pool_pages, page_size, Dh];
    page_table: [B, max_pages] int32 physical page per logical page;
    lengths: [B] int32 valid KV length.  Returns [B, Hkv, G, Dh] in q's
    dtype.  Scores and the softmax are float32; positions at or past a
    sequence's length are masked to NEG_INF."""
    B, Hkv, G, Dh = q.shape
    _, _, page_size, _ = k_pool.shape
    max_pages = page_table.shape[1]
    S = max_pages * page_size
    idx = page_table.long()
    k = k_pool[:, idx].transpose(0, 1).reshape(B, Hkv, S, Dh)
    v = v_pool[:, idx].transpose(0, 1).reshape(B, Hkv, S, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * (Dh ** -0.5)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, None, None] < lengths[:, None, None, None]
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhgk,bhkd->bhgd", p, v.float()).to(q.dtype)
