"""Plain PyTorch version of the flash-attention kernels (the JAX package's
`flash_attention/ref.py::mha_reference`, with p rounded to v's dtype before
the p.v product as the kernels and the TPU kernel round it).  Autograd
through it is the plain version of the gradient kernels."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [BH, G, Tq, Dh]; k/v: [BH, 1, Tk, Dh] -> [BH, G, Tq, Dh] in q's
    dtype.  Scores and the softmax are float32; masked positions (causal:
    query >= key; window > 0: query - key < window) take the finite NEG_INF."""
    Tq, Dh = q.shape[2], q.shape[3]
    Tk = k.shape[2]
    # a DTensor takes the broadcast matmul: einsum's flattening of (G, Tq)
    # is refused where Tq is sharded (sequence parallelism)
    dist = isinstance(q, DTensor)
    s = (torch.matmul(q.float(), k.float().transpose(-1, -2)) if dist else
         torch.einsum("bgqd,bokd->bgqk", q.float(), k.float())) * (Dh ** -0.5)
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
    if dist:
        return torch.matmul(p, v.float()).to(q.dtype)
    return torch.einsum("bgqk,bokd->bgqd", p, v.float()).to(q.dtype)
