"""RWKV-6 "Finch" block (the JAX package's `models/rwkv6.py`): token-shift
time-mix with data-dependent decay, and squared-ReLU channel-mix.

Recurrence per head (state S [Dk, Dv]):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + tanh(x_w A) B)) computed from the input.  Training
and prefill run the recurrence over the sequence, decode one step of it
(T = 1) from the cached state: both go through `wkv_scan`, which is the WKV
CUDA kernels on a CUDA device and their plain version on the CPU.

The parameters are an `RWKV` module whose attribute names are the
reference's leaves.  `CAST` leaves are stored in `cfg.dtype` (the
reference casts its float32 masters at every use, which gives the same
bits as casting once); `w0`, `wB`, `u` and `ln_x` stay float32 (in a
training state they take `cfg.dtype` too, as the reference's
`init_state` casts every float32 leaf of two or more dimensions; the
functions here read them in float32 either way).  The cast
points of the activations are the reference's: the lerps run in the
activation dtype, the decay is computed in float32 from the float32 cast
of tanh(x_w A), r/k/v go to float32 for the recurrence, and y goes back to
the activation dtype before the per-head norm.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (constrain, is_distributed, matmul, merge_dims,
                                    split_dim)
from ..kernels.rwkv6_wkv import ops as wkv_ops
from .layers import _heads, _normal, _param, upcast, weight_dtype

LORA_R = 32
NAMES = ("mu", "wr", "wk", "wv", "wg", "wo", "w0", "wA", "wB", "u", "ln_x",
         "mu_c", "ck", "cv", "cr")
CAST = ("mu", "wr", "wk", "wv", "wg", "wo", "wA", "mu_c", "ck", "cv", "cr")


class RWKV(nn.Module):
    """mu [5, D], wr/wk/wv/wg [D, H, Dh], wo [H, Dh, D], w0 [H, Dh], wA [D, R],
    wB [R, H, Dh], u [H, Dh], ln_x [H, Dh], mu_c [2, D], ck [D, F], cv [F, D],
    cr [D, D]."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        if set(leaves) != set(NAMES):
            raise ValueError(f"RWKV leaves {sorted(leaves)}, expected {sorted(NAMES)}")
        for n in NAMES:
            setattr(self, n, _param(leaves[n]))


def rwkv_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> RWKV:
    """Random weights from the reference's distributions, drawn with `gen`."""
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    dt = weight_dtype(cfg)
    s = d ** -0.5

    def normal(shape, std, dtype=dt):
        return _normal(gen, shape, std, dtype, device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return RWKV(
        mu=torch.zeros((5, d), dtype=dt, device=device),
        wr=normal((d, H, hd), s), wk=normal((d, H, hd), s),
        wv=normal((d, H, hd), s), wg=normal((d, H, hd), s),
        wo=normal((H, hd, d), s),
        w0=full((H, hd), -6.0),
        wA=normal((d, LORA_R), s),
        wB=normal((LORA_R, H, hd), 0.01, torch.float32),
        u=full((H, hd), 0.0),
        ln_x=full((H, hd), 1.0),
        mu_c=torch.zeros((2, d), dtype=dt, device=device),
        ck=normal((d, cfg.d_ff), s),
        cv=normal((cfg.d_ff, d), cfg.d_ff ** -0.5),
        cr=normal((d, d), s))


def _shift(x, x_prev):
    """Token shift: x_{t-1} with x_prev seeding position 0. x: [B,T,D]."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_inputs(cfg: ModelConfig, p: RWKV, x, x_prev):
    """(r, k, v, g [B,H,T,Dh] in x's dtype, w [B,H,T,Dh] float32)."""
    dt = x.dtype
    diff = _shift(x, x_prev) - x
    mu = p.mu.to(dt)
    xr, xk, xv, xw, xg = (x + diff * mu[i] for i in range(5))
    r = _heads(xr, p.wr)
    k = _heads(xk, p.wk)
    v = _heads(xv, p.wv)
    g = F.silu(_heads(xg, p.wg))
    dd = torch.tanh(matmul(xw, p.wA.to(dt)))                        # [B,T,R]
    B, T, _ = x.shape
    R, H, hd = p.wB.shape
    dd = upcast(dd)
    lw = split_dim(matmul(dd, merge_dims(p.wB.to(dd.dtype), 1, 2)), 2,
                   (H, hd)).transpose(1, 2)
    lw = p.w0.float()[None, :, None, :] + lw
    w = torch.exp(-torch.exp(lw))                                    # (0,1) decay
    r = constrain(r, "batch", "heads", "seq", None)
    k = constrain(k, "batch", "heads", "seq", None)
    v = constrain(v, "batch", "heads", "seq", None)
    return r, k, v, g, w


def wkv_scan(r, k, v, w, u, state: Optional[torch.Tensor], need_state: bool = True):
    """The WKV recurrence.  r, k, v: [B,H,T,Dh] (taken in float32); w:
    [B,H,T,Dh] decay; u: [H,Dh]; state: [B,H,Dh,Dh] or None (zeros).
    Returns (y [B,H,T,Dh] float32, state' or None without need_state).
    Laid out over a mesh, the sequence is gathered once, each device runs
    the recurrence of its (batch, heads) shard (`_wkv_per_shard`), and y is
    split over the sequence again as r came."""
    if not is_distributed(r):
        return wkv_ops.wkv(r, k, v, w, u, state, need_state=need_state)
    r, k, v, w = (constrain(t, "batch", "heads", None, None) for t in (r, k, v, w))
    y, s = _wkv_per_shard(r, k, v, w, u, state, need_state)
    return constrain(y, "batch", "heads", "seq", None), s


def _wkv_per_shard(r, k, v, w, u, state, need_state: bool):
    """`wkv_ops.wkv` on each device's shard through `local_map`: r, k, v, w
    (and the state) split over batch and heads only, u over the heads as r
    is.  No batch row or head crosses a shard, so each runs alone; u's
    gradient is partial over the mesh dimensions that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(r.placements)
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in pl):
        raise ValueError(f"wkv: r laid out as {pl}; the recurrence takes batch "
                         "and heads split, the sequence whole")
    u_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl)
    u_grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(pl, u_pl))
    s_pl = pl if state is not None else None
    return local_map(
        lambda *a: wkv_ops.wkv(*a, need_state=need_state),
        out_placements=(pl, pl if need_state else None),
        in_placements=(pl, pl, pl, pl, u_pl, s_pl),
        in_grad_placements=(pl, pl, pl, pl, u_grad, s_pl),
        device_mesh=r.device_mesh, redistribute_inputs=True)(r, k, v, w, u, state)


def time_mix(cfg: ModelConfig, p: RWKV, x, x_prev, wkv_state,
             need_state: bool = True):
    """Returns (out [B,T,D], new_x_prev [B,D], new_wkv_state or None)."""
    dt = x.dtype
    r, k, v, g, w = _time_mix_inputs(cfg, p, x, x_prev)
    y, new_state = wkv_scan(r, k, v, w, p.u.float(), wkv_state, need_state)
    # per-head group norm then gate
    y = rmsnorm_heads(y.to(dt), p.ln_x) * g
    B, H, T, K = y.shape
    out = matmul(merge_dims(y.transpose(1, 2), 2, 2), merge_dims(p.wo.to(dt), 0, 2))
    return constrain(out, "batch", "seq", "embed"), x[:, -1, :], new_state


def rmsnorm_heads(y, scale, eps=1e-6):
    dt = y.dtype
    yf = upcast(y)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * scale.float()[None, :, None, :]).to(dt)


def channel_mix(cfg: ModelConfig, p: RWKV, x, x_prev):
    """Returns (out [B,T,D], new_x_prev [B,D])."""
    dt = x.dtype
    diff = _shift(x, x_prev) - x
    mu = p.mu_c.to(dt)
    xk = x + diff * mu[0]
    xr = x + diff * mu[1]
    kk = torch.square(F.relu(matmul(xk, p.ck.to(dt))))
    kk = constrain(kk, "batch", "seq", "mlp")
    vv = matmul(kk, p.cv.to(dt))
    rr = torch.sigmoid(matmul(xr, p.cr.to(dt)))
    return constrain(rr * vv, "batch", "seq", "embed"), x[:, -1, :]
