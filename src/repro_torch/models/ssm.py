"""Minimal selective SSM (S6 / Mamba-style) head for the Hymba hybrid (the
JAX package's `models/ssm.py`):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (diag A, state N)
    y_t = h_t . C_t + D * x_t

with input-dependent (dt, B, C), the selective part.  A depthwise causal
conv (k = 4) precedes the SSM as in Mamba; decode carries the conv's tail.

The scan is a plain PyTorch loop over T, as the reference's is a
`lax.scan` outside any Pallas kernel: a handful of small launches a step,
so a prefill of T tokens through L layers makes about 8 * T * L of them.
On `meta` tensors (the dry-run) one step runs, counted T times
(`launch.step_trace.scan_by_trip_count`).

`in_proj`, `conv`, `wb`, `wc`, `dskip` and `out_proj` are stored in
`cfg.dtype` (the reference casts its float32 masters at use); `wdt`,
`dt_bias` and `a_log` stay float32 and are read as stored, as the
reference reads them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain, matmul
from ..launch import step_trace
from .layers import _normal, _param, gated_proj, weight_dtype

CONV_K = 4
NAMES = ("in_proj", "conv", "wdt", "dt_bias", "wb", "wc", "a_log", "dskip",
         "out_proj")
CAST = ("in_proj", "conv", "wb", "wc", "dskip", "out_proj")


class SSM(nn.Module):
    """in_proj [D, 2, din], conv [CONV_K, din], wdt/dt_bias/dskip [din],
    wb/wc/a_log [din, N], out_proj [din, D]."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        if set(leaves) != set(NAMES):
            raise ValueError(f"SSM leaves {sorted(leaves)}, expected {sorted(NAMES)}")
        for n in NAMES:
            setattr(self, n, _param(leaves[n]))


def ssm_params(cfg: ModelConfig, gen: torch.Generator, d: int, device=None) -> SSM:
    """Random weights from the reference's distributions, drawn with `gen`."""
    din, N = cfg.ssm_expand * d, cfg.ssm_state
    dt, f32 = weight_dtype(cfg), torch.float32
    s = d ** -0.5
    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=device))[None, :]
    return SSM(in_proj=_normal(gen, (d, 2, din), s, dt, device),
               conv=_normal(gen, (CONV_K, din), 0.3, dt, device),
               wdt=_normal(gen, (din,), 0.1, f32, device),
               dt_bias=torch.full((din,), -3.0, device=device),
               wb=_normal(gen, (din, N), s, dt, device),
               wc=_normal(gen, (din, N), s, dt, device),
               a_log=a_log * torch.ones((din, 1), device=device),
               dskip=torch.ones((din,), dtype=dt, device=device),
               out_proj=_normal(gen, (din, d), din ** -0.5, dt, device))


def causal_conv(x, w, conv_state) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,T,C]; w: [K,C]; conv_state: [B,K-1,C] (the previous inputs).
    Returns (out [B,T,C], new conv_state)."""
    xp = torch.cat([conv_state, x], dim=1)                   # [B,T+K-1,C]
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(CONV_K))
    return out, xp[:, -(CONV_K - 1):, :]


def _scan(dt, xs32, B_, C_, A, h):
    """The selective scan over T: dt, xs32 [B,T,din], B_, C_ [B,T,N]
    float32, A [din,N], h [B,din,N] -> (y [B,T,din] float32, final h)."""
    ys = []
    for t in range(dt.shape[1]):
        dtt = dt[:, t]                                       # [B,din]
        da = torch.exp(dtt[..., None] * A[None])             # [B,din,N]
        h = da * h + (dtt * xs32[:, t])[..., None] * B_[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_mix(cfg: ModelConfig, p: SSM, x, state: Dict[str, torch.Tensor]):
    """x: [B,T,D]; state: {"conv": [B,K-1,din], "h": [B,din,N] float32}.
    Returns (y [B,T,D], new state)."""
    dt_ = x.dtype
    hproj = gated_proj(x, p.in_proj.to(dt_))
    xs, z = hproj[..., 0, :], hproj[..., 1, :]               # [B,T,din]
    xs = constrain(xs, "batch", "seq", "mlp")
    xs, conv_state = causal_conv(xs, p.conv.to(dt_), state["conv"])
    xs = F.silu(xs)

    # input-dependent per-channel step size (the selective part); softplus
    # as jax.nn.softplus computes it (F.softplus turns linear above 20)
    v = xs.float() * p.wdt[None, None, :] + p.dt_bias[None, None, :]
    dt = torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))
    B_ = matmul(xs, p.wb.to(dt_)).float()                    # [B,T,N]
    C_ = matmul(xs, p.wc.to(dt_)).float()
    A = -torch.exp(p.a_log)                                  # [din,N] negative

    # laid out over a mesh, the scan sees the whole sequence (gathered once)
    dt, xs32 = (constrain(t, "batch", None, "mlp") for t in (dt, xs.float()))
    B_, C_ = (constrain(t, "batch", None, None) for t in (B_, C_))
    Bn, T, din = xs32.shape
    if xs32.device.type == "meta" and step_trace.by_trip_count():
        # the dry-run: one step of the scan, counted T times
        y, h = step_trace.scan_by_trip_count(
            _scan, T, dt[:, :1], xs32[:, :1], B_[:, :1], C_[:, :1], A, state["h"])
        y = y.expand(Bn, T, din)
    else:
        y, h = _scan(dt, xs32, B_, C_, A, state["h"])
    y = constrain(y, "batch", "seq", "mlp").to(dt_)
    y = y + xs * p.dskip.to(dt_)[None, None, :]
    y = y * F.silu(z)
    out = matmul(y, p.out_proj.to(dt_))
    return constrain(out, "batch", "seq", "embed"), {"conv": conv_state, "h": h}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device=None):
    din = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((batch, CONV_K - 1, din), dtype=dtype, device=device),
            "h": torch.zeros((batch, din, cfg.ssm_state), device=device)}
