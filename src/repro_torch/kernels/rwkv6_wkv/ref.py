"""Plain PyTorch versions of the WKV kernels.

Per head, with the state S [Dk, Dv]:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

`wkv_reference` is the JAX package's `models/rwkv6.py::wkv_scan` (a Python
loop over T); with `state=None` it starts from zero, as the TPU kernel's
oracle `kernels/rwkv6_wkv/ref.py::wkv_reference` does.  Autograd through
it is the plain gradient.

`wkv_backward_reference` is the reverse recurrence the gradient kernels
run, written out step by step; with G_t = dL/dS_t:

    G_{t-1} = diag(w_t) G_t + r_t dy_t^T
    dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
    dk_t = G_t v_t + u * r_t (v_t . dy_t)
    dv_t = G_t^T k_t + (sum_i u_i r_ti k_ti) dy_t
    dw_t = rowsum(G_t * S_{t-1})
    du   = sum_t r_t * k_t (v_t . dy_t)
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv_reference(r, k, v, w, u, state: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, H, T, D]; u: [H, D]; state: [B, H, D, D] or None
    (zeros).  Returns (y [B, H, T, D], state' [B, H, D, D]), float32 (float64
    where r is float64)."""
    B, H, T, D = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    S = (torch.zeros((B, H, D, D), dtype=ct, device=r.device)
         if state is None else state.to(ct))
    uu = u.to(ct)[None, :, :, None]
    ys = []
    for t in range(T):
        rt, kt, vt = (x[:, :, t].to(ct) for x in (r, k, v))
        wt = w[:, :, t].to(ct)
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S + uu * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=2), S


def wkv_backward_reference(r, k, v, w, u, dy, state=None, dstate=None):
    """The gradient of `wkv_reference` by the reverse recurrence: dy [B, H,
    T, D] and dstate [B, H, D, D] (or None: zero) are the gradients of y
    and of the final state.  Returns (dr, dk, dv, dw [B, H, T, D], du [H, D],
    dstate0 [B, H, D, D]), float32."""
    B, H, T, D = r.shape
    f = [x.float() for x in (r, k, v, w, dy)]
    r, k, v, w, dy = f
    uu = u.float()
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    prev = []
    for t in range(T):
        prev.append(S)
        S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None, :]
    G = (torch.zeros_like(S) if dstate is None else dstate.float().clone())
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((B, H, D), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = (x[:, :, t] for x in (r, k, v, w, dy))
        Sp = prev[t]
        vdy = (vt * dyt).sum(-1, keepdim=True)                     # [B,H,1]
        ruk = (uu * rt * kt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", Sp, dyt) + uu * kt * vdy
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", G, vt) + uu * rt * vdy
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", G, kt) + ruk * dyt
        dw[:, :, t] = (G * Sp).sum(-1)
        du += rt * kt * vdy
        G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), G
