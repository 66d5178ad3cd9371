"""Mixture-of-Experts FFN (the JAX package's `models/moe.py`) on one device.

Each token picks its `top_k` experts from a float32 softmax router; the
(token, expert) assignments are capacity-slotted with one stable sort
(`slot_by_group`: the same deterministic slotting primitive as the F2
batched linearization), each expert runs its gated FFN as one batched
matmul over its slots, and every token sums its weighted expert outputs.
Assignments past an expert's capacity are dropped.  The reference's
expert-parallel `shard_map` branch (experts split over the `model` mesh
axis, a psum of the partial outputs) waits for the distributed slice
(ROADMAP item 15); here every expert lives on the one device.

The combine adds each token's K contributions in k order, in the model
dtype, as the reference's `.at[flat_t].add` does; no atomics, so a repeated
call gives the same bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import _normal, _param, weight_dtype


class MoE(nn.Module):
    """router [D, E] float32, wi [E, D, 2, F], wo [E, F, D] and, with shared
    experts, shared_wi [D, 2, F * n_shared], shared_wo [F * n_shared, D]."""

    def __init__(self, router, wi, wo, shared_wi=None, shared_wo=None):
        super().__init__()
        self.router, self.wi, self.wo = _param(router), _param(wi), _param(wo)
        if shared_wi is not None:
            self.shared_wi, self.shared_wo = _param(shared_wi), _param(shared_wo)


def moe_params(cfg: ModelConfig, gen: torch.Generator, d: int, device=None) -> MoE:
    """Random weights from the reference's distributions.  The experts are
    drawn one at a time: a float32 draw of all of Kimi-K2's `wi` at once
    would need 45 GB of scratch."""
    f, E = cfg.moe_d_ff, cfg.n_experts
    dt = weight_dtype(cfg)
    s = d ** -0.5
    router = _normal(gen, (d, E), s, torch.float32, device)
    wi = torch.empty((E, d, 2, f), dtype=dt, device=device)
    wo = torch.empty((E, f, d), dtype=dt, device=device)
    for e in range(E):
        wi[e] = _normal(gen, (d, 2, f), s, dt, device)
        wo[e] = _normal(gen, (f, d), f ** -0.5, dt, device)
    shared = ()
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shared = (_normal(gen, (d, 2, fs), s, dt, device),
                  _normal(gen, (fs, d), f ** -0.5, dt, device))
    return MoE(router, wi, wo, *shared)


def slot_by_group(gid: torch.Tensor, n_groups: int, cap: int) -> torch.Tensor:
    """Deterministic capacity slotting: gid [N] int in [0, n_groups]
    (n_groups = the drop bucket).  Returns slot [N] int32 in
    [0, n_groups * cap), or -1 (dropped): within a group, assignments keep
    their order and the first `cap` get slots."""
    N = gid.shape[0]
    order = torch.argsort(gid, stable=True)
    g_s = gid[order].int()
    idx = torch.arange(N, dtype=torch.int32, device=gid.device)
    first = torch.ones((N,), dtype=torch.bool, device=gid.device)
    first[1:] = g_s[1:] != g_s[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank_s = idx - run_start
    ok = (rank_s < cap) & (g_s < n_groups)
    slot_s = torch.where(ok, g_s * cap + rank_s, -1).int()
    return torch.empty_like(slot_s).scatter_(0, order, slot_s)


def route(cfg: ModelConfig, p: MoE, xs: torch.Tensor):
    """(experts [t, K] int32, weights [t, K] float32) of tokens xs [t, D]:
    the top-K of the float32 router softmax, renormalised."""
    gates = xs.float() @ p.router.float()
    probs = torch.softmax(gates, dim=-1)
    topw, tope = torch.topk(probs, cfg.top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return tope.int(), topw


def moe_local(cfg: ModelConfig, p: MoE, xs: torch.Tensor) -> torch.Tensor:
    """The MoE body over tokens xs [t, D] (the reference's `_moe_local` with
    one shard): route, slot, run every expert over its slots, combine.
    Returns [t, D] in xs's dtype."""
    t, D = xs.shape
    E, K = cfg.n_experts, cfg.top_k
    tope, topw = route(cfg, p, xs)
    flat_e = tope.reshape(-1)
    flat_w = topw.reshape(-1)
    cap = max(8, int(cfg.capacity_factor * t * K / E))
    slot = slot_by_group(flat_e, E, cap)
    keep = slot >= 0

    dt = xs.dtype
    # each token's row K times (flat_t = repeat(arange(t), K)); a dropped
    # assignment writes the spare last row, which is cut off
    rows = xs[:, None, :].expand(t, K, D).reshape(t * K, D)
    xe = torch.zeros((E * cap + 1, D), dtype=dt, device=xs.device)
    xe = xe.index_put((torch.where(keep, slot, E * cap).long(),), rows)
    xe = xe[:E * cap].view(E, cap, D)
    Fd = p.wi.shape[-1]
    h = torch.bmm(xe, p.wi.to(dt).reshape(E, D, 2 * Fd)).view(E, cap, 2, Fd)
    act = F.silu(h[..., 0, :]) * h[..., 1, :]
    ye = torch.bmm(act, p.wo.to(dt)).reshape(E * cap, D)

    contrib = ye[torch.where(keep, slot, 0).clamp(max=E * cap - 1).long()]
    contrib = torch.where(keep[:, None], contrib * flat_w[:, None].to(dt),
                          torch.zeros((), dtype=dt, device=xs.device))
    contrib = contrib.view(t, K, D)
    y = contrib[:, 0]
    for k in range(1, K):          # k order, in dt: the reference's scatter-add
        y = y + contrib[:, k]
    return y


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D]: the routed experts, plus the shared
    expert's gated FFN where the config has one."""
    B, T, D = x.shape
    y = moe_local(cfg, p, x.reshape(-1, D)).view(B, T, D)
    if cfg.n_shared_experts:
        dt = x.dtype
        Fs = p.shared_wi.shape[-1]
        hs = (x @ p.shared_wi.to(dt).reshape(D, 2 * Fs)).unflatten(-1, (2, Fs))
        y = y + (F.silu(hs[..., 0, :]) * hs[..., 1, :]) @ p.shared_wo.to(dt)
    return y
