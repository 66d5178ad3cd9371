"""Mixture-of-Experts FFN with expert-parallel local dispatch (the JAX
package's `models/moe.py`).

Each token picks its `top_k` experts from a float32 softmax router; the
(token, expert) assignments are capacity-slotted with one stable sort
(`slot_by_group`: the same deterministic slotting primitive as the F2
batched linearization), each expert runs its gated FFN as one batched
matmul over its slots, and every token sums its weighted expert outputs.
Assignments past an expert's capacity are dropped.

Under an active mesh (`distributed.sharding.use_mesh`) whose `model` axis
divides `n_experts`, `moe_ffn` runs expert parallel, as the reference's
`shard_map` branch: `local_map` gives each model rank its tokens (sharded
over the (pod, data) axes the batch fills) and its `E / n_model` experts;
each rank slots the assignments whose expert it owns (`moe_local` with its
`shard_id`) and an all-reduce over the `model` group sums the partial
outputs.  A token's K contributions meet in that sum where their experts
live on different ranks, so the result equals the one-device path's bits
wherever the sum of a contribution and exact zeros is the contribution.
With no mesh, every expert runs on the one device.

The combine adds each token's K contributions in k order, in the model
dtype, as the reference's `.at[flat_t].add` does; no atomics, so a repeated
call gives the same bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (active_mesh, axis_sizes, constrain,
                                    matmul, mesh_axes, placements)
from .layers import _normal, _param, gated_proj, weight_dtype


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
    for e in range(E if wi.device.type != "meta" else 0):   # meta holds no values
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


def moe_local(cfg: ModelConfig, p: MoE, xs: torch.Tensor, shard_id: int = 0,
              n_shards: int = 1, psum=None) -> torch.Tensor:
    """The MoE body over tokens xs [t, D] (the reference's `_moe_local`):
    route, slot the assignments whose expert this shard owns (experts
    [shard_id * E_loc, (shard_id + 1) * E_loc); `p.wi`/`p.wo` are those
    experts' slices), run each over its slots, combine, and `psum` the
    partial outputs across shards (None: one shard).  Returns [t, D] in
    xs's dtype."""
    t, D = xs.shape
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // n_shards
    tope, topw = route(cfg, p, xs)
    flat_e = tope.reshape(-1)
    flat_w = topw.reshape(-1)
    cap = max(8, int(cfg.capacity_factor * t * K / E))
    if n_shards == 1:
        gid = flat_e
    else:            # a dropped or foreign assignment goes to group E_loc
        local = torch.div(flat_e, E_loc, rounding_mode="floor") == shard_id
        gid = torch.where(local, flat_e % E_loc, E_loc)
    slot = slot_by_group(gid, E_loc, cap)
    keep = slot >= 0

    dt = xs.dtype
    # each token's row K times (flat_t = repeat(arange(t), K)); a dropped
    # assignment writes the spare last row, which is cut off
    rows = xs[:, None, :].expand(t, K, D).reshape(t * K, D)
    xe = torch.zeros((E_loc * cap + 1, D), dtype=dt, device=xs.device)
    xe = xe.index_put((torch.where(keep, slot, E_loc * cap).long(),), rows)
    xe = xe[:E_loc * cap].view(E_loc, cap, D)
    Fd = p.wi.shape[-1]
    h = torch.bmm(xe, p.wi.to(dt).reshape(E_loc, D, 2 * Fd)).view(E_loc, cap, 2, Fd)
    act = F.silu(h[..., 0, :]) * h[..., 1, :]
    ye = torch.bmm(act, p.wo.to(dt)).reshape(E_loc * cap, D)

    contrib = ye[torch.where(keep, slot, 0).clamp(max=E_loc * cap - 1).long()]
    contrib = torch.where(keep[:, None], contrib * flat_w[:, None].to(dt),
                          torch.zeros((), dtype=dt, device=xs.device))
    contrib = contrib.view(t, K, D)
    y = contrib[:, 0]
    for k in range(1, K):          # k order, in dt: the reference's scatter-add
        y = y + contrib[:, k]
    return y if psum is None else psum(y)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group; the gradient passes through
    unchanged, since every rank of the group holds the same output and
    computes the same loss from it (the transpose of `jax.lax.psum` inside
    `shard_map`)."""

    @staticmethod
    def forward(ctx, y, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(y, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ep_ready(cfg: ModelConfig, mesh) -> bool:
    return (mesh is not None and "model" in mesh_axes(mesh)
            and cfg.n_experts % axis_sizes(mesh)["model"] == 0)


def _moe_expert_parallel(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh):
    """The routed experts split over the mesh's `model` axis (the
    reference's shard_map branch), through `local_map`: tokens over the
    (pod, data) axes that the batch fills, experts over `model`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    B, T, D = x.shape
    sizes = axis_sizes(mesh)
    axes = mesh_axes(mesh)
    n_model = sizes["model"]
    tok_axes = tuple(a for a in ("pod", "data") if a in axes)
    while tok_axes and B % math.prod(sizes[a] for a in tok_axes) != 0:
        tok_axes = tok_axes[1:]           # drop axes the batch can't fill
    batch = tok_axes if tok_axes else None
    x_pl = placements((batch, None, None), mesh)
    specs = ((None, None), ("model", None, None, None), ("model", None, None))
    args = []
    plain = not isinstance(x, DTensor)
    for t in (x, p.router, p.wi, p.wo):
        if not isinstance(t, DTensor):    # the same full tensor on every rank
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        args.append(t)
    group = (mesh, axes.index("model"))

    def body(xb, router, wi, wo):
        sid = mesh.get_local_rank("model")
        y = moe_local(cfg, _Experts(router, wi, wo), xb.reshape(-1, D), sid,
                      n_model, psum=lambda v: _SumOverGroup.apply(v, group))
        return y.reshape(xb.shape)

    in_pl = (x_pl,) + tuple(placements(s, mesh) for s in specs)
    # the tokens and the router are replicated over `model`, and each rank's
    # gradient holds only its experts' share: partial sums over `model`
    mi = axes.index("model")
    grad_pl = tuple(tuple(Partial() if i == mi else q for i, q in enumerate(pl))
                    for pl in in_pl[:2]) + in_pl[2:]
    y = local_map(body, out_placements=(x_pl,), in_placements=in_pl,
                  in_grad_placements=grad_pl, device_mesh=mesh,
                  redistribute_inputs=True)(*args)
    return y.full_tensor() if plain else y


class _Experts:
    """The router and one rank's expert slices, read as an `MoE` is."""

    def __init__(self, router, wi, wo):
        self.router, self.wi, self.wo = router, wi, wo


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D]: the routed experts (expert parallel
    under an active mesh whose `model` axis divides the experts), plus the
    shared expert's gated FFN where the config has one."""
    B, T, D = x.shape
    mesh = active_mesh()
    if _ep_ready(cfg, mesh):
        y = _moe_expert_parallel(cfg, p, x, mesh)
    else:
        y = moe_local(cfg, p, x.reshape(-1, D)).view(B, T, D)
    if cfg.n_shared_experts:
        dt = x.dtype
        hs = gated_proj(x, p.shared_wi.to(dt))
        y = y + matmul(F.silu(hs[..., 0, :]) * hs[..., 1, :], p.shared_wo.to(dt))
    return constrain(y, "batch", "seq", "embed")
