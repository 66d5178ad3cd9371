"""Transformer layers: norms, RoPE, GQA projections, full-sequence
attention (the flash-attention kernels) and single-token attention over a
dense cache, gated MLPs, embeddings and logits, with the parameter
containers (`nn.Module`s) they read.  The full-sequence functions are
differentiable: the training path takes gradients through them.

Each function computes what the JAX package's `models/layers.py` function
of the same name computes, on PyTorch tensors.  Parameters are modules
whose attribute names are the reference's tree keys (`wq`, `wk`, `wv`,
`wo`, `q_norm`, `k_norm`, `wi`, `scale`, `bias`, `table`).  Matmul weights
and the embedding are stored in `cfg.dtype` and norm scales in float32: the
reference keeps float32 masters and casts them to `cfg.dtype` at every use,
which gives the same bits as casting once when the weights are made.

The `*_params` initialisers draw from the reference's distributions with a
`torch.Generator`; the numbers differ from JAX's, so tests carry weights
across with `interop.params_from_numpy` instead.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain, matmul, merge_dims, split_dim
from ..kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 (as the reference draws its masters),
    then stored in `dtype`."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def weight_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def upcast(x):
    """x in float32 for the norms' and the recurrence's arithmetic, or left
    in float64 (a float64 model, the yardstick of float32's rounding)."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """`scale` (rmsnorm, stored as the offset from 1) or `scale` + `bias`
    (layernorm), float32."""

    def __init__(self, scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.scale = _param(scale)
        if bias is not None:
            self.bias = _param(bias)


def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = upcast(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


def norm(cfg: ModelConfig, x, p: Norm):
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias)
    return rmsnorm(x, p.scale)


def norm_params(cfg: ModelConfig, d: int, device=None) -> Norm:
    if cfg.norm == "layernorm":
        return Norm(torch.ones((d,), device=device), torch.zeros((d,), device=device))
    return Norm(torch.zeros((d,), device=device))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions, dh: int, theta: float, fraction: float = 1.0):
    """(cos, sin) [..., T, rot/2] float32 of the rotary angles, or None when
    no dimension rotates."""
    rot = int(dh * fraction) // 2 * 2
    if rot == 0:
        return None
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs               # [..., T, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, tables):
    """Rotate the leading dimensions of x [..., T, Dh] by `rope_tables`."""
    if tables is None:
        return x
    cos, sin = tables
    half = cos.shape[-1]
    x1, x2, xp = x[..., :half], x[..., half:2 * half], x[..., 2 * half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def rope(x, positions, theta: float, fraction: float = 1.0):
    """x: [..., T, Dh]; positions: [..., T] (broadcastable)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta, fraction))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq [D, Hq, Dh], wk/wv [D, Hkv, Dh], wo [Hq, Dh, D] (+ q_norm/k_norm
    [Dh] with qk-norm)."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(wq), _param(wk),
                                              _param(wv), _param(wo))
        if q_norm is not None:
            self.q_norm, self.k_norm = _param(q_norm), _param(k_norm)


def attn_params(cfg: ModelConfig, gen: torch.Generator, d: int,
                device=None) -> Attention:
    hd = cfg.resolved_head_dim
    dt = weight_dtype(cfg)
    s = d ** -0.5
    w = [_normal(gen, shape, s, dt, device) for shape in
         ((d, cfg.n_heads, hd), (d, cfg.n_kv_heads, hd),
          (d, cfg.n_kv_heads, hd), (cfg.n_heads, hd, d))]
    if cfg.qk_norm:
        w += [torch.zeros((hd,), device=device), torch.zeros((hd,), device=device)]
    return Attention(*w)


def gated_proj(x, w):
    """einsum("...d,dcf->...cf", x, w) for w [D, 2, F]: one matmul on a view
    of w."""
    _, C, Fd = w.shape
    return split_dim(matmul(x, merge_dims(w, 1, 2)), x.dim() - 1, (C, Fd))


def _heads(x, w):
    """einsum("btd,dhk->bhtk", x, w) as one matmul on a view of w."""
    B, T, D = x.shape
    _, H, K = w.shape
    return split_dim(matmul(x, merge_dims(w.to(x.dtype), 1, 2)), 2, (H, K)).transpose(1, 2)


def project_qkv(cfg: ModelConfig, p: Attention, x, positions, use_rope=True,
                tables=None):
    """x: [B,T,D] -> q [B,Hq,T,Dh], k/v [B,Hkv,T,Dh] with RoPE applied.
    `tables`, if given, are `rope_tables(positions[:, None, :], ...)`, made
    once for all layers by a caller that runs every layer at the same
    positions."""
    q, k, v = _heads(x, p.wq), _heads(x, p.wk), _heads(x, p.wv)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if use_rope:     # q and k rotated together, by one table
        if tables is None:
            tables = rope_tables(positions[:, None, :], q.shape[-1],
                                 cfg.rope_theta, cfg.rope_fraction)
        q, k = apply_rope(torch.cat([q, k], dim=1), tables).split(
            [q.shape[1], k.shape[1]], dim=1)
    q = constrain(q, "batch", "heads", "seq", None)
    k = constrain(k, "batch", "kv_heads", "seq", None)
    v = constrain(v, "batch", "kv_heads", "seq", None)
    return q, k, v


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    cross: bool = False):
    """Full-sequence GQA attention: q [B,Hq,Tq,Dh], k/v [B,Hkv,Tk,Dh] ->
    [B,Hq,Tq,Dh]; window None or <= 0 means unlimited; `cross` (the
    encoder-decoder's attention to the encoder output, Tq != Tk) drops the
    causal mask.  The flash-attention kernels on a CUDA device, their plain
    version on the CPU (both take any Tk and any head dim); a DTensor or a
    `meta` tensor (the dry-run) takes the
    reference's grouped loop over key blocks, a ragged Tk padded to the
    block as the reference pads it (`fa_ops.grouped_attention`)."""
    w = 0 if window is None else int(window)
    # K/V gathered over the sequence once (q keeps its layout)
    k = constrain(k, "batch", "kv_heads", None, None)
    v = constrain(v, "batch", "kv_heads", None, None)
    return fa_ops.flash_attention(q, k, v, causal=causal and not cross,
                                  window=max(w, 0))


def attn_out(p: Attention, attn, dtype):
    """einsum("bhtk,hkd->btd", attn, wo) as one matmul: attn [B,Hq,T,Dh]."""
    B, H, T, K = attn.shape
    return matmul(merge_dims(attn.transpose(1, 2), 2, 2), merge_dims(p.wo.to(dtype), 0, 2))


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token attention over a cache.

    q: [B,Hq,Dh]; k/v_cache: [B,Hkv,S,Dh]; cache_len: [B] valid length;
    window: None, or a scalar (int or tensor; > 0 limits attention to the
    last `window` positions)."""
    B, Hq, Dh = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    qg = split_dim(q, 1, (Hkv, G))
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache).float()
    s = s * (Dh ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = pos[None] < cache_len[:, None]                       # [B,S]
    if isinstance(window, torch.Tensor):
        w = window.to(q.device)
        mask &= torch.where(w > 0, pos[None] >= cache_len[:, None] - w,
                            torch.ones_like(mask))
    elif window is not None and window > 0:
        mask &= pos[None] >= cache_len[:, None] - window
    s = torch.where(mask[:, None, None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, Hq, Dh)


def attn_out_token(p: Attention, attn):
    """einsum("bhk,hkd->bd", attn, wo) for one token: attn [B,Hq,Dh]."""
    B, H, K = attn.shape
    return merge_dims(attn, 1, 2) @ merge_dims(p.wo.to(attn.dtype), 0, 2)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """wi [D, 2, F] (gated: gate, up) or [D, F]; wo [F, D]."""

    def __init__(self, wi, wo):
        super().__init__()
        self.wi, self.wo = _param(wi), _param(wo)


def mlp_params(cfg: ModelConfig, gen: torch.Generator, d: int, f: int,
               device=None) -> MLP:
    dt = weight_dtype(cfg)
    s = d ** -0.5
    wi_shape = (d, 2, f) if cfg.mlp_act in ("swiglu", "geglu") else (d, f)
    return MLP(_normal(gen, wi_shape, s, dt, device),
               _normal(gen, (f, d), f ** -0.5, dt, device))


def mlp(cfg: ModelConfig, p: MLP, x):
    dt = x.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        h = gated_proj(x, p.wi.to(dt))
        h = constrain(h, "batch", "seq", None, "mlp")
        gate, up = h[..., 0, :], h[..., 1, :]
        # jax.nn.gelu is the tanh approximation by default
        act = F.silu(gate) if cfg.mlp_act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(constrain(matmul(x, p.wi.to(dt)), "batch", "seq", "mlp"),
                   approximate="tanh")
    return constrain(matmul(h, p.wo.to(dt)), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def sinusoid_pos(positions, d: int, dtype):
    """Whisper-style sinusoidal positions.  positions: [B,T] -> [B,T,d]."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class Embed(nn.Module):
    """table [padded_vocab, D], tied with the output projection."""

    def __init__(self, table):
        super().__init__()
        self.table = _param(table)


def embed_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> Embed:
    return Embed(_normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                         weight_dtype(cfg), device))


def embed(cfg: ModelConfig, p: Embed, tokens):
    t = constrain(p.table.to(weight_dtype(cfg)), "vocab", "embed")
    x = F.embedding(tokens, t)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return constrain(x, "batch", "seq", "embed")


def logits(cfg: ModelConfig, p: Embed, x):
    out = matmul(x, p.table.to(x.dtype).T)
    # vocab-sharded logits; seq deliberately unsharded (see the loss chunks)
    out = constrain(out, "batch", None, "vocab")
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        out = out.masked_fill(pad, NEG_INF)
    return out
