"""The decoders of the dense and ssm (RWKV-6) families as `nn.Module`s,
and their decode paths.

The module tree keeps the JAX reference's parameter names: `embed.table`,
`final_norm` and, per block, `blocks[l].{norm1,norm2,attn.{wq,wk,wv,wo},
mlp.{wi,wo}}` (dense; `attn.q_norm`/`attn.k_norm` with qk-norm) or
`blocks[l].{norm1,norm2,rwkv.{mu,wr,...,cr}}` (ssm).  The layer stack is an
`nn.ModuleList` walked by a Python loop where the reference scans over
stacked blocks.

Exposes `layer_flags`, `init_params`, the full-sequence path of training
and prefill (`forward_hidden`, `forward`, `loss_fn`) and the decode path
(`init_cache`, `decode_step`: the contiguous-cache backend of the serving
engine).  The other families (moe, hybrid, audio, vlm) are not ported yet
(ROADMAP queue 1, item 14): asking for them raises `NotImplementedError`.

Parameters are made with `requires_grad=False`; the training step switches
them on.  `decode_step` runs under `torch.no_grad()` whatever they hold.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import layers, rwkv6

PORTED_FAMILIES = ("dense", "ssm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to PyTorch "
            f"yet (ROADMAP queue 1, item 14); {PORTED_FAMILIES} run")


# ---------------------------------------------------------------------------
# Per-layer static pattern (local/global etc.)
# ---------------------------------------------------------------------------

def layer_flags(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{"window": int32 [L]}: each layer's sliding window (0 = full)."""
    L = cfg.n_layers
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        is_local = (torch.arange(L) % (r + 1)) != r       # r local, then 1 global
    elif cfg.sliding_window and cfg.family == "hybrid":
        # hymba: a few full-attention layers (first/mid/last), rest windowed
        g = {0, L // 2, L - 1} if cfg.n_global_attn_layers else set()
        is_local = torch.tensor([i not in g for i in range(L)])
    elif cfg.sliding_window:
        is_local = torch.ones((L,), dtype=torch.bool)
    else:
        is_local = torch.zeros((L,), dtype=torch.bool)
    w = torch.full((L,), cfg.sliding_window or 0, dtype=torch.int32)
    return {"window": torch.where(is_local, w, torch.zeros_like(w))}


# ---------------------------------------------------------------------------
# Modules and parameter init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, norm1: layers.Norm, norm2: layers.Norm,
                 attn: layers.Attention, mlp: layers.MLP):
        super().__init__()
        self.norm1, self.norm2, self.attn, self.mlp = norm1, norm2, attn, mlp


class RWKVBlock(nn.Module):
    def __init__(self, norm1: layers.Norm, norm2: layers.Norm, rwkv: rwkv6.RWKV):
        super().__init__()
        self.norm1, self.norm2, self.rwkv = norm1, norm2, rwkv


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, embed: layers.Embed,
                 blocks: List[nn.Module], final_norm: layers.Norm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights from the reference's distributions, drawn with
    `generator` (which must live on `device`)."""
    check_family(cfg)
    d = cfg.d_model
    embed = layers.embed_params(cfg, generator, device)
    if cfg.family == "ssm":
        blocks = [RWKVBlock(layers.norm_params(cfg, d, device),
                            layers.norm_params(cfg, d, device),
                            rwkv6.rwkv_params(cfg, generator, device))
                  for _ in range(cfg.n_layers)]
        return Transformer(cfg, embed, blocks, layers.norm_params(cfg, d, device))
    blocks = [Block(layers.norm_params(cfg, d, device),
                    layers.norm_params(cfg, d, device),
                    layers.attn_params(cfg, generator, d, device),
                    layers.mlp_params(cfg, generator, d, cfg.d_ff, device))
              for _ in range(cfg.n_layers)]
    return Transformer(cfg, embed, blocks,
                       layers.norm_params(cfg, d, device))


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _attn_block_seq(cfg: ModelConfig, blk: Block, x, tables, window: int):
    h = layers.norm(cfg, x, blk.norm1)
    q, k, v = layers.project_qkv(cfg, blk.attn, h, None,
                                 use_rope=(cfg.norm != "layernorm"), tables=tables)
    att = layers.flash_attention(q, k, v, causal=True, window=window)
    x = x + layers.attn_out(blk.attn, att, x.dtype)
    h2 = layers.norm(cfg, x, blk.norm2)
    return x + layers.mlp(cfg, blk.mlp, h2)


def _rwkv_block_seq(cfg: ModelConfig, blk: RWKVBlock, x):
    """One RWKV-6 block over a whole sequence, from zero token shift and
    zero WKV state (the final state is not computed)."""
    zero_prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    h = layers.norm(cfg, x, blk.norm1)
    tm, _, _ = rwkv6.time_mix(cfg, blk.rwkv, h, zero_prev, None, need_state=False)
    x = x + tm
    h2 = layers.norm(cfg, x, blk.norm2)
    cm, _ = rwkv6.channel_mix(cfg, blk.rwkv, h2, zero_prev)
    return x + cm


def forward_hidden(cfg: ModelConfig, model: Transformer,
                   batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
    """Final hidden states [B, T, D] of batch["tokens"] [B, T].  With remat
    each block is recomputed in the backward pass from its input (the
    reference's `jax.checkpoint` with nothing saveable), so only the block
    inputs stay alive between the passes."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = layers.embed(cfg, model.embed, tokens)
    if cfg.family == "ssm":
        for blk in model.blocks:
            x = (checkpoint(_rwkv_block_seq, cfg, blk, x, use_reentrant=False)
                 if remat else _rwkv_block_seq(cfg, blk, x))
        return layers.norm(cfg, x, model.final_norm)
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    tables = None
    if cfg.norm != "layernorm":      # one rotary table for every layer
        tables = layers.rope_tables(positions[:, None, :], cfg.resolved_head_dim,
                                    cfg.rope_theta, cfg.rope_fraction)
    windows = layer_flags(cfg)["window"].tolist()
    for blk, w in zip(model.blocks, windows):
        if remat:
            x = checkpoint(_attn_block_seq, cfg, blk, x, tables, w,
                           use_reentrant=False)
        else:
            x = _attn_block_seq(cfg, blk, x, tables, w)
    return layers.norm(cfg, x, model.final_norm)


def forward(cfg: ModelConfig, model: Transformer, batch: Dict[str, torch.Tensor],
            remat: bool = True, last_only: bool = False) -> torch.Tensor:
    """Logits [B, T, Vpad], or [B, 1, Vpad] with last_only."""
    x = forward_hidden(cfg, model, batch, remat=remat)
    if last_only:
        x = x[:, -1:, :]
    return layers.logits(cfg, model.embed, x)


def _chunk_nll(cfg: ModelConfig, embed: layers.Embed, xc, tc, mc):
    lg = layers.logits(cfg, embed, xc).float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def loss_fn(cfg: ModelConfig, model: Transformer, batch: Dict[str, torch.Tensor],
            remat: bool = True, loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy over batch["tokens"] [B, T+1] (weighted by
    batch["loss_mask"] [B, T+1] where given), computed in sequence chunks of
    `loss_chunk` so the [B, T, V] logits never exist at once; with remat
    each chunk's logits are recomputed in the backward pass."""
    toks = batch["tokens"]
    x = forward_hidden(cfg, model, {"tokens": toks[:, :-1]}, remat=remat)
    tgt = toks[:, 1:]
    mask: Optional[torch.Tensor] = batch.get("loss_mask")
    mask = (torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
            if mask is None else mask[:, 1:].float())
    T = x.shape[1]
    c = min(loss_chunk, T)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of loss_chunk {c}")
    nlls, counts = [], []
    for i in range(0, T, c):
        args = (cfg, model.embed, x[:, i:i + c], tgt[:, i:i + c], mask[:, i:i + c])
        nll, n = (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                  else _chunk_nll(*args))
        nlls.append(nll)
        counts.append(n)
    return torch.stack(nlls).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict[str, Any]:
    """{"len": int32 [B]} and, dense: "k"/"v" [L, B, Hkv, max_len, Dh] in
    the model dtype; ssm: "wkv" [L, B, H, Dh, Dh] float32 (float64 in a
    float64 model) and "shift" [L, 2, B, D] in the model dtype (max_len
    unused)."""
    check_family(cfg)
    dt = getattr(torch, dtype or cfg.dtype)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.family == "ssm":
        H = cfg.n_heads
        return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
                "wkv": torch.zeros((L, batch, H, Dh, Dh), device=device,
                                   dtype=dt if dt == torch.float64 else torch.float32),
                "shift": torch.zeros((L, 2, batch, cfg.d_model), dtype=dt,
                                     device=device)}
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros((L, batch, Hkv, max_len, Dh), dtype=dt, device=device),
            "v": torch.zeros((L, batch, Hkv, max_len, Dh), dtype=dt, device=device)}


def _decode_attn(cfg, p: layers.Attention, x, cache_k, cache_v, cache_len,
                 window, tables):
    """x: [B,1,D]; writes the new K/V row into cache_k/v [B,Hkv,S,Dh] (in
    place) and returns the attention output [B,1,D]."""
    dt = x.dtype
    pos = cache_len[:, None]                                # [B,1]
    q, k, v = layers.project_qkv(cfg, p, x, pos,
                                 use_rope=(cfg.norm != "layernorm"),
                                 tables=tables)
    # the new row goes to position cache_len[0] (the same for all lanes),
    # clamped into the cache as dynamic_update_slice clamps its start
    at = cache_len[:1].clamp(max=cache_k.shape[2] - 1).long()
    cache_k.index_copy_(2, at, k.to(cache_k.dtype))
    cache_v.index_copy_(2, at, v.to(cache_v.dtype))
    att = layers.decode_attention(q[:, :, 0, :], cache_k, cache_v,
                                  cache_len + 1, window=window)
    return layers.attn_out_token(p, att.to(dt))[:, None, :]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B] int32 (the last generated token).  Returns
    (logits [B, Vpad], cache).  Uses cache["len"] as the position.  The
    cache's K/V (dense) or WKV-state and shift (ssm) tensors are updated in
    place; "len" is replaced by len+1."""
    check_family(cfg)
    x = layers.embed(cfg, model.embed, tokens[:, None])
    cache_len = cache["len"]
    if cfg.family == "ssm":
        for l, blk in enumerate(model.blocks):
            shift = cache["shift"][l]
            h = layers.norm(cfg, x, blk.norm1)
            tm, sh1, wkv = rwkv6.time_mix(cfg, blk.rwkv, h, shift[0], cache["wkv"][l])
            x = x + tm
            cache["wkv"][l].copy_(wkv)
            shift[0].copy_(sh1)
            h2 = layers.norm(cfg, x, blk.norm2)
            cm, sh2 = rwkv6.channel_mix(cfg, blk.rwkv, h2, shift[1])
            x = x + cm
            shift[1].copy_(sh2)
        cache = dict(cache, len=cache_len + 1)
        x = layers.norm(cfg, x, model.final_norm)
        return layers.logits(cfg, model.embed, x)[:, 0], cache
    windows = layer_flags(cfg)["window"].tolist()
    tables = layers.rope_tables(cache_len[:, None, None], cfg.resolved_head_dim,
                                cfg.rope_theta, cfg.rope_fraction)
    for l, blk in enumerate(model.blocks):
        h = layers.norm(cfg, x, blk.norm1)
        x = x + _decode_attn(cfg, blk.attn, h, cache["k"][l], cache["v"][l],
                             cache_len, windows[l], tables)
        h2 = layers.norm(cfg, x, blk.norm2)
        x = x + layers.mlp(cfg, blk.mlp, h2)
    cache = dict(cache, len=cache_len + 1)
    x = layers.norm(cfg, x, model.final_norm)
    return layers.logits(cfg, model.embed, x)[:, 0], cache
