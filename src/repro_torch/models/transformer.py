"""The model families as `nn.Module`s (the JAX package's
`models/transformer.py`), with their full-sequence and decode paths:

  dense / vlm      : GQA attention (+ sliding-window / local:global) + MLP;
                     vlm prepends the (stub) patch embeddings
  moe              : GQA attention + capacity-bounded MoE FFN (`moe.py`)
  ssm (rwkv6)      : time-mix (WKV6, data-dependent decay) + channel-mix
  hybrid (hymba)   : parallel attention || selective-SSM heads (`ssm.py`) + MLP
  audio (whisper)  : encoder stack (bidirectional) + decoder with cross-attention

The module tree keeps the JAX reference's parameter names: `embed.table`,
`final_norm` and, per block, `blocks[l].{norm1,norm2,attn.{wq,wk,wv,wo},
mlp.{wi,wo}}` (`attn.q_norm`/`attn.k_norm` with qk-norm; `moe.{router,wi,
wo,shared_wi,shared_wo}` in place of `mlp` for moe; `ssm.*`,
`norm_attn_out` and `norm_ssm_out` added for hybrid; `norm_cross` and
`cross.*` added for audio, with `enc_blocks[l].*` and `enc_final_norm`) or
`blocks[l].{norm1,norm2,rwkv.{mu,wr,...,cr}}` (ssm).  Layer stacks are
`nn.ModuleList`s walked by a Python loop where the reference scans over
stacked blocks.

Exposes `layer_flags`, `init_params`, the full-sequence path of training
and prefill (`encode`, `forward_hidden`, `forward`, `loss_fn`) and the
decode path (`init_cache`, `decode_step`: the contiguous-cache backend of
the serving engine).  Modality frontends are stubs, as in the reference:
the patch embeddings (batch["frontend"]) and the encoder's frames
(batch["frames"]) arrive precomputed.

Parameters are made with `requires_grad=False`; the training step switches
them on.  `decode_step` runs under `torch.no_grad()` whatever they hold.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import index_write_
from . import layers, moe, rwkv6, ssm

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"{PORTED_FAMILIES} run")


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
    """norm1, norm2, attn and the FFN: `mlp`, or `moe` (moe family).  The
    hybrid family adds `ssm`, `norm_attn_out` and `norm_ssm_out`; the
    encoder-decoder adds `norm_cross` and `cross` (an `Attention`)."""

    def __init__(self, norm1: layers.Norm, norm2: layers.Norm,
                 attn: layers.Attention, mlp: Optional[layers.MLP] = None,
                 **extra: nn.Module):
        super().__init__()
        self.norm1, self.norm2, self.attn = norm1, norm2, attn
        if mlp is not None:
            self.mlp = mlp
        for name, m in extra.items():
            setattr(self, name, m)


class RWKVBlock(nn.Module):
    def __init__(self, norm1: layers.Norm, norm2: layers.Norm, rwkv: rwkv6.RWKV):
        super().__init__()
        self.norm1, self.norm2, self.rwkv = norm1, norm2, rwkv


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, embed: layers.Embed,
                 blocks: List[nn.Module], final_norm: layers.Norm,
                 enc_blocks: Optional[List[Block]] = None,
                 enc_final_norm: Optional[layers.Norm] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        if enc_blocks is not None:
            self.enc_blocks = nn.ModuleList(enc_blocks)
            self.enc_final_norm = enc_final_norm


def _block_params(cfg: ModelConfig, gen: torch.Generator, device) -> nn.Module:
    d = cfg.d_model
    if cfg.family == "ssm":
        return RWKVBlock(layers.norm_params(cfg, d, device),
                         layers.norm_params(cfg, d, device),
                         rwkv6.rwkv_params(cfg, gen, device))
    extra: Dict[str, nn.Module] = {}
    if cfg.family == "moe":
        extra["moe"] = moe.moe_params(cfg, gen, d, device)
    else:
        extra["mlp"] = layers.mlp_params(cfg, gen, d, cfg.d_ff, device)
    if cfg.family == "hybrid":
        extra["ssm"] = ssm.ssm_params(cfg, gen, d, device)
        extra["norm_attn_out"] = layers.norm_params(cfg, d, device)
        extra["norm_ssm_out"] = layers.norm_params(cfg, d, device)
    if cfg.is_encoder_decoder:
        extra["norm_cross"] = layers.norm_params(cfg, d, device)
        extra["cross"] = layers.attn_params(cfg, gen, d, device)
    return Block(layers.norm_params(cfg, d, device), layers.norm_params(cfg, d, device),
                 layers.attn_params(cfg, gen, d, device), **extra)


def _enc_block_params(cfg: ModelConfig, gen: torch.Generator, device) -> Block:
    d = cfg.d_model
    return Block(layers.norm_params(cfg, d, device), layers.norm_params(cfg, d, device),
                 layers.attn_params(cfg, gen, d, device),
                 layers.mlp_params(cfg, gen, d, cfg.d_ff, device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights from the reference's distributions, drawn with
    `generator` (which must live on `device`)."""
    check_family(cfg)
    d = cfg.d_model
    embed = layers.embed_params(cfg, generator, device)
    blocks = [_block_params(cfg, generator, device) for _ in range(cfg.n_layers)]
    enc = {}
    if cfg.is_encoder_decoder:
        enc = dict(enc_blocks=[_enc_block_params(cfg, generator, device)
                               for _ in range(cfg.n_encoder_layers)],
                   enc_final_norm=layers.norm_params(cfg, d, device))
    return Transformer(cfg, embed, blocks, layers.norm_params(cfg, d, device), **enc)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, blk: Block, h):
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, blk.moe, h)
    return layers.mlp(cfg, blk.mlp, h)


def _attn_block_seq(cfg: ModelConfig, blk: Block, x, tables, window: int,
                    enc_out=None):
    h = layers.norm(cfg, x, blk.norm1)
    q, k, v = layers.project_qkv(cfg, blk.attn, h, None,
                                 use_rope=(cfg.norm != "layernorm"), tables=tables)
    att = layers.flash_attention(q, k, v, causal=True, window=window)
    attn_out = layers.attn_out(blk.attn, att, x.dtype)
    if cfg.family == "hybrid":
        s_out, _ = ssm.ssm_mix(cfg, blk.ssm, h,
                               ssm.init_ssm_state(cfg, x.shape[0], x.dtype, x.device))
        x = x + (layers.norm(cfg, attn_out, blk.norm_attn_out)
                 + layers.norm(cfg, s_out, blk.norm_ssm_out)) * 0.5
    else:
        x = x + attn_out
    if enc_out is not None:          # cross-attention: K/V from the encoder output
        hc = layers.norm(cfg, x, blk.norm_cross)
        qc = layers._heads(hc, blk.cross.wq)
        kc, vc = layers._heads(enc_out, blk.cross.wk), layers._heads(enc_out, blk.cross.wv)
        att_c = layers.flash_attention(qc, kc, vc, causal=False, cross=True)
        x = x + layers.attn_out(blk.cross, att_c, x.dtype)
    h2 = layers.norm(cfg, x, blk.norm2)
    return x + _ffn(cfg, blk, h2)


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


def _enc_block(cfg: ModelConfig, blk: Block, x):
    h = layers.norm(cfg, x, blk.norm1)
    q, k, v = layers.project_qkv(cfg, blk.attn, h, None, use_rope=False)
    att = layers.flash_attention(q, k, v, causal=False)
    x = x + layers.attn_out(blk.attn, att, x.dtype)
    h2 = layers.norm(cfg, x, blk.norm2)
    return x + layers.mlp(cfg, blk.mlp, h2)


def encode(cfg: ModelConfig, model: Transformer, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """The Whisper encoder over precomputed (stub) conv frames [B, Tf, D]:
    sinusoid positions, bidirectional blocks, the final norm.  With remat
    each block is recomputed in the backward pass (the reference always
    checkpoints its encoder blocks)."""
    x = frames.to(layers.weight_dtype(cfg))
    B, Tf = x.shape[:2]
    pos = torch.arange(Tf, device=x.device).expand(B, Tf)
    x = x + layers.sinusoid_pos(pos, cfg.d_model, x.dtype)
    for blk in model.enc_blocks:
        x = (checkpoint(_enc_block, cfg, blk, x, use_reentrant=False) if remat
             else _enc_block(cfg, blk, x))
    return layers.norm(cfg, x, model.enc_final_norm)


def forward_hidden(cfg: ModelConfig, model: Transformer,
                   batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
    """Final hidden states [B, T, D] over the positions of batch["tokens"]
    [B, T]; batch["frontend"] [B, P, D] (vlm: patch embeddings, prepended
    and cut off again at the end) and batch["frames"] [B, Tf, D] (audio:
    the encoder's input) where the family takes them.  With remat each
    block is recomputed in the backward pass from its input (the
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
    n_front = 0
    if cfg.frontend == "patches" and "frontend" in batch:
        fe = batch["frontend"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)
        n_front = fe.shape[1]
    B, T = x.shape[:2]
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    tables = None
    if cfg.norm == "layernorm":      # whisper: absolute positions, no RoPE
        x = x + layers.sinusoid_pos(positions, cfg.d_model, x.dtype)
    else:                            # one rotary table for every layer
        tables = layers.rope_tables(positions[:, None, :], cfg.resolved_head_dim,
                                    cfg.rope_theta, cfg.rope_fraction)
    enc_out = (encode(cfg, model, batch["frames"], remat=remat)
               if cfg.is_encoder_decoder else None)
    windows = layer_flags(cfg)["window"].tolist()
    for blk, w in zip(model.blocks, windows):
        if remat:
            x = checkpoint(_attn_block_seq, cfg, blk, x, tables, w, enc_out,
                           use_reentrant=False)
        else:
            x = _attn_block_seq(cfg, blk, x, tables, w, enc_out)
    x = layers.norm(cfg, x, model.final_norm)
    return x[:, n_front:, :] if n_front else x


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
    # the gold logit, summed over the vocab shards before it is reshaped
    gold = layers.constrain(torch.gather(lg, -1, tc[..., None].long()),
                            "batch", None, None)[..., 0]
    return torch.sum((lse - gold) * mc), torch.sum(mc)


def loss_fn(cfg: ModelConfig, model: Transformer, batch: Dict[str, torch.Tensor],
            remat: bool = True, loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy over batch["tokens"] [B, T+1] (weighted by
    batch["loss_mask"] [B, T+1] where given; batch["frontend"] and
    batch["frames"] go to `forward_hidden`), computed in sequence chunks of
    `loss_chunk` so the [B, T, V] logits never exist at once; with remat
    each chunk's logits are recomputed in the backward pass."""
    toks = batch["tokens"]
    x = forward_hidden(cfg, model, dict(batch, tokens=toks[:, :-1]), remat=remat)
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
    """{"len": int32 [B]} and, attention families: "k"/"v" [L, B, Hkv,
    max_len, Dh] in the model dtype, plus for hybrid the SSM's "conv" [L, B,
    CONV_K-1, din] (model dtype) and "h" [L, B, din, N] float32, and for
    audio the cross-attention K/V "xk"/"xv" [L, B, Hkv, encoder_len, Dh]
    (zeros: the caller fills them from `encode`, as the reference's caller
    does); ssm: "wkv" [L, B, H, Dh, Dh] float32 (float64 in a float64
    model) and "shift" [L, 2, B, D] in the model dtype (max_len unused)."""
    check_family(cfg)
    dt = getattr(torch, dtype or cfg.dtype)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    cache: Dict[str, Any] = {"len": torch.zeros((batch,), dtype=torch.int32,
                                                device=device)}
    if cfg.family == "ssm":
        H = cfg.n_heads
        cache["wkv"] = torch.zeros((L, batch, H, Dh, Dh), device=device,
                                   dtype=dt if dt == torch.float64 else torch.float32)
        cache["shift"] = torch.zeros((L, 2, batch, cfg.d_model), dtype=dt, device=device)
        return cache
    cache["k"] = torch.zeros((L, batch, Hkv, max_len, Dh), dtype=dt, device=device)
    cache["v"] = torch.zeros((L, batch, Hkv, max_len, Dh), dtype=dt, device=device)
    if cfg.family == "hybrid":
        din = cfg.ssm_expand * cfg.d_model
        cache["conv"] = torch.zeros((L, batch, ssm.CONV_K - 1, din), dtype=dt,
                                    device=device)
        cache["h"] = torch.zeros((L, batch, din, cfg.ssm_state), device=device)
    if cfg.is_encoder_decoder:
        for n in ("xk", "xv"):
            cache[n] = torch.zeros((L, batch, Hkv, cfg.encoder_len, Dh), dtype=dt,
                                   device=device)
    return cache


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
    index_write_(cache_k, 2, at, k.to(cache_k.dtype))
    index_write_(cache_v, 2, at, v.to(cache_v.dtype))
    att = layers.decode_attention(q[:, :, 0, :], cache_k, cache_v,
                                  cache_len + 1, window=window)
    return layers.attn_out_token(p, att.to(dt))[:, None, :]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B] int32 (the last generated token).  Returns
    (logits [B, Vpad], cache).  Uses cache["len"] as the position.  The
    cache's K/V and SSM state (attention families) or WKV state and shift
    (ssm) are updated in place; "len" is replaced by len+1."""
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
    B = tokens.shape[0]
    if cfg.norm == "layernorm":      # whisper: absolute positions
        x = x + layers.sinusoid_pos(cache_len[:, None], cfg.d_model, x.dtype)
    windows = layer_flags(cfg)["window"].tolist()
    tables = layers.rope_tables(cache_len[:, None, None], cfg.resolved_head_dim,
                                cfg.rope_theta, cfg.rope_fraction)
    for l, blk in enumerate(model.blocks):
        h = layers.norm(cfg, x, blk.norm1)
        att = _decode_attn(cfg, blk.attn, h, cache["k"][l], cache["v"][l],
                           cache_len, windows[l], tables)
        if cfg.family == "hybrid":
            s_out, st = ssm.ssm_mix(cfg, blk.ssm, h, {"conv": cache["conv"][l],
                                                      "h": cache["h"][l]})
            x = x + (layers.norm(cfg, att, blk.norm_attn_out)
                     + layers.norm(cfg, s_out, blk.norm_ssm_out)) * 0.5
            cache["conv"][l].copy_(st["conv"])
            cache["h"][l].copy_(st["h"])
        else:
            x = x + att
        if cfg.is_encoder_decoder:
            hc = layers.norm(cfg, x, blk.norm_cross)
            qc = layers._heads(hc, blk.cross.wq)[:, :, 0, :]
            enc_len = torch.full((B,), cfg.encoder_len, dtype=torch.int32,
                                 device=x.device)
            att_c = layers.decode_attention(qc, cache["xk"][l], cache["xv"][l], enc_len)
            x = x + layers.attn_out_token(blk.cross, att_c.to(x.dtype))[:, None, :]
        h2 = layers.norm(cfg, x, blk.norm2)
        x = x + _ffn(cfg, blk, h2)
    cache = dict(cache, len=cache_len + 1)
    x = layers.norm(cfg, x, model.final_norm)
    return layers.logits(cfg, model.embed, x)[:, 0], cache
