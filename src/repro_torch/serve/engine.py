"""Serving engine: continuous batching over either cache backend.

  * backend="contiguous": the model's own cache (`decode_step`): dense K/V
    (with the SSM state of hybrid and the cross K/V of audio), or RWKV-6's
    per-lane WKV state and token shift; every family runs on it;
  * backend="paged": the F2-tiered paged cache (`repro_torch.kvcache`) with
    the paged-attention CUDA kernel per layer — hot/cold page tiering,
    demotion under pressure, promotion of re-read pages, metered cold
    touches.  This is the paper's design serving tokens.  It runs the
    dense block, so it serves the dense and vlm families and refuses the
    others (`PAGED_REFUSES`).

Requests enter a queue; each engine step admits new sequences into free
slots, decodes one token for every active sequence, and retires finished
ones.  Greedy sampling (argmax) keeps runs deterministic.  Every decode
runs all `max_batch` lanes; prefill feeds a prompt one token per decode
with only its slot active.

The engine runs on the CUDA device unless given another `device`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.api import resolve_device
from ..kvcache.paged import PagedConfig, PagedKV
from ..models import layers, transformer


# why the paged backend does not serve a family: its decode is the
# reference's `_paged_decode`, a dense block (attention with RoPE, then
# `mlp`) over the paged pools
PAGED_REFUSES = {
    "ssm": "pages attention K/V, and the ssm family has none (its state is O(1) "
           "per lane)",
    "moe": "runs the dense block's `mlp`, which the moe family lacks (the "
           "reference's paged decode reads blocks['mlp'] and fails there)",
    "hybrid": "would compute another model: its dense block has no SSM branch",
    "audio": "would compute another model: its dense block applies RoPE to a "
             "layernorm model and has no cross-attention",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int = 8
    out_tokens: Optional[List[int]] = None


class Engine:
    """`model` is a `transformer.Transformer` on `device`.  `interpret=True`
    makes the paged backend run the plain paged attention in place of the
    kernel (the reference's `PagedKV.attend(interpret=...)`)."""

    def __init__(self, cfg: ModelConfig, model, max_batch: int = 4,
                 max_len: int = 256, backend: str = "contiguous",
                 page_size: int = 16, device=None, interpret: bool = False):
        transformer.check_family(cfg)
        if backend not in ("contiguous", "paged"):
            raise ValueError(f"backend {backend!r}: 'contiguous' or 'paged'")
        if backend == "paged" and cfg.family in PAGED_REFUSES:
            raise ValueError(f"{cfg.name}: backend='paged' {PAGED_REFUSES[cfg.family]}; "
                             "use backend='contiguous'")
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.backend = backend
        self.device = resolve_device(device, "repro_torch Engine")
        self.interpret = interpret
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: List[Request] = []
        self.decode_steps = 0                    # decodes of all lanes
        if backend == "contiguous":
            self.cache = transformer.init_cache(cfg, max_batch, max_len,
                                                device=self.device)
        else:
            self.pkv = PagedKV(PagedConfig(
                n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, page_size=page_size,
                n_hot_pages=max_batch * 2,
                n_cold_pages=max_batch * (max_len // page_size + 2),
                max_seqs=max_batch,
                max_pages_per_seq=max_len // page_size + 1), self.device)
            self._all_ids = torch.arange(max_batch, dtype=torch.int32,
                                         device=self.device)
        self.last_tok: Dict[int, int] = {}

    def submit(self, req: Request):
        req.out_tokens = []
        self.queue.append(req)

    # -- scheduling ------------------------------------------------------------
    def _admit(self):
        """paged: continuous batching — admit whenever a slot frees up,
        ragged prompts fine (per-sequence page tables).  contiguous: wave
        admission with equal-length prompts (uniform cache positions) —
        the raggedness limitation the F2-paged design removes."""
        if self.backend == "contiguous":
            if self.active or not self.queue:
                return
            wave = []
            self.cache = transformer.init_cache(self.cfg, self.max_batch,
                                                self.max_len, device=self.device)
            while self.queue and len(wave) < self.max_batch:
                wave.append(self.queue.pop(0))
            plen = len(wave[0].prompt)
            if not all(len(r.prompt) == plen for r in wave):
                raise ValueError("contiguous backend needs equal-length "
                                 "prompts (use paged)")
            for slot, req in enumerate(wave):
                self.active[slot] = req
            for t in range(plen - 1):
                toks = np.zeros((self.max_batch,), np.int32)
                for slot, req in enumerate(wave):
                    toks[slot] = int(req.prompt[t])
                self._step_tokens(toks, active=set(self.active))
            for slot, req in enumerate(wave):
                self.last_tok[slot] = int(req.prompt[-1])
            return
        for slot in range(self.max_batch):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.pop(0)
            self.active[slot] = req
            seq = self.pkv.new_seq()
            while seq != slot:            # slots double as sequence ids
                self.pkv.free_seqs.append(seq)
                seq = self.pkv.new_seq()
            for t in req.prompt[:-1]:
                self._step_tokens(self._tok_vec(slot, int(t)), active={slot})
            self.last_tok[slot] = int(req.prompt[-1])

    def _tok_vec(self, slot: int, token: int) -> np.ndarray:
        toks = np.zeros((self.max_batch,), np.int32)
        toks[slot] = token
        return toks

    @torch.no_grad()
    def _step_tokens(self, toks, active) -> np.ndarray:
        self.decode_steps += 1
        tk = torch.as_tensor(np.asarray(toks, np.int32), device=self.device)
        if self.backend == "contiguous":
            logits = self._contiguous_logits(tk)
        else:
            logits = self._paged_logits(tk, active)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _contiguous_logits(self, toks: torch.Tensor) -> torch.Tensor:
        """One token for every lane through the model's own cache; returns
        the logits [max_batch, Vpad]."""
        logits, self.cache = transformer.decode_step(self.cfg, self.model,
                                                     self.cache, toks)
        return logits

    # -- paged data path --------------------------------------------------------
    def _paged_logits(self, toks: torch.Tensor, active) -> torch.Tensor:
        """One token for every lane via the F2-paged pools and the
        paged-attention kernel; returns the logits [max_batch, Vpad]."""
        cfg, m = self.cfg, self.model
        B = self.max_batch
        seq_ids = np.arange(B, dtype=np.int32)
        mask = np.zeros((B,), bool)
        for s in active:
            mask[s] = True
        self.pkv.begin_token(seq_ids[mask])
        x = layers.embed(cfg, m.embed, toks[:, None])
        pos = self.pkv.state.seq_lens[:, None]
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        G = cfg.n_heads // Hkv
        tables = layers.rope_tables(pos[:, None, :], Dh, cfg.rope_theta,
                                    cfg.rope_fraction)
        for l, blk in enumerate(m.blocks):
            h = layers.norm(cfg, x, blk.norm1)
            q, k, v = layers.project_qkv(cfg, blk.attn, h, pos, tables=tables)
            # rows [B, Hkv, Dh]
            self.pkv.append_layer(l, self._all_ids, k[:, :, 0, :], v[:, :, 0, :])
            qr = q[:, :, 0, :].reshape(B, Hkv, G, Dh)
            att = self.pkv.attend(l, qr, self._all_ids, interpret=self.interpret)
            att = att.reshape(B, cfg.n_heads, Dh)
            x = x + layers.attn_out_token(blk.attn, att.to(x.dtype))[:, None, :]
            h2 = layers.norm(cfg, x, blk.norm2)
            x = x + layers.mlp(cfg, blk.mlp, h2)
        self.pkv.end_token(seq_ids[mask])
        self.pkv.promote_if_hot()
        x = layers.norm(cfg, x, m.final_norm)
        return layers.logits(cfg, m.embed, x)[:, 0]

    # -- public stepping ---------------------------------------------------------
    def step(self):
        self._admit()
        if not self.active:
            return
        toks = np.zeros((self.max_batch,), np.int32)
        for slot in self.active:
            toks[slot] = self.last_tok[slot]
        out = self._step_tokens(toks, active=set(self.active))
        done = []
        for slot, req in self.active.items():
            nxt = int(out[slot])
            req.out_tokens.append(nxt)
            self.last_tok[slot] = nxt
            if len(req.out_tokens) >= req.max_new_tokens:
                done.append(slot)
        for slot in done:
            req = self.active.pop(slot)
            self.finished.append(req)
            if self.backend == "paged":
                self.pkv.release_seq(slot)

    def run(self, max_steps: int = 1000):
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
