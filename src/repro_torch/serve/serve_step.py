"""Serving steps (the JAX package's `serve/serve_step.py`, its model half):
prefill (a full-sequence forward that keeps only the last position's
logits) and decode (one token against the model's cache).  The KV-service
half of the reference's module (the sharded F2 store behind the model) is
not ported yet (ROADMAP queue 1, items 8-10)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import transformer


@torch.no_grad()
def prefill_step(cfg: ModelConfig, model: transformer.Transformer,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Last-position logits [B, Vpad] (the next-token distribution) of
    batch["tokens"] [B, T]."""
    lg = transformer.forward(cfg, model, batch, remat=False, last_only=True)
    return lg[:, -1, :]


def decode_step(cfg: ModelConfig, model: transformer.Transformer,
                cache: Dict[str, Any], tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    return transformer.decode_step(cfg, model, cache, tokens)
