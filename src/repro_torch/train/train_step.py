"""Training step: loss -> gradients -> AdamW (the JAX package's
`train/train_step.py`).  The loss and its gradient run under
`TRAIN_RULES`: with DTensor parameters under an active mesh, the
activations take the training layout (FSDP + sequence parallelism); on
plain tensors the rules change nothing.

`TrainState` holds the model (its parameters are the trained leaves), the
AdamW state over the same parameter names and the step count.  The step
updates the parameters and moments in place and returns the state with the
new optimizer count and step.  Microbatching (gradient accumulation) sums
float32 gradients over row slices of the batch, as the reference's scan.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import TRAIN_RULES, use_rules
from ..models import transformer
from ..optim import adamw


class TrainState(NamedTuple):
    params: transformer.Transformer
    opt: adamw.OptState
    step: torch.Tensor        # int32 scalar


def trainable(model: transformer.Transformer) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, with gradients switched on."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def cast_like_reference(cfg: ModelConfig, model: transformer.Transformer):
    """The reference's `init_state` cast of its float32 masters: every
    float32 leaf of two or more dimensions takes `cfg.dtype`.  The
    reference stacks the blocks' (and encoder blocks') leaves on a layer
    axis, so a block's norm scales (and RWKV-6's `w0`, `wB`, `u`, `ln_x`,
    the MoE router, the SSM's `wdt`, `dt_bias`, `a_log`) are cast, and only
    `final_norm` and `enc_final_norm` stay float32.  The functions read
    these leaves as the reference reads them, whatever their dtype."""
    dt = getattr(torch, cfg.dtype)
    for name, p in model.named_parameters():
        ndim = p.dim() + (1 if name.startswith(("blocks.", "enc_blocks.")) else 0)
        if p.dtype == torch.float32 and ndim >= 2:
            p.data = p.data.to(dt)
    return model


def init_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
               generator: torch.Generator, device=None) -> TrainState:
    """Random weights from `generator` (on `device`), in the dtypes of the
    reference's training state (`cast_like_reference`)."""
    model = cast_like_reference(cfg, transformer.init_params(cfg, generator, device))
    params = trainable(model)
    return TrainState(params=model, opt=adamw.init(ocfg, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1, remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics); batch is
    {"tokens": [B, T+1] int, optional "loss_mask": [B, T+1]} on the model's
    device."""

    def value_and_grad(params, model, batch):
        # the training layout (FSDP + sequence parallelism), for the
        # recomputed blocks of the backward pass too
        with use_rules(TRAIN_RULES):
            loss = transformer.loss_fn(cfg, model, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        params = trainable(model)
        if microbatches <= 1:
            loss, grads = value_and_grad(params, model, batch)
        else:
            mb = batch["tokens"].shape[0] // microbatches
            total = torch.zeros((), dtype=torch.float32, device=state.step.device)
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()}
            for i in range(microbatches):
                part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                l, g = value_and_grad(params, model, part)
                total = total + l
                for n, a in acc.items():
                    a += g[n]
                del g
            loss = total / microbatches
            grads = {n: a / microbatches for n, a in acc.items()}
        _, opt, om = adamw.apply(ocfg, grads, state.opt, params)
        return (TrainState(params=model, opt=opt, step=state.step + 1),
                {"loss": loss, **om})

    return train_step
