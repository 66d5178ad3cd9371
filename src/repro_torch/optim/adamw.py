"""AdamW (the JAX package's `optim/adamw.py`), over a dict of named
parameter tensors, updated in place:

  * float32 or bfloat16 moment states;
  * global-norm gradient clipping;
  * linear warmup + cosine decay schedule;
  * optional int8 gradient quantisation with error feedback.  One int8
    scale covers each reference leaf: the reference stacks a parameter of
    every layer into one leaf, so `blocks.<l>.<name>` of all layers share
    the scale of their largest gradient.

The arithmetic follows the reference's order and dtypes: every update is
computed in float32 from the stored dtypes and rounded back once.  The
schedule and bias corrections are float32 tensors on the parameters'
device, so a step reads nothing back to the host.  Plain tensor code: the
reference has no kernel here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory
    compress_grads: bool = False     # int8 + error feedback


class OptState(NamedTuple):
    mu: Tensors
    nu: Tensors
    err: Tensors          # error-feedback residual (empty when compression is off)
    count: torch.Tensor   # int32 scalar


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (an int32 tensor), float32."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(cfg: AdamWConfig, params: Tensors) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    mu = {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()}
    nu = {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()}
    if cfg.compress_grads:
        err = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
               for n, p in params.items()}
    else:
        err = {n: torch.zeros((0,), dtype=torch.int8, device=p.device)
               for n, p in params.items()}
    device = next(iter(params.values())).device
    return OptState(mu=mu, nu=nu, err=err,
                    count=torch.zeros((), dtype=torch.int32, device=device))


def _leaf_group(name: str) -> str:
    """The reference's leaf of a parameter: its name without the layer."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "blocks" else name


def _quantize_int8(g: torch.Tensor, gmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = gmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Tensors, state: OptState, params: Tensors):
    """One AdamW step.  Updates `params` and the state's moment (and
    error-feedback) tensors in place; returns (params, new state, metrics
    {"lr", "grad_norm"} as float32 tensors)."""
    count = state.count + 1
    lr = schedule(cfg, count)
    grads = dict(grads)
    if cfg.compress_grads:
        fed = {n: g.float() + state.err[n].float() for n, g in grads.items()}
        gmax: Dict[str, torch.Tensor] = {}
        for n, g in fed.items():
            k = _leaf_group(n)
            m = torch.max(torch.abs(g))
            gmax[k] = m if k not in gmax else torch.maximum(gmax[k], m)
        for n, g in fed.items():
            q, s = _quantize_int8(g, gmax[_leaf_group(n)])
            deq = q.float() * s
            state.err[n].copy_((g - deq).to(torch.bfloat16))
            grads[n] = deq

    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state.mu[n], state.nu[n]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (step + cfg.weight_decay * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    new_state = OptState(mu=state.mu, nu=state.nu, err=state.err, count=count)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
