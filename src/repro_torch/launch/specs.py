"""Meta-tensor stand-ins for every model input and state, with their
partition specs: what the dry-run lays out over a mesh (the JAX package's
`launch/specs.py`, with `meta` tensors where it has `ShapeDtypeStruct`s:
shapes and dtypes, no storage).

The serving layout replicates the weights over (pod, data) when the
model-sharded copy fits the device memory it plans for: the reference's
9/16 share of a 16 GB v5e, as a share of `device_memory` (by default the
H100 SXM's 80 GB; pass 16e9 for the reference's decisions).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ALL_SHAPES, ModelConfig, ShapeSpec
from ..distributed.param_sharding import param_specs
from ..distributed.sharding import (DEFAULT_RULES, PartitionSpec, axis_sizes,
                                    fit_spec, local_shape, spec_for)
from ..models import transformer
from ..optim import adamw
from ..serve import serve_step
from ..train import train_step as ts

SHAPES = {s.name: s for s in ALL_SHAPES}
H100_MEMORY = 80e9          # bytes of HBM3 on an H100 SXM
SERVE_REPLICATE_SHARE = 9 / 16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, PartitionSpec]]:
    """(batch of meta tensors, their specs) for the shape."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    batch: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        batch["tokens"] = _meta((B, S + 1), torch.int32)
    elif shape.kind == "prefill":
        batch["tokens"] = _meta((B, S), torch.int32)
    else:                    # decode: one new token, a cache of length S
        batch["tokens"] = _meta((B,), torch.int32)
    if cfg.frontend == "patches" and shape.kind != "decode":
        batch["frontend"] = _meta((B, cfg.num_frontend_tokens, cfg.d_model), dt)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        batch["frames"] = _meta((B, cfg.encoder_len, cfg.d_model), dt)
    pspecs = {k: spec_for(("batch",) + (None,) * (v.dim() - 1), mesh=mesh,
                          shape=tuple(v.shape)) for k, v in batch.items()}
    return batch, pspecs


def serve_rules(cfg: ModelConfig, mesh, device_memory: float = H100_MEMORY):
    """The weight-stationary serving rules (no ZeRO regather per token)
    when the model-sharded bf16 copy fits `SERVE_REPLICATE_SHARE` of the
    device memory; None (the storage rules) otherwise."""
    if mesh is None:
        return None
    n_model = axis_sizes(mesh).get("model", 1)
    per_dev = 2 * cfg.param_count() / max(n_model, 1)
    if per_dev < SERVE_REPLICATE_SHARE * device_memory:
        return dict(DEFAULT_RULES, fsdp=None)
    return None


def meta_model(cfg: ModelConfig) -> transformer.Transformer:
    """The model on `meta`, in the reference's training-state dtypes."""
    return ts.cast_like_reference(
        cfg, transformer.init_params(cfg, torch.Generator(), device="meta"))


def params_specs(cfg: ModelConfig, mesh=None, mode: str = "train",
                 device_memory: float = H100_MEMORY, model=None):
    """(the model on `meta` (`model` if given, else a new `meta_model`), and
    {parameter name: spec})."""
    model = meta_model(cfg) if model is None else model
    rules = serve_rules(cfg, mesh, device_memory) if mode == "serve" else None
    return model, param_specs(model, mesh, rules=rules)


def train_state_specs(cfg: ModelConfig, ocfg: adamw.AdamWConfig, mesh=None,
                      model=None):
    """(a TrainState of meta tensors, a TrainState of specs): the moments
    and the error-feedback residual take their parameter's spec."""
    model, p_specs = params_specs(cfg, mesh, model=model)
    params = dict(model.named_parameters())
    sdt = getattr(torch, ocfg.state_dtype)
    mom = {n: _meta(p.shape, sdt) for n, p in params.items()}
    if ocfg.compress_grads:
        err = {n: _meta(p.shape, torch.bfloat16) for n, p in params.items()}
        err_spec = dict(p_specs)
    else:
        err = {n: _meta((0,), torch.int8) for n in params}
        err_spec = {n: PartitionSpec() for n in params}
    state = ts.TrainState(
        params=model,
        opt=adamw.OptState(mu=mom, nu={n: _meta(t.shape, sdt) for n, t in mom.items()},
                           err=err, count=_meta((), torch.int32)),
        step=_meta((), torch.int32))
    specs = ts.TrainState(
        params=p_specs,
        opt=adamw.OptState(mu=p_specs, nu=p_specs, err=err_spec,
                           count=PartitionSpec()),
        step=PartitionSpec())
    return state, specs


def cache_state_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None):
    """(the decode cache of meta tensors, its specs fitted to the shapes)."""
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="meta")
    specs = serve_step.cache_specs(cfg, mesh)
    specs = {k: fit_spec(v, tuple(cache[k].shape), mesh) for k, v in specs.items()}
    return cache, specs


def _bytes(t: torch.Tensor, spec, mesh) -> int:
    n = 1
    for d in local_shape(tuple(t.shape), spec, mesh) if mesh is not None else t.shape:
        n *= d
    return n * t.element_size()


def argument_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   ocfg: Optional[adamw.AdamWConfig] = None,
                   device_memory: float = H100_MEMORY, model=None) -> int:
    """Bytes one device holds of a cell's arguments by the specs' arithmetic
    (every sharded dimension's size over its mesh axes' product): the
    training state and batch, or the weights, cache and tokens.  `model`:
    a `meta_model` to reuse."""
    ocfg = ocfg or adamw.AdamWConfig(state_dtype="bfloat16")
    batch, bspecs = input_specs(cfg, shape, mesh)
    pairs = [(batch[k], bspecs[k]) for k in batch]
    if shape.kind == "train":
        state, specs = train_state_specs(cfg, ocfg, mesh, model=model)
        params = dict(state.params.named_parameters())
        pairs += [(params[n], specs.params[n]) for n in params]
        for d, s in ((state.opt.mu, specs.opt.mu), (state.opt.nu, specs.opt.nu),
                     (state.opt.err, specs.opt.err)):
            pairs += [(d[n], s[n]) for n in d]
        pairs += [(state.opt.count, PartitionSpec()), (state.step, PartitionSpec())]
    else:
        model, p_specs = params_specs(cfg, mesh, mode="serve",
                                      device_memory=device_memory, model=model)
        pairs += [(p, p_specs[n]) for n, p in model.named_parameters()]
        if shape.kind == "decode":
            cache, cspecs = cache_state_specs(cfg, shape, mesh)
            pairs += [(cache[k], cspecs[k]) for k in cache]
    return sum(_bytes(t, s, mesh) for t, s in pairs)
