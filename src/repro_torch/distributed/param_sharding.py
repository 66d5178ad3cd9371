"""Parameter partition specs: FSDP over (pod, data) + TP/EP over model
(the JAX package's `distributed/param_sharding.py`).

Specs are assigned by parameter path.  The port's blocks are one module a
layer (`blocks.<l>.attn.wq`), where the reference stacks them on a leading
[L] axis it never shards, so a block parameter's spec is the reference's
without its leading None.  The same table serves parameters, gradients and
optimizer moments (ZeRO: moments take their parameter's sharding).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .sharding import PartitionSpec, placements, spec_for

STACKED = ("blocks", "enc_blocks")

# path suffix -> logical axes (without the reference's stacked [L] axis)
_TABLE: Dict[str, tuple] = {
    "embed/table": ("vocab", "fsdp"),
    "final_norm/scale": (None,), "final_norm/bias": (None,),
    "enc_final_norm/scale": (None,), "enc_final_norm/bias": (None,),
    # attention (also cross/enc attention)
    "attn/wq": ("fsdp", "heads", None),
    "attn/wk": ("fsdp", "kv_heads", None),
    "attn/wv": ("fsdp", "kv_heads", None),
    "attn/wo": ("heads", None, "fsdp"),
    "attn/q_norm": (None,), "attn/k_norm": (None,),
    "cross/wq": ("fsdp", "heads", None),
    "cross/wk": ("fsdp", "kv_heads", None),
    "cross/wv": ("fsdp", "kv_heads", None),
    "cross/wo": ("heads", None, "fsdp"),
    # mlp
    "mlp/wi": ("fsdp", None, "mlp"),
    "mlp/wo": ("mlp", "fsdp"),
    # moe
    "moe/router": ("fsdp", None),
    "moe/wi": ("expert", "fsdp", None, None),
    "moe/wo": ("expert", None, "fsdp"),
    "moe/shared_wi": ("fsdp", None, "mlp"),
    "moe/shared_wo": ("mlp", "fsdp"),
    # rwkv6
    "rwkv/mu": (None, None), "rwkv/mu_c": (None, None),
    "rwkv/wr": ("fsdp", "heads", None), "rwkv/wk": ("fsdp", "heads", None),
    "rwkv/wv": ("fsdp", "heads", None), "rwkv/wg": ("fsdp", "heads", None),
    "rwkv/wo": ("heads", None, "fsdp"),
    "rwkv/w0": ("heads", None), "rwkv/u": ("heads", None),
    "rwkv/ln_x": ("heads", None),
    "rwkv/wA": ("fsdp", None), "rwkv/wB": (None, "heads", None),
    "rwkv/ck": ("fsdp", "mlp"), "rwkv/cv": ("mlp", "fsdp"),
    "rwkv/cr": ("fsdp", None),
    # hymba ssm
    "ssm/in_proj": ("fsdp", None, "mlp"),
    "ssm/conv": (None, "mlp"),
    "ssm/wdt": ("mlp",), "ssm/dt_bias": ("mlp",),
    "ssm/wb": ("mlp", None), "ssm/wc": ("mlp", None),
    "ssm/a_log": ("mlp", None), "ssm/dskip": ("mlp",),
    "ssm/out_proj": ("mlp", "fsdp"),
}


def reference_path(name: str) -> str:
    """The reference's tree path of a port parameter name, without the
    layer index: `blocks.3.attn.wq` -> `blocks/attn/wq`."""
    parts = name.split(".")
    if parts[0] in STACKED:
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def logical_axes(name: str, ndim: int) -> tuple:
    """The logical axes of a port parameter (as the reference assigns them
    to its stacked leaf, less the layer axis)."""
    ps = reference_path(name)
    suffix = "/".join(ps.split("/")[-2:])
    logical = _TABLE.get(suffix)
    if suffix == "mlp/wi" and ndim == 2:
        logical = ("fsdp", "mlp")          # non-gated (gelu) MLP
    if logical is None:
        if ps in _TABLE:
            logical = _TABLE[ps]
        elif ps.endswith(("scale", "bias")):
            logical = (None,) * ndim
        else:
            raise KeyError(f"no sharding rule for param '{ps}' (ndim {ndim})")
    if len(logical) != ndim:
        raise ValueError(f"{name}: logical axes {logical} for ndim {ndim}")
    return tuple(logical)


def param_specs(model: torch.nn.Module, mesh=None,
                rules: Optional[Dict] = None) -> Dict[str, PartitionSpec]:
    """{parameter name: PartitionSpec} over `model.named_parameters()`."""
    return {n: spec_for(logical_axes(n, p.dim()), rules=rules, mesh=mesh,
                        shape=tuple(p.shape))
            for n, p in model.named_parameters()}


def shardings_for(model: torch.nn.Module, mesh,
                  rules: Optional[Dict] = None) -> Dict[str, tuple]:
    """{parameter name: DTensor placements} on a DeviceMesh."""
    return {n: placements(s, mesh)
            for n, s in param_specs(model, mesh, rules).items()}


def distribute_params(model: torch.nn.Module, mesh,
                      rules: Optional[Dict] = None) -> torch.nn.Module:
    """Every parameter replaced, in place, by a DTensor laid out by its
    spec (`distribute_tensor`: each rank keeps its shard).  Returns the
    model."""
    from torch.distributed.tensor import distribute_tensor
    place = shardings_for(model, mesh, rules)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        dt = distribute_tensor(p.data, mesh, place[name])
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model
