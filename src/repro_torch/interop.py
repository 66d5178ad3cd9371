"""Carry configurations and store states between this port and the JAX
reference package, through plain dicts and numpy arrays.

  * `config_to_dict(cfg)` / `config_from_dict(d)` map `F2Config` fields one
    to one; engine names are translated (`ENGINE_TO_REFERENCE`).
  * `state_to_numpy(state)` / `state_from_numpy(leaves, device)` map an
    `F2State` to and from its flat list of leaves, in the order the JAX
    package's pytree flattening gives them (`leaf_names()` names each one).

This is the store's counterpart of carrying weights across: every parity
test loads one state into both packages this way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .core import cold_index, hybrid_log, read_cache, store
from .core.types import IoStats, F2Config

# port engine name -> the reference's name for the same backend
ENGINE_TO_REFERENCE = {"unfused": "jnp", "fused_ref": "fused_ref",
                       "fused_cuda": "fused_pallas", "fused": "fused"}
ENGINE_FROM_REFERENCE = {v: k for k, v in ENGINE_TO_REFERENCE.items()}

# F2State fields that are NamedTuples of leaves (the rest are single leaves)
_SUBTREES = {"hot": hybrid_log.LogState, "rc": read_cache.RCState,
             "cold": hybrid_log.LogState,
             "cold_idx": cold_index.ColdIndexState, "stats": IoStats,
             "host": store.HostCacheState}


def config_to_dict(cfg: F2Config) -> Dict:
    """F2Config fields as a dict the reference's F2Config accepts."""
    d = dataclasses.asdict(cfg)
    d["engine"] = ENGINE_TO_REFERENCE[cfg.engine]
    return d


def config_from_dict(d: Dict) -> F2Config:
    """The port's F2Config from a dict of the reference's fields (its engine
    names or the port's)."""
    d = dict(d)
    if "engine" in d:
        d["engine"] = ENGINE_FROM_REFERENCE.get(d["engine"], d["engine"])
    return F2Config(**d)


def leaf_names() -> List[str]:
    names = []
    for f in store.F2State._fields:
        sub = _SUBTREES.get(f)
        names += [f"{f}.{g}" for g in sub._fields] if sub else [f]
    return names


def state_leaves(state: store.F2State) -> List[torch.Tensor]:
    """The state's tensors (not copies), in the reference's flattening
    order."""
    out = []
    for f in store.F2State._fields:
        node = getattr(state, f)
        out.extend(node if f in _SUBTREES else (node,))
    return out


def state_to_numpy(state: store.F2State) -> List[np.ndarray]:
    """Copies of the state's leaves, in the reference's flattening order."""
    return [t.detach().to("cpu", copy=True).numpy() for t in state_leaves(state)]


def state_from_numpy(leaves: Sequence, device) -> store.F2State:
    """An F2State on `device` from the reference's flat list of leaves."""
    leaves = list(leaves)
    if len(leaves) != len(leaf_names()):
        raise ValueError(f"{len(leaves)} leaves, expected {len(leaf_names())}")
    it = iter(leaves)

    def take():
        a = np.asarray(next(it))
        if a.dtype not in (np.int32, np.bool_):
            raise TypeError(f"leaf dtype {a.dtype}: the store is int32/bool")
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    fields = {}
    for f in store.F2State._fields:
        sub = _SUBTREES.get(f)
        fields[f] = sub(*(take() for _ in sub._fields)) if sub else take()
    return store.F2State(**fields)
