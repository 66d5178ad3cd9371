"""Carry configurations, store states and model weights between this port
and the JAX reference package, through plain dicts and numpy arrays.

  * `config_to_dict(cfg)` / `config_from_dict(d)` map `F2Config` fields one
    to one; engine names are translated (`ENGINE_TO_REFERENCE`).
  * `state_to_numpy(state)` / `state_from_numpy(leaves, device)` map an
    `F2State` to and from its flat list of leaves, in the order the JAX
    package's pytree flattening gives them (`leaf_names()` names each one).
    A stacked state (the reference's `ShardedKV.state`: every leaf with a
    leading shard axis) maps the same way, `n_shards=S` checking the axis;
    `shard_state(state, s)` is shard s's slice as one store's state.  The
    reference's replicated state (`ReplicatedKV.state`: leaves [R, S, ...])
    maps with `n_replicas=R` both ways: the port folds the two axes into
    its R*S rows (row r * S + s), `state_to_numpy(state, n_replicas=R)`
    unfolds them.
  * `snapshot_tree(state, meta, n_replicas)` is a store snapshot (the
    `{"state": F2State, "meta": {...}}` payload of `core.durability`) as
    one flat dict keyed by the reference's leaf names
    (`jax.tree_util.keystr` paths: `"['meta']['seq']"`,
    `"['state'].hot.key"`), in the reference's flattening order (the meta
    keys sorted, then the state's leaves), a replicated state's rows
    unfolded to [R, S, ...].  The durability layer writes and restores its
    snapshots through it, so each package's `recover` takes a durable
    directory the other wrote: the reference's restore matches leaves by
    position, the port's by name (`snapshot_leaf_names`).
  * `host_store_to_numpy(ht)` / `host_store_from_numpy(ht, d)` map a
    `HostTier`'s host store (the demoted cold chunks) to and from the
    reference's `HostTier.export_snapshot()` dict; with the state's leaves
    they carry a spilled store either way.
  * `pool_to_numpy(pool)` / `pool_from_numpy(leaves, device)` map the
    session layer's `SessionPool` to and from the reference's leaves.
  * `model_config_to_dict(cfg)` / `model_config_from_dict(d)` map
    `ModelConfig` fields one to one.
  * `params_from_numpy(tree, cfg, device)` / `params_to_numpy(model)` map
    the reference's parameter tree (`jax.tree.map(np.asarray, params)`:
    nested dicts, blocks stacked on a leading layer axis) to and from the
    port's `transformer.Transformer`.
  * `train_state_from_numpy(state, cfg, device)` / `train_state_to_numpy(
    state)` map the reference's `TrainState` (`jax.tree.map(np.asarray,
    state)`: the params tree, AdamW's `mu`/`nu`/`err` trees of the same
    shape, `count` and `step`) to and from the port's `TrainState`.

Every parity test loads one state, or one set of weights, into both
packages this way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .configs.base import ModelConfig
from .core import cold_index, host_tier, hybrid_log, read_cache, store
from .core.types import IoStats, F2Config
from .models import layers, rwkv6, transformer
from .optim import adamw
from .serve.sessions import SessionPool
from .train import train_step

# port engine name -> the reference's name for the same backend
ENGINE_TO_REFERENCE = {"unfused": "jnp", "fused_ref": "fused_ref",
                       "fused_cuda": "fused_pallas", "fused": "fused"}
ENGINE_FROM_REFERENCE = {v: k for k, v in ENGINE_TO_REFERENCE.items()}

# F2State fields that are NamedTuples of leaves (the rest are single leaves)
_SUBTREES = {"hot": hybrid_log.LogState, "rc": read_cache.RCState,
             "cold": hybrid_log.LogState,
             "cold_idx": cold_index.ColdIndexState, "stats": IoStats,
             "host": host_tier.HostCacheState}


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


def state_to_numpy(state: store.F2State, n_replicas=None) -> List[np.ndarray]:
    """Copies of the state's leaves, in the reference's flattening order;
    with `n_replicas=R`, a replicated state's rows unfolded to [R, S, ...]."""
    out = [t.detach().to("cpu", copy=True).numpy() for t in state_leaves(state)]
    if n_replicas is not None:
        out = [a.reshape((n_replicas, a.shape[0] // n_replicas) + a.shape[1:])
               for a in out]
    return out


def state_from_numpy(leaves: Sequence, device, n_shards=None,
                     n_replicas=None) -> store.F2State:
    """An F2State on `device` from the reference's flat list of leaves; with
    `n_shards`, a stacked state whose every leaf leads with that axis; with
    `n_replicas` too, the reference's replicated leaves [R, S, ...] folded
    into R*S rows."""
    leaves = list(leaves)
    if len(leaves) != len(leaf_names()):
        raise ValueError(f"{len(leaves)} leaves, expected {len(leaf_names())}")
    it = iter(leaves)
    lead = (() if n_shards is None else (n_shards,) if n_replicas is None
            else (n_replicas, n_shards))

    def take():
        a = np.asarray(next(it))
        if a.dtype not in (np.int32, np.bool_):
            raise TypeError(f"leaf dtype {a.dtype}: the store is int32/bool")
        if a.shape[:len(lead)] != lead:
            raise ValueError(f"leaf of shape {a.shape}: expected leading "
                             f"replica/shard axes {lead}")
        if n_replicas is not None:
            a = a.reshape((n_replicas * n_shards,) + a.shape[2:])
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    fields = {}
    for f in store.F2State._fields:
        sub = _SUBTREES.get(f)
        fields[f] = sub(*(take() for _ in sub._fields)) if sub else take()
    return store.F2State(**fields)


def shard_state(state: store.F2State, s: int) -> store.F2State:
    """Shard s of a stacked state as one store's state (views)."""
    fields = {}
    for f in store.F2State._fields:
        node = getattr(state, f)
        fields[f] = (type(node)(*(x[s] for x in node)) if f in _SUBTREES
                     else node[s])
    return store.F2State(**fields)


HOST_STORE_KEYS = host_tier.SNAPSHOT_KEYS


def snapshot_meta_name(key: str) -> str:
    """The reference's leaf name of snapshot metadata entry `key`."""
    return f"['meta']['{key}']"


def snapshot_leaf_names(meta_keys) -> List[str]:
    """The reference's names of a store snapshot's leaves, in its
    flattening order: a dict's keys sorted ("meta" before "state"; the
    metadata's own keys too), an F2State's fields in declaration order."""
    return ([snapshot_meta_name(k) for k in sorted(meta_keys)]
            + [f"['state'].{n}" for n in leaf_names()])


def snapshot_tree(state: store.F2State, meta: Dict[str, torch.Tensor],
                  n_replicas=None) -> Dict[str, torch.Tensor]:
    """A store snapshot as {the reference's leaf name: tensor}, in the
    reference's order: `meta`'s tensors, then the state's leaves as views
    (with `n_replicas=R`, a replicated state's rows viewed as [R, S, ...]),
    so a restore into the dict lands in `state` and `meta` in place."""
    def view(t):
        if n_replicas is None:
            return t
        return t.view((n_replicas, t.shape[0] // n_replicas) + t.shape[1:])
    tensors = ([meta[k] for k in sorted(meta)]
               + [view(t) for t in state_leaves(state)])
    return dict(zip(snapshot_leaf_names(meta), tensors))


def host_store_to_numpy(ht: host_tier.HostTier) -> Dict[str, np.ndarray]:
    """A `HostTier`'s host store as the reference's `export_snapshot()`
    dict (rows by shard, then chunk id; a flat KV's shard is 0)."""
    return ht.export_snapshot()


def host_store_from_numpy(ht: host_tier.HostTier, d: Dict) -> None:
    """Load the reference's `export_snapshot()` dict into `ht`'s host store
    (pins, prefetch marks and miss EWMAs reset, as the reference's
    `import_snapshot`).  With `state_from_numpy` of the same store's leaves
    this carries a spilled reference store into the port."""
    missing = [k for k in HOST_STORE_KEYS if k not in d]
    if missing:
        raise KeyError(f"host store dict lacks {missing}")
    ht.import_snapshot({k: np.asarray(d[k]) for k in HOST_STORE_KEYS})


def pool_to_numpy(pool: SessionPool) -> List[np.ndarray]:
    """Copies of a `SessionPool`'s leaves, in the reference's order."""
    return [t.detach().to("cpu", copy=True).numpy() for t in pool]


def pool_from_numpy(leaves: Sequence, device) -> SessionPool:
    """A `SessionPool` on `device` from the reference's leaves."""
    leaves = list(leaves)
    if len(leaves) != len(SessionPool._fields):
        raise ValueError(f"{len(leaves)} leaves, expected {len(SessionPool._fields)}")
    return SessionPool(*(torch.from_numpy(np.array(np.asarray(a, np.int32), copy=True)
                                          ).to(device) for a in leaves))


# ---------------------------------------------------------------------------
# model configurations and weights
# ---------------------------------------------------------------------------

def model_config_to_dict(cfg: ModelConfig) -> Dict:
    """ModelConfig fields as a dict the reference's ModelConfig accepts."""
    return dataclasses.asdict(cfg)


def model_config_from_dict(d: Dict) -> ModelConfig:
    return ModelConfig(**d)


def params_from_numpy(tree, cfg: ModelConfig, device="cpu") -> transformer.Transformer:
    """The port's model from the reference's parameter tree of numpy arrays
    (float32 masters).  Matmul weights, the embedding and RWKV-6's `CAST`
    leaves are cast to `cfg.dtype` (round to nearest even, as the
    reference's `.astype` at use); norm scales and RWKV-6's `w0`, `wB`, `u`
    and `ln_x` stay float32."""
    transformer.check_family(cfg)
    dt = layers.weight_dtype(cfg)

    def w(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dt)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def norm(t, l=None):
        pick = (lambda a: a) if l is None else (lambda a: a[l])
        return layers.Norm(f32(pick(t["scale"])),
                           f32(pick(t["bias"])) if "bias" in t else None)

    B = tree["blocks"]
    blocks = []
    for l in range(cfg.n_layers):
        if cfg.family == "ssm":
            R = B["rwkv"]
            leaves = {n: (w if n in rwkv6.CAST else f32)(R[n][l]) for n in rwkv6.NAMES}
            blocks.append(transformer.RWKVBlock(norm(B["norm1"], l), norm(B["norm2"], l),
                                                rwkv6.RWKV(**leaves)))
            continue
        a = B["attn"]
        qk = (f32(a["q_norm"][l]), f32(a["k_norm"][l])) if "q_norm" in a else ()
        attn = layers.Attention(w(a["wq"][l]), w(a["wk"][l]), w(a["wv"][l]),
                                w(a["wo"][l]), *qk)
        mlp = layers.MLP(w(B["mlp"]["wi"][l]), w(B["mlp"]["wo"][l]))
        blocks.append(transformer.Block(norm(B["norm1"], l), norm(B["norm2"], l),
                                        attn, mlp))
    return transformer.Transformer(cfg, layers.Embed(w(tree["embed"]["table"])),
                                   blocks, norm(tree["final_norm"]))


def _stack_named(items) -> Dict:
    """The reference's nested tree (blocks stacked on a leading layer axis)
    from (port parameter name, numpy array) pairs, layers in order."""
    tree: Dict = {}
    stacked: Dict = {}

    def put(path, a):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a

    for name, a in items:
        parts = name.split(".")
        if parts[0] == "blocks":      # blocks.<l>.<path>, layers in order
            stacked.setdefault(tuple(parts[2:]), []).append(a)
        else:
            put(parts, a)
    for path, arrs in stacked.items():
        put(("blocks",) + path, np.stack(arrs))
    return tree


def reference_leaf(tree, name: str):
    """The reference leaf of a port parameter name (a layer's slice of a
    stacked block leaf)."""
    parts = name.split(".")
    layer = None
    if parts[0] == "blocks":
        layer, parts = int(parts[1]), ["blocks"] + parts[2:]
    node = tree
    for k in parts:
        node = node[k]
    return node if layer is None else node[layer]


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def params_to_numpy(model: transformer.Transformer) -> Dict:
    """The reference's parameter tree (float32 numpy, blocks stacked on a
    leading layer axis) of the port's model."""
    return _stack_named((n, _f32(p)) for n, p in model.named_parameters())


def _tensor(a, device) -> torch.Tensor:
    """A tensor of a numpy leaf, bfloat16 where the leaf is (ml_dtypes')
    bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def train_state_from_numpy(state, cfg: ModelConfig, device="cpu") -> train_step.TrainState:
    """The port's TrainState from the reference's, as numpy leaves.
    Parameters take the dtypes of the reference's training state
    (`params_from_numpy`, then `train_step.cast_like_reference`); the
    moments and residuals keep the reference's."""
    params, opt, step = state
    mu, nu, err, count = opt
    model = train_step.cast_like_reference(cfg, params_from_numpy(params, cfg, device))
    names = list(train_step.trainable(model))
    compressed = any(np.asarray(a).size for a in _tree_leaves(err))

    def named(tree):
        return {n: _tensor(reference_leaf(tree, n), device) for n in names}

    errs = (named(err) if compressed else
            {n: torch.zeros((0,), dtype=torch.int8, device=device) for n in names})
    return train_step.TrainState(
        params=model,
        opt=adamw.OptState(mu=named(mu), nu=named(nu), err=errs,
                           count=_tensor(count, device).to(torch.int32)),
        step=_tensor(step, device).to(torch.int32))


def train_state_to_numpy(state: train_step.TrainState) -> Dict:
    """{"params", "opt": {"mu", "nu", "err", "count"}, "step"} in the
    reference's tree shapes, float32 where a leaf is bfloat16 (numpy has no
    bfloat16); `err` leaves are int8 of shape (0,) when compression is off,
    as the reference's."""
    opt = state.opt
    params = params_to_numpy(state.params)

    def tree(d):
        return _stack_named((n, _f32(t)) for n, t in d.items())

    if all(t.numel() == 0 for t in opt.err.values()):
        err = _empty_like(params)
    else:
        err = tree(opt.err)
    return {"params": params,
            "opt": {"mu": tree(opt.mu), "nu": tree(opt.nu), "err": err,
                    "count": np.asarray(int(opt.count), np.int32)},
            "step": np.asarray(int(state.step), np.int32)}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return np.zeros((0,), np.int8)
