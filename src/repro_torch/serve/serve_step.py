"""Serving steps (the JAX package's `serve/serve_step.py`): prefill (a
full-sequence forward that keeps only the last position's logits) and
decode (one token against the model's cache), the decode cache's sharding
(`cache_specs`), and the F2 KV service served beside the model.

KV service: `ServiceConfig` is a deployment's shape (shards, replicas,
slab width, rebalancer, session pool); `make_kv_service` builds the
backing store from it (`ShardedKV`, or `ReplicatedKV` when `n_replicas >
1`), `make_session_service` wraps that store in the ticketed session layer
(`serve.sessions.KVSessionService`), and `kv_service_step` /
`kv_service_read` / `kv_service_stats` are the request paths and the
telemetry an operator polls.  The store runs on the CUDA device unless
`store_kwargs` names another `device`.  `durability` (a
`core.durability.DurabilityConfig`) wraps the store in `DurableKV`:
snapshots and a write-ahead slab log, from which
`core.durability.recover(dir, make_kv)` brings the deployment back.
`obs_enabled` arms `repro_torch.obs` process-wide (metrics, spans, the
journal, latency histograms, alert rules); `obs_port` serves its endpoints
(`/metrics`, `/snapshot.json`, `/trace.json`, `/healthz`) on the loopback,
port 0 picking a free one (`obs.serve.start`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from .. import obs
from ..configs.base import ModelConfig
from ..obs import serve as obs_serve
from ..models import transformer


def cache_specs(cfg: ModelConfig, mesh=None) -> Dict[str, Any]:
    """PartitionSpecs of each decode-cache entry (`transformer.init_cache`'s
    keys), laid out per REPRO_DECODE_KV: batch over (pod, data), and the
    cache sequence (`seq`, the default) or the KV heads (`heads`) over
    `model`."""
    from ..distributed import sharding
    sp = lambda *names: sharding.spec_for(names, mesh=mesh)  # noqa: E731
    specs: Dict[str, Any] = {"len": sp("batch")}
    if cfg.family == "ssm":
        specs["wkv"] = sp(None, "batch", "heads", None, None)
        specs["shift"] = sp(None, None, "batch", None)
        return specs
    if sharding._DECODE_KV == "heads":
        kv = sp(None, "batch", "kv_heads", None, None)
    else:
        kv = sp(None, "batch", None, "cache_seq", None)
    specs["k"] = kv
    specs["v"] = kv
    if cfg.family == "hybrid":
        specs["conv"] = sp(None, "batch", None, "mlp")
        specs["h"] = sp(None, "batch", "mlp", None)
    if cfg.is_encoder_decoder:
        specs["xk"] = kv
        specs["xv"] = kv
    return specs


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


# ---------------------------------------------------------------------------
# F2 KV service (key-value traffic served beside the model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceConfig:
    """The deployment shape of the KV service, apart from the store's
    geometry (`F2Config`): shards and replicas, the slab width, the
    rebalancer, and the session pool of `make_session_service`."""

    n_shards: int = 1               # hash-routed F2 shards (power of 2)
    lanes: Optional[int] = None     # per-shard slab width (None: 1 round)
    dispatch: str = "auto"          # "auto" | "vmap" | "shard_map"
    rebalance_cfg: Any = None       # core.rebalance.RebalanceConfig
    n_replicas: int = 1             # replica copies of every shard
    read_selector: str = "round_robin"   # fan-out read policy
    # -- the session layer (make_session_service) --
    max_sessions: int = 8           # concurrent Session handles
    session_depth: int = 64         # ring slots per session
    pack_lanes: Optional[int] = None    # per-shard pack width (None: lanes)
    durability: Any = None          # core.durability.DurabilityConfig
    # -- observability (repro_torch.obs): armed process-wide --
    obs_enabled: bool = False
    obs_port: Optional[int] = None  # set: serve /metrics etc. on this port
    # -- pass-through store knobs (mode, trigger, compact_batch, device...) --
    store_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


# (server, thread) of every endpoint `make_kv_service` started in this
# process (`server.server_address[1]` is its port; `server.shutdown()` ends it)
OBS_SERVERS: list = []

_LEGACY_KEYS = ("n_shards", "lanes", "dispatch", "rebalance_cfg",
                "n_replicas", "read_selector", "max_sessions",
                "session_depth", "pack_lanes")


def _coerce_service_cfg(service, kw: dict) -> ServiceConfig:
    """The deprecation shim: the older keyword-splat call
    (`make_kv_service(cfg, n_shards=8, lanes=64, mode=...)`) folds into a
    ServiceConfig, store knobs into `store_kwargs`, with a warning."""
    if service is not None:
        if kw:
            raise TypeError(f"pass store knobs in store_kwargs, got {sorted(kw)}")
        return service
    if kw:
        warnings.warn(
            "make_kv_service(**kwargs) is deprecated: pass a ServiceConfig "
            "(store knobs go in store_kwargs)", DeprecationWarning, stacklevel=3)
    fields = {k: kw.pop(k) for k in _LEGACY_KEYS if k in kw}
    return ServiceConfig(store_kwargs=kw, **fields)


def make_kv_service(kv_cfg, service: Optional[ServiceConfig] = None, **kw):
    """The backing store of a KV deployment: `service.n_shards` hash-routed
    shards behind one router (`core.sharded.ShardedKV`), or R replicas of
    them with fan-in writes and fan-out reads (`core.replication.
    ReplicatedKV`) when `service.n_replicas > 1`; the live rebalancer armed
    by `service.rebalance_cfg`; wrapped in `core.durability.DurableKV` when
    `service.durability` is set; `service.obs_enabled` arms observability
    and `service.obs_port` serves its endpoints on a daemon thread."""
    sc = _coerce_service_cfg(service, dict(kw))
    if sc.obs_enabled:
        obs.configure(enabled=True)
    if sc.obs_port is not None:
        # a daemon thread; port 0 picks a free one: read it from the server
        OBS_SERVERS.append(obs_serve.start(port=sc.obs_port))
    if sc.n_replicas > 1:
        from ..core.replication import ReplicatedKV
        kv = ReplicatedKV(kv_cfg, sc.n_shards, n_replicas=sc.n_replicas,
                          read_selector=sc.read_selector, lanes=sc.lanes,
                          dispatch=sc.dispatch, rebalance_cfg=sc.rebalance_cfg,
                          **sc.store_kwargs)
    else:
        from ..core.sharded import ShardedKV
        kv = ShardedKV(kv_cfg, sc.n_shards, lanes=sc.lanes, dispatch=sc.dispatch,
                       rebalance_cfg=sc.rebalance_cfg, **sc.store_kwargs)
    if sc.durability is not None:
        from ..core.durability import DurableKV
        kv = DurableKV(kv, sc.durability)
    return kv


def make_session_service(kv_cfg, service: Optional[ServiceConfig] = None,
                         **kw):
    """The async serving stack in one call: `make_kv_service`'s store in
    the ticketed session layer (which also satisfies `KVProtocol`)."""
    from .sessions import KVSessionService
    sc = _coerce_service_cfg(service, dict(kw))
    return KVSessionService(make_kv_service(kv_cfg, sc),
                            max_sessions=sc.max_sessions,
                            session_depth=sc.session_depth,
                            pack_lanes=sc.pack_lanes)


def kv_service_step(kv, keys, ops, vals=None):
    """One KV service step: route the request batch, execute (under
    replication: fan in to every alive replica), restore request order;
    the pressure scheduler and the rebalance check run after it.  Returns
    (status [B], values [B, V])."""
    return kv.apply(keys, ops, vals)


def kv_service_read(kv, keys):
    """The read path: routed, no write pass; under replication the fan-out
    read (each lane served by one alive replica)."""
    return kv.read(keys)


def kv_service_stats(kv) -> dict:
    """The nested `KVProtocol.stats()` tree: `io`, plus `shards` /
    `replicas` / `sessions` as the deployment has them."""
    return kv.stats()
