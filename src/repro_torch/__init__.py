"""PyTorch + CUDA port of the F2 key-value store.

The JAX package `repro` is the reference; this package mirrors its layout
(`core/`, `kernels/f2_probe/`) and imports nothing of it.  Public API:

    F2Config, KV (the facade; runs on the CUDA device unless given another
    `device`), ShardedKV (S hash-partitioned stores behind one router, with
    live rebalancing; same device rule), ReplicatedKV (R replicas of them:
    fan-in writes, fan-out reads, drop and resync; same rule), DurableKV
    and DurabilityConfig (either of them made durable: a write-ahead slab
    log and snapshots; `recover` brings one back), KVProtocol
    (the surface they share; `serve.serve_step.make_kv_service` and
    `make_session_service` build deployments), the op / status codes, and
    the functional layers
    `core.store` / `core.compaction` / `core.probe_engine` /
    `core.write_engine`.  `interop` carries configs and states to and from
    the reference's numpy leaves; `workload` generates YCSB op streams.
"""
from .core import (KV, BLOCK_BYTES, OP_DELETE, OP_NOOP, OP_READ, OP_RMW,
                   OP_UPSERT, ST_CREATED, ST_NONE, ST_NOT_FOUND, ST_OK,
                   DurabilityConfig, DurableKV, F2Config, IoStats,
                   KVProtocol, RebalanceConfig, ReplicatedKV, ShardedKV,
                   recover)

__all__ = ["KV", "ShardedKV", "ReplicatedKV", "DurableKV", "DurabilityConfig",
           "recover", "KVProtocol", "RebalanceConfig",
           "F2Config", "IoStats", "BLOCK_BYTES", "OP_NOOP", "OP_READ",
           "OP_UPSERT", "OP_RMW", "OP_DELETE", "ST_NONE", "ST_OK",
           "ST_NOT_FOUND", "ST_CREATED"]
