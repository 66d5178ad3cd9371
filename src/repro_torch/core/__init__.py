"""F2 core on PyTorch: the tiered store (its host-resident cold tier,
`host_tier`, optional), single-shard (`KV`), hash-partitioned over S shards
on one device (`ShardedKV`), replicated R ways (`ReplicatedKV`) and made
durable (`DurableKV`, `recover`); `KVProtocol` is the surface they share."""
from .api import KV
from .types import (BLOCK_BYTES, OP_DELETE, OP_NOOP, OP_READ, OP_RMW,
                    OP_UPSERT, ST_CREATED, ST_NONE, ST_NOT_FOUND, ST_OK,
                    F2Config, IoStats)
from . import (chain, cold_index, compaction, durability, groups,
               host_tier, hybrid_log, probe_engine, protocol, read_cache,
               rebalance, replication, shard_router, store, write_engine)
from .durability import DurabilityConfig, DurableKV, recover
from .protocol import KVProtocol
from .rebalance import RebalanceConfig
from .replication import ReplicatedKV
from .sharded import ShardedKV

__all__ = [
    "KV", "ShardedKV", "ReplicatedKV", "DurableKV", "DurabilityConfig",
    "recover", "KVProtocol", "RebalanceConfig", "F2Config", "IoStats",
    "BLOCK_BYTES",
    "OP_NOOP", "OP_READ", "OP_UPSERT", "OP_RMW", "OP_DELETE",
    "ST_NONE", "ST_OK", "ST_NOT_FOUND", "ST_CREATED",
    "chain", "cold_index", "compaction", "durability", "groups", "host_tier",
    "hybrid_log",
    "probe_engine", "protocol", "read_cache", "rebalance", "replication",
    "shard_router", "store", "write_engine",
]
