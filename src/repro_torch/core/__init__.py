"""F2 core on PyTorch: the single-shard tiered store (host tier off)."""
from .api import KV
from .types import (BLOCK_BYTES, OP_DELETE, OP_NOOP, OP_READ, OP_RMW,
                    OP_UPSERT, ST_CREATED, ST_NONE, ST_NOT_FOUND, ST_OK,
                    F2Config, IoStats)
from . import (chain, cold_index, compaction, groups, hybrid_log,
               probe_engine, read_cache, store, write_engine)

__all__ = [
    "KV", "F2Config", "IoStats", "BLOCK_BYTES",
    "OP_NOOP", "OP_READ", "OP_UPSERT", "OP_RMW", "OP_DELETE",
    "ST_NONE", "ST_OK", "ST_NOT_FOUND", "ST_CREATED",
    "chain", "cold_index", "compaction", "groups", "hybrid_log",
    "probe_engine", "read_cache", "store", "write_engine",
]
