"""KVProtocol: the one serving surface every store facade of the port
satisfies (the JAX package's `core/protocol.py`, declared again here: the
port imports nothing of the reference).

`api.KV` (one store), `sharded.ShardedKV` (S routed shards),
`replication.ReplicatedKV` (R replicas of them) and
`serve.sessions.KVSessionService` (ticketed sessions over either) answer
the same calls, so a caller written against this protocol runs on any of
them; conformance is an `isinstance` check.

Surface (batch-first, int32):

    apply(keys, ops, vals=None) -> (status [B], vals [B, V])
        a mixed op batch (OP_READ/UPSERT/RMW/DELETE; OP_NOOP lanes ignored)
    read(keys)          -> (status [B], vals [B, V])
    upsert(keys, vals)  -> (status [B], vals [B, V])
    rmw(keys, deltas)   -> (status [B], vals [B, V])   add-merge, creates
    delete(keys)        -> (status [B], vals [B, V])
    stats()             -> the nested telemetry dict: `io` always
        (read_bytes/write_bytes/read_ops/mem_hits), plus `shards` /
        `replicas` / `sessions` as the deployment grows axes.  (The
        reference mirrors its leaves into its metrics registry, ROADMAP
        item 13; the tree is the same.)
    check_invariants()  -> raises AssertionError on a broken store
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable


@runtime_checkable
class KVProtocol(Protocol):
    """Structural interface of a servable key-value store facade."""

    def apply(self, keys, ops, vals=None) -> Tuple:
        ...

    def read(self, keys) -> Tuple:
        ...

    def upsert(self, keys, vals) -> Tuple:
        ...

    def rmw(self, keys, deltas) -> Tuple:
        ...

    def delete(self, keys) -> Tuple:
        ...

    def stats(self) -> dict:
        ...

    def check_invariants(self) -> None:
        ...
