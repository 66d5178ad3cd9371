"""Core types and constants of the PyTorch F2 store.

Addresses are *logical* int32 offsets into an append-only address space per
log.  Physical storage is a ring buffer: slot = addr & (capacity - 1).  Each
HybridLog keeps the paper's layout (Fig 3):

    BEGIN <= HEAD <= READ_ONLY <= TAIL

  [BEGIN, HEAD)      -> "stable" tier; every record touch here is metered as
                        one 4 KiB block read by the I/O model.
  [HEAD, READ_ONLY)  -> in-memory read-only region (RCU on update).
  [READ_ONLY, TAIL)  -> in-memory mutable region (in-place updates).

Read-cache addresses are tagged with bit 30 (RC_FLAG) so that a hash-chain
head can point either into a record log or into the read cache (F2's
spliced hash chains, paper S7.1).

Every tensor of the store is int32 (or bool); constants are plain Python
ints so that `tensor op constant` keeps the tensor's dtype.

**The shard axis.** The store's functions are written for a state whose
leaves carry a leading shard axis: per-shard scalars (`tail`, `begin`,
counters, `IoStats`) are `[S]`, columns `[S, capacity, ...]`, lane batches
`[S, W]`.  S independent stores then run in one pass, each torch op (and
each kernel launch) serving every shard; `api.KV` holds a stack of one.
`shard_entry` lets the few functions that are also called on one store's
tensors without the axis (`KV.state`) take them: it adds the axis as a
view on the way in and drops it on the way out, so in-place scatters still
land in the caller's tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

NULL_ADDR = -1
RC_FLAG = 1 << 30  # address tag: record lives in the read cache

# record meta bitfield
META_TOMBSTONE = 1
META_INVALID = 2

# op codes for mixed batches
OP_NOOP = 0
OP_READ = 1
OP_UPSERT = 2
OP_RMW = 3
OP_DELETE = 4

# status codes returned per lane
ST_NONE = 0
ST_OK = 1
ST_NOT_FOUND = 2
ST_CREATED = 3  # RMW created the record from the initial value

BLOCK_BYTES = 4096

# probe / write engine backends (F2Config.engine)
ENGINES = ("unfused", "fused", "fused_ref", "fused_cuda")

_M32 = 0xFFFFFFFF


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves so no product reaches 2**63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanching finalizer over int32 keys.

    Returns the uint32 hash as an int64 tensor in [0, 2**32): torch.uint32
    supports few ops and `>>` on int32 is an arithmetic shift, so the
    arithmetic runs in int64 under a 32-bit mask."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def slot_of_keys(keys: torch.Tensor, size: int) -> torch.Tensor:
    """int32 hash slot in [0, size) for a power-of-two table size."""
    return (hash32(keys) & (size - 1)).to(torch.int32)


def is_rc(addr: torch.Tensor) -> torch.Tensor:
    return (addr >= 0) & ((addr & RC_FLAG) != 0)


def rc_untag(addr: torch.Tensor) -> torch.Tensor:
    return addr & ~RC_FLAG


def rc_tag(addr: torch.Tensor) -> torch.Tensor:
    return addr | RC_FLAG


def i32(x, device, lead=()) -> torch.Tensor:
    """A scalar state leaf: int32 of shape `lead` (() for one shard, (S,)
    for a stacked state)."""
    return torch.full(tuple(lead), x, dtype=torch.int32, device=device)


def count(mask: torch.Tensor) -> torch.Tensor:
    """Number of set lanes along the last axis, int32 (torch.sum defaults
    to int64 for integer inputs): [S] for a [S, W] mask."""
    return mask.sum(dim=-1, dtype=torch.int32)


def excl_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a bool mask along the last axis, int32."""
    m32 = mask.to(torch.int32)
    return (torch.cumsum(m32, -1) - m32).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _rows(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None]


def rows(x: torch.Tensor) -> torch.Tensor:
    """The shard index [S, 1] that pairs with a [S, W] lane index."""
    return _rows(x.shape[0], x.device)


def take(col: torch.Tensor, idx: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
    """Per-shard gather: col [S, N, ...] at idx [S, W] (and at the further
    [S, W] indices `more` into the next axes; every index in range) ->
    [S, W, ...].  One shard takes a one-store gather: a broadcast row index
    would cost CUDA's advanced indexing a copy of it to match the lane
    index's strides, and `index_select` is the cheapest call on the host."""
    if idx.shape[0] == 1:
        if not more:
            return torch.index_select(col, 1, idx[0])
        return col[0][(idx[0],) + tuple(m[0] for m in more)].unsqueeze(0)
    return col[(rows(idx), idx) + more]


def lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-shard scalar [S] broadcast over a [S, W] lane batch."""
    return x[:, None].expand(like.shape[0], like.shape[1])


def tree_map(fn, x):
    """`fn` on every tensor of a nest of (named) tuples and lists."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tree_map(fn, y) for y in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, list):
        return [tree_map(fn, y) for y in x]
    return x


def shard_entry(single):
    """Decorator of a function written for the shard axis: when
    `single(*args, **kwargs)` says the call carries one shard's tensors
    without the axis, every tensor argument gets a leading axis of 1 (a
    view) and every tensor of the result loses it again."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not single(*args, **kwargs):
                return fn(*args, **kwargs)

            def up(t):
                return t.unsqueeze(0)
            out = fn(*tree_map(up, args),
                     **{k: tree_map(up, v) for k, v in kwargs.items()})
            return tree_map(lambda t: t.squeeze(0), out)
        return inner
    return deco


class IoStats(NamedTuple):
    """Modeled device<->stable-tier I/O, in 4 KiB blocks / ops (the paper's
    /proc/io methodology): random record and chunk reads from the stable
    tier are one block each; log flushes are sequential bytes at block
    granularity.  Every field is an int32 per-shard scalar."""

    read_blocks: torch.Tensor
    write_blocks: torch.Tensor
    read_ops: torch.Tensor
    mem_hits: torch.Tensor

    @staticmethod
    def zeros(device, lead=()) -> "IoStats":
        return IoStats(*(i32(0, device, lead) for _ in range(4)))

    def add_reads(self, n_blocks, n_ops) -> "IoStats":
        return self._replace(read_blocks=self.read_blocks + n_blocks,
                             read_ops=self.read_ops + n_ops)

    def add_writes(self, n_blocks) -> "IoStats":
        return self._replace(write_blocks=self.write_blocks + n_blocks)

    def add_mem_hits(self, n) -> "IoStats":
        return self._replace(mem_hits=self.mem_hits + n)


@dataclasses.dataclass(frozen=True)
class F2Config:
    """Static configuration of an F2 store instance.

    All sizes are powers of two.  `*_capacity` / `*_mem` are record counts,
    `value_width` is int32 words per value.  Modeled byte sizes (used only by
    the I/O model) follow the paper's YCSB setup: 8 B keys, 8 B RecordInfo
    header, 4*value_width B values.  The fields mirror the JAX package's
    F2Config one to one (`interop.config_from_dict` maps them).
    """

    # hot log
    hot_index_size: int = 1 << 16
    hot_capacity: int = 1 << 18
    hot_mem: int = 1 << 16
    hot_mutable_frac: float = 0.9
    # cold log
    cold_capacity: int = 1 << 20
    cold_mem: int = 1 << 12
    # cold two-level index
    n_chunks: int = 1 << 12
    chunk_slots: int = 32
    chunklog_capacity: int = 1 << 14
    chunklog_mem: int = 1 << 10
    # read cache
    rc_capacity: int = 1 << 14             # 0 disables the read cache
    rc_mutable_frac: float = 0.5
    # host tier (core.host_tier): cold-log chunks below LogState.floor are
    # demoted to host memory; the device ring only holds [floor, tail)
    host_tier: bool = False
    host_chunk_records: int = 256          # records per demotable cold chunk
    host_cache_chunks: int = 16            # device chunk-cache rows
    host_resident_frac: float = 0.5        # demote target: resident/capacity
    host_prefetch: int = 1                 # extra chunks warmed per miss
    host_log_factor: float = 8.0           # cold-cold GC budget as a multiple
                                           # of cold_capacity (with the tier,
                                           # demotion relieves the ring, so
                                           # GC fires on the whole span)
    # execution
    value_width: int = 2
    chain_max: int = 24
    engine: str = "fused"                  # probe + write engine backend:
                                           # "fused" (CUDA kernel for CUDA
                                           # tensors, plain single pass for
                                           # CPU tensors), "unfused" (the
                                           # per-hop oracle), "fused_ref"
                                           # (plain single pass), "fused_cuda"
                                           # (forced kernel; CUDA only)
    # modeled record geometry for the I/O model (bytes)
    key_bytes: int = 8
    header_bytes: int = 8

    @property
    def record_bytes(self) -> int:
        return self.key_bytes + self.header_bytes + 4 * self.value_width

    @property
    def chunk_bytes(self) -> int:
        return 8 * self.chunk_slots

    @property
    def cold_index_slots(self) -> int:
        return self.n_chunks * self.chunk_slots

    def __post_init__(self):
        for name in ("hot_index_size", "hot_capacity", "hot_mem",
                     "cold_capacity", "cold_mem", "n_chunks",
                     "chunklog_capacity", "chunklog_mem"):
            v = getattr(self, name)
            if not (v > 0 and (v & (v - 1)) == 0):
                raise ValueError(f"{name}={v} not a power of 2")
        if self.rc_capacity and self.rc_capacity & (self.rc_capacity - 1):
            raise ValueError(f"rc_capacity={self.rc_capacity} not a power of 2")
        if not (self.hot_mem <= self.hot_capacity
                and self.cold_mem <= self.cold_capacity
                and self.chunklog_mem <= self.chunklog_capacity):
            raise ValueError("an in-memory window exceeds its ring capacity")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; one of {ENGINES}")
        if self.host_tier:
            c = self.host_chunk_records
            if not (c > 0 and (c & (c - 1)) == 0):
                raise ValueError(f"host_chunk_records={c} not a power of 2")
            if c > self.cold_capacity:
                raise ValueError("host_chunk_records exceeds cold_capacity")
            if self.host_cache_chunks < 1:
                raise ValueError("host_cache_chunks must be >= 1")
            if not 0.0 < self.host_resident_frac < 1.0:
                raise ValueError("host_resident_frac must lie in (0, 1)")
            if self.host_prefetch < 0:
                raise ValueError("host_prefetch must be >= 0")
            if self.host_log_factor < 1.0:
                raise ValueError("host_log_factor must be >= 1")
            # the demote target must leave headroom below capacity, or every
            # compaction step would demote again
            if int(self.host_resident_frac * self.cold_capacity) + 2 * c \
                    > self.cold_capacity:
                raise ValueError("host_resident_frac leaves no headroom")


def records_to_blocks(n_records: torch.Tensor, record_bytes: int) -> torch.Tensor:
    """Sequential-flush accounting: bytes rounded up to 4 KiB blocks (int32
    arithmetic, as in the reference)."""
    total = n_records * record_bytes
    return torch.div(total + (BLOCK_BYTES - 1), BLOCK_BYTES,
                     rounding_mode="floor").to(torch.int32)
