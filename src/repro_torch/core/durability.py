"""CPR-style durability for the sharded and replicated stores: fuzzy
snapshots, a write-ahead slab log and crash recovery (the JAX package's
`core/durability.py`).

`DurableKV` wraps a `ShardedKV` or a `ReplicatedKV` and makes it durable
with two artifacts under one directory:

    <dir>/snap/step_<E>/...        snapshots (`checkpoint.Checkpointer`)
    <dir>/wal_<E>.log              one WAL segment per snapshot epoch

**Snapshots** hold the whole stacked `F2State` and the routing and
replication metadata (`bucket_map`, `map_version`, epoch, next WAL seq, the
replicas' `alive` mask, and with the host tier the host chunk store as
`HostTier.export_snapshot`'s arrays: the floor is a state leaf, so a
restore without them could not read below it) as CPU tensors, captured between rounds: a host copy
of every leaf (the capture stall, `Checkpointer.capture_s`), then the disk
write on the checkpointer's thread.  Snapshot E first rotates the WAL to
segment E, so segment E holds exactly the rounds after snapshot E.  The
leaves are written under the reference's names and in its order
(`interop.snapshot_tree`), so either package recovers a directory the other
wrote.

**The WAL** logs client batches, not rounds: a SLAB record is one batch's
keys, ops and values, logged once before its first routed round.  Routing is
a pure function of (batch, bucket map, lanes), and the map holds still for a
batch, so replay derives the batch's deferral rounds again.  Batches with no
write are not logged.  A migration logs one MAP record (the new map and the
drained records under one CRC) after its drain and before its purge, so
recovery replays all of a migration or none of it.  The byte format is the
reference's: a segment that either package writes is byte-identical for the
same batches.  Records are encoded from the caller's arrays: host arrays as
they are, device tensors in one copy a record (`WalWriter.d2h_copies`).

**Recovery** (`recover(dir, make_kv)`) restores the newest complete snapshot
into a fresh store (in place: no second state), then replays the WAL suffix
(epochs >= the snapshot's, in seq order; purge, flip and replay at MAP
records) through the store's own routed rounds, so `fused_probe` and
`fused_write` run the replay on the card.  The result is logically the
crashed store: statuses and values of every later op are bit-exact with an
uninterrupted twin (reads are not logged, so read-cache contents may
differ).  Replay fans in to the replicas alive at the snapshot; the others
are revived as copies of the recovered primary's rows.

**Graceful degradation** (`rebuild_replica(r)`): a dropped replica is
rebuilt from the snapshot and the WAL suffix instead of `resync()`'s drain
of a healthy replica, which serves no drain read.  The replay is masked to r
(`apply_round(..., _rep_do=onehot)`) with the scheduler restricted to r's
rows, record by record as the reference replays them.  Segment reads retry
with bounded backoff; a torn tail record (length or CRC mismatch) is
dropped.

**Observability** (`repro_torch.obs`, off by default), at the reference's
points: `f2_wal_records_total` / `f2_wal_bytes_total{kind=}`, the group
commit's `f2_wal_fsync_seconds` and the `fsync` latency phase, the
`wal.segment_rotated`, `snapshot.taken` / `snapshot.committed`,
`replica.rebuilt` and `recovery.completed` events, `f2_snapshots_total`,
`f2_checkpoint_save_seconds`, and the snapshot, rebuild and recovery spans.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import interop, obs
from ..checkpoint.checkpointer import Checkpointer, leaves
from ..testing import faults
from . import rebalance, shard_router
from .host_tier import SNAPSHOT_KEYS as HOST_STORE_KEYS
from .replication import replicated_view
from .types import OP_DELETE, OP_NOOP, OP_RMW, OP_UPSERT, IoStats, tree_map

SEG_MAGIC = b"F2WL"
SEG_VERSION = 2
REC_MAGIC = 0xF25AB10C
REC_SLAB = 1
REC_MAP = 2
_SEG_HDR = struct.Struct("<4sII")          # magic, version, epoch
_REC_HDR = struct.Struct("<IIIIIII")       # magic, type, epoch, seq,
#                                            map_version, payload_len, crc
_PAY_HDR = struct.Struct("<III")           # n_map, batch, value_width

@dataclass
class DurabilityConfig:
    """The durability layer of a deployment.

    fsync: "batch" (group commit: a client batch's appends are fsync'd once,
    before its statuses are returned, so every acked op is durable),
    "always" (after every record too) or "rotate" (only at segment rotation
    and close; a crash may lose the OS-buffered tail, which reads back as a
    torn tail).  snapshot_every_rounds=0 means `snapshot()` calls only."""

    dir: str
    snapshot_every_rounds: int = 0
    fsync: str = "batch"               # "batch" | "always" | "rotate"
    keep: int = 3                      # snapshots retained
    segment_retries: int = 3           # bounded retry on segment reads
    retry_backoff: float = 0.01        # seconds, doubled per retry
    revive_dead_replicas: bool = True  # recover(): copy the primary's rows
    blocking_snapshots: bool = False   # True: snapshot() waits for the disk

    def __post_init__(self):
        if self.fsync not in ("batch", "always", "rotate"):
            raise ValueError(f"unknown fsync mode {self.fsync!r}")


class WalRecord(NamedTuple):
    rtype: int            # REC_SLAB | REC_MAP
    epoch: int
    seq: int
    map_version: int      # SLAB: the map in effect; MAP: the version after the flip
    keys: np.ndarray      # int32 [B]
    ops: np.ndarray       # int32 [B]
    vals: np.ndarray      # int32 [B, V]
    new_map: Optional[np.ndarray]   # MAP only: int32 [n_buckets]


class WalError(RuntimeError):
    """The WAL does not replay onto the store (a record out of map order,
    or a replay that ends on another map than the live store's)."""


def _segment_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"wal_{epoch:08d}.log")


def wal_epochs(directory: str) -> List[int]:
    out = []
    for f in os.listdir(directory):
        if f.startswith("wal_") and f.endswith(".log"):
            out.append(int(f[4:-4]))
    return sorted(out)


def _host_int32(keys, ops, vals):
    """(keys [B], ops [B], vals [B, V]) as int32 numpy arrays, and whether a
    copy from a device was made.  Host arrays are taken as they are; the
    tensors that lie on a device are packed into one [B, k] tensor there
    and come over in one copy."""
    xs = [keys, ops, vals]
    on_dev = [i for i, x in enumerate(xs)
              if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    out = [None, None, None]
    if on_dev:
        B = len(keys)
        cols = [xs[i].to(torch.int32).reshape(B, -1) for i in on_dev]
        host = torch.cat(cols, 1).cpu().numpy()
        at = 0
        for i, c in zip(on_dev, cols):
            out[i] = host[:, at:at + c.shape[1]]
            at += c.shape[1]
    for i, x in enumerate(xs):
        if out[i] is None:
            out[i] = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    k, o, v = out
    return (np.ascontiguousarray(k.reshape(-1), np.int32),
            np.ascontiguousarray(o.reshape(-1), np.int32),
            np.ascontiguousarray(v.reshape(len(k), -1), np.int32)), bool(on_dev)


class WalWriter:
    """Appends slab and map records to the current epoch's segment."""

    def __init__(self, directory: str, epoch: int = 0, seq: int = 0,
                 fsync: str = "batch"):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.epoch = int(epoch)
        self.seq = int(seq)          # the next record's global sequence number
        self.fsync = fsync
        self.d2h_copies = 0          # device-to-host copies made to encode records
        self._dirty = False          # appends not yet fsync'd
        self._f = None
        self._open()

    def _open(self):
        self._f = open(_segment_path(self.dir, self.epoch), "ab")
        if self._f.tell() == 0:
            self._f.write(_SEG_HDR.pack(SEG_MAGIC, SEG_VERSION, self.epoch))
            self._f.flush()

    # -- record encoding -------------------------------------------------------
    @staticmethod
    def _encode(keys, ops, vals, new_map=None) -> bytes:
        """`_PAY_HDR` (n_map, B, V), then the int32 arrays back to back,
        little-endian."""
        nm = (b"" if new_map is None
              else np.ascontiguousarray(new_map, "<i4").tobytes())
        return (_PAY_HDR.pack(len(nm) // 4, len(keys), vals.shape[1])
                + nm + keys.astype("<i4").tobytes() + ops.astype("<i4").tobytes()
                + vals.astype("<i4").tobytes())

    def _append(self, rtype: int, map_version: int, payload: bytes):
        hdr = _REC_HDR.pack(REC_MAGIC, rtype, self.epoch, self.seq,
                            map_version, len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF)
        try:
            faults.maybe_crash("wal.mid_append")
        except faults.InjectedCrash:
            # a torn append: half the record reaches the disk, then the
            # process dies; recovery must drop this tail record
            torn = (hdr + payload)[: _REC_HDR.size + max(1, len(payload) // 2)]
            self._f.write(torn)
            self._f.flush()
            os.fsync(self._f.fileno())
            raise
        self._f.write(hdr)
        self._f.write(payload)
        if self.fsync == "always":
            self._f.flush()
            os.fsync(self._f.fileno())
        else:
            self._dirty = True          # flushed and fsync'd at sync()/close()
        self.seq += 1
        kind = "slab" if rtype == REC_SLAB else "map"
        obs.count("f2_wal_records_total", help="WAL records appended",
                  kind=kind)
        obs.count("f2_wal_bytes_total", _REC_HDR.size + len(payload),
                  help="WAL bytes appended", kind=kind)

    # -- the two record types --------------------------------------------------
    def _host(self, keys, ops, vals):
        (keys, ops, vals), copied = _host_int32(keys, ops, vals)
        self.d2h_copies += copied
        return keys, ops, vals

    def log_slab(self, keys, ops, vals, map_version: int):
        """One client batch's input.  Batches with no write (reads and
        NOOPs) are not logged: they change no content."""
        keys, ops, vals = self._host(keys, ops, vals)
        if not ((ops == OP_UPSERT) | (ops == OP_RMW) | (ops == OP_DELETE)).any():
            return
        self._append(REC_SLAB, map_version, self._encode(keys, ops, vals))

    def log_map(self, new_map, map_version: int, keys, ops, vals):
        """One migration: the map after the flip and the drained records,
        under one CRC.  Durable in every fsync mode: the purge that follows
        is safe only once the record that replays it is on disk."""
        keys, ops, vals = self._host(keys, ops, vals)
        self._append(REC_MAP, map_version,
                     self._encode(keys, ops, vals, new_map=new_map))
        self.sync()

    # -- lifecycle -------------------------------------------------------------
    def sync(self):
        """Group-commit barrier: fsync the buffered appends (none buffered:
        nothing to do)."""
        if self._dirty and self._f is not None and not self._f.closed:
            t0 = time.perf_counter() if obs.enabled() else 0.0
            self._f.flush()
            os.fsync(self._f.fileno())
            self._dirty = False
            if obs.enabled():
                obs.observe("f2_wal_fsync_seconds", time.perf_counter() - t0,
                            help="group-commit fsync latency")

    def rotate(self, new_epoch: int):
        """Start segment `new_epoch` (at a snapshot's capture point)."""
        self.close()
        self.epoch = int(new_epoch)
        self._open()
        obs.journal.emit("wal.segment_rotated", epoch=self.epoch)

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.flush()
            if self._dirty:
                os.fsync(self._f.fileno())
                self._dirty = False
            self._f.close()


def _read_file_with_retry(path: str, retries: int, backoff: float) -> bytes:
    """Segment reads retry transient I/O errors with doubling backoff; the
    last error propagates."""
    delay = backoff
    for attempt in range(max(1, retries)):
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            if attempt == max(1, retries) - 1:
                raise
            time.sleep(delay)
            delay *= 2


def read_segment(path: str, retries: int = 3, backoff: float = 0.01,
                 ) -> List[WalRecord]:
    """Decode one segment.  A torn tail (short header, short payload, CRC
    mismatch, framing mismatch) ends the segment: records are appended and
    fsync'd in order, so nothing after a torn record is reachable."""
    raw = _read_file_with_retry(path, retries, backoff)
    out: List[WalRecord] = []
    if len(raw) < _SEG_HDR.size:
        return out
    magic, version, _ = _SEG_HDR.unpack_from(raw, 0)
    if magic != SEG_MAGIC or version != SEG_VERSION:
        return out
    off = _SEG_HDR.size
    while off + _REC_HDR.size <= len(raw):
        (rmagic, rtype, epoch, seq, map_version,
         plen, crc) = _REC_HDR.unpack_from(raw, off)
        if rmagic != REC_MAGIC:
            break
        body = raw[off + _REC_HDR.size: off + _REC_HDR.size + plen]
        if len(body) < plen or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            break
        n_map, b, v = _PAY_HDR.unpack_from(body, 0)
        if plen != _PAY_HDR.size + 4 * (n_map + 2 * b + b * v):
            break
        p = _PAY_HDR.size
        new_map = None
        if n_map:
            new_map = np.frombuffer(body, "<i4", n_map, p).astype(np.int32)
            p += 4 * n_map
        keys = np.frombuffer(body, "<i4", b, p).astype(np.int32)
        p += 4 * b
        ops = np.frombuffer(body, "<i4", b, p).astype(np.int32)
        p += 4 * b
        vals = np.frombuffer(body, "<i4", b * v, p).astype(np.int32).reshape(b, v)
        out.append(WalRecord(rtype=rtype, epoch=epoch, seq=seq,
                             map_version=map_version, keys=keys, ops=ops,
                             vals=vals, new_map=new_map))
        off += _REC_HDR.size + plen
    return out


def read_wal(directory: str, from_epoch: int = 0, retries: int = 3,
             backoff: float = 0.01) -> List[WalRecord]:
    """Every decodable record of the segments >= from_epoch, in seq order."""
    recs: List[WalRecord] = []
    for e in wal_epochs(directory):
        if e >= from_epoch:
            recs.extend(read_segment(_segment_path(directory, e), retries,
                                     backoff))
    recs.sort(key=lambda r: r.seq)
    return recs


def _meta_like(kv) -> dict:
    """Snapshot metadata of `kv` as CPU tensors (the checkpointer takes
    tensors only): the bucket map, its version, and `alive` under
    replication; epoch and seq are filled in by the caller."""
    meta = {"bucket_map": torch.from_numpy(np.array(kv.bucket_map, np.int32)),
            "map_version": torch.tensor(int(kv.map_version), dtype=torch.int64),
            "epoch": torch.tensor(0, dtype=torch.int64),
            "seq": torch.tensor(0, dtype=torch.int64)}
    if hasattr(kv, "alive"):
        meta["alive"] = torch.from_numpy(np.array(kv.alive, bool))
    ht = getattr(kv, "_ht", None)
    if ht is not None:
        # empty placeholders: restore takes their length (the demoted chunk
        # count) from the checkpoint
        for k, a in ht.export_snapshot().items():
            meta[k] = torch.empty((0,) + a.shape[1:], dtype=torch.int32)
    return meta


def _host_paths(kv) -> tuple:
    """The snapshot leaves whose length the checkpoint decides."""
    if getattr(kv, "_ht", None) is None:
        return ()
    return tuple(interop.snapshot_meta_name(k) for k in HOST_STORE_KEYS)


def _snapshot_tree(kv, state, meta) -> dict:
    """`state` and `meta` as the snapshot's leaves, under the reference's
    names and in its order (a replicated state's rows as [R, S, ...])."""
    return interop.snapshot_tree(state, meta, getattr(kv, "R", None))


def _replica_leaves(state, R: int) -> list:
    """Every leaf of a replicated state viewed as [R, S, ...]."""
    return [t for _, t in leaves(replicated_view(state, R))]


# ---------------------------------------------------------------------------
# DurableKV
# ---------------------------------------------------------------------------

class DurableKV:
    """Installs the WAL on the inner store, snapshots it through the
    `Checkpointer`, and rebuilds a dropped replica from snapshot and WAL
    (`rebuild_replica`); `recover` brings a whole store back.  Conforms to
    `KVProtocol`; every other attribute (bucket_map, migrate, drop_replica,
    shard_stats, ...) is the wrapped store's."""

    _obs_facade = "durable"

    def __init__(self, kv, cfg: DurabilityConfig):
        if getattr(kv, "wal", "missing") is not None:
            raise ValueError("the store has a WAL installed already, or has "
                             "no WAL hook (DurableKV wraps ShardedKV and "
                             "ReplicatedKV)")
        self.kv = kv
        self.dcfg = cfg
        os.makedirs(cfg.dir, exist_ok=True)
        self.ckpt = Checkpointer(os.path.join(cfg.dir, "snap"), keep=cfg.keep)
        self.epoch = 0
        self.snapshots = 0
        self.recovery: Optional[dict] = None
        self._last_snap_rounds = kv.rounds
        self._wal = WalWriter(cfg.dir, epoch=self.epoch, fsync=cfg.fsync)
        kv.wal = self._wal

    # -- the protocol surface (delegation, group commit, snapshot cadence) -----
    def _commit(self):
        """Group commit ("batch"): fsync what this batch appended before its
        statuses reach the caller."""
        if self.dcfg.fsync == "batch":
            if obs.enabled():   # fsync-to-ack: the durability ack stall
                t0 = time.perf_counter()
                self._wal.sync()
                obs.observe_phase("fsync", time.perf_counter() - t0)
            else:
                self._wal.sync()

    def _acked(self, out):
        self._commit()
        self.maybe_snapshot()
        return out

    def apply(self, keys, ops, vals=None):
        return self._acked(self.kv.apply(keys, ops, vals))

    def apply_round(self, keys, ops, vals=None):
        out = self.kv.apply_round(keys, ops, vals)
        self._commit()
        return out

    def read(self, keys):
        return self.kv.read(keys)

    def upsert(self, keys, vals):
        return self._acked(self.kv.upsert(keys, vals))

    def rmw(self, keys, deltas):
        return self._acked(self.kv.rmw(keys, deltas))

    def delete(self, keys):
        return self._acked(self.kv.delete(keys))

    def stats(self) -> dict:
        return obs.fold_stats(self._obs_facade, self._stats_tree())

    def _stats_tree(self) -> dict:
        out = self.kv._stats_tree()
        out["durability"] = {
            "epoch": self.epoch,
            "snapshots": self.snapshots,
            "wal_seq": self._wal.seq,
            "wal_segments": len(wal_epochs(self.dcfg.dir)),
        }
        return out

    def check_invariants(self):
        self.kv.check_invariants()

    def __getattr__(self, name):
        if name == "kv":                    # not bound yet (mid-construction)
            raise AttributeError(name)
        return getattr(self.kv, name)

    # -- snapshots -------------------------------------------------------------
    def _meta(self) -> dict:
        meta = _meta_like(self.kv)
        meta["epoch"].fill_(self.epoch)
        meta["seq"].fill_(self._wal.seq)
        ht = getattr(self.kv, "_ht", None)
        if ht is not None:
            # the demoted cold chunks travel with the snapshot
            meta.update({k: torch.from_numpy(a)
                         for k, a in ht.export_snapshot().items()})
        return meta

    def snapshot(self, blocking: Optional[bool] = None) -> int:
        """Snapshot epoch E+1: rotate the WAL (the capture point), host-copy
        the state, write it on the checkpointer's thread (waiting for it
        only if `blocking`).  Returns the new epoch."""
        self.ckpt.wait()                # a prior save's error surfaces here
        with obs.span("durability.snapshot", cat="durability"):
            self.epoch += 1
            self._wal.rotate(self.epoch)
            payload = _snapshot_tree(self.kv, self.kv.state, self._meta())
            blocking = (self.dcfg.blocking_snapshots if blocking is None
                        else blocking)
            epoch, t0 = self.epoch, time.perf_counter()

            def on_commit():
                # on the checkpointer's thread (the registry and the journal
                # take locks); segment GC waits for the snapshot to be
                # durable
                dt = time.perf_counter() - t0
                obs.observe("f2_checkpoint_save_seconds", dt,
                            help="snapshot capture-to-durable latency",
                            facade=self._obs_facade)
                obs.journal.emit("snapshot.committed", epoch=epoch,
                                 seconds=round(dt, 6))
                self._gc_segments()

            self.ckpt.save(self.epoch, payload, blocking=blocking,
                           on_commit=on_commit)
            self.snapshots += 1
            self._last_snap_rounds = self.kv.rounds
        obs.journal.emit("snapshot.taken", epoch=self.epoch,
                         blocking=bool(blocking))
        obs.count("f2_snapshots_total", facade=self._obs_facade)
        return self.epoch

    def maybe_snapshot(self) -> bool:
        """The cadence hook, called at batch and packed-round boundaries: a
        snapshot every `snapshot_every_rounds` routed rounds."""
        every = self.dcfg.snapshot_every_rounds
        if every <= 0 or self.kv.rounds - self._last_snap_rounds < every:
            return False
        self.snapshot()
        return True

    def _gc_segments(self):
        """Drop the WAL segments older than the newest complete snapshot:
        recovery never reads below it."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        for e in wal_epochs(self.dcfg.dir):
            if e < latest:
                os.remove(_segment_path(self.dcfg.dir, e))

    def wait(self):
        """Block until the snapshot in flight (if any) is durable."""
        self.ckpt.wait()

    def close(self):
        self.ckpt.wait()
        self._wal.close()

    # -- replica rebuild from disk (graceful degradation) ----------------------
    def rebuild_replica(self, r: int) -> int:
        """Rebuild dropped replica r from the snapshot and the WAL suffix
        instead of `resync()`'s drain: the healthy replicas serve no drain
        read and their rows stay byte-untouched.  r's rows are restored from
        the snapshot (the snapshot primary's rows if r was dead then), or
        reset to an empty store when there is no snapshot; then the WAL is
        replayed into r alone under the maps it logged.  Returns the records
        replayed into r."""
        kv = self.kv
        if not hasattr(kv, "alive"):
            raise ValueError("rebuild_replica needs a ReplicatedKV")
        r = int(r)
        if kv.alive[r]:
            raise ValueError(f"replica {r} is alive; drop it first")
        if kv._migrating:
            raise RuntimeError("rebuild_replica during a migration")
        self._wal.sync()                # the replay below reads the log
        self.ckpt.wait()
        snap_epoch = self.ckpt.latest_step()
        onehot = np.arange(kv.R) == r
        if snap_epoch is None:
            kv._reset_rows(r)
            start_map = shard_router.default_bucket_map(kv.S, kv.n_buckets)
            start_version, from_epoch = 0, 0
        else:
            # the snapshot lands on the host; one replica's rows of it go to
            # the device, into r's rows in place
            host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                            kv.state)
            meta = _meta_like(kv)
            self.ckpt.restore(_snapshot_tree(kv, host, meta), step=snap_epoch)
            snap_alive = meta["alive"].numpy().astype(bool)
            src = r if snap_alive[r] else int(np.flatnonzero(snap_alive)[0])
            st = kv.state               # gathered under a device mesh
            for dst, snap in zip(_replica_leaves(st, kv.R),
                                 _replica_leaves(host, kv.R)):
                dst[r].copy_(snap[src])
            kv.state = st
            start_map = meta["bucket_map"].numpy().astype(np.int32)
            start_version = int(meta["map_version"])
            from_epoch = int(meta["epoch"])
        # a fresh replica's telemetry, as resync() resets it
        for counts in (kv.compactions, kv.temp_table_peak_bytes,
                       *kv.compaction_counts.values()):
            counts[r] = 0
        kv._fold_read()
        for f in IoStats._fields:
            kv._read_io[f][r] = 0
        kv._read_exhausted[r] = False
        recs = read_wal(self.dcfg.dir, from_epoch=from_epoch,
                        retries=self.dcfg.segment_retries,
                        backoff=self.dcfg.retry_backoff)
        kv.alive[r] = True
        with obs.span("durability.rebuild_replica", cat="durability",
                      replica=r):
            n, end_map, _ = _replay(kv, recs, start_map, start_version,
                                    rep_mask=onehot)
        if not (end_map == kv.bucket_map).all():
            raise WalError("the WAL replay ended on another bucket map than "
                           "the live store's")
        kv.resyncs += 1
        obs.journal.emit("replica.rebuilt", facade=self._obs_facade,
                         replica=r, records=n)
        return n


def _n_writes(ops: np.ndarray) -> int:
    return int(((ops == OP_UPSERT) | (ops == OP_RMW) | (ops == OP_DELETE)).sum())


def _replay(kv, recs: List[WalRecord], start_map: np.ndarray,
            start_version: int = 0, rep_mask: Optional[np.ndarray] = None):
    """Replay WAL records onto `kv` from bucket map `start_map`.

    Full recovery (`rep_mask` None): rounds fan in to `kv.alive` as the
    logged rounds did.  Masked rebuild: `rep_mask` is the onehot of the
    replica being rebuilt; only its rows change and only they see scheduler
    passes (`_sched_rows`).

    A SLAB record replays as `apply` ran it: one routed round, then a round
    for the lanes it deferred, until none is (the same map and lanes give
    the same rounds).  A MAP record purges the moved buckets' source copies
    (`bucket_moves` of the replayed map and the record's), flips the map and
    replays the drained records: the live `migrate` without its drain,
    which the record carries.  `_migrating` is held throughout, so the
    replay is not logged again and starts no migration of its own.  Returns
    (records replayed, the map after the last record, its version)."""
    cur_map = np.asarray(start_map, np.int32).copy()
    cur_ver = int(start_version)
    live_map, live_dev = kv.bucket_map, kv._bucket_map_dev
    kv._bucket_map_dev = kv._dev(cur_map)
    rep_kw = {} if rep_mask is None else {"_rep_do": rep_mask}
    Bm = kv._mig_batch
    replayed = 0
    kv._migrating = True
    if rep_mask is not None:
        kv._sched_rows = np.repeat(np.asarray(rep_mask, bool)[:, None], kv.S, 1)
    try:
        last_seq = None
        for rec in recs:
            if last_seq is not None and rec.seq <= last_seq:
                continue                # a duplicate (overlapping segments)
            last_seq = rec.seq
            if rec.rtype == REC_SLAB:
                if rec.map_version != cur_ver:
                    raise WalError(f"SLAB record {rec.seq} was routed under map "
                                   f"version {rec.map_version}, replay is at {cur_ver}")
                keys, ops, vals = kv._coerce(rec.keys, rec.ops, rec.vals)
                cur_ops = ops
                for _ in range(len(rec.keys) + 1):
                    _, _, _, deferred = kv.apply_round(keys, cur_ops, vals,
                                                       **rep_kw)
                    if not bool(deferred.any()):
                        break
                    cur_ops = torch.where(deferred, ops, OP_NOOP).to(torch.int32)
                replayed += _n_writes(rec.ops)
            else:                       # REC_MAP: purge -> flip -> replay
                if rec.map_version != cur_ver + 1:
                    raise WalError(f"MAP record {rec.seq} flips to version "
                                   f"{rec.map_version}, replay is at {cur_ver}")
                new_map = np.asarray(rec.new_map, np.int32)
                move = shard_router.bucket_moves(cur_map, new_map, kv.S)
                if move.any():
                    mshard = move.any(axis=1)
                    do = (kv._rep_shard(mshard) if rep_mask is None else
                          np.asarray(rep_mask, bool)[:, None] & mshard[None, :])
                    kv._st = kv._map(
                        rebalance.purge_step, kv.cfg, kv.n_buckets, kv._st,
                        kv._rep_move(move), kv._dev_bool(do))
                cur_map = new_map.copy()
                cur_ver = int(rec.map_version)
                kv._bucket_map_dev = kv._dev(cur_map)
                n_moved = len(rec.keys)
                for off in range(0, n_moved, Bm):
                    ks = rec.keys[off:off + Bm]
                    pad = Bm - len(ks)
                    kv.apply(np.pad(ks, (0, pad)),
                             np.pad(rec.ops[off:off + Bm], (0, pad),
                                    constant_values=OP_NOOP),
                             np.pad(rec.vals[off:off + Bm], ((0, pad), (0, 0))),
                             **rep_kw)
                replayed += n_moved
    finally:
        if rep_mask is not None:
            kv._sched_rows = None
        kv._migrating = False
        if rep_mask is None:
            # full recovery: the replayed map is the store's map now
            kv.bucket_map = cur_map.copy()
            kv._bucket_map_dev = kv._dev(cur_map)
            kv.map_version = cur_ver
        else:
            # a masked rebuild on a live store: the live map again (the
            # caller checks that the replay ended on it)
            kv.bucket_map, kv._bucket_map_dev = live_map, live_dev
    return replayed, cur_map, cur_ver


def recover(directory: str, make_kv: Callable[[], Any],
            cfg: Optional[DurabilityConfig] = None) -> DurableKV:
    """Bring a crashed durable store back: restore the newest complete
    snapshot into a fresh store from `make_kv` (the crashed one's shape and
    device), replay the WAL suffix, check invariants, and return a
    `DurableKV` whose WAL goes on in a fresh epoch.  With no complete
    snapshot the replay starts from the empty store: the WAL holds the whole
    history.  `recovery` on the result holds the snapshot epoch, the
    records replayed and the restore and replay seconds."""
    cfg = cfg if cfg is not None else DurabilityConfig(dir=directory)
    kv = make_kv()
    if getattr(kv, "wal", "missing") is not None:
        raise ValueError("make_kv must build a store with no WAL installed")
    ckpt = Checkpointer(os.path.join(directory, "snap"), keep=cfg.keep)
    snap_epoch = ckpt.latest_step()
    t0 = time.perf_counter()
    if snap_epoch is None:
        start_map = kv.bucket_map.copy()
        from_epoch, next_seq, epoch = 0, 0, 0
    else:
        # into the fresh store's tensors, in place
        meta = _meta_like(kv)
        st = kv.state                   # gathered under a device mesh
        ckpt.restore(_snapshot_tree(kv, st, meta), step=snap_epoch,
                     resizable=_host_paths(kv))
        kv.state = st
        if getattr(kv, "_ht", None) is not None:
            kv._ht.import_snapshot({k: meta[k].numpy() for k in HOST_STORE_KEYS})
        start_map = meta["bucket_map"].numpy().astype(np.int32)
        kv.bucket_map = start_map.copy()
        kv._bucket_map_dev = kv._dev(start_map)
        kv.map_version = int(meta["map_version"])
        if hasattr(kv, "alive"):
            kv.alive = meta["alive"].numpy().astype(bool).copy()
        from_epoch = int(meta["epoch"])
        next_seq = int(meta["seq"])
        epoch = snap_epoch
    if kv.device.type == "cuda":
        torch.cuda.synchronize(kv.device)
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = read_wal(directory, from_epoch=from_epoch,
                    retries=cfg.segment_retries, backoff=cfg.retry_backoff)
    with obs.span("durability.recover", cat="durability"):
        n_replayed, _, _ = _replay(kv, recs, start_map,
                                   start_version=kv.map_version)
    obs.journal.emit("recovery.completed", records=n_replayed,
                     snapshot_epoch=snap_epoch)
    if recs:
        next_seq = max(next_seq, recs[-1].seq + 1)
    if (hasattr(kv, "alive") and cfg.revive_dead_replicas
            and not kv.alive.all()):
        # replicas dead at the snapshot: copies of the recovered primary's
        # rows (alive replicas are byte-identical, so this is what a
        # finished resync would give)
        h = int(np.flatnonzero(kv.alive)[0])
        st = kv.state                   # gathered under a device mesh
        for leaf in _replica_leaves(st, kv.R):
            for d in np.flatnonzero(~kv.alive):
                leaf[d].copy_(leaf[h])
        kv.state = st
        kv.alive[:] = True
    if kv.device.type == "cuda":
        torch.cuda.synchronize(kv.device)
    t_replay = time.perf_counter() - t0
    kv.check_invariants()

    dk = DurableKV.__new__(DurableKV)
    dk.kv = kv
    dk.dcfg = cfg
    dk.ckpt = ckpt
    # a fresh epoch: appending to the segment that fed this recovery could
    # bury new records behind its torn tail
    dk.epoch = max(wal_epochs(directory) + [epoch]) + 1
    dk.snapshots = 0
    dk.recovery = dict(snapshot_epoch=snap_epoch, records=n_replayed,
                       wal_records=len(recs), restore_s=t_restore,
                       replay_s=t_replay)
    dk._last_snap_rounds = kv.rounds
    dk._wal = WalWriter(cfg.dir, epoch=dk.epoch, seq=next_seq, fsync=cfg.fsync)
    kv.wal = dk._wal
    return dk
