"""ShardedKV: S independent F2 stores driven as one (horizontal
partitioning, the F2 paper's "more cores" scaling story on one device).

State model
-----------
The state is an `F2State` whose every leaf carries a leading shard axis
(`store.create(cfg, device, n_shards=S)`).  The store's functions take that
axis directly (see `types`): one call, and each kernel launch in it, serves
all S shards, where the reference lifts every step with `jax.vmap`.  Rows
never interact, so the store is bit-exact with S independent stores.

Batch flow
----------
`apply` routes one B-lane batch through `shard_router` into S slabs of
`lanes` lanes, runs `store.apply` over the stacked state, and gathers the
statuses and values back into lane order.  With `lanes=None` (slab width B)
every batch routes in one round.  A narrower slab defers a shard's lanes
past its capacity to follow-up rounds (rounds run in order, equal keys share
a shard, and routing is stable, so per-key order holds).

Compaction scheduler
--------------------
`maybe_compact` reads every shard's hot, cold and chunk-log bounds in one
host transfer, then runs masked passes over the shards above the trigger
(re-reading the bounds after a pass that ran, so a hot->cold pass that
pushes a cold log over its own trigger cascades in the same call).  A
masked step gives the other shards an empty frontier, which touches none of
their arrays, and keeps their scalars (`rebalance.select_shards`): an idle
shard's counters, stats and truncation markers stay byte-identical.

Live rebalancing
----------------
Keys route through a bucket -> shard map (`self.bucket_map`; the default map
routes exactly like the hash's top bits).  Each routed round counts placed
lanes per bucket on the device; `maybe_rebalance` folds them into an EWMA,
plans bucket moves past the imbalance threshold and migrates them
(`core.rebalance`).

Subclass hooks
--------------
`core.replication.ReplicatedKV` keeps R copies of the S shards in the same
row axis: `_lead_shape` is (R, S) there and row r * S + s is replica r's
shard s.  The host arrays of the scheduler (bounds, masks, `compactions`)
take `_lead_shape`; `_sched_mask` restricts a pass's rows, `_rep_shard`
and `_rep_move` lift a migration's per-shard masks to the rows, and
`_host_view` / `_client_rows` give the rows a client sees (one replica's).

Durability hooks
----------------
`core.durability.DurableKV` installs a write-ahead log as `self.wal`.  A
client batch is logged once, before its first routed round (`apply` logs
the whole batch and runs its deferral rounds with `_wal_defer` set, since
replay derives them from the batch); nothing is logged while `_migrating`
(migration and resync replay rebuild data the log already holds) or for a
round masked to some replicas (`_rep_do`, replication's rebuild).
`migrate` logs one MAP record (the new map and the drained records) before
its purge, and `map_version` counts the flips.

Host tier
---------
With `F2Config.host_tier` one `host_tier.HostTier` of S shards keeps every
shard's demoted cold chunks.  A routed round pre-faults the chunks its
slabs would touch (`store.plan_fetch` over the routed slabs) before it
runs; reads share one retry loop between router deferral and chunk misses
(`_read_host_loop`); the compactions demote for ring headroom before every
masked step, and masked cold-cold steps run the resumable protocol of
`compaction` with the idle shards' frontiers empty and their scalars kept,
so an idle shard's floor and cache clock stay still through a pass it is
not in.  Live rebalancing is refused with the tier on (a migration would
have to move host-resident chunks), as in the reference.

Observability
-------------
`repro_torch.obs` (off by default) is called at the reference's points:
`sharded.apply_round` and `sharded.read` spans, `f2_deferral_rounds{path=}`
per client batch and the `deferral` latency phase, the compactions' spans,
journal events and `f2_compactions_total`, the migration's span, journal
event and counters, and at the traffic fold (`_fold_traffic`) the router
gauges and an alert-rule pass.  Every device value it reads is one the
store reads anyway; disabled, each site is one flag check.

Dispatch
--------
`dispatch="vmap"` (the default on one device) holds every row on one
device.  `dispatch="shard_map"` partitions the row axis over a device mesh
(`resolve_mesh`: the most devices that divide S, from `devices`, by default
every visible CUDA device, or the store's own device when it runs on the
CPU); `"auto"` picks it when there is more than one device.  A mesh of P
devices holds P partitions of S/P rows, each an `F2State` on its own device
(`_Parts`), and every store step runs once per partition (`_map`): the
routed slabs split by rows, and the results come back in row order on the
first device.  No partition reads another's state.  At P = 1 the program is
the vmap program.  The list may name a device twice, which runs P > 1 on
one device (the counterpart of a forced host device count).  `state` gathers
the partitions on read and splits on write, for the layers that take the
state whole (snapshots, recovery, interop, the host tier's manager).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from . import cold_index, compaction, host_tier, rebalance, shard_router, store
from ..testing import faults
from .api import check_host_invariants, check_host_tier, resolve_device
from .rebalance import RebalanceConfig, select_shards
from .types import (BLOCK_BYTES, OP_DELETE, OP_NOOP, OP_READ, OP_RMW,
                    OP_UPSERT, F2Config, tree_map)

DISPATCHES = ("auto", "vmap", "shard_map")
COMPACTION_KINDS = ("hot_cold", "cold_cold", "single_log", "chunk_gc")


def bucket_counts(rt: shard_router.Route, n_buckets: int) -> torch.Tensor:
    """Placed lanes per bucket (int32 [n_buckets]), counted on the device:
    the rebalancer's traffic signal of one routed round."""
    bidx = torch.where(rt.placed, rt.bucket, n_buckets)
    counts = torch.zeros((n_buckets + 1,), dtype=torch.int32, device=bidx.device)
    return counts.index_add_(0, bidx, torch.ones_like(bidx))[:n_buckets]


def _bounds_of(s) -> torch.Tensor:
    return torch.stack([s.hot.begin, s.hot.tail, s.cold.begin, s.cold.tail,
                        s.cold_idx.begin, s.cold_idx.tail], dim=1)


def _cold_bounds_of(s) -> torch.Tensor:
    return torch.stack([s.cold.begin, s.cold.tail, s.cold.floor], dim=1)


def _io_of(s) -> torch.Tensor:
    return torch.stack([s.stats.read_blocks, s.stats.write_blocks,
                        s.stats.read_ops, s.stats.mem_hits], dim=1)


def _flags_of(s) -> torch.Tensor:
    """bool [rows, 4]: the invariants' overflow and exhaustion flags."""
    return torch.stack([s.hot.overflowed, s.cold.overflowed,
                        s.cold_idx.overflowed, s.walk_exhausted], dim=1)


def _chunklog_step(cfg: F2Config, old, do: torch.Tensor):
    """Masked chunk-log GC of the rows with `do`."""
    ci, stats = cold_index.compact_chunklog(old.cold_idx, cfg, old.stats, do=do)
    return select_shards(do, old._replace(cold_idx=ci, stats=stats), old)


def _hot_truncate(cfg: F2Config, old, until: torch.Tensor, do: torch.Tensor):
    return compaction.hot_truncate(cfg, old, until, do=do)


class StoreMesh(NamedTuple):
    """The devices a store's rows are partitioned over: `devices` row-major
    over `shape`, which is (P,) over the shard axis, or (replica devices,
    shard devices) over (replica, shard)."""
    devices: tuple
    shape: tuple
    axis_names: tuple


def store_devices(device: torch.device) -> list:
    """The default device list of the partitioned dispatch: every visible
    CUDA device for a CUDA store, the store's own device otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def resolve_mesh(dispatch: str, n_shards: int, devices) -> Optional[StoreMesh]:
    """None -> every row on one device (vmap); else a 1-D mesh over the
    shard axis of the most devices that divide S (1 is always valid)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    devs = [torch.device(d) for d in devices]
    if dispatch == "vmap" or (dispatch == "auto" and len(devs) == 1):
        return None
    ndev = max(d for d in range(1, min(len(devs), n_shards) + 1)
               if n_shards % d == 0)
    return StoreMesh(tuple(devs[:ndev]), (ndev,), ("shard",))


class _Parts(list):
    """A partitioned state: one `F2State` of its rows per mesh device."""


class ShardedKV:
    """`api.KV`'s operations (apply/upsert/read/rmw/delete, the compactions,
    check_invariants, io_stats, memory_model_bytes) over S hash-partitioned
    shards behind one deterministic batch router, on one device (the CUDA
    device unless `device` says otherwise)."""

    _obs_facade = "sharded"         # the label of every metric it folds
    _read_span = "sharded.read"     # the span of one routed read round
    _observe_apply = True           # write rounds spanned and counted, and
    #                                 deferral rounds timed

    def __init__(self, cfg: F2Config, n_shards: int, mode: str = "f2",
                 trigger: float = 0.8, compact_frac: float = 0.1,
                 compact_batch: int = 2048, faster_compaction: str = "scan",
                 dispatch: str = "auto", lanes: Optional[int] = None,
                 n_buckets: Optional[int] = None,
                 rebalance_cfg: Optional[RebalanceConfig] = None,
                 device=None, devices=None):
        if mode not in ("f2", "faster"):
            raise ValueError(f"unknown mode {mode!r}")
        if faster_compaction not in ("scan", "lookup"):
            raise ValueError(f"unknown faster_compaction {faster_compaction!r}")
        if not (n_shards >= 1 and (n_shards & (n_shards - 1)) == 0):
            raise ValueError(f"n_shards={n_shards} not a power of 2")
        if mode == "faster" and cfg.rc_capacity < 1:
            raise ValueError("mode='faster' needs rc_capacity >= 1")
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}")
        if device is None and devices:
            device = devices[0]
        self.device = resolve_device(device, f"repro_torch.{type(self).__name__}")
        self.cfg = cfg
        self.S = n_shards
        self.mode = mode
        self.trigger = trigger
        self.compact_frac = compact_frac
        self.compact_batch = compact_batch
        self.faster_compaction = faster_compaction
        self.lanes = lanes
        self.mesh = self._resolve_mesh(
            dispatch, store_devices(self.device) if devices is None else devices)
        self.dispatch = "vmap" if self.mesh is None else "shard_map"
        self._pp = None                 # [(rows, device)] when P > 1
        self._inv = None                # gathered order -> row order
        if self.mesh is not None:
            self.device = self.mesh.devices[0]
            if len(self.mesh.devices) > 1:
                self._partition()
        lead = self._lead_shape
        if self._pp is None:
            self._st = store.create(cfg, self.device, n_shards=self._n_rows)
        else:
            self._st = _Parts(store.create(cfg, dev, n_shards=len(r))
                              for r, dev in zip(self._partition_rows(),
                                                self.mesh.devices))
        self.compactions = np.zeros(lead, np.int64)
        self.compaction_counts = {k: np.zeros(lead, np.int64)
                                  for k in COMPACTION_KINDS}
        self.temp_table_peak_bytes = np.zeros(lead, np.int64)
        self.frontier_bytes = compact_batch * cfg.record_bytes
        self.rounds = 0                 # routed rounds executed
        self.last_occupancy = torch.zeros(n_shards, dtype=torch.int32,
                                          device=self.device)
        self._admit = mode == "f2" and cfg.rc_capacity > 1

        # -- the rebalancer (the map always exists; the default one routes
        #    exactly like the hash's top bits) --
        self.rb = rebalance_cfg
        bps = rebalance_cfg.buckets_per_shard if rebalance_cfg else 8
        self.n_buckets = n_buckets or n_shards * bps
        nb = self.n_buckets
        if not (nb >= n_shards and (nb & (nb - 1)) == 0):
            raise ValueError(f"n_buckets={nb} not a power of 2 >= n_shards")
        self.bucket_map = shard_router.default_bucket_map(n_shards, nb)
        self._bucket_map_dev = self._dev(self.bucket_map)
        self._traffic_ewma = np.zeros(nb, np.float64)
        self._routed_lanes = np.zeros(n_shards, np.int64)
        self._pending = []              # unfolded (occupancy, bucket counts)
        self.migrations = 0             # migrate() passes that moved >= 1
        self.migrated_buckets = 0
        self.migrated_records = 0
        self._migrating = False
        self._last_rb_round = 0
        self._decay = rebalance_cfg.decay if rebalance_cfg else 0.9
        self._mig_batch = (rebalance_cfg.migrate_batch if rebalance_cfg
                           else min(compact_batch, 256))
        # durability hooks (core.durability): the write-ahead log, the map
        # flips it has seen, and "inside apply's deferral rounds"
        self.wal = None
        self.map_version = 0
        self._wal_defer = False
        # the host tier: one manager for every shard's demoted chunks
        self._ht = None
        if cfg.host_tier:
            check_host_tier(cfg, mode, compact_batch)
            if rebalance_cfg is not None:
                raise ValueError(
                    "host_tier is incompatible with live rebalancing (a "
                    "bucket migration would have to move host-resident "
                    "chunks)")
            self._ht = host_tier.HostTier(cfg, self._n_rows, self.device,
                                          obs_facade=self._obs_facade)

    # -- the partitioned dispatch ----------------------------------------------
    def _resolve_mesh(self, dispatch: str, devices) -> Optional[StoreMesh]:
        return resolve_mesh(dispatch, self.S, devices)

    def _partition_rows(self) -> list:
        """The rows of each mesh device, in mesh order: S/P consecutive
        shards each."""
        n = self.S // len(self.mesh.devices)
        return [np.arange(p * n, (p + 1) * n) for p in range(len(self.mesh.devices))]

    def _partition(self):
        rows = self._partition_rows()
        self._pp = []
        for r, dev in zip(rows, self.mesh.devices):
            if np.array_equal(r, np.arange(r[0], r[0] + len(r))):
                idx = slice(int(r[0]), int(r[0]) + len(r))
            else:
                idx = torch.as_tensor(r, device=self.device)
            self._pp.append((idx, dev))
        order = np.concatenate(rows)
        if not np.array_equal(order, np.arange(len(order))):
            self._inv = torch.as_tensor(np.argsort(order), device=self.device)

    def _take(self, x, p: int, copy: bool = False):
        """Partition p's part of a row-leading argument: its rows of every
        tensor (moved to its device), its `F2State` of a partitioned state;
        anything else as it is."""
        if isinstance(x, _Parts):
            return x[p]
        rows, dev = self._pp[p]
        n = self._n_rows

        def part(t):
            if t.dim() == 0:
                return t.to(dev)
            if t.shape[0] != n:
                raise ValueError(f"a partitioned step got a tensor of shape "
                                 f"{tuple(t.shape)}; its rows must be {n}")
            out = t[rows]
            if out.device != dev:
                return out.to(dev)
            return out.clone() if copy and isinstance(rows, slice) else out
        return tree_map(part, x)

    def _cat(self, outs):
        """Per-partition results as one result in row order on the first
        device (a state stays partitioned: `_Parts`)."""
        o = outs[0]
        if isinstance(o, store.F2State):
            return _Parts(outs)
        if isinstance(o, torch.Tensor):
            t = torch.cat([x.to(self.device) for x in outs])
            return t if self._inv is None else t[self._inv]
        if isinstance(o, tuple):
            vals = [self._cat([x[i] for x in outs]) for i in range(len(o))]
            return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
        if o is None:
            return None
        raise TypeError(f"a partitioned step returned {type(o).__name__}")

    def _map(self, fn, *args, **kw):
        """`fn(*args, **kw)` once per partition, on its rows and device: every
        positional tensor is row-leading (the partitioned state passes as
        itself), keywords pass as they are; results come back by `_cat`.
        Without partitions, the call itself."""
        if self._pp is None:
            return fn(*args, **kw)
        return self._cat([fn(*(self._take(a, p) for a in args), **kw)
                          for p in range(len(self._pp))])

    @property
    def state(self) -> store.F2State:
        """The whole state: the partitions gathered in row order on the first
        device (a copy) under a multi-device mesh."""
        if self._pp is None:
            return self._st
        return self._gather(self._st)

    @state.setter
    def state(self, st):
        if self._pp is None or isinstance(st, _Parts):
            self._st = st
        else:
            self._st = _Parts(self._take(st, p, copy=True)
                              for p in range(len(self._pp)))

    def _gather(self, parts: _Parts) -> store.F2State:
        leaves = [[] for _ in parts]
        for out, st in zip(leaves, parts):
            tree_map(out.append, st)
        flat = iter([self._cat([lv[i] for lv in leaves])
                     for i in range(len(leaves[0]))])
        return tree_map(lambda _: next(flat), parts[0])

    def _rows_of_state(self, fn) -> np.ndarray:
        """`fn(state)` -> [rows, k] per store, as a host array [k, rows]."""
        return self._map(fn, self._st).cpu().numpy().T

    def _dev(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def _dev_rows(self, x) -> torch.Tensor:
        """A host array of `_lead_shape` as int32 [rows] on the device."""
        return self._dev(np.asarray(x).reshape(-1))

    def _dev_bool(self, x) -> torch.Tensor:
        """A host mask of `_lead_shape` as bool [rows] on the device."""
        return torch.as_tensor(np.asarray(x, bool).reshape(-1),
                               device=self.device)

    # -- subclass hooks (the replica axis lives in core.replication) ---------
    @property
    def _lead_shape(self) -> tuple:
        """The leading axes of the per-store host arrays: (S,) here, (R, S)
        under replication; the state folds them into one row axis."""
        return (self.S,)

    @property
    def _n_rows(self) -> int:
        return int(np.prod(self._lead_shape))

    def _sched_mask(self, rows: np.ndarray) -> np.ndarray:
        """The rows a scheduler pass may touch (replication masks out dead
        or, mid-resync, healthy replicas); all of them here."""
        return rows

    def _rep_shard(self, m: np.ndarray) -> np.ndarray:
        """A per-shard mask [S] as a mask of `_lead_shape`."""
        return m

    def _rep_move(self, move: np.ndarray) -> torch.Tensor:
        """A migration's bucket-move mask [S, n_buckets] as bool [rows,
        n_buckets] on the device."""
        return torch.as_tensor(np.asarray(move, bool), device=self.device)

    def _host_view(self, x) -> np.ndarray:
        """A host array of `_lead_shape` as the client's [S] view."""
        return np.asarray(x)

    def _client_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A device tensor [rows, ...] as the client's [S, ...] rows."""
        return x

    # -- routed steps --------------------------------------------------------
    def _lanes_of(self, B: int) -> int:
        return self.lanes or B

    def _note_round(self, occ: torch.Tensor, bcounts: torch.Tensor):
        """Record one routed round.  The count arrays stay on the device and
        are folded into the host EWMA lazily (`_fold_traffic`), so a routed
        round adds no host sync.  Migration replay rounds count as rounds
        but not as traffic."""
        self.last_occupancy = occ
        self.rounds += 1
        if self._migrating:
            return
        self._pending.append((occ, bcounts))
        if len(self._pending) >= 128:
            self._fold_traffic()

    def _fold_traffic(self):
        """Drain the queued rounds into the EWMA and the lane totals, in
        round order, with one host transfer."""
        if not self._pending:
            return
        occ = torch.stack([p[0] for p in self._pending]).cpu().numpy()
        bc = torch.stack([p[1] for p in self._pending]).cpu().numpy()
        self._pending = []
        for occ_np, bc_np in zip(occ, bc):
            self._routed_lanes += occ_np.astype(np.int64)
            self._traffic_ewma = self._decay * self._traffic_ewma + bc_np
        if obs.enabled():       # mirror the folded traffic signal
            obs.gauge_set("f2_bucket_traffic_ewma",
                          self._traffic_ewma.tolist(),
                          help="per-bucket routed-traffic EWMA",
                          facade=self._obs_facade)
            obs.gauge_set("f2_routed_lanes", self._routed_lanes.tolist(),
                          help="cumulative routed lanes per shard",
                          facade=self._obs_facade)
            obs.rules.maybe_evaluate()  # an alert pass at the fold point

    @property
    def traffic_ewma(self) -> np.ndarray:
        self._fold_traffic()
        return self._traffic_ewma.copy()

    @property
    def routed_lanes(self) -> np.ndarray:
        self._fold_traffic()
        return self._routed_lanes.copy()

    def _coerce(self, keys, ops, vals):
        keys, ops = self._dev(keys), self._dev(ops)
        if vals is None:
            vals = torch.zeros((keys.shape[0], self.cfg.value_width),
                               dtype=torch.int32, device=self.device)
        else:
            vals = self._dev(vals)
        return keys, ops, vals

    def _logs(self, rep_do) -> bool:
        """Whether a client batch goes to the write-ahead log: a WAL is
        installed, no migration or resync replays, no replica mask."""
        return self.wal is not None and not self._migrating and rep_do is None

    def _log_slab(self, keys, ops, vals):
        """One client batch's input to the WAL, as the caller gave it (host
        arrays are encoded as they are; device tensors in one copy)."""
        if vals is None:
            vals = np.zeros((len(keys), self.cfg.value_width), np.int32)
        self.wal.log_slab(keys, ops, vals, self.map_version)

    def _routed_apply(self, keys, ops, vals, rep_do=None):
        """One routed round over every shard (`rep_do` is replication's
        replica mask; a ShardedKV has none)."""
        if rep_do is not None:
            raise ValueError("_rep_do needs a ReplicatedKV")
        skeys, sops, svals, rt = shard_router.route(
            keys, ops, vals, self.S, self._lanes_of(keys.shape[0]),
            bucket_map=self._bucket_map_dev)
        if self._ht is not None:
            # pre-fault every host chunk the round would touch (routed
            # writes cannot defer mid-step, as in KV.apply)
            heads = self._map(store.fetch_heads, self.cfg, self._st, skeys, sops)
            self.state = self._ht.ensure(self.state, lambda st: store.plan_fetch(
                self.cfg, st, skeys, sops, heads))
        self._st, sst, srv = self._map(store.apply, self.cfg, self._st, skeys,
                                       sops, svals, admit_rc=self._admit)
        if self._ht is not None:
            self._ht.end_batch()
        status, rvals = shard_router.unroute(rt, sst, srv)
        self._note_round(rt.occupancy, bucket_counts(rt, self.n_buckets))
        return status, rvals, rt

    def _routed_read(self, keys, ops):
        vals = torch.zeros((keys.shape[0], self.cfg.value_width),
                           dtype=torch.int32, device=self.device)
        skeys, sops, _, rt = shard_router.route(
            keys, ops, vals, self.S, self._lanes_of(keys.shape[0]),
            bucket_map=self._bucket_map_dev)
        self._st, sst, srv = self._map(store.read_batch, self.cfg, self._st,
                                       skeys, sops == OP_READ,
                                       admit_rc=self._admit)
        status, rvals = shard_router.unroute(rt, sst, srv)
        self._note_round(rt.occupancy, bucket_counts(rt, self.n_buckets))
        return status, rvals, rt

    # -- batched operations --------------------------------------------------
    def apply_round(self, keys, ops, vals=None, _rep_do=None):
        """Exactly one routed round, then a scheduler pass.  Returns
        (status [B], vals [B, V], placed [B], deferred [B]) on the device,
        with no host sync of its own: deferred lanes did not run.  With a
        WAL, the round's input is logged first (write-ahead) unless `apply`
        logged its batch already.  `_rep_do` (bool [R]) is replication's
        replica mask."""
        if self._logs(_rep_do) and not self._wal_defer:
            self._log_slab(keys, ops, vals)
        keys, ops, vals = self._coerce(keys, ops, vals)
        span = (obs.span("sharded.apply_round", cat="serve",
                         B=int(keys.shape[0]))
                if self._observe_apply else obs.NOOP_SPAN)
        with span:
            status, rvals, rt = self._routed_apply(keys, ops, vals, _rep_do)
            self.maybe_compact()
        return status, rvals, rt.placed, rt.deferred

    def _note_rounds(self, n_rounds: int, path: str, t_defer=None):
        """A client batch's routed rounds into `f2_deferral_rounds{path=}`,
        and the time from its first deferral to its end into the `deferral`
        phase (`t_defer`: when round 1 left lanes deferred)."""
        if t_defer is not None:
            obs.observe_phase("deferral", time.perf_counter() - t_defer)
        obs.observe("f2_deferral_rounds", n_rounds, buckets=obs.COUNT_BUCKETS,
                    help="routed rounds needed per client batch",
                    facade=self._obs_facade, path=path)

    def _rounds(self, keys, ops, one_round, redo_op, path):
        """Route rounds until no lane is deferred; results in lane order
        (a lane's from the round that placed it: the first round's results
        hold ST_NONE and zeros for every lane it deferred).  The results
        merge on the device; a round's one host read is whether any lane is
        still deferred.  The rounds are observed under `path` (None: not
        observed)."""
        status, rvals, _, deferred = one_round(ops)
        n_rounds, t_defer = 1, None
        for _ in range(keys.shape[0]):    # each round places >= 1 lane
            if not bool(deferred.any()):
                break
            if (t_defer is None and path and self._observe_apply
                    and obs.enabled()):
                t_defer = time.perf_counter()
            cur_ops = torch.where(deferred, redo_op, OP_NOOP).to(torch.int32)
            st_r, rv_r, placed, deferred = one_round(cur_ops)
            n_rounds += 1
            status = torch.where(placed, st_r, status)
            rvals = torch.where(placed[:, None], rv_r, rvals)
        if path:
            self._note_rounds(n_rounds, path, t_defer)
        return status, rvals

    def apply(self, keys, ops, vals=None, _rep_do=None):
        """Route, execute, gather back.  With lanes=None this is one round
        (bit-exact with one `store.apply` per shard); with a narrower slab,
        deferred lanes run in follow-up rounds, each followed by a scheduler
        pass.  With a WAL the batch is logged once, before its first round:
        the map holds still until the rebalance check, which runs once,
        after the batch, so replay derives the deferral rounds from it."""
        B = len(keys)
        if self.lanes is None or self.lanes >= B:
            status, rvals, _, _ = self.apply_round(keys, ops, vals, _rep_do)
            if self._observe_apply:
                self._note_rounds(1, "apply")
        else:
            if self._logs(_rep_do):
                self._log_slab(keys, ops, vals)
            keys, ops, vals = self._coerce(keys, ops, vals)
            self._wal_defer = True
            try:
                status, rvals = self._rounds(
                    keys, ops,
                    lambda o: self.apply_round(keys, o, vals, _rep_do), ops,
                    "apply" if self._observe_apply else None)
            finally:
                self._wal_defer = False
        self.maybe_rebalance()
        return status, rvals

    def upsert(self, keys, vals):
        return self.apply(keys, np.full(len(keys), OP_UPSERT, np.int32), vals)

    def read(self, keys):
        """Routed read-only batch (`store.read_batch` over the slabs: no
        write engine and no scheduler pass; read-cache admission still
        updates the state, as in `KV.read`)."""
        keys = self._dev(keys)
        B = keys.shape[0]
        ops = torch.full((B,), OP_READ, dtype=torch.int32, device=self.device)

        if self._ht is not None:
            return self._read_host_loop(keys, ops)

        def one_round(cur_ops):
            with obs.span(self._read_span, cat="serve", B=B):
                st, rv, rt = self._routed_read(keys, cur_ops)
            return st, rv, rt.placed, rt.deferred
        if self.lanes is None or self.lanes >= B:
            status, rvals = one_round(ops)[:2]
            self._note_rounds(1, "read")
            return status, rvals
        return self._rounds(keys, ops, one_round, OP_READ, "read")

    def _read_host_loop(self, keys, cur_ops):
        """Routed reads under the host tier: router deferral and chunk misses
        share one retry loop.  A placed lane whose cold walk parked on an
        absent chunk comes back unserved; the parked chunks are promoted
        (partial, pinned) and only the unserved lanes run again.  A batch
        whose pinned walks outgrow the cache splits into two retried halves
        (`note_contract_split`); a one-lane batch raises `CacheThrash`."""
        ht = self._ht
        B = keys.shape[0]
        n_active = int((cur_ops == OP_READ).sum())
        status = torch.zeros((B,), dtype=torch.int32, device=self.device)
        rvals = torch.zeros((B, self.cfg.value_width), dtype=torch.int32,
                            device=self.device)
        vals0 = torch.zeros((B, self.cfg.value_width), dtype=torch.int32,
                            device=self.device)
        n_rounds, t_defer = 0, None
        for _ in range(B + ht.max_rounds + 8):
            with obs.span(self._read_span, cat="serve", B=B):
                skeys, sops, _, rt = shard_router.route(
                    keys, cur_ops, vals0, self.S, self._lanes_of(B),
                    bucket_map=self._bucket_map_dev)
                self._st, sst, srv, smissed = self._map(
                    store.read_batch_host, self.cfg, self._st, skeys,
                    sops == OP_READ, admit_rc=self._admit)
                st_r, rv_r = shard_router.unroute(rt, sst, srv)
                lane_miss, _ = shard_router.unroute(rt, smissed, srv)
                self._note_round(rt.occupancy,
                                 bucket_counts(rt, self.n_buckets))
            n_rounds += 1
            hmiss = rt.placed & (lane_miss >= 0)
            served = rt.placed & ~hmiss
            status = torch.where(served, st_r, status)
            rvals = torch.where(served[:, None], rv_r, rvals)
            redo = rt.deferred | hmiss
            if not bool(redo.any()):
                break
            if t_defer is None and obs.enabled():
                t_defer = time.perf_counter()
            needs = ht.collect(smissed)
            if ht.any_missing(needs):
                try:
                    self.state = ht.promote(self.state, needs, partial=True)
                except host_tier.CacheThrash:
                    if n_active <= 1:
                        raise
                    unserved = torch.nonzero(redo).flatten().cpu().numpy()
                    ht.end_batch()
                    ht.note_contract_split()
                    parts = (np.array_split(unserved, 2)
                             if len(unserved) > 1 else [unserved])
                    for half in parts:
                        hmask = np.zeros(B, np.bool_)
                        hmask[half] = True
                        hj = torch.as_tensor(hmask, device=self.device)
                        st_h, rv_h = self._read_host_loop(
                            keys, torch.where(hj, OP_READ, OP_NOOP
                                              ).to(torch.int32))
                        status = torch.where(hj, st_h, status)
                        rvals = torch.where(hj[:, None], rv_h, rvals)
                    self._note_rounds(n_rounds, "read", t_defer)
                    return status, rvals
            cur_ops = torch.where(redo, OP_READ, OP_NOOP).to(torch.int32)
        else:
            raise RuntimeError(
                "host tier: sharded read deferral did not converge")
        ht.end_batch()
        self._note_rounds(n_rounds, "read", t_defer)
        return status, rvals

    def rmw(self, keys, deltas):
        return self.apply(keys, np.full(len(keys), OP_RMW, np.int32), deltas)

    def delete(self, keys):
        return self.apply(keys, np.full(len(keys), OP_DELETE, np.int32))

    # -- vectorized pressure scheduler ---------------------------------------
    def _bounds(self):
        """(hot begin, hot tail, cold begin, cold tail, chunk-log begin,
        chunk-log tail) of every store, int64 of `_lead_shape` each, in one
        transfer."""
        b = self._rows_of_state(_bounds_of)
        return list(b.astype(np.int64).reshape((6,) + self._lead_shape))

    def hot_fills(self) -> np.ndarray:
        hb, ht, *_ = self._bounds()
        return (ht - hb) / self.cfg.hot_capacity

    def cold_fills(self) -> np.ndarray:
        _, _, cb, ct, *_ = self._bounds()
        return (ct - cb) / self.cfg.cold_capacity

    def chunklog_fills(self) -> np.ndarray:
        *_, ib, it = self._bounds()
        return (it - ib) / self.cfg.chunklog_capacity

    def hot_fill(self) -> float:        # KV-facade scalar: the fullest shard
        return float(self.hot_fills().max())

    def cold_fill(self) -> float:
        return float(self.cold_fills().max())

    def chunklog_fill(self) -> float:
        return float(self.chunklog_fills().max())

    def maybe_compact(self):
        """Every shard's occupancy of all three tiers in one host read, then
        masked passes over exactly the shards above the trigger; bounds are
        re-read after a pass that ran, so cascades fire in the same call."""
        hb, ht, cb, ct, ib, it = self._bounds()
        hot_over = (ht - hb) / self.cfg.hot_capacity > self.trigger
        if self.mode == "faster":
            if hot_over.any():
                self.compact_single_log(shards=hot_over)
            return
        if hot_over.any():
            self.compact_hot_cold(shards=hot_over)
            _, _, cb, ct, ib, it = self._bounds()
        # under the host tier cold-cold GC fires on the span against the host
        # log budget (demotion handles ring pressure), as in KV
        cold_budget = self.cfg.cold_capacity * (
            self.cfg.host_log_factor if self._ht is not None else 1.0)
        cold_over = (ct - cb) / cold_budget > self.trigger
        if cold_over.any():
            self.compact_cold_cold(shards=cold_over)
            *_, ib, it = self._bounds()
        chunk_over = self._sched_mask(
            (it - ib) / self.cfg.chunklog_capacity > self.trigger)
        if chunk_over.any():
            self.compact_chunklog(shards=chunk_over)

    def compact_chunklog(self, shards: Optional[np.ndarray] = None):
        """Masked chunk-log GC: relocate the selected shards' live chunks out
        of the oldest half of their chunk logs."""
        shards = self._sched_mask(np.ones(self._lead_shape, bool)
                                  if shards is None else np.asarray(shards, bool))
        n_sh = int(shards.sum())
        with obs.span("compact.chunk_gc", cat="compaction", shards=n_sh):
            self._st = self._map(_chunklog_step, self.cfg, self._st,
                                 self._dev_bool(shards))
        self.compaction_counts["chunk_gc"] += shards
        self._note_compaction("chunk_gc", n_sh)

    def _note_compaction(self, kind: str, n_sh: int):
        obs.journal.emit(f"compaction.{kind}", facade=self._obs_facade,
                         shards=n_sh)
        obs.count("f2_compactions_total", facade=self._obs_facade, kind=kind)

    def _regions(self, begins, tails, n_records, shards):
        """Per-shard compaction region sizes, as `KV._region` (0 where a
        shard is not selected)."""
        avail = np.maximum(tails - begins, 0)
        if n_records is None:
            n = np.maximum(np.minimum(
                (avail * self.compact_frac).astype(np.int64), avail),
                self.compact_batch)
        else:
            n = np.full(begins.shape, int(n_records), np.int64)
        return np.where(shards, np.minimum(n, avail), 0)

    def _masked_steps(self, step, begins, n, shards):
        """ceil(max n / compact_batch) masked step calls (the copying phase):
        shard j runs in call i iff begins[j] + i*cb is inside its region.
        Returns (until [S] on the device, per-shard live totals)."""
        until_np = begins + n
        until = self._dev_rows(until_np)
        cb = self.compact_batch
        n_steps = int(-(-int(n.max()) // cb)) if n.max() > 0 else 0
        live = torch.zeros(self._n_rows, dtype=torch.int64, device=self.device)
        for i in range(n_steps):
            starts_np = begins + i * cb
            do = self._dev_bool(shards & (starts_np < until_np))
            starts = self._dev_rows(starts_np)
            if self._ht is not None:
                # a step appends <= compact_batch cold records a shard: keep
                # that much ring headroom by demoting first (every shard, as
                # the reference's demotion check)
                self.state = self._ht.demote_if_needed(
                    self.state, cb + self.cfg.host_chunk_records)
            old = self._st
            new, n_live = self._map(step, self.cfg, old, starts,
                                    torch.where(do, until, starts), cb)
            self._st = self._map(select_shards, do, new, old)
            live += torch.where(do, n_live, 0)
        return until, live.cpu().numpy().reshape(self._lead_shape)

    def _truncate(self, tier, until, shards):
        """The truncation phase on the selected shards (the hot one masks
        its index writes; the cold one writes scalars only)."""
        do = self._dev_bool(shards)
        old = self._st
        if tier == "hot":
            new = self._map(_hot_truncate, self.cfg, old, until, do)
        else:
            new = self._map(compaction.cold_truncate, self.cfg, old, until)
        self._st = self._map(select_shards, do, new, old)

    def _region(self, shards, n_records, tier):
        """(begins [S], region sizes [S], shard mask) of one log tier."""
        b = self._bounds()
        begins, tails = (b[0], b[1]) if tier == "hot" else (b[2], b[3])
        shards = self._sched_mask(np.ones(self._lead_shape, bool)
                                  if shards is None else np.asarray(shards, bool))
        return begins, self._regions(begins, tails, n_records, shards), shards

    def compact_hot_cold(self, n_records: Optional[int] = None,
                         shards: Optional[np.ndarray] = None):
        begins, n, shards = self._region(shards, n_records, "hot")
        n_sh = int(shards.sum())
        with obs.span("compact.hot_cold", cat="compaction", shards=n_sh):
            until, _ = self._masked_steps(compaction.hot_cold_step, begins, n,
                                          shards)
            self._truncate("hot", until, shards)
        self.compactions += shards
        self.compaction_counts["hot_cold"] += shards
        self._note_compaction("hot_cold", n_sh)

    def compact_cold_cold(self, n_records: Optional[int] = None,
                          shards: Optional[np.ndarray] = None):
        begins, n, shards = self._region(shards, n_records, "cold")
        n_sh = int(shards.sum())
        with obs.span("compact.cold_cold", cat="compaction", shards=n_sh):
            if self._ht is None:
                until, _ = self._masked_steps(compaction.cold_cold_step,
                                              begins, n, shards)
            else:
                until = self._cc_steps_host(begins, n, shards)
            self._truncate("cold", until, shards)
            if self._ht is not None:
                self._ht.end_batch()
                self.state = self._ht.gc(self.state)
        self.compactions += shards
        self.compaction_counts["cold_cold"] += shards
        self._note_compaction("cold_cold", n_sh)

    def _cc_steps_host(self, begins, n, shards):
        """The masked cold-cold copying phase under the host tier, step by
        step: demote for headroom, pin and ensure each live shard's frontier
        chunks, drain the resumable liveness walk (parked chunks promote
        partially, unpinned), commit.  Idle shards get an empty frontier
        and keep their scalars (`select_shards`).  Returns until [S]."""
        ht, cfg, cb = self._ht, self.cfg, self.compact_batch
        until_np = begins + n
        until = self._dev_rows(until_np)
        n_steps = int(-(-int(n.max()) // cb)) if n.max() > 0 else 0
        shift = host_tier.chunk_shift(cfg)
        for i in range(n_steps):
            starts_np = begins + i * cb
            do_np = shards & (starts_np < until_np)
            do = self._dev_bool(do_np)
            sj = self._dev_rows(starts_np)
            uj = torch.where(do, until, sj)          # idle shards: empty
            ht.end_batch()
            self.state = ht.demote_if_needed(self.state,
                                             cb + cfg.host_chunk_records)
            # pin each live shard's below-floor frontier chunks: the commit
            # reads the frontier again after unpinned walk promotions
            cbg, ctl, cfl = self._rows_of_state(_cold_bounds_of).astype(np.int64)
            pins = []
            for s in range(self._n_rows):
                lo = max(int(starts_np[s]), int(cbg[s]))
                hi = min(int(until_np[s]), int(ctl[s]),
                         int(starts_np[s]) + cb, int(cfl[s]))
                pins.append(set(range(lo >> shift, ((hi - 1) >> shift) + 1))
                            if do_np[s] and lo < hi else set())
            ht.pin_chunks(pins)
            self.state = ht.ensure(self.state, lambda st: compaction.
                                   plan_cc_frontier(cfg, st, sj, uj, cb))
            carry = self._map(compaction.cc_walk_init, cfg, self._st, sj, uj, cb)
            for r in range(cb * cfg.chain_max + 9):
                if r:
                    needs = ht.collect(carry.missed)
                    if not ht.any_missing(needs):
                        break
                    self.state = ht.promote(self.state, needs, partial=True,
                                            pin=False)
                old = self._st
                new, carry = self._map(compaction.cc_walk_round, cfg, old, sj,
                                       uj, carry, cb)
                self._st = self._map(select_shards, do, new, old)
            else:
                raise RuntimeError("host tier: cold-cold walk did not converge")
            old = self._st
            new, _ = self._map(compaction.cc_commit, cfg, old, sj, uj, carry, cb)
            self._st = self._map(select_shards, do, new, old)
        return until

    def compact_single_log(self, n_records: Optional[int] = None,
                           shards: Optional[np.ndarray] = None):
        begins, n, shards = self._region(shards, n_records, "hot")
        n_sh = int(shards.sum())
        charge = self.faster_compaction == "lookup"

        def step(cfg, state, start, until, B):
            return compaction.single_log_lookup_step(
                cfg, state, start, until, B, charge_walk_io=charge)
        with obs.span("compact.single_log", cat="compaction", shards=n_sh):
            until, live_total = self._masked_steps(step, begins, n, shards)
            if self.faster_compaction == "scan":
                do = self._dev_bool(shards)
                old = self._st
                self._st = self._map(
                    select_shards, do,
                    self._map(compaction.charge_full_scan, self.cfg, old), old)
                self.temp_table_peak_bytes = np.maximum(
                    self.temp_table_peak_bytes,
                    np.where(shards, live_total * (self.cfg.record_bytes + 16),
                             0))
            self._truncate("hot", until, shards)
        self.compactions += shards
        self.compaction_counts["single_log"] += shards
        self._note_compaction("single_log", n_sh)

    # -- live rebalancing (core.rebalance) -----------------------------------
    def shard_stats(self) -> rebalance.ShardStats:
        """Per-shard fills and record counts, per-bucket traffic EWMA, and
        the max/mean imbalance under the current map."""
        hb, ht, cb, ct, ib, it = self._bounds()
        load = rebalance.shard_loads(self.traffic_ewma, self.bucket_map,
                                     self.S)
        view = self._host_view
        return rebalance.ShardStats(
            hot_fill=view((ht - hb) / self.cfg.hot_capacity),
            cold_fill=view((ct - cb) / self.cfg.cold_capacity),
            chunklog_fill=view((it - ib) / self.cfg.chunklog_capacity),
            records=view((ht - hb) + (ct - cb)),
            occupancy=self.last_occupancy.cpu().numpy().astype(np.int64),
            routed_lanes=self.routed_lanes,
            traffic_ewma=self.traffic_ewma,
            shard_traffic=load,
            imbalance=rebalance.imbalance_of(load),
            bucket_map=self.bucket_map.copy(),
        )

    def stats(self) -> dict:
        """The nested telemetry tree (`core.protocol`): `io` (KV.io_stats
        totals) and `shards` (`replicas` under replication, `sessions`
        through the session service), folded through the metrics registry
        when observability is on (`obs.fold_stats`)."""
        return obs.fold_stats(self._obs_facade, self._stats_tree())

    def _stats_tree(self) -> dict:
        """The raw nested telemetry tree `stats()` folds."""
        t = dict(
            io=self.io_stats(),
            shards=dict(
                n_shards=self.S, rounds=self.rounds,
                **self.shard_stats().to_dict(),
                compactions=self.compactions.tolist(),
                migrations=self.migrations,
                migrated_buckets=self.migrated_buckets,
                migrated_records=self.migrated_records))
        if self._ht is not None:
            t["host"] = self._ht.stats()
        return t

    def maybe_rebalance(self) -> bool:
        """Every `check_every` routed rounds, plan bucket moves from the
        traffic EWMA and migrate them when the imbalance crossed the
        threshold; a balanced store is left byte-identical."""
        rb = self.rb
        if rb is None or not rb.enabled or self._migrating or self.S == 1:
            return False
        if self.rounds - self._last_rb_round < rb.check_every:
            return False
        self._last_rb_round = self.rounds
        new_map = rebalance.plan_moves(
            self.traffic_ewma, self.bucket_map, self.S,
            threshold=rb.threshold, max_moves=rb.max_moves,
            min_traffic=rb.min_traffic,
            fill=self._fill_signal() if rb.fill_weight > 0 else None,
            fill_weight=rb.fill_weight)
        if new_map is None:
            return False
        self.migrate(new_map)
        return True

    def _fill_signal(self) -> np.ndarray:
        hb, ht, cb, ct, *_ = self._bounds()
        return self._host_view((ht - hb) + (ct - cb)).astype(np.float64)

    def rebalance(self, new_map: Optional[np.ndarray] = None,
                  threshold: Optional[float] = None) -> int:
        """Migrate to an explicit map, or to one planned from the current
        traffic; returns the records moved (0 when balanced)."""
        if new_map is None:
            rb = self.rb
            fw = rb.fill_weight if rb else 0.0
            new_map = rebalance.plan_moves(
                self.traffic_ewma, self.bucket_map, self.S,
                threshold=(threshold if threshold is not None
                           else rb.threshold if rb else 1.25),
                max_moves=rb.max_moves if rb else 0,
                min_traffic=rb.min_traffic if rb else 0.0,
                fill=self._fill_signal() if fw > 0 else None,
                fill_weight=fw)
            if new_map is None:
                return 0
        return self.migrate(new_map)

    def migrate(self, new_map: np.ndarray) -> int:
        """Live bucket migration: drain -> (scheduler pass) -> purge ->
        flip -> replay.  Shards with no moving bucket stay byte-identical.
        Returns the number of records replayed into their new shards."""
        if self._ht is not None:
            raise ValueError("host_tier does not support live bucket migration")
        new_map = np.asarray(new_map, np.int32)
        if new_map.shape != (self.n_buckets,):
            raise ValueError(f"bucket map of shape {new_map.shape}, expected "
                             f"({self.n_buckets},)")
        if not ((new_map >= 0) & (new_map < self.S)).all():
            raise ValueError("bucket map names a shard outside [0, S)")
        changed = np.flatnonzero(new_map != self.bucket_map)
        if changed.size == 0:
            return 0
        move_np = shard_router.bucket_moves(self.bucket_map, new_map, self.S)
        do = self._rep_shard(move_np.any(axis=1))
        move = self._rep_move(move_np)
        Bm = self._mig_batch
        V = self.cfg.value_width
        cfg, nb = self.cfg, self.n_buckets
        self._migrating = True
        mig_span = obs.span("rebalance.migrate", cat="rebalance",
                            buckets=int(changed.size))
        mig_span.__enter__()
        try:
            # drain the cold then the hot log of the source shards, so the
            # replay puts hot versions after cold ones
            hb, ht, cb, ct, *_ = self._bounds()
            parts = []
            for tier, begins, tails in (("cold", cb, ct), ("hot", hb, ht)):
                n = np.where(do, tails - begins, 0)
                until = self._dev_rows(tails)
                n_steps = int(-(-int(n.max()) // Bm)) if n.max() > 0 else 0
                for i in range(n_steps):
                    starts = begins + i * Bm
                    sdo = self._dev_bool(do & (starts < begins + n))
                    sj = self._dev_rows(starts)
                    if tier == "cold":
                        self._st, k, v, took = self._map(
                            rebalance.drain_cold_step, cfg, Bm, nb, self._st,
                            sj, until, move, sdo)
                        tomb = None
                    else:
                        self._st, k, v, tomb, took = self._map(
                            rebalance.drain_hot_step, cfg, Bm, nb, self._st,
                            sj, until, move, sdo)
                    parts += self._collect(k, v, tomb, took)
            # a pending pressure pass may interleave: the drained snapshot
            # stays valid (compaction copies live records and truncates), and
            # the purge below sweeps whole arrays by bucket
            self.maybe_compact()
            if parts:
                keys_all = np.concatenate([p[0] for p in parts])
                vals_all = np.concatenate([p[1] for p in parts])
                ops_all = np.concatenate([p[2] for p in parts])
            else:
                keys_all = np.zeros(0, np.int32)
                vals_all = np.zeros((0, V), np.int32)
                ops_all = np.zeros(0, np.int32)
            n_moved = len(keys_all)
            # one MAP record (new map and drained records under one CRC) is
            # durable before the destructive purge: recovery replays all of
            # the migration or, from a torn record, none of it
            if self.wal is not None:
                self.wal.log_map(new_map, self.map_version + 1, keys_all,
                                 ops_all, vals_all)
            # purge the source copies, then flip the indirection
            self._st = self._map(rebalance.purge_step, cfg, nb, self._st, move,
                                 self._dev_bool(do))
            self.bucket_map = new_map.copy()
            self._bucket_map_dev = self._dev(self.bucket_map)
            self.map_version += 1
            faults.maybe_crash("migrate.after_flip")
            # replay as ordinary routed writes, which now land on the
            # destination shards
            for off in range(0, n_moved, Bm):
                ks = keys_all[off:off + Bm]
                pad = Bm - len(ks)
                self.apply(np.pad(ks, (0, pad)),
                           np.pad(ops_all[off:off + Bm], (0, pad),
                                  constant_values=OP_NOOP),
                           np.pad(vals_all[off:off + Bm], ((0, pad), (0, 0))))
        finally:
            self._migrating = False
            mig_span.__exit__(None, None, None)
        self.migrations += 1
        self.migrated_buckets += int(changed.size)
        self.migrated_records += n_moved
        obs.journal.emit("rebalance.migrated", facade=self._obs_facade,
                         buckets=int(changed.size), records=n_moved,
                         map_version=self.map_version)
        obs.count("f2_migrations_total", facade=self._obs_facade)
        obs.count("f2_migrated_records_total", n_moved,
                  facade=self._obs_facade)
        return n_moved

    def _collect(self, k, v, tomb, took) -> list:
        """The drained lanes of one drain step as [(keys, vals, ops)] numpy
        parts (none when nothing was taken), from the client's rows, in flat
        [S, B] order as the reference takes them."""
        took = self._client_rows(took)
        s, w = took.nonzero(as_tuple=True)
        if s.numel() == 0:
            return []
        k_np = self._client_rows(k)[s, w].cpu().numpy()
        v_np = self._client_rows(v)[s, w].cpu().numpy()
        if tomb is None:
            ops_np = np.full(len(k_np), OP_UPSERT, np.int32)
        else:
            ops_np = np.where(self._client_rows(tomb)[s, w].cpu().numpy(),
                              OP_DELETE, OP_UPSERT).astype(np.int32)
        return [(k_np, v_np, ops_np)]

    # -- reporting ------------------------------------------------------------
    def _io(self) -> np.ndarray:
        return self._rows_of_state(_io_of).astype(np.int64)

    def io_stats(self) -> dict:
        """KV-compatible totals over all shards."""
        rb, wb, ro, mh = self._io()
        return dict(read_bytes=int(rb.sum()) * BLOCK_BYTES,
                    write_bytes=int(wb.sum()) * BLOCK_BYTES,
                    read_ops=int(ro.sum()), mem_hits=int(mh.sum()))

    def io_stats_per_shard(self) -> dict:
        """Per store, nested as `_lead_shape`."""
        rb, wb, ro, mh = (x.reshape(self._lead_shape) for x in self._io())
        return dict(read_bytes=(rb * BLOCK_BYTES).tolist(),
                    write_bytes=(wb * BLOCK_BYTES).tolist(),
                    read_ops=ro.tolist(), mem_hits=mh.tolist())

    def memory_model_bytes(self) -> dict:
        c = self.cfg
        f2 = self.mode == "f2"
        per = dict(
            hot_index=c.hot_index_size * 8,
            hot_log_mem=c.hot_mem * c.record_bytes,
            read_cache=(c.rc_capacity if f2 else 0) * c.record_bytes,
            cold_log_mem=(c.cold_mem if f2 else 0) * c.record_bytes,
            chunk_index=(c.n_chunks if f2 else 0) * 8,
            chunklog_mem=(c.chunklog_mem if f2 else 0) * c.chunk_bytes,
        )
        if c.host_tier:
            per["host_chunk_cache"] = (c.host_cache_chunks * c.host_chunk_records
                                       * 4 * (3 + c.value_width))
        out = {k: v * self.S for k, v in per.items()}
        out["total"] = sum(out.values())
        if self._ht is not None:
            # the host store is not device memory: reported, not totalled
            out["host_store_bytes"] = self._ht.host_bytes()
        return out

    def check_invariants(self):
        """Every invariant of `KV.check_invariants`, per shard."""
        flags = self._rows_of_state(_flags_of)
        hb, ht, cb, ct, *_ = self._bounds()
        for s in range(self.S):
            for bad, what in zip(flags[:, s], (
                    "hot log ring overflow", "cold log ring overflow",
                    "chunk log overwrote live chunk",
                    "hash chain exceeded chain_max")):
                if bad:
                    raise AssertionError(f"shard {s}: {what}")
            if hb[s] > ht[s] or cb[s] > ct[s]:
                raise AssertionError(f"shard {s}: log BEGIN passed TAIL")
        if self.cfg.host_tier:
            check_host_invariants(self.cfg, self.state)
