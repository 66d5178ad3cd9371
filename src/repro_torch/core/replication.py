"""ReplicatedKV: R replicas of the S shards of `ShardedKV`, with fan-in
writes, fan-out reads and live replica resync (the JAX package's
`core/replication.py`).

State model
-----------
The replica axis folds into the shard axis: the state is one stacked
`F2State` of R*S stores (`create`), row r * S + s holding replica r's shard
s, so every leaf reads as [R, S, ...] through a view (`replicated_view`).
The store's functions and the three store kernels take the R*S rows as
they take S shards: a routed round is one `store.apply` over all of them,
one call of each kernel, with no loop over replicas.

Write fan-in
------------
A batch routes once (one bucket map for every replica) into [S, W] slabs,
which repeat over the replicas; every selected replica applies the same
slabs, so alive replicas stay byte-identical, and results come from the
primary (the lowest selected replica).  A replica that is not selected (a
dropped one, or every healthy one while `resync` replays into another)
gets NOOP slabs, which touch no array row, and keeps its per-store scalars
(`rebalance.select_shards`): its state stays byte-identical.  (The
reference applies every replica and selects the old state back; the port
updates its arrays in place, so the old state is not there to select.)

Read fan-out
------------
`read` gives each lane one alive replica (`shard_router.assign_replicas`:
round robin, or least loaded by the replicas' read-load EWMA) and routes
the batch once into R*S rows, each lane to row `replica * S + shard` at its
rank among that row's lanes: the slab the reference's per-replica route
gives it.  One `store.read_batch(admit_rc=False)` over the rows serves the
batch; it writes no array, and its returned state is discarded, so reads
never desync replicas.  The I/O it charged (new stats minus old) and its
chain-walk exhaustion are folded into host-side per-replica records.

Replica lifecycle
-----------------
`drop_replica(r)` takes r out of serving: reads skip it and fan-in leaves
it alone.  `resync(r)` rebuilds it live: r's rows are reset to a fresh
store in place, the primary's cold then hot log are drained by the
compaction liveness walk (pure: the drains change only stats, which are
discarded), and the live records are replayed into r alone, with the
scheduler restricted to r.  The reference replays them in batches, which
mostly fill one shard's slab a round; the port gives every shard of r its
next slab of that schedule each round (`replay_plan`, `_replay`), with the
same result in about 1/S of the rounds.  Healthy replicas stay
byte-identical throughout; the resynced one is logically equal (its log
layout is compacted).  Rebalancing flips the one shared bucket map; drain,
purge and replay run on the alive replicas.

Durability
----------
`apply_round(..., _rep_do=onehot)` and `apply(..., _rep_do=onehot)` run a
round on the selected replicas only and log nothing:
`durability.DurableKV.rebuild_replica` replays the WAL into one replica
through them, with `_sched_rows` restricting the scheduler to its rows.

Refused, as in the reference: the host tier (`host_tier=True`: its chunk
stores would need a replica axis, and resync would have to carry them).  Not ported:
`dispatch="shard_map"` (ROADMAP item 15; `resolve_mesh_2d`).

Observability (`repro_torch.obs`, off by default), at the reference's
points: `replicated.read` spans and `f2_deferral_rounds{path=read}` (a
fan-in round has no span and no count, as in the reference), the fan-out
gauges at `_fold_read` (`f2_replica_load`, `f2_fanout_*_total`),
`replica.dropped` / `replica.resynced` events with their counters and the
`replica.resync` span.  The resync's replay runs fewer rounds than the
reference's (see above), so its scheduler passes, which the reference runs
round by round, are grouped otherwise: the `compaction.*` events and
`f2_compactions_total` increments inside a resync differ, the per-row
compaction counts do not.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from . import rebalance, shard_router, store
from ..testing import faults
from .rebalance import select_shards
from .sharded import ShardedKV, bucket_counts
from .types import BLOCK_BYTES, OP_NOOP, OP_READ, F2Config, IoStats, tree_map


def create(cfg: F2Config, device, n_replicas: int, n_shards: int
           ) -> store.F2State:
    """R * S empty stores on one row axis (row r * S + s)."""
    return store.create(cfg, device, n_shards=n_replicas * n_shards)


def _leaves(state) -> list:
    out = []
    tree_map(out.append, state)
    return out


def replicated_view(state: store.F2State, n_replicas: int) -> store.F2State:
    """The state with every leaf viewed as [R, S, ...] (views, no copy)."""
    def view(t):
        return t.view((n_replicas, t.shape[0] // n_replicas) + t.shape[1:])
    return tree_map(view, state)


def replicas_byte_identical(kv: "ReplicatedKV", replicas=None) -> bool:
    """True iff the given replicas (default: the alive ones) are equal on
    every state leaf, compared on the device."""
    reps = (list(np.flatnonzero(kv.alive)) if replicas is None
            else [int(r) for r in replicas])
    if len(reps) < 2:
        return True
    for leaf in _leaves(replicated_view(kv.state, kv.R)):
        if not all(torch.equal(leaf[reps[0]], leaf[r]) for r in reps[1:]):
            return False
    return True


def replay_plan(shard: np.ndarray, batch: int, lanes: int, n_shards: int):
    """The reference's replay schedule of records (their shards in stream
    order): batches of `batch` records, a batch's records of shard s in
    slabs of `lanes` in order, slab j of every shard in the batch's round j.
    Returns (slabs, idle, n_rounds, last): per shard its slabs in order (record
    indices) and the rounds it sits idle after each, the total round count,
    and the last round's lanes per shard."""
    n = len(shard)
    at = np.arange(n)
    grp = (at // batch) * n_shards + shard
    order = np.argsort(grp, kind="stable")
    g = grp[order]
    first = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    rank = at - np.repeat(first, np.diff(np.r_[first, n]))
    slab = np.empty(n, np.int64)
    slab[order] = rank // lanes
    per_batch = np.maximum.reduceat(slab + 1, np.arange(0, n, batch))
    rnd = (np.cumsum(per_batch) - per_batch)[at // batch] + slab
    n_rounds = int(per_batch.sum())
    slabs, idle = [], []
    for s in range(n_shards):
        rec = np.flatnonzero(shard == s)
        cut = np.flatnonzero(np.diff(rnd[rec])) + 1
        starts = rnd[rec[np.r_[0, cut]]] if rec.size else np.zeros(0, np.int64)
        slabs.append(np.split(rec, cut) if rec.size else [])
        idle.append(np.diff(np.r_[starts, n_rounds]) - 1)
    last = np.bincount(shard[rnd == n_rounds - 1], minlength=n_shards)
    return slabs, idle, n_rounds, last


class ReplicatedKV(ShardedKV):
    """`ShardedKV`'s API over R replica copies of S hash-partitioned shards:
    writes fan in to every alive replica, `read` fans out (each lane served
    by one replica), and replicas can be dropped and resynced live."""

    _obs_facade = "replicated"
    _read_span = "replicated.read"
    _observe_apply = False          # the reference's fan-in has no span and
    #                                 no count, its fan-out no deferral time

    def __init__(self, cfg: F2Config, n_shards: int, n_replicas: int = 2,
                 read_selector: str = "round_robin",
                 replica_decay: float = 0.8, **kw):
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} must be >= 1")
        if read_selector not in shard_router.REPLICA_POLICIES:
            raise ValueError(f"unknown read_selector {read_selector!r}")
        if cfg.host_tier:
            raise ValueError(
                "host_tier is not supported under replication (the host "
                "chunk stores would need a replica axis and resync "
                "integration)")
        # the hooks used inside ShardedKV.__init__ need these first
        self.R = int(n_replicas)
        self.read_selector = read_selector
        self.alive = np.ones(self.R, bool)
        self._sched_rows: Optional[np.ndarray] = None   # bool [R, S], mid-resync
        super().__init__(cfg, n_shards, **kw)
        self.drops = 0
        self.resyncs = 0
        self.resynced_records = 0
        self.resync_rounds = 0          # replay rounds run (`rounds` counts the reference's)
        self._read_batches = 0          # the selector's rotation counter
        self._replica_decay = float(replica_decay)
        self._replica_load = np.zeros(self.R, np.float64)
        self._pending_read = []         # unfolded fan-out round records
        self._read_io = {f: np.zeros((self.R, self.S), np.int64)
                         for f in IoStats._fields}
        self._read_exhausted = np.zeros((self.R, self.S), bool)
        self._row_masks = {}            # selected replicas -> bool [R*S]
        self._read_rep = None           # int32 [B]: the lanes' replicas of `read`

    # -- axis hooks (consumed by ShardedKV's scheduler and migration) --------
    @property
    def _lead_shape(self) -> tuple:
        return (self.R, self.S)

    def _sched_mask(self, rows: np.ndarray) -> np.ndarray:
        """Scheduler passes touch only alive replicas, or, mid-resync, only
        the rows of the replica being rebuilt that the replay says are due
        a pass."""
        if self._sched_rows is not None:
            return rows & self._sched_rows
        return rows & self.alive[:, None]

    def _rep_shard(self, m: np.ndarray) -> np.ndarray:
        return self.alive[:, None] & m[None, :]

    def _rep_move(self, move: np.ndarray) -> torch.Tensor:
        move = np.asarray(move, bool)
        return torch.as_tensor(np.tile(move, (self.R, 1)), device=self.device)

    def _host_view(self, x) -> np.ndarray:
        return np.asarray(x)[self._primary(self.alive)]

    def _client_rows(self, x: torch.Tensor) -> torch.Tensor:
        h = self._primary(self.alive)
        return x[h * self.S:(h + 1) * self.S]

    @staticmethod
    def _primary(sel: np.ndarray) -> int:
        """The lowest selected replica: where fan-in results are taken."""
        return int(np.flatnonzero(sel)[0])

    def _rows_of(self, sel: np.ndarray) -> torch.Tensor:
        """bool [R*S] on the device: the rows of the selected replicas."""
        key = tuple(bool(x) for x in sel)
        m = self._row_masks.get(key)
        if m is None:
            m = self._row_masks[key] = self._dev_bool(
                np.repeat(np.asarray(key, bool), self.S))
        return m

    # -- routed rounds (ShardedKV's apply, apply_round and read drive them) --
    def _routed_apply(self, keys, ops, vals, rep_do=None):
        """Fan-in: route once, repeat the slabs over the replicas (NOOP for
        the unselected ones: dropped replicas, or all but the one a masked
        rebuild replays into, `rep_do`), one `store.apply` over every row;
        statuses and values from the primary."""
        R, S = self.R, self.S
        sel = self.alive if rep_do is None else np.asarray(rep_do, bool)
        skeys, sops, svals, rt = shard_router.route(
            keys, ops, vals, S, self._lanes_of(keys.shape[0]),
            bucket_map=self._bucket_map_dev)
        W = skeys.shape[1]
        all_rows = bool(sel.all())
        rops = sops.repeat(R, 1)
        if not all_rows:
            rows = self._rows_of(sel)
            rops = torch.where(rows[:, None], rops, OP_NOOP).to(torch.int32)
        old = self.state
        new, sst, srv = store.apply(self.cfg, old, skeys.repeat(R, 1), rops,
                                    svals.repeat(R, 1, 1),
                                    admit_rc=self._admit)
        self.state = new if all_rows else select_shards(rows, new, old)
        h = self._primary(sel)
        status, rvals = shard_router.unroute(
            rt, sst.view(R, S, W)[h], srv.view(R, S, W, -1)[h])
        self._note_round(rt.occupancy, bucket_counts(rt, self.n_buckets))
        return status, rvals, rt

    def _routed_read(self, keys, ops):
        """One fan-out read round over the R*S rows, each lane to its
        replica of `read` (pure)."""
        R, S = self.R, self.S
        vals = torch.zeros((keys.shape[0], self.cfg.value_width),
                           dtype=torch.int32, device=self.device)
        skeys, sops, _, rt = shard_router.route(
            keys, ops, vals, S, self._lanes_of(keys.shape[0]),
            bucket_map=self._bucket_map_dev, replica=self._read_rep,
            n_replicas=R)
        old = self.state
        new, sst, srv = store.read_batch(self.cfg, old, skeys, sops == OP_READ,
                                         admit_rc=False)
        status, rvals = shard_router.unroute(rt, sst, srv)
        occ = rt.occupancy.view(R, S)
        io = torch.stack([a - b for a, b in zip(new.stats, old.stats)])
        self._note_round(occ.sum(0, dtype=torch.int32),
                         bucket_counts(rt, self.n_buckets))
        self._pending_read.append((io, new.walk_exhausted,
                                   occ.sum(1, dtype=torch.int32)))
        if len(self._pending_read) >= 128:
            self._fold_read()
        return status, rvals, rt

    def read(self, keys, replica: Optional[int] = None):
        """Fan-out read: every lane served by one alive replica (the
        selector's choice, or `replica` for the whole batch), in
        `ShardedKV.read`'s rounds.  Pure: no replica's state changes."""
        keys = self._dev(keys)
        B = keys.shape[0]
        if replica is None:
            if self.read_selector == "least_loaded":
                self._fold_read()       # it reads the folded load EWMA
            rep = shard_router.assign_replicas(
                B, self.alive, counter=self._read_batches,
                policy=self.read_selector, loads=self._replica_load)
        else:
            if not self.alive[replica]:
                raise ValueError(f"replica {replica} is not alive")
            rep = np.full(B, int(replica), np.int32)
        self._read_batches += 1
        self._read_rep = self._dev(rep)
        return super().read(keys)

    # -- fan-out read telemetry (host side: replica states never change) -----
    def _fold_read(self):
        """Drain the queued fan-out rounds into the per-replica I/O,
        exhaustion and load records, in round order, in one transfer."""
        if not self._pending_read:
            return
        io = torch.stack([p[0] for p in self._pending_read]).cpu().numpy()
        exh = torch.stack([p[1] for p in self._pending_read]).cpu().numpy()
        rl = torch.stack([p[2] for p in self._pending_read]).cpu().numpy()
        self._pending_read = []
        shape = (self.R, self.S)
        for io_r, exh_r, rl_r in zip(io, exh, rl):
            for f, d in zip(IoStats._fields, io_r):
                self._read_io[f] += d.reshape(shape).astype(np.int64)
            self._read_exhausted |= exh_r.reshape(shape)
            self._replica_load = (self._replica_decay * self._replica_load
                                  + rl_r.astype(np.float64))
        if obs.enabled():       # mirror the folded fan-out read signal
            obs.gauge_set("f2_replica_load", self._replica_load.tolist(),
                          help="per-replica fan-out read-load EWMA",
                          facade=self._obs_facade)
            obs.count_total("f2_fanout_read_ops_total",
                            int(self._read_io["read_ops"].sum()),
                            help="reads served via replica fan-out",
                            facade=self._obs_facade)
            obs.count_total("f2_fanout_mem_hits_total",
                            int(self._read_io["mem_hits"].sum()),
                            help="fan-out reads served from memory",
                            facade=self._obs_facade)

    @property
    def replica_load(self) -> np.ndarray:
        self._fold_read()
        return self._replica_load.copy()

    # -- replica lifecycle ----------------------------------------------------
    def drop_replica(self, r: int):
        """Take replica r out of serving: reads skip it, fan-in leaves it
        alone, its state freezes (the stand-in for a crashed node)."""
        r = int(r)
        if not self.alive[r]:
            raise ValueError(f"replica {r} already dropped")
        if self.alive.sum() < 2:
            raise ValueError("cannot drop the last alive replica")
        if self._migrating:
            raise RuntimeError("drop_replica during a migration")
        self.alive[r] = False
        self.drops += 1
        obs.journal.emit("replica.dropped", facade=self._obs_facade,
                         replica=r)
        obs.count("f2_replica_drops_total", facade=self._obs_facade)

    def _reset_rows(self, r: int):
        """Replica r's rows set to an empty store, in place (one empty
        store's leaves broadcast over the S rows)."""
        fresh = store.create(self.cfg, self.device, n_shards=1)
        rows = slice(r * self.S, (r + 1) * self.S)
        for dst, src in zip(_leaves(self.state), _leaves(fresh)):
            dst[rows].copy_(src.expand_as(dst[rows]))

    def resync(self, r: int) -> int:
        """Rebuild dropped replica r live from the primary: reset r, drain
        the primary's cold then hot log (pure), replay the live records into
        r alone (cold values first, live hot tombstones as Deletes) with the
        scheduler restricted to r.  Returns the records replayed."""
        r = int(r)
        if self.alive[r]:
            raise ValueError(f"replica {r} is alive; drop it first")
        if self._migrating:
            raise RuntimeError("resync during a migration")
        rs_span = obs.span("replica.resync", cat="replication", replica=r)
        rs_span.__enter__()
        h = self._primary(self.alive)
        Bm = self._mig_batch
        V = self.cfg.value_width
        cfg, nb = self.cfg, self.n_buckets
        self._reset_rows(r)
        for counts in (self.compactions, self.temp_table_peak_bytes,
                       *self.compaction_counts.values()):
            counts[r] = 0
        self._fold_read()
        for f in IoStats._fields:
            self._read_io[f][r] = 0
        self._read_exhausted[r] = False
        # --- pure drain of the primary (cold tier, then hot) ---------------
        move = self._rep_move(np.ones((self.S, nb), bool))
        do = np.zeros(self._lead_shape, bool)
        do[h] = True
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
                    _, k, v, took = rebalance.drain_cold_step(
                        cfg, Bm, nb, self.state, sj, until, move, sdo)
                    tomb = None
                else:
                    _, k, v, tomb, took = rebalance.drain_hot_step(
                        cfg, Bm, nb, self.state, sj, until, move, sdo)
                parts += self._collect(k, v, tomb, took)   # h's rows
        # --- replay into r alone, the scheduler restricted to r ------------
        if parts:
            keys_all = np.concatenate([p[0] for p in parts])
            vals_all = np.concatenate([p[1] for p in parts])
            ops_all = np.concatenate([p[2] for p in parts])
        else:
            keys_all = np.zeros(0, np.int32)
            vals_all = np.zeros((0, V), np.int32)
            ops_all = np.zeros(0, np.int32)
        n_moved = len(keys_all)
        self.alive[r] = True
        self._migrating = True          # replay lanes are not client traffic
        self._sched_rows = np.zeros(self._lead_shape, bool)
        try:
            self._replay(r, keys_all, ops_all, vals_all)
        finally:
            self._sched_rows = None
            self._migrating = False
            rs_span.__exit__(None, None, None)
        self.resyncs += 1
        self.resynced_records += n_moved
        obs.journal.emit("replica.resynced", facade=self._obs_facade,
                         replica=r, records=n_moved)
        obs.count("f2_replica_resyncs_total", facade=self._obs_facade)
        return n_moved

    def _pass_counts(self, r: int) -> np.ndarray:
        """Replica r's compaction counts of every kind, [kinds + 1, S]."""
        return np.stack([self.compactions[r]]
                        + [c[r] for c in self.compaction_counts.values()])

    def _replay(self, r: int, keys, ops, vals):
        """Replay drained records into replica r alone with r's rows side by
        side.  The reference replays batch by batch (`replay_plan`): a round
        gives each row a slab or nothing, then a scheduler pass on r's rows.
        A row's state depends only on its own slabs and passes, a NOOP slab
        leaves it unchanged, and so does a pass after one that compacted
        nothing.  So here a round gives each row its next slab and a pass;
        a row whose pass compacted first takes a pass alone for each idle
        round the reference gave it there, until one compacts nothing; the
        pass runs on those rows only.  State, compaction counts, `rounds`
        (advanced by the reference's count) and `last_occupancy` come out as
        the reference's, in about 1/S of its rounds: a drain gives each
        shard's records in runs, so the reference's rounds mostly fill one
        shard's slab."""
        R, S, n = self.R, self.S, len(keys)
        if n == 0:
            return
        W = self._lanes_of(self._mig_batch)
        dev = self.device
        # record n is the padding lane (OP_NOOP, key 0, value 0)
        keys_d = self._dev(np.append(keys, 0))
        ops_d = self._dev(np.append(ops, OP_NOOP))
        vals_d = self._dev(np.concatenate(
            [vals, np.zeros((1, vals.shape[1]), np.int32)]))
        _, sid = shard_router.shards_of(keys_d[:n], S, self._bucket_map_dev)
        slabs, idle, n_rounds, last = replay_plan(
            sid.cpu().numpy(), self._mig_batch, W, S)
        rows = self._rows_of(np.arange(R) == r)
        nxt = np.zeros(S, np.int64)      # each row's next slab
        owed = np.zeros(S, np.int64)     # idle rounds still due after a pass fired
        while True:
            take = (owed == 0) & (nxt < [len(x) for x in slabs])
            if not (take.any() or owed.any()):
                break
            idx = np.full((R * S, W), n, np.int64)     # other rows: NOOP
            for s in np.flatnonzero(take):
                lanes = slabs[s][nxt[s]]
                idx[r * S + s, :len(lanes)] = lanes
            if take.any():
                it = torch.as_tensor(idx, device=dev)
                old = self.state
                new, _, _ = store.apply(self.cfg, old, keys_d[it], ops_d[it],
                                        vals_d[it], admit_rc=self._admit)
                self.state = select_shards(rows, new, old)
            self._sched_rows[r] = take | (owed > 0)
            before = self._pass_counts(r)
            self.maybe_compact()
            fired = (self._pass_counts(r) != before).any(axis=0)
            for s in range(S):
                if take[s]:
                    owed[s] = idle[s][nxt[s]] if fired[s] else 0
                    nxt[s] += 1
                elif owed[s]:
                    owed[s] = owed[s] - 1 if fired[s] else 0
            self.resync_rounds += 1
            faults.maybe_crash("resync.mid_replay")
        self.rounds += n_rounds
        self.last_occupancy = torch.as_tensor(last, dtype=torch.int32,
                                              device=dev)

    # -- reporting ------------------------------------------------------------
    def io_stats(self) -> dict:
        """Cluster totals: fan-in I/O is charged on every alive replica,
        fan-out read I/O from the host-side per-replica records."""
        out = super().io_stats()
        self._fold_read()
        out["read_bytes"] += int(self._read_io["read_blocks"].sum()) * BLOCK_BYTES
        out["read_ops"] += int(self._read_io["read_ops"].sum())
        out["mem_hits"] += int(self._read_io["mem_hits"].sum())
        return out

    def replica_stats(self) -> dict:
        """Per-replica serving telemetry: liveness, read-load EWMA, served
        read I/O and the lifecycle counters."""
        self._fold_read()
        return dict(
            n_replicas=self.R,
            alive=self.alive.tolist(),
            read_selector=self.read_selector,
            replica_load=np.round(self._replica_load, 2).tolist(),
            read_ops=self._read_io["read_ops"].sum(axis=1).tolist(),
            mem_hits=self._read_io["mem_hits"].sum(axis=1).tolist(),
            drops=self.drops,
            resyncs=self.resyncs,
            resynced_records=self.resynced_records,
        )

    def _stats_tree(self) -> dict:
        out = super()._stats_tree()
        out["replicas"] = self.replica_stats()
        return out

    def memory_model_bytes(self) -> dict:
        return {k: v * self.R for k, v in super().memory_model_bytes().items()}

    def check_invariants(self):
        """Every ShardedKV invariant, per (replica, shard), fan-out reads'
        chain-walk exhaustion included."""
        st = self.state
        flags = torch.stack([st.hot.overflowed, st.cold.overflowed,
                             st.cold_idx.overflowed, st.walk_exhausted]
                            ).cpu().numpy().reshape(4, self.R, self.S)
        self._fold_read()
        flags[3] |= self._read_exhausted
        hb, ht, cb, ct, *_ = self._bounds()
        for r in range(self.R):
            for s in range(self.S):
                at = f"replica {r} shard {s}"
                for bad, what in zip(flags[:, r, s], (
                        "hot log ring overflow", "cold log ring overflow",
                        "chunk log overwrote live chunk",
                        "hash chain exceeded chain_max")):
                    if bad:
                        raise AssertionError(f"{at}: {what}")
                if hb[r, s] > ht[r, s] or cb[r, s] > ct[r, s]:
                    raise AssertionError(f"{at}: log BEGIN passed TAIL")
