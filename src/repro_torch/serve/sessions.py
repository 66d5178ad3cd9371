"""Ticketed multi-session serving with cross-session batch packing, over
`ShardedKV` or `ReplicatedKV` (the JAX package's `serve/sessions.py`).

Callers open sessions, enqueue operations (one global ticket per op), and
collect completions out of order with `poll` or `drain`.  The service packs
pending work of many sessions into every routed round, so the lanes a hot
shard's deferral would leave empty in the synchronous path carry other
sessions' ops instead.

Pool
----
`SessionPool` holds every session's ring of pending ops as tensors on the
store's device: N rings of C slots stacked on a leading axis, per-session
`head`/`tail` cursors (monotone; slot = cursor mod C) and a per-slot state
(FREE -> PENDING -> DONE -> FREE).  `enqueue`, `commit` and `free` update
it in place (the store's convention) with no host synchronisation:
`commit`'s lanes that carry no op rewrite a row that a valid lane writes,
with the same value, so they change nothing, as the reference's
out-of-range scatter drops them.

Scheduler
---------
`step()` runs one routed round: `shard_router.pack_from_pool` picks at most
`lanes` pending ops per shard in global ticket order, closed under each
session's FIFO prefix, in a batch that routes with no deferral; the store's
`apply_round` runs it (the pressure scheduler runs as for a synchronous
batch) and the completions scatter back into the pool, then the rebalance
check runs, and a durable store (`core.durability.DurableKV`) may take its
snapshot.  Nothing of that reads the device from the host beyond what
`apply_round` itself reads.

Tickets and ordering
--------------------
`Session.enqueue` returns the tickets, computed on the host (t0 + lane,
-1 for lanes past the ring's room).  Every session's ops execute in its
enqueue order and each round emits lanes in ascending ticket order, so the
history is the round sequence under the store's batch semantics (reads see
the round's entry snapshot, writes apply in ticket order), and the oldest
pending op is packed every round: no session starves.

Observability
-------------
With `repro_torch.obs` on, `step()` is spanned (`sessions.step`) and a
`TicketClock` stamps each ticket's enqueue, pack, apply and collection on
the host; a round's packed tickets are gathered into a fresh tensor on the
device and queued, and a fold (every `FOLD_EVERY` rounds, at a collection,
or at `_fold_fill`) reads all the queued ones in one device-to-host copy
(`fetch_tickets`), then feeds the `queue`, `pack`, `apply` and `e2e`
latency phases.  `_fold_fill` also sets `f2_slab_occupancy` and
`f2_packed_lanes_total` and runs an alert pass; sessions opened and closed
are journaled.  Disabled, none of it runs.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core import shard_router
from ..core.types import (OP_DELETE, OP_NOOP, OP_READ, OP_RMW, OP_UPSERT,
                          ST_NONE)

SLOT_FREE, SLOT_PENDING, SLOT_DONE = 0, 1, 2


class SessionPool(NamedTuple):
    """All sessions' rings as one set of tensors: N sessions x C slots."""

    keys: torch.Tensor        # int32 [N, C]
    ops: torch.Tensor         # int32 [N, C]
    vals: torch.Tensor        # int32 [N, C, V]
    ticket: torch.Tensor      # int32 [N, C] global enqueue sequence number
    slot_state: torch.Tensor  # int32 [N, C] FREE / PENDING / DONE
    status: torch.Tensor      # int32 [N, C] completion status
    rvals: torch.Tensor       # int32 [N, C, V] completion values
    head: torch.Tensor        # int32 [N] collect cursor (monotone)
    tail: torch.Tensor        # int32 [N] enqueue cursor (monotone)


def create_pool(n_sessions: int, depth: int, value_width: int,
                device) -> SessionPool:
    N, C, V = n_sessions, depth, value_width

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return SessionPool(
        keys=z(N, C), ops=torch.full((N, C), OP_NOOP, dtype=torch.int32,
                                     device=device),
        vals=z(N, C, V), ticket=z(N, C), slot_state=z(N, C), status=z(N, C),
        rvals=z(N, C, V), head=z(N), tail=z(N))


def enqueue(pool: SessionPool, sid: int, keys: torch.Tensor,
            ops: torch.Tensor, vals: torch.Tensor, t0: int) -> SessionPool:
    """Claim the next len(keys) ring slots of session `sid` (the caller
    keeps to the ring's room) and stamp them PENDING with tickets t0,
    t0 + 1, ...; in place."""
    n = keys.shape[0]
    if n == 0:
        return pool
    C = pool.keys.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    col = (pool.tail[sid] + idx) % C
    pool.keys[sid, col] = keys
    pool.ops[sid, col] = ops
    pool.vals[sid, col] = vals
    pool.ticket[sid, col] = t0 + idx
    pool.slot_state[sid, col] = SLOT_PENDING
    pool.tail[sid] += n
    return pool


def _scatter_valid(dst: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                   src) -> None:
    """dst[idx] = src on the valid lanes (whose idx are distinct), in place,
    with no copy of dst and no host read: the other lanes write the first
    valid lane's row with that lane's value, or, when no lane is valid,
    row 0 with its own value, so every write to a row carries one value."""
    src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device).expand(
        idx.shape[:1] + dst.shape[1:])
    first = torch.argmax(valid.to(torch.int32))
    some = valid[first]
    at = torch.where(valid, idx, torch.where(some, idx[first], 0))
    fill = torch.where(some, src[first], dst[0])
    lane = valid.view((-1,) + (1,) * (src.dim() - 1))
    dst.index_put_((at,), torch.where(lane, src, fill))


def commit(pool: SessionPool, sess: torch.Tensor, slot: torch.Tensor,
           valid: torch.Tensor, status: torch.Tensor,
           rvals: torch.Tensor) -> SessionPool:
    """Scatter one round's completions into the pool: results land at
    (sess, slot) of the valid lanes, whose slots flip PENDING -> DONE; in
    place."""
    N, C = pool.keys.shape
    idx = sess.to(torch.int64) * C + slot
    _scatter_valid(pool.status.view(N * C), idx, valid, status)
    _scatter_valid(pool.rvals.view(N * C, -1), idx, valid, rvals)
    _scatter_valid(pool.slot_state.view(N * C), idx, valid, SLOT_DONE)
    return pool


def free(pool: SessionPool, sid: int, mask: torch.Tensor) -> SessionPool:
    """Collection: free the masked slots of session `sid` (bool [C], ring
    indexed) and advance `head` over the FREE prefix of the in-use window
    (a freed slot behind an uncollected one still counts against the
    ring's room); in place."""
    C = pool.keys.shape[1]
    state_row = torch.where(mask, SLOT_FREE, pool.slot_state[sid]).to(torch.int32)
    ar = torch.arange(C, dtype=torch.int32, device=mask.device)
    idx = ((pool.head[sid] + ar) % C).to(torch.int64)
    used = ar < (pool.tail[sid] - pool.head[sid])
    run = torch.cumsum((~(used & (state_row[idx] == SLOT_FREE))).to(torch.int32),
                       0) == 0
    pool.slot_state[sid] = state_row
    pool.head[sid] += run.sum(dtype=torch.int32)
    return pool


def round_tickets(pool: SessionPool, sess, slot, valid) -> torch.Tensor:
    """The ticket of each lane of a packed round (-1 on padding)."""
    t = pool.ticket[sess.clamp_min(0).to(torch.int64),
                    slot.clamp_min(0).to(torch.int64)]
    return torch.where(valid, t, -1).to(torch.int32)


def fetch_tickets(rounds: Sequence[torch.Tensor]) -> List[list]:
    """The ticket lists of queued rounds (the `TicketClock`'s fetch): every
    round's tensor read in one device-to-host copy, split on the host."""
    flat = [t.reshape(-1) for t in rounds]
    host = torch.cat(flat).cpu().numpy()
    cuts = np.cumsum([t.numel() for t in flat])[:-1]
    return [part.tolist() for part in np.split(host, cuts)]


class Session:
    """A caller's handle: enqueue ops, collect completions by ticket.  One
    session's ops execute in FIFO order; sessions interleave inside the
    service's packed rounds.  One owner per session."""

    def __init__(self, svc: "KVSessionService", sid: int):
        self._svc = svc
        self.sid = sid
        self.open = True
        self._head = 0                  # host mirrors of the pool's cursors
        self._tail = 0
        self._freed: set = set()        # collected cursors ahead of head
        self._slot_of: dict = {}        # outstanding ticket -> cursor
        self._fifo: list = []           # outstanding tickets, enqueue order

    @property
    def capacity(self) -> int:
        return self._svc.depth

    @property
    def in_use(self) -> int:
        return self._tail - self._head

    @property
    def outstanding(self) -> int:
        """Ops enqueued and not yet collected (pending or done)."""
        return len(self._fifo)

    def _check_open(self):
        if not self.open:
            raise RuntimeError("session is closed")

    def enqueue(self, keys, ops, vals=None) -> np.ndarray:
        """Submit a batch; returns one int32 ticket per lane, -1 for lanes
        that did not fit the ring (retry after poll/drain frees slots)."""
        self._check_open()
        return self._svc._enqueue(self, keys, ops, vals)

    def poll(self, tickets: Sequence[int]):
        """Non-blocking collection: (done [k] bool, status [k], vals [k, V])
        aligned with `tickets`.  A completed ticket is collected once; a
        ticket polled again (or -1) reads done=False."""
        self._check_open()
        return self._svc._poll(self, np.asarray(tickets, np.int64))

    def drain(self):
        """Pump the service until every outstanding op of this session has
        completed, then collect them: (tickets [m], status [m], vals [m, V])
        in enqueue order."""
        self._check_open()
        return self._svc._drain(self)

    def close(self):
        self._svc.close_session(self)


class KVSessionService:
    """Ticketed multi-session serving over a sharded or replicated store.

    `open_session()` hands out up to `max_sessions` handles, each with a
    `session_depth`-slot ring in the shared pool; `step()` runs one packed
    round through the store's `apply_round`, and `poll`/`drain` pump it.
    The synchronous `KVProtocol` surface (apply/read/upsert/rmw/delete)
    runs through a private session."""

    _obs_facade = "sessions"

    def __init__(self, kv, max_sessions: int = 8, session_depth: int = 64,
                 pack_lanes: Optional[int] = None):
        if not hasattr(kv, "apply_round"):
            raise TypeError("KVSessionService needs a routed store "
                            "(ShardedKV or ReplicatedKV)")
        if max_sessions < 1 or session_depth < 1:
            raise ValueError("max_sessions and session_depth must be >= 1")
        self.kv = kv
        self.N = int(max_sessions)
        self.depth = int(session_depth)
        self.W = int(pack_lanes or kv.lanes or session_depth)
        if kv.lanes is not None and self.W > kv.lanes:
            raise ValueError("pack_lanes wider than the store's slab would "
                             "defer rounds")
        self.V = kv.cfg.value_width
        self.device = kv.device
        self.pool = create_pool(self.N, self.depth, self.V, self.device)
        self._sessions: list = [None] * self.N
        self._sync: Optional[Session] = None    # the protocol facade's session
        self._next_ticket = 0
        self.tickets_issued = 0
        self.tickets_rejected = 0
        self.collected = 0
        self.pack_rounds = 0
        self.sessions_opened = 0
        self._pending_fill: list = []           # unfolded per-round fill [S]
        self._packed_lanes = 0                  # folded totals
        self._fill_rounds = 0
        self._fill_max = 0                      # most lanes a shard took
        self.trace_schedule = False             # record the rounds (tests)
        self.schedule: list = []    # [(sess, valid, bkeys, bops, bvals,
        #                              status, rvals, ticket)] per round
        # the tickets' lifecycle stamps (enqueue -> packed -> applied ->
        # collected), with obs on; a round's tickets are queued on the
        # device and read at a fold
        self._clock = obs.latency.TicketClock(fetch=fetch_tickets)

    # -- session lifecycle ----------------------------------------------------
    def open_session(self) -> Session:
        for sid in range(self.N):
            if self._sessions[sid] is None:
                s = Session(self, sid)
                # the cursors continue where the sid's last owner left them
                s._head = int(self.pool.head[sid])
                s._tail = int(self.pool.tail[sid])
                if s._head != s._tail:
                    raise RuntimeError(f"session slot {sid} has slots in use")
                self._sessions[sid] = s
                self.sessions_opened += 1
                obs.journal.emit("session.opened", sid=sid)
                obs.count("f2_sessions_opened_total", facade=self._obs_facade)
                return s
        raise RuntimeError(f"all {self.N} sessions are open")

    def close_session(self, session: Session):
        if session.outstanding:
            raise RuntimeError("close_session with outstanding ops: drain() first")
        self._sessions[session.sid] = None
        session.open = False
        obs.journal.emit("session.closed", sid=session.sid)

    # -- the scheduler round --------------------------------------------------
    def total_outstanding(self) -> int:
        return sum(s.outstanding for s in self._sessions if s is not None)

    def step(self, sync: bool = False):
        """One cross-session packed round: pack -> apply_round -> commit ->
        the rebalance check.  With `sync=False` nothing is read back here;
        `sync=True` returns the number of lanes packed."""
        kv, pool = self.kv, self.pool
        armed = obs.enabled()
        t_pack0 = time.perf_counter() if armed else 0.0
        with obs.span("sessions.step", cat="serve"):
            (bkeys, bops, bvals, sess, slot, valid,
             fill) = shard_router.pack_from_pool(
                pool.keys, pool.ops, pool.vals, pool.ticket,
                pool.slot_state == SLOT_PENDING, kv.S, self.W,
                kv._bucket_map_dev)
            t_pack1 = time.perf_counter() if armed else 0.0
            status, rvals, placed, _ = kv.apply_round(bkeys, bops, bvals)
            # the packer never exceeds a shard's slab, so nothing defers;
            # `placed` still gates the commit
            commit(pool, sess, slot, valid & placed, status, rvals)
            t_applied = time.perf_counter() if armed else 0.0
            kv.maybe_rebalance()
            # a DurableKV snapshots on its cadence at packed-round
            # boundaries (between rounds the rings hold every un-acked op)
            snap = getattr(kv, "maybe_snapshot", None)
            if snap is not None:
                snap()
        self.pack_rounds += 1
        self._pending_fill.append(fill)
        if armed or self.trace_schedule:
            tkt = round_tickets(pool, sess, slot, valid)    # a fresh tensor
            if armed:       # queued on the device, read at a fold
                self._clock.note_round(tkt, t_pack0, t_pack1, t_applied)
            if self.trace_schedule:
                self.schedule.append((sess, valid, bkeys, bops, bvals, status,
                                      rvals, tkt))
        if len(self._pending_fill) >= 128:
            self._fold_fill()
        if sync:
            return int(fill.sum())
        return None

    def run_until_idle(self, max_rounds: Optional[int] = None) -> int:
        """Pump packed rounds until no op is pending; returns the rounds."""
        limit = (max_rounds if max_rounds is not None
                 else self.total_outstanding() + self.N + 2)
        rounds = 0
        for _ in range(limit):
            if not self._any_pending():
                return rounds
            self.step()
            rounds += 1
        if self._any_pending():
            raise RuntimeError(f"session scheduler made no progress in {limit} rounds")
        return rounds

    def _any_pending(self) -> bool:
        return bool((self.pool.slot_state == SLOT_PENDING).any())

    # -- internals driven by the Session handles ------------------------------
    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _enqueue(self, s: Session, keys, ops, vals):
        keys = np.asarray(keys, np.int32)
        ops = np.asarray(ops, np.int32)
        if vals is None:
            vals = np.zeros((len(keys), self.V), np.int32)
        else:
            vals = np.asarray(vals, np.int32)
        if not (keys.shape == ops.shape and vals.shape == keys.shape + (self.V,)):
            raise ValueError(f"shapes {keys.shape} {ops.shape} {vals.shape}")
        if (ops == OP_NOOP).any():
            raise ValueError("OP_NOOP cannot be enqueued (it would never complete)")
        B = len(keys)
        n_acc = min(B, self.depth - s.in_use)
        t0 = self._next_ticket
        enqueue(self.pool, s.sid, self._dev(keys[:n_acc]), self._dev(ops[:n_acc]),
                self._dev(vals[:n_acc]), t0)
        self._next_ticket += n_acc
        self.tickets_issued += n_acc
        self.tickets_rejected += B - n_acc
        if n_acc and obs.enabled():
            self._clock.note_enqueue(t0, n_acc, time.perf_counter())
        for i in range(n_acc):
            s._slot_of[t0 + i] = s._tail + i    # monotone cursor, slot = mod C
            s._fifo.append(t0 + i)
        s._tail += n_acc
        idx = np.arange(B, dtype=np.int32)
        return np.where(idx < n_acc, t0 + idx, np.int32(-1)).astype(np.int32)

    def _state_row(self, s: Session) -> np.ndarray:
        return self.pool.slot_state[s.sid].cpu().numpy()

    def _collect(self, s: Session, tickets: np.ndarray):
        """Collect the given (DONE) tickets: gather results, free slots,
        advance the host head mirror."""
        C = self.depth
        status = self.pool.status[s.sid].cpu().numpy()
        rvals = self.pool.rvals[s.sid].cpu().numpy()
        mask = np.zeros(C, bool)
        out_st = np.full(len(tickets), ST_NONE, np.int32)
        out_v = np.zeros((len(tickets), self.V), np.int32)
        for i, t in enumerate(tickets):
            cur = s._slot_of.pop(int(t))
            s._fifo.remove(int(t))
            mask[cur % C] = True
            out_st[i] = status[cur % C]
            out_v[i] = rvals[cur % C]
            s._freed.add(cur)
        if mask.any():
            free(self.pool, s.sid, self._dev(mask))
            while s._head in s._freed:
                s._freed.remove(s._head)
                s._head += 1
            self.collected += len(tickets)
            if obs.enabled():   # a collection reads the device anyway
                self._clock.note_collected(tickets, time.perf_counter())
        return out_st, out_v

    def _poll(self, s: Session, tickets: np.ndarray):
        state = self._state_row(s)
        C = self.depth
        done = np.zeros(len(tickets), bool)
        ready = []
        for i, t in enumerate(tickets):
            cur = s._slot_of.get(int(t))
            if cur is not None and state[cur % C] == SLOT_DONE:
                done[i] = True
                ready.append(int(t))
        out_st = np.full(len(tickets), ST_NONE, np.int32)
        out_v = np.zeros((len(tickets), self.V), np.int32)
        if ready:
            st_r, v_r = self._collect(s, np.asarray(ready))
            out_st[done], out_v[done] = st_r, v_r
        return done, out_st, out_v

    def _drain(self, s: Session):
        limit = self.total_outstanding() + self.N + 2
        C = self.depth
        for _ in range(limit):
            state = self._state_row(s)
            if all(state[cur % C] == SLOT_DONE for cur in s._slot_of.values()):
                break
            self.step()
        else:
            raise RuntimeError("drain made no progress")
        tickets = np.asarray(sorted(s._fifo), np.int64)
        if not len(tickets):
            return tickets, np.zeros(0, np.int32), np.zeros((0, self.V), np.int32)
        st, v = self._collect(s, tickets)
        return tickets, st, v

    # -- slab-occupancy telemetry ---------------------------------------------
    def _fold_fill(self):
        if not self._pending_fill:
            return
        fills = torch.stack(self._pending_fill).cpu().numpy().astype(np.int64)
        self._pending_fill = []
        self._packed_lanes += int(fills.sum())
        self._fill_rounds += len(fills)
        self._fill_max = max(self._fill_max, int(fills.max()))
        if obs.enabled():       # mirror the folded packing signal
            denom = self._fill_rounds * self.kv.S * self.W
            obs.gauge_set("f2_slab_occupancy",
                          self._packed_lanes / denom if denom else 0.0,
                          help="mean fraction of slab lanes filled per "
                               "packed round",
                          facade=self._obs_facade)
            obs.count_total("f2_packed_lanes_total", self._packed_lanes,
                            help="lanes packed into routed rounds",
                            facade=self._obs_facade)
            self._clock.fold()          # the queued ticket rounds ride along
            obs.rules.maybe_evaluate()  # an alert pass at the fold point

    @property
    def packed_lanes(self) -> int:
        self._fold_fill()
        return self._packed_lanes

    @property
    def max_fill(self) -> int:
        """The most lanes one shard took in one packed round (<= the pack
        width by construction)."""
        self._fold_fill()
        return self._fill_max

    def slab_occupancy(self) -> float:
        """Mean fraction of the S*W slab lanes filled per packed round."""
        self._fold_fill()
        if not self._fill_rounds:
            return 0.0
        return self._packed_lanes / (self._fill_rounds * self.kv.S * self.W)

    # -- KVProtocol surface (synchronous, over the async path) ---------------
    def _sync_session(self) -> Session:
        if self._sync is None or not self._sync.open:
            self._sync = self.open_session()
        return self._sync

    def apply(self, keys, ops, vals=None):
        """A synchronous mixed batch through the session machinery: enqueue
        on a private session (chunked to its ring), drain, and return
        (status [B], vals [B, V]) in batch order, on the store's device."""
        s = self._sync_session()
        keys = np.asarray(keys, np.int32)
        ops = np.asarray(ops, np.int32)
        if vals is None:
            vals = np.zeros((len(keys), self.V), np.int32)
        else:
            vals = np.asarray(vals, np.int32)
        B = len(keys)
        status = np.zeros(B, np.int32)
        rvals = np.zeros((B, self.V), np.int32)
        lane_of = {}
        start = 0
        while start < B:
            live = ops[start:] != OP_NOOP       # NOOP lanes complete as
            if not live.any():                  # ST_NONE without enqueue
                break
            nxt = start + int(np.argmax(live))
            n = min(B - nxt, self.depth - s.in_use)
            if n <= 0:
                self._drain_into(s, lane_of, status, rvals)
                continue
            sel = ops[nxt:nxt + n] != OP_NOOP
            if not sel.all():
                n = int(np.argmin(sel))         # stop the chunk at a NOOP
            tk = s.enqueue(keys[nxt:nxt + n], ops[nxt:nxt + n], vals[nxt:nxt + n])
            for j, t in enumerate(tk):
                lane_of[int(t)] = nxt + j
            start = nxt + n
        self._drain_into(s, lane_of, status, rvals)
        return self._dev(status), self._dev(rvals)

    def _drain_into(self, s, lane_of, status, rvals):
        tk, st, v = s.drain()
        for j, t in enumerate(tk):
            lane = lane_of.pop(int(t))
            status[lane] = st[j]
            rvals[lane] = v[j]

    def read(self, keys):
        return self.apply(keys, np.full(len(keys), OP_READ, np.int32))

    def upsert(self, keys, vals):
        return self.apply(keys, np.full(len(keys), OP_UPSERT, np.int32), vals)

    def rmw(self, keys, deltas):
        return self.apply(keys, np.full(len(keys), OP_RMW, np.int32), deltas)

    def delete(self, keys):
        return self.apply(keys, np.full(len(keys), OP_DELETE, np.int32))

    # -- reporting ------------------------------------------------------------
    def io_stats(self) -> dict:
        return self.kv.io_stats()

    def stats(self) -> dict:
        """The store's nested telemetry tree plus the `sessions` view,
        folded through the metrics registry when observability is on."""
        return obs.fold_stats(self._obs_facade, self._stats_tree())

    def _stats_tree(self) -> dict:
        out = self.kv._stats_tree()
        self._fold_fill()
        out["sessions"] = dict(
            max_sessions=self.N,
            session_depth=self.depth,
            pack_lanes=self.W,
            open=sum(x is not None for x in self._sessions),
            opened=self.sessions_opened,
            tickets_issued=self.tickets_issued,
            tickets_rejected=self.tickets_rejected,
            collected=self.collected,
            outstanding=self.total_outstanding(),
            pack_rounds=self.pack_rounds,
            packed_lanes=self.packed_lanes,
            slab_occupancy=round(self.slab_occupancy(), 4),
        )
        return out

    def check_invariants(self):
        """Store invariants plus the pool's: device cursors equal the host
        mirrors, in-use windows fit the rings, and every slot in use belongs
        to an outstanding ticket."""
        self.kv.check_invariants()
        head = self.pool.head.cpu().numpy()
        tail = self.pool.tail.cpu().numpy()
        state = self.pool.slot_state.cpu().numpy()
        for sid, s in enumerate(self._sessions):
            if s is None:
                continue
            if s._head != int(head[sid]) or s._tail != int(tail[sid]):
                raise AssertionError(f"session {sid}: cursor mirror drift")
            if not 0 <= s.in_use <= self.depth:
                raise AssertionError(f"session {sid}: ring overflow")
            if int((state[sid] != SLOT_FREE).sum()) != len(s._slot_of):
                raise AssertionError(f"session {sid}: slot bookkeeping drift")
