"""Bounded structured event journal: the store's lifecycle, as data.

Where metrics answer "how much" and traces answer "how long", the
journal answers "what happened, in what order" — compactions fired,
buckets migrated, replicas dropped/resynced/rebuilt, snapshots taken and
committed, WAL segments rotated, crash points armed and hit.  Fault
injection tests assert against it: instead of proving only end-state
equality, they pin the *event sequence* a crash-and-recover run must
produce.

Event kinds emitted by the instrumented subsystems:

    compaction.hot_cold / compaction.cold_cold / compaction.single_log /
        compaction.chunk_gc          {facade, shards|records}
    rebalance.migrated               {buckets, records, map_version}
    replica.dropped                  {replica}
    replica.resynced                 {replica, records}
    replica.rebuilt                  {replica, records}
    session.opened / session.closed  {sid}
    snapshot.taken                   {epoch, blocking}
    snapshot.committed               {epoch, seconds}
    wal.segment_rotated              {epoch}
    recovery.completed               {records, snapshot_epoch}
    crashpoint.armed                 {point, at}
    crashpoint.hit                   {point}
    host.promoted / host.demoted     {facade, chunks}
    host.contract_split              {facade, splits}
    alert.fired                      {rule, value, threshold, expr}
    alert.resolved                   {rule, value, threshold}

Each event carries a monotone `seq` and a wall-clock `ts`.  The buffer
is a fixed-capacity deque: old events evict, `dropped` counts them, and
`total` is the all-time emit count — so a test can detect both the
events it expects and whether the window it is asserting over is
complete."""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from . import _flags

DEFAULT_CAPACITY = 4096


class Journal:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        assert capacity >= 1
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self.total = 0          # all-time emits (dropped = total - len)

    def emit(self, kind: str, **fields) -> dict:
        ev = dict(seq=None, ts=time.time(), kind=kind, **fields)
        with self._lock:
            ev["seq"] = self.total
            self.total += 1
            self._events.append(ev)
        return ev

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Snapshot of retained events, oldest first; `kind` filters by
        exact kind or, with a trailing ".", by prefix ("compaction.")."""
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        if kind.endswith("."):
            return [e for e in evs if e["kind"].startswith(kind)]
        return [e for e in evs if e["kind"] == kind]

    def kinds(self) -> List[str]:
        """Retained event kinds in emit order (the sequence tests pin)."""
        with self._lock:
            return [e["kind"] for e in self._events]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.total - len(self._events)

    def __len__(self):
        with self._lock:
            return len(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self.total = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "total": self.total,
                    "dropped": self.total - len(self._events),
                    "events": list(self._events)}


JOURNAL = Journal()


def emit(kind: str, **fields) -> Optional[dict]:
    """Emit into the process journal; no-op (returns None) when obs is
    disabled."""
    if not _flags.ENABLED:
        return None
    return JOURNAL.emit(kind, **fields)


def events(kind: Optional[str] = None) -> List[dict]:
    return JOURNAL.events(kind)


def kinds() -> List[str]:
    return JOURNAL.kinds()


def clear():
    JOURNAL.clear()
