"""Crash-fault injection: named crash points for durability testing (the
JAX package's `testing/faults.py`).  Arming a point and hitting it are
journaled (`crashpoint.armed`, `crashpoint.hit`) when observability is on,
so fault-injection tests pin the event sequence of a crash and recovery.

Code calls ``maybe_crash("point.name")`` at the instants where a real
process death would be most damaging (for the checkpointer: after the
leaves are written and before the manifest commits them).  Tests ``arm()``
a point, with an optional hit countdown so the Nth traversal crashes rather
than the first, then run the workload and catch :class:`InjectedCrash`,
which models a kill -9: the object is abandoned and recovery starts from
the on-disk artifacts alone.

The registry is process-global (the code and the test share it) and
cleared by ``reset()``; tests reset in a ``finally`` or fixture so an armed
point never leaks into the next test.
"""
from __future__ import annotations

import threading

from .. import obs

# Every crash point of the reference, so that tests written against it arm
# the same names; the port's code reaches each of them (the host tier's two
# in `core.host_tier.HostTier`).
CRASH_POINTS = (
    "checkpoint.before_manifest",  # snapshot leaves written, manifest not yet
    "wal.mid_append",              # WAL record half-written (torn tail)
    "migrate.after_flip",          # bucket map flipped, drained replay pending
    "resync.mid_replay",           # replica reset + drained, replay half-done
    "host.mid_demote",             # cold chunks copied to host, floor not yet
    #                                committed on device
    "host.mid_promote",            # host chunks staged for the device cache,
    #                                install scatter pending
)


class InjectedCrash(RuntimeError):
    """Raised at an armed crash point; models an abrupt process death."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


_lock = threading.Lock()
_armed: dict[str, int] = {}


def arm(point: str, at: int = 1) -> None:
    """Arm ``point`` so its ``at``-th traversal raises InjectedCrash.

    ``at=1`` crashes on the next hit; ``at=3`` lets two traversals pass.
    """
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; known: {CRASH_POINTS}")
    if at < 1:
        raise ValueError(f"at must be >= 1, got {at}")
    with _lock:
        _armed[point] = at
    obs.journal.emit("crashpoint.armed", point=point, at=at)


def armed(point: str) -> bool:
    """True if ``point`` is currently armed (without consuming a hit)."""
    with _lock:
        return point in _armed


def maybe_crash(point: str) -> None:
    """Crash-point hook: no-op unless a test armed ``point``."""
    with _lock:
        if point not in _armed:
            return
        _armed[point] -= 1
        if _armed[point] > 0:
            return
        del _armed[point]
    obs.journal.emit("crashpoint.hit", point=point)
    raise InjectedCrash(point)


def reset() -> None:
    """Disarm every crash point (call between tests)."""
    with _lock:
        _armed.clear()
