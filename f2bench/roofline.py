"""The chip's peaks and the bytes each store kernel's work needs.

The bytes are what a batch needs, counted once and read off the batch and
its results alone, whatever implements the kernel: each lane's inputs and
the outputs the function defines, one 32-byte index sector per lane, and
one record (its header sector and value row) for each lane whose key the
result reports present.  The hops a chain walk takes depend on one
implementation's chains and the compares of a sort on its algorithm; they
are not counted.  The work is integer compares and copies, so the bound is
memory bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM (the data sheet's figure, at its 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

SECTOR = 32          # bytes: the smallest DRAM transaction
WORD = 4             # int32 keys, ops, statuses and value words


def peak_bytes_per_s(kind: str) -> float:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])["hbm_bytes_per_s"]


def probe_bytes(n_read: int, n_found: int, V: int) -> int:
    """A read: key and op in, status and value row out, an index sector,
    and for a present key its record (header sector, value row)."""
    lane = 2 * WORD + WORD + V * WORD + SECTOR
    return n_read * lane + n_found * (SECTOR + V * WORD)


def write_bytes(n_write: int, V: int) -> int:
    """An upsert or rmw: key, op and value row in, status out, an index
    sector, and its record (header sector, value row): every written key
    is present after the batch."""
    lane = 2 * WORD + V * WORD + WORD + SECTOR
    return n_write * (lane + SECTOR + V * WORD)


def roofline_pct(n_bytes: int, device_s: float, kind: str):
    """Least time over the kernels' device time, in %; None where the
    trace holds no time for them or the batch needs no bytes."""
    if device_s <= 0 or n_bytes <= 0:
        return None
    return 100.0 * (n_bytes / peak_bytes_per_s(kind)) / device_s
