"""YCSB workloads (paper S8.1) and the paper's memory-budgeted F2 sizing,
numpy only.

Scrambled-Zipfian key distribution with exponent theta (0.99 is classic
YCSB).  Workloads: A (50r/50u), B (95r/5u), C (100r), D (95r/5
insert-latest), F (50r/50rmw).  `make_f2_config` splits the memory budget
like the paper's S8.1 F2 configuration.  Both are copies of the
reference's benchmark helpers, kept here so the port imports none of them;
the same seed gives the same op stream in both packages.
"""
from __future__ import annotations

import numpy as np

from .core.types import OP_READ, OP_RMW, OP_UPSERT, F2Config

WORKLOADS = {
    "A": {OP_READ: 0.5, OP_UPSERT: 0.5},
    "B": {OP_READ: 0.95, OP_UPSERT: 0.05},
    "C": {OP_READ: 1.0},
    "D": {OP_READ: 0.95, "INSERT": 0.05},
    "F": {OP_READ: 0.5, OP_RMW: 0.5},
}


class Zipf:
    """Classic (YCSB) zipfian sampler over [0, n) with scrambling."""

    def __init__(self, n: int, theta: float):
        self.n = n
        self.theta = theta
        w = np.arange(1, n + 1, dtype=np.float64) ** (-theta)
        self.cdf = np.cumsum(w) / np.sum(w)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        r = np.searchsorted(self.cdf, rng.random(size))
        # scramble: decorrelate rank from key id (YCSB scrambled zipfian)
        x = r.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return ((x >> np.uint64(33)) % np.uint64(self.n)).astype(np.int32)

    def mass_fraction(self, top_frac: float) -> float:
        """Fraction of accesses hitting the top `top_frac` of keys."""
        return float(self.cdf[max(1, int(self.n * top_frac)) - 1])


def make_ops(rng: np.random.Generator, workload: str, zipf: Zipf, size: int,
             value_width: int, insert_base: int = 0):
    """(keys, ops, vals, n_inserts) for one batch of a YCSB mix."""
    mix = WORKLOADS[workload]
    kinds = list(mix.keys())
    probs = np.array([mix[k] for k in kinds])
    choice = rng.choice(len(kinds), size=size, p=probs / probs.sum())
    keys = zipf.sample(rng, size)
    ops = np.zeros(size, np.int32)
    n_ins = 0
    for i, kid in enumerate(kinds):
        m = choice == i
        if kid == "INSERT":
            ops[m] = OP_UPSERT
            cnt = int(m.sum())
            keys[m] = insert_base + np.arange(cnt)
            n_ins = cnt
        else:
            ops[m] = kid
    vals = rng.integers(0, 127, (size, value_width)).astype(np.int32)
    return keys, ops, vals, n_ins


def _p2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def make_f2_config(n_keys: int, mem_frac: float = 0.10, value_width: int = 25,
                   chunk_slots: int = 32, rc_frac: float = 0.17,
                   index_frac: float = 0.17, rc_enabled: bool = True,
                   engine: str = "fused") -> F2Config:
    """Split the memory budget like the paper's S8.1 F2 configuration:
    ~1/6 hot index, ~1/6 read cache, ~1/2 hot-log memory, small cold-log
    and chunk-log windows; hot disk budget n/4, cold 2n."""
    rec = 16 + 4 * value_width
    budget = int(n_keys * rec * mem_frac)
    hot_mem = _p2(max(64, int(budget * 0.5 / rec)))
    n_chunks = _p2(max(64, n_keys // chunk_slots))
    return F2Config(
        hot_index_size=_p2(max(256, int(budget * index_frac / 8))),
        hot_capacity=_p2(max(2 * hot_mem, n_keys // 4)),
        hot_mem=hot_mem,
        cold_capacity=_p2(2 * n_keys),
        cold_mem=_p2(max(32, hot_mem // 16)),
        n_chunks=n_chunks,
        chunk_slots=chunk_slots,
        chunklog_capacity=_p2(max(4 * n_chunks, 256)),
        chunklog_mem=_p2(max(32, int(budget * 0.03 / (8 * chunk_slots)))),
        rc_capacity=_p2(max(2, int(budget * rc_frac / rec))) if rc_enabled else 1,
        value_width=value_width,
        chain_max=48,
        engine=engine,
    )
