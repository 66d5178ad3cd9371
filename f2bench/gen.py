"""Traffic generation: YCSB op streams made from the seed on the device.

Batch i of a mix is a pure function of the seed and i: the benchmark makes
it on the card right before it submits it, and the reference makes it again
after the window, bit for bit, on the same device.  The loaded values and
the load's order are counter-based hashes of (seed, key), exact on any
device (int64 under a 32-bit mask, no product reaching 2**63).

Key distributions (a mix's `keys.dist`):
  zipf     scrambled Zipfian of exponent `theta` over [0, n_keys): the rank
           is the inverse-CDF table's `searchsorted` of a float64 uniform,
           then scrambled as YCSB does (a table of every rank's key).  A
           frozen copy of `repro_torch/workload.py`'s `Zipf` (its CDF and
           its 0x9E3779B97F4A7C15 scramble), with the host RNG replaced by
           the device's.
  uniform  floor(u * n_keys).

Op kinds (a mix's `mix`, shares summing to 1): read, upsert, rmw, with the
program's op codes.  Upsert values, rmw deltas and loaded values are
full-range 31-bit words, so a store that narrows a value shows it.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# op and status codes of the store's protocol (`repro_torch.core.types`)
OP_NOOP, OP_READ, OP_UPSERT, OP_RMW = 0, 1, 2, 3
ST_NONE, ST_OK, ST_NOT_FOUND, ST_CREATED = 0, 1, 2, 3
OP_CODES = {"read": OP_READ, "upsert": OP_UPSERT, "rmw": OP_RMW}
WRITE_KINDS = ("upsert", "rmw")

# stream ids: independent hash streams of one seed
S_BATCH, S_LOAD, S_SAMPLE = 1, 5, 6

SCRAMBLE = 0x9E3779B97F4A7C15
TABLE_BLOCK = 1 << 20


def _mulmod32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and 0 <= c < 2**32, with
    no product at or above 2**63 (torch and numpy alike)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x):
    """murmur3's finalizer over int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mulmod32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _fmix_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def stream_salt(seed: int, stream: int) -> tuple:
    """Two 32-bit salts of (seed, stream); any seed in [0, 2**64)."""
    s = int(seed) % (1 << 64)
    a = _fmix_int((s & M32) ^ _fmix_int(stream * 0x9E3779B1 + 1))
    b = _fmix_int((s >> 32) ^ _fmix_int(stream * 0x85EBCA77 + 2) ^ a)
    return a, b


def hash32(seed: int, stream: int, c):
    """32-bit hash (int64 in [0, 2**32)) of each counter c >= 0."""
    a, b = stream_salt(seed, stream)
    x = fmix32((c & M32) ^ a)
    return fmix32(x ^ ((c >> 32) & M32) ^ b)


def batch_seed(seed: int, i: int) -> int:
    """A 63-bit generator seed for batch i of a run's seed."""
    a, b = stream_salt(seed, S_BATCH)
    lo = _fmix_int(_fmix_int((i & M32) ^ a) ^ (i >> 32))
    hi = _fmix_int(lo ^ b) & 0x7FFFFFFF
    return (hi << 32) | lo


def scramble(rank, n: int):
    """((rank * 0x9E3779B97F4A7C15) mod 2**64 >> 33) % n for int64 ranks in
    [0, 2**32), the YCSB scramble of `repro_torch/workload.py`'s
    `Zipf.sample`, in 16/32-bit limbs so no int64 product overflows."""
    cl, ch = SCRAMBLE & M32, SCRAMBLE >> 32
    rl, rh = rank & 0xFFFF, rank >> 16
    a = rl * cl                                    # < 2**48
    b = rh * cl                                    # < 2**48, times 2**16
    low = (a & M32) + ((b & 0xFFFF) << 16)
    high = (a >> 32) + (b >> 16) + (low >> 32) + _mulmod32(rank, ch)
    return ((high & M32) >> 1) % n


def zipf_cdf(n: int, theta: float) -> np.ndarray:
    """The Zipf CDF of `repro_torch/workload.py`'s `Zipf` (float64)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-theta)
    return np.cumsum(w) / np.sum(w)


class Traffic:
    """One mix's batches, a pure function of (seed, batch index) on one
    device type: batch i is drawn by torch's Philox generator on the device,
    seeded from (seed, i) alone, so the reference draws it again bit for bit
    after the window.  A batch takes a handful of launches: the host, not
    the card, is what the store's facade spends its time on.

    `mix`: the traffic file's dict (`mix`, `keys`, `batch`, ...);
    `n_keys`, `value_width`: the configuration's."""

    def __init__(self, mix: dict, n_keys: int, value_width: int, seed: int,
                 device):
        self.mix = mix
        self.n = int(n_keys)
        self.V = int(value_width)
        self.B = int(mix["batch"])
        self.seed = int(seed)
        self.device = torch.device(device)
        shares = mix["mix"]
        unknown = set(shares) - set(OP_CODES)
        if unknown:
            raise ValueError(f"unknown op kinds {sorted(unknown)}")
        if abs(sum(shares.values()) - 1.0) > 1e-9:
            raise ValueError("op shares must sum to 1")
        # op kinds in OP_CODES order with their cumulative shares
        self.kinds, self.bounds, acc = [], [], 0.0
        for kind in OP_CODES:
            if shares.get(kind, 0) > 0:
                acc += shares[kind]
                self.kinds.append(OP_CODES[kind])
                self.bounds.append(acc)
        self.writes = any(shares.get(k, 0) > 0 for k in WRITE_KINDS)
        keys = mix["keys"]
        self.dist = keys["dist"]
        self.cdf = self.rank_key = None
        if self.dist == "zipf":
            self.cdf = torch.as_tensor(zipf_cdf(self.n, float(keys["theta"])),
                                       device=self.device)
            # YCSB's scramble of every rank, looked up by one gather (made
            # in blocks, so its temporaries stay small)
            self.rank_key = torch.empty(self.n, dtype=torch.int32,
                                        device=self.device)
            for lo in range(0, self.n, TABLE_BLOCK):
                ranks = torch.arange(lo, min(lo + TABLE_BLOCK, self.n),
                                     dtype=torch.int64, device=self.device)
                self.rank_key[lo:lo + len(ranks)] = scramble(ranks, self.n)
        elif self.dist != "uniform":
            raise ValueError(f"unknown key distribution {self.dist!r}")
        self.gen = torch.Generator(device=self.device)

    def device_bytes(self) -> int:
        """Bytes the generator holds on the device between batches."""
        if self.cdf is None:
            return 0
        return self.cdf.numel() * 8 + self.rank_key.numel() * 4

    def batch(self, i: int):
        """(keys [B] int32, ops [B] int32, vals [B, V] int32 or None for a
        mix without writes) of batch i."""
        g = self.gen
        g.manual_seed(batch_seed(self.seed, i))
        u = torch.rand(self.B, dtype=torch.float64, device=self.device,
                       generator=g)
        if self.dist == "uniform":
            keys = (u * self.n).to(torch.int64).clamp_(max=self.n - 1) \
                .to(torch.int32)
        else:
            rank = torch.searchsorted(self.cdf, u).clamp_(max=self.n - 1)
            keys = self.rank_key[rank]
        ops = None
        if len(self.kinds) == 1:
            ops = torch.full((self.B,), self.kinds[0], dtype=torch.int32,
                             device=self.device)
        else:
            v = torch.rand(self.B, device=self.device, generator=g)
            ops = torch.full((self.B,), self.kinds[-1], dtype=torch.int32,
                             device=self.device)
            for code, bound in zip(reversed(self.kinds[:-1]),
                                   reversed(self.bounds[:-1])):
                ops = torch.where(v < bound, code, ops)
        vals = None
        if self.writes:
            vals = torch.randint(0, 2 ** 31 - 1, (self.B, self.V),
                                 dtype=torch.int32, device=self.device,
                                 generator=g)
        return keys, ops.to(torch.int32), vals

    def sample_slice(self, i: int, n_check: int) -> tuple:
        """The lanes [lo, lo + n) of batch i whose values are kept and
        compared: a contiguous run (lanes are independent draws), at an
        offset drawn from the seed."""
        n_check = min(int(n_check), self.B)
        a, b = stream_salt(self.seed, S_SAMPLE)
        lo = _fmix_int(_fmix_int(int(i) ^ a) ^ b) % (self.B - n_check + 1)
        return lo, lo + n_check


def loaded_values(seed: int, keys: torch.Tensor, V: int) -> torch.Tensor:
    """The value every key is loaded with: [len(keys), V] int32."""
    cols = torch.arange(V, dtype=torch.int64, device=keys.device)
    c = keys.to(torch.int64)[:, None] * V + cols
    return (hash32(seed, S_LOAD, c) & 0x7FFFFFFF).to(torch.int32)


def load_order(seed: int, n: int, device) -> torch.Tensor:
    """Every key in [0, n) once, in an order drawn from the seed."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    return torch.argsort(hash32(seed, S_LOAD + 100, k)).to(torch.int32)
