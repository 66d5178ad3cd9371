"""The plain reference: a dense key -> value table in plain PyTorch, and the
comparison that decides `correct`.

It imports nothing of the program.  Its semantics are the store's
guarantees as the configuration states them (`linearizable_batches`):

* every key of the load holds its loaded value;
* in one batch, every read sees the state before the batch;
* then the writes apply in lane order: the last upsert of a key wins, and
  an rmw adds its delta (int32 vector add, from 0 for an absent key) to
  what the batch's last upsert of that key before it, or else the stored
  value, gives;
* status: a read is OK with the value, or NOT_FOUND with zeros; an upsert
  is OK; an rmw is CREATED where its key was absent and its group holds no
  upsert, else OK.

`DenseStore(narrow=True)` keeps the values in int16: the control, the
reference put in the program's place with a guarantee broken (values are
stored exactly).
"""
from __future__ import annotations

import torch

from f2bench.gen import (OP_READ, OP_RMW, OP_UPSERT, ST_CREATED,
                         ST_NOT_FOUND, ST_OK, loaded_values)

LOAD_BLOCK = 1 << 20


class DenseStore:
    """n_keys rows of V int32 words and a presence bit per key."""

    def __init__(self, n_keys: int, V: int, seed: int, device,
                 narrow: bool = False):
        self.n, self.V = int(n_keys), int(V)
        dtype = torch.int16 if narrow else torch.int32
        self.val = torch.empty((self.n, self.V), dtype=dtype, device=device)
        for lo in range(0, self.n, LOAD_BLOCK):
            k = torch.arange(lo, min(lo + LOAD_BLOCK, self.n), device=device)
            self.val[lo:lo + len(k)] = loaded_values(seed, k, self.V).to(dtype)
        self.present = torch.ones(self.n, dtype=torch.bool, device=device)
        self.device = torch.device(device)

    def apply(self, keys, ops, vals=None):
        """(status [B] int32, values [B, V] int32) of one batch."""
        keys = keys.to(torch.int64)
        B = keys.shape[0]
        read = ops == OP_READ
        status = torch.zeros(B, dtype=torch.int32, device=self.device)
        out = torch.zeros((B, self.V), dtype=torch.int32, device=self.device)
        r = read.nonzero().flatten()
        kr = keys[r]
        pres = self.present[kr]
        status[r] = torch.where(pres, ST_OK, ST_NOT_FOUND).to(torch.int32)
        out[r] = self.val[kr].to(torch.int32) * pres[:, None]
        w = ((ops == OP_UPSERT) | (ops == OP_RMW)).nonzero().flatten()
        if w.numel():
            self._write(keys, ops, vals, w, status)
        return status, out

    def _write(self, keys, ops, vals, w, status):
        # group the write lanes by key, in lane order inside a group
        order = torch.argsort(keys[w] * (w.numel() + 1) + torch.arange(
            w.numel(), device=self.device))
        lane = w[order]
        k = keys[lane]
        new = torch.ones_like(k, dtype=torch.bool)
        new[1:] = k[1:] != k[:-1]
        g = torch.cumsum(new.to(torch.int64), 0) - 1
        n_g = int(g[-1]) + 1
        gk = k[new]
        pos = torch.arange(k.numel(), device=self.device)
        up = ops[lane] == OP_UPSERT
        last_up = torch.full((n_g,), -1, dtype=torch.int64, device=self.device)
        last_up.scatter_reduce_(0, g, torch.where(up, pos, -1), "amax")
        has_up = last_up >= 0
        base = torch.where(self.present[gk][:, None],
                           self.val[gk].to(torch.int64), 0)
        base = torch.where(has_up[:, None],
                           vals[lane[last_up.clamp(min=0)]].to(torch.int64),
                           base)
        after = (ops[lane] == OP_RMW) & (pos > last_up[g])
        delta = torch.zeros((n_g, self.V), dtype=torch.int64,
                            device=self.device)
        delta.index_add_(0, g[after], vals[lane[after]].to(torch.int64))
        final = base + delta
        final = ((final + 2 ** 31) % 2 ** 32 - 2 ** 31)     # int32 wrap
        created = ~has_up & ~self.present[gk]
        status[lane] = torch.where((ops[lane] == OP_RMW) & created[g],
                                   ST_CREATED, ST_OK).to(torch.int32)
        self.val[gk] = final.to(self.val.dtype)
        self.present[gk] = True


class Checker:
    """Holds what the timed path returned (every status, the sampled value
    rows) and judges it against the reference once the window has closed.
    Nothing is compared inside the window."""

    def __init__(self, traffic, n_check: int):
        self.traffic = traffic
        self.n_check = int(n_check)
        self.status = []            # per batch: int8 [B]
        self.sample = []            # per batch: (lo, int32 [n, V])

    def keep(self, i: int, status_host, vals_host):
        """Batch i's results, as host arrays (copied: the caller reuses its
        buffers)."""
        lo, hi = self.traffic.sample_slice(i, self.n_check)
        if i != len(self.status):
            raise ValueError(f"batch {i} kept out of order")
        self.status.append(status_host.astype("int8"))
        self.sample.append((lo, vals_host[lo:hi].copy()))

    def judge(self, store: DenseStore, first_window_batch: int) -> dict:
        """Replay every kept batch through the reference; count wrong
        statuses (every lane), wrong value rows (the sampled read lanes),
        and those of the timed window's batches apart."""
        dev = store.device
        out = dict(wrong_status=0, wrong_value=0, window_wrong=0,
                   statuses_checked=0, values_checked=0)
        for i in range(len(self.status)):
            keys, ops, vals = self.traffic.batch(i)
            st_ref, v_ref = store.apply(keys, ops, vals)
            st = torch.as_tensor(self.status[i], device=dev).to(torch.int32)
            bad_st = int((st != st_ref).sum())
            lo, got = self.sample[i]
            hi = lo + got.shape[0]
            read = ops[lo:hi] == OP_READ
            got = torch.as_tensor(got, device=dev)
            bad_v = int(((got != v_ref[lo:hi]).any(1) & read).sum())
            out["wrong_status"] += bad_st
            out["wrong_value"] += bad_v
            out["statuses_checked"] += st.numel()
            out["values_checked"] += int(read.sum())
            if i >= first_window_batch:
                out["window_wrong"] += bad_st + bad_v
        return out
