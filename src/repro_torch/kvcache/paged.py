"""F2-tiered paged KV cache.

The serving KV cache is organized like F2's tiered record logs:

  * a unified page pool per layer, split into a HOT range [0, n_hot) and a
    COLD range [n_hot, n_total);
  * the page table maps (sequence, logical page) -> physical page — the
    hash-index role; entries are repointed with the same
    publish-then-invalidate discipline as the store;
  * the decode tail page is the *mutable region*: new tokens write in
    place; full pages become read-only;
  * demotion (hot->cold) copies cold pages out of the hot ring — the
    hot-cold compaction; promotion copies a re-referenced cold page back
    into the hot ring — the read cache (second chance = a per-page
    reference counter);
  * touches of cold-range pages are metered (blocks read) like the store's
    I/O model.

Page allocation and demotion decisions are control plane (Python, like
vLLM's scheduler); the data plane (append, attend) is tensor code, with the
paged-attention CUDA kernel behind `attend`.

Unlike the JAX reference, whose state is immutable, the tensors of a
`PagedKVState` are updated in place: every data-plane function writes into
the state it is given and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.api import resolve_device
from ..kernels.paged_attention import ops as pa_ops
from ..kernels.paged_attention.ref import paged_attention_reference


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 64
    n_hot_pages: int = 64          # HBM-resident pages (per layer-shared pool)
    n_cold_pages: int = 192        # host-tier pages
    max_seqs: int = 8
    max_pages_per_seq: int = 32
    dtype: str = "float32"

    @property
    def n_pages(self) -> int:
        return self.n_hot_pages + self.n_cold_pages


class PagedKVState(NamedTuple):
    k_pool: torch.Tensor       # [L, Hkv, n_pages, page, Dh]
    v_pool: torch.Tensor
    page_table: torch.Tensor   # [max_seqs, max_pages] int32 physical, -1 empty
    seq_lens: torch.Tensor     # [max_seqs] int32
    ref_count: torch.Tensor    # [n_pages] int32 hotness (second chance)
    cold_reads: torch.Tensor   # int32 metered cold-tier page touches (0-d)


def create(cfg: PagedConfig, device) -> PagedKVState:
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, cfg.n_kv_heads, cfg.n_pages, cfg.page_size,
             cfg.head_dim)
    i32 = torch.int32
    return PagedKVState(
        k_pool=torch.zeros(shape, dtype=dt, device=device),
        v_pool=torch.zeros(shape, dtype=dt, device=device),
        page_table=torch.full((cfg.max_seqs, cfg.max_pages_per_seq), -1,
                              dtype=i32, device=device),
        seq_lens=torch.zeros((cfg.max_seqs,), dtype=i32, device=device),
        ref_count=torch.zeros((cfg.n_pages,), dtype=i32, device=device),
        cold_reads=torch.zeros((), dtype=i32, device=device),
    )


class PageAllocator:
    """Control-plane page management (Python)."""

    def __init__(self, cfg: PagedConfig):
        self.cfg = cfg
        self.free_hot = list(range(cfg.n_hot_pages))
        self.free_cold = list(range(cfg.n_hot_pages, cfg.n_pages))

    def alloc_hot(self) -> Optional[int]:
        return self.free_hot.pop(0) if self.free_hot else None

    def alloc_cold(self) -> Optional[int]:
        return self.free_cold.pop(0) if self.free_cold else None

    def free(self, page: int):
        (self.free_hot if page < self.cfg.n_hot_pages
         else self.free_cold).append(page)

    def is_hot(self, page: int) -> bool:
        return page < self.cfg.n_hot_pages


# ---------------------------------------------------------------------------
# Data plane
# ---------------------------------------------------------------------------

def _tail_entries(cfg: PagedConfig, st: PagedKVState, seq_ids):
    """(logical page, offset, table entry) of each sequence's next row.  The
    logical page is clamped into the table, as JAX clamps gather indices."""
    lens = st.seq_lens[seq_ids]
    logical = (lens // cfg.page_size).clamp(max=cfg.max_pages_per_seq - 1)
    return logical, lens % cfg.page_size, st.page_table[seq_ids, logical]


def append_layer(cfg: PagedConfig, st: PagedKVState, layer: int, seq_ids,
                 k_row, v_row) -> PagedKVState:
    """Write one new KV row for `layer` at each sequence's current length
    (the mutable tail page, updated in place).  k/v_row: [A, Hkv, Dh].
    seq_lens is NOT bumped here — bump_lens() commits the token once all
    layers have appended.  Sequences without an allocated tail page
    (inactive lanes) are dropped, as the reference's drop-mode scatter
    drops them; finding them is a host sync."""
    _, offset, entry = _tail_entries(cfg, st, seq_ids)
    lanes = torch.nonzero(entry >= 0).squeeze(1)
    phys, off = entry[lanes].long(), offset[lanes].long()
    heads = torch.arange(k_row.shape[1], device=k_row.device)[None, :]
    for pool, row in ((st.k_pool, k_row), (st.v_pool, v_row)):
        pool[layer].index_put_((heads, phys[:, None], off[:, None]),
                               row[lanes].to(pool.dtype))
    return st


def bump_lens(st: PagedKVState, seq_ids, mask=None) -> PagedKVState:
    """Commit one decoded token per active sequence."""
    inc = (torch.ones_like(seq_ids) if mask is None
           else mask.to(device=seq_ids.device, dtype=torch.int32))
    st.seq_lens.index_add_(0, seq_ids.long(), inc.to(st.seq_lens.dtype))
    return st


def attend(cfg: PagedConfig, st: PagedKVState, layer_k, layer_v, q, seq_ids,
           extra_len: int = 1, interpret: bool = False):
    """Single-layer paged attention for active sequences.
    layer_k/v: [Hkv, n_pages, page, Dh] (one layer's pool slice);
    q: [A, Hkv, G, Dh].  extra_len=1 includes the just-appended row.
    `interpret=True` runs the plain version (`ref.py`) in place of the
    kernel on any device (the reference's switch between the Pallas kernel
    and its interpreter; the reference defaults to interpreting, the port
    to the kernel).  Returns ([A, Hkv, G, Dh], st)."""
    table = st.page_table[seq_ids]
    lens = st.seq_lens[seq_ids] + extra_len
    pages = table.clamp(min=0)
    fn = paged_attention_reference if interpret else pa_ops.paged_attention
    out = fn(q.contiguous(), layer_k, layer_v, pages, lens)
    # metered cold-tier touches + read-reference counts (promotion signal)
    n_log = (lens + cfg.page_size - 1) // cfg.page_size
    touched = ((torch.arange(table.shape[1], device=table.device)[None]
                < n_log[:, None]) & (table >= 0))
    st.cold_reads.add_((touched & (table >= cfg.n_hot_pages)).sum()
                       .to(torch.int32))
    # untouched entries add 0 (the reference drops them)
    st.ref_count.index_add_(0, pages.reshape(-1).long(),
                            touched.reshape(-1).to(torch.int32))
    return out, st


def move_page(st: PagedKVState, src: int, dst: int, seq: int, logical: int
              ) -> PagedKVState:
    """Copy a page between tiers and repoint the table entry (the
    ConditionalInsert publish: copy first, swing pointer after)."""
    st.k_pool[:, :, dst] = st.k_pool[:, :, src]
    st.v_pool[:, :, dst] = st.v_pool[:, :, src]
    st.page_table[seq, logical] = dst
    st.ref_count[dst] = 0
    return st


# ---------------------------------------------------------------------------
# Control plane: F2-style tiering policy
# ---------------------------------------------------------------------------

class PagedKV:
    """Facade: allocator + tiering policy around the state.  Runs on the
    CUDA device unless given another `device`."""

    def __init__(self, cfg: PagedConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device, "repro_torch.PagedKV")
        self.state = create(cfg, self.device)
        self.alloc = PageAllocator(cfg)
        self.seq_pages = {}          # seq -> [(logical, phys)]
        self.free_seqs = list(range(cfg.max_seqs))
        self.demotions = 0
        self.promotions = 0

    def new_seq(self) -> int:
        seq = self.free_seqs.pop(0)
        self.seq_pages[seq] = []
        return seq

    def release_seq(self, seq: int):
        for _, phys in self.seq_pages.pop(seq, []):
            self.alloc.free(phys)
        self.state.seq_lens[seq] = 0
        self.state.page_table[seq] = -1
        self.free_seqs.append(seq)

    def ensure_capacity(self, seq: int):
        """Allocate the tail page if the next token crosses a boundary;
        demote the coldest full hot page when the hot ring is exhausted
        (hot-cold compaction).  Reads the sequence's length on the host."""
        ln = int(self.state.seq_lens[seq])
        if ln % self.cfg.page_size != 0 or \
                any(l == ln // self.cfg.page_size
                    for l, _ in self.seq_pages[seq]):
            return
        page = self.alloc.alloc_hot()
        if page is None:
            self._demote_coldest()
            page = self.alloc.alloc_hot()
        if page is None:
            raise RuntimeError("hot pool exhausted even after demotion")
        logical = ln // self.cfg.page_size
        self.seq_pages[seq].append((logical, page))
        self.state.page_table[seq, logical] = page

    def _demote_coldest(self):
        """Pick the lowest-ref full hot page that is not a tail page (ties
        broken by sequence, logical page, physical page)."""
        ref = self.state.ref_count[:self.cfg.n_hot_pages].cpu().numpy()
        candidates = []
        for seq, pages in self.seq_pages.items():
            ln = int(self.state.seq_lens[seq])
            tail_logical = ln // self.cfg.page_size
            for logical, phys in pages:
                if self.alloc.is_hot(phys) and logical < tail_logical:
                    candidates.append((int(ref[phys]), seq, logical, phys))
        if not candidates:
            raise RuntimeError("nothing demotable: hot pool too small")
        _, seq, logical, src = min(candidates)
        dst = self.alloc.alloc_cold()
        if dst is None:
            raise RuntimeError("cold pool exhausted")
        move_page(self.state, src, dst, seq, logical)
        self.seq_pages[seq] = [(l, dst if p == src else p)
                               for l, p in self.seq_pages[seq]]
        self.alloc.free(src)
        self.demotions += 1

    def promote_if_hot(self, threshold: int = 4):
        """Read-cache behavior: cold pages that keep being referenced come
        back into the hot ring (second chance)."""
        ref = self.state.ref_count.cpu().numpy()
        for seq, pages in self.seq_pages.items():
            for i, (logical, phys) in enumerate(pages):
                if not self.alloc.is_hot(phys) and ref[phys] >= threshold \
                        and self.alloc.free_hot:
                    dst = self.alloc.alloc_hot()
                    move_page(self.state, phys, dst, seq, logical)
                    self.seq_pages[seq][i] = (logical, dst)
                    self.alloc.free(phys)
                    self.promotions += 1

    # -- data-plane wrappers ---------------------------------------------------
    def _ids(self, seq_ids) -> torch.Tensor:
        if isinstance(seq_ids, torch.Tensor):
            return seq_ids.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(seq_ids, np.int32), device=self.device)

    def begin_token(self, seq_ids):
        """Ensure every active sequence has a tail page for its next row."""
        for s in np.asarray(seq_ids):
            self.ensure_capacity(int(s))

    def append_layer(self, layer: int, seq_ids, k_row, v_row):
        append_layer(self.cfg, self.state, layer, self._ids(seq_ids),
                     k_row, v_row)

    def end_token(self, seq_ids, mask=None):
        sid = self._ids(seq_ids)
        _, _, entry = _tail_entries(self.cfg, self.state, sid)
        self.state.ref_count.index_put_((entry.clamp(min=0).long(),),
                                        torch.ones_like(entry), accumulate=True)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask), device=self.device)
        bump_lens(self.state, sid, mask)

    def attend(self, layer: int, q, seq_ids, interpret: bool = False):
        out, _ = attend(self.cfg, self.state, self.state.k_pool[layer],
                        self.state.v_pool[layer], q, self._ids(seq_ids),
                        interpret=interpret)
        return out
