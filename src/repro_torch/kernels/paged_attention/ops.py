"""Wrapper of the paged-attention CUDA kernels.

`paged_attention` checks device, dtype, shape and contiguity, allocates the
output and the split kernel's float32 partials with `torch.empty`, launches
on the current CUDA stream and raises if the C entry point reports a CUDA
error.  For tensors on the CPU it runs the plain version in `ref.py`; for
CUDA tensors it launches the kernels or raises; any other device raises.
A call launches two CUDA kernels: the split kernel (grid B * Hkv x
n_split, each CTA a run of `pages_per_split` pages) and the merge of the
partials; `splits` picks the split from max_pages and the shape, never from
the lengths, so a call makes no host sync.  `launches["paged_attention"]`
counts launches, one per call of up to MAX_GROUP query heads a KV head: a
q of more runs in groups of at most MAX_GROUP (`head_groups`), a launch
each (exact: query heads are independent given their KV head).  Past
CHUNK_DH (256) the head dim runs as column chunks of at most 256, a third
axis of the split grid and a second of the merge grid.  The split kernel
holds a launch's q whole in shared memory (`split_smem_bytes`: q in
float32 and a ring of K/V units, at most SMEM_LIMIT), so where G heads do
not fit (G 16 passes it near Dh 2,000) they run in the largest groups that
do (`group_limit`), a launch each, exactly as above; only a head dim at
which one head does not fit (past about 33,000) raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from ..flash_attention.ops import head_groups
from .ref import paged_attention_reference

launches: Dict[str, int] = {"paged_attention": 0}
MAX_GROUP = 16        # query heads per KV head the kernel holds
CHUNK_DH = 256        # output columns a CTA holds; more run as chunks
KEYS_PER_CHUNK = 32   # keys a stage of the ring holds (one per lane)
STAGE_BUDGET = 112 * 1024   # bytes of the K/V ring
SMEM_LIMIT = 232448   # shared memory a CTA may take on sm_90 (227 KB)
CTAS_PER_SM = 4       # split CTAs launched per SM, live or not
MAX_SPLITS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _entry():
    f = build.load("paged_attention").pa_paged_attention
    if f.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P] * 7 + [I] * 11 + [ctypes.c_float, P]
        f.restype = I
    return f


def split_smem_bytes(G: int, Dh: int, pool_elem: int) -> int:
    """Shared memory of the split kernel (csrc/paged_attention.cu
    `launch`): its ring of 2 or 3 stages (K and V rows of 32 keys up to
    CHUNK_DH; past it, [32][CHUNK_DH] units of K pieces and V chunks), then
    q [G][Dh rounded up to 8] in float32, p [G][32] and the correction [G].
    Rows are padded to a 16-byte vector and one more."""
    vec = 16 // pool_elem

    def row_ld(n):
        return -(-n // vec) * vec + vec

    wide = Dh > CHUNK_DH
    stage = pool_elem * (1 if wide else 2) * KEYS_PER_CHUNK * row_ld(
        CHUNK_DH if wide else Dh)
    stages = 3 if STAGE_BUDGET >= 3 * stage else 2
    return stages * stage + 4 * G * (-(-Dh // 8) * 8 + KEYS_PER_CHUNK + 1)


def group_limit(Dh: int, pool_elem: int) -> int:
    """The most query heads a launch holds at head dim Dh: MAX_GROUP, or
    fewer where their q would take the split kernel past SMEM_LIMIT (0
    where one head does not fit)."""
    ring = split_smem_bytes(0, Dh, pool_elem)
    per_head = split_smem_bytes(1, Dh, pool_elem) - ring
    return max(0, min(MAX_GROUP, (SMEM_LIMIT - ring) // per_head))


def splits(bh: int, max_pages: int, sms: int):
    """(pages_per_split, n_split) for B * Hkv = bh sequences' heads over a
    table of max_pages pages on a card of `sms` SMs: about CTAS_PER_SM * sms
    CTAs (at most MAX_SPLITS per head), whatever the lengths turn out to be,
    since they are not read on the host."""
    want = min(MAX_SPLITS, max(1, -(-CTAS_PER_SM * sms // bh)))
    pps = -(-max_pages // want)
    return pps, -(-max_pages // pps)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q: [B, Hkv, G, Dh]; k/v_pool: [Hkv, n_pool_pages, page_size, Dh];
    page_table: [B, max_pages] int32 (entries in [0, n_pool_pages));
    lengths: [B] int32.  Returns [B, Hkv, G, Dh] in q's dtype (see
    `ref.paged_attention_reference`)."""
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table, lengths)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {dev}")
    return paged_attention_cuda(q, k_pool, v_pool, page_table, lengths)


def paged_attention_cuda(q, k_pool, v_pool, page_table, lengths):
    """The CUDA kernel, forced: raises for tensors that are not on a CUDA
    device; G above `group_limit` (MAX_GROUP, or fewer where the shared
    memory holds fewer heads) runs in `head_groups`, a launch each."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda: q is on {dev}; the kernel "
                         "needs CUDA tensors")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention: q {q.dtype}, pools {k_pool.dtype}; "
                        "the kernel takes float32 or bfloat16")
    B, Hkv, G, Dh = q.shape
    _, n_pool, page, _ = k_pool.shape
    max_pages = page_table.shape[1] if page_table.dim() == 2 else -1
    if G < 1 or Dh < 1:
        raise ValueError(f"paged_attention: G={G}, Dh={Dh} (at least 1 each)")
    most = group_limit(Dh, k_pool.element_size())
    if most < 1:
        raise ValueError(f"paged_attention: one query head at Dh={Dh} needs "
                         f"{split_smem_bytes(1, Dh, k_pool.element_size())} bytes of "
                         f"shared memory a CTA (at most {SMEM_LIMIT})")
    if G > most:
        return torch.cat([paged_attention_cuda(qg.contiguous(), k_pool, v_pool,
                                               page_table, lengths)
                          for qg in q.split(head_groups(G, most), dim=2)], dim=2)
    if n_pool < 1 or page < 1 or max_pages < 1:
        raise ValueError(f"paged_attention: pool {tuple(k_pool.shape)}, "
                         f"table {tuple(page_table.shape)}")
    _check("q", q, q.dtype, (B, Hkv, G, Dh), dev)
    _check("k_pool", k_pool, k_pool.dtype, (Hkv, n_pool, page, Dh), dev)
    _check("v_pool", v_pool, k_pool.dtype, (Hkv, n_pool, page, Dh), dev)
    _check("page_table", page_table, torch.int32, (B, max_pages), dev)
    _check("lengths", lengths, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    if B * Hkv == 0:
        return out
    pps, n_split = splits(B * Hkv, max_pages,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty(B * Hkv * n_split * G * (Dh + 2), dtype=torch.float32, device=dev)
    vec16 = int((Dh * k_pool.element_size()) % 16 == 0
                and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0)
    err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   part.data_ptr(), B, Hkv, G, Dh, n_pool, page, max_pages, pps,
                   _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], vec16, Dh ** -0.5,
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention: CUDA error {err} at launch")
    launches["paged_attention"] += 1
    return out
