"""Wrappers of the flash-attention CUDA kernels, forward and gradient.

`flash_attention(q, k, v, causal, window)` takes the model's layout (q
[B, Hq, Tq, Dh], k/v [B, Hkv, Tk, Dh], Tk independent of Tq as in the
reference: cross-attention, a ragged cache) and is differentiable.  For tensors on
the CPU it runs the plain version in `ref.py` (autograd through it is the
plain gradient); for CUDA tensors it runs `flash_attention_cuda`, a
`torch.autograd.Function` whose forward launches the forward kernel and
saves q, k, v, o and the row log-sum-exp, and whose backward launches the
gradient kernels.  A DTensor, or a tensor on `meta` (the dry-run's), takes
the reference's own shape instead (`grouped_attention`): query heads split
into (Hkv, G) without folding the batch into them, and the reference's
loop over key blocks, one block counted by its trip count on `meta`.  Any
other device raises.

`flash_attention_cuda` takes the kernels' layout (q [BH, G, Tq, Dh], k/v
[BH, 1, Tk, Dh]) and raises for tensors that are not on a CUDA device.  The
kernels take float32 or bfloat16 (one dtype for q, k and v), contiguous
tensors with 16-byte aligned storage, and BH <= MAX_BH and G <= MAX_GROUP a
launch; `flash_attention_cuda` runs a larger BH as slices of at most MAX_BH
rows and a larger G as groups of at most MAX_GROUP query heads
(`head_groups`), a launch each, forward and gradient (exact: the rows are
independent, and query heads are independent given their KV head; dK and
dV sum the groups' shares).  Any head dim runs: `forward_cuda` and
`backward_cuda` zero-pad q, k, v (o, dO) to `head_dim_for(dtype, Dh)`
(`pad_head_dim`), launch at that width with the true Dh's scale Dh^-0.5,
and slice the output and the gradients back (exact: zero columns add
nothing to q.k, and the padded columns of o, dq, dk and dv are dropped).

Two routes, picked by `route(dtype, Dh)`: "tc", the tensor-core kernels of
`csrc/flash_attention_tc.cu`, for bfloat16 at every head dim (the forward
on `wgmma` at Dh 128, on `mma.sync` at the others; the gradient on
`mma.sync`; instantiated at the widths of TC_HEAD_DIMS, and past 256 at
every multiple of WIDE_STEP (128) as column chunks of 256 over a
reduction in 128-column pieces); "simt", the CUDA-core kernels of
`csrc/flash_attention.cu`, for float32 (exact float32 arithmetic, which the
float32 tolerances need; any Dh % 4 == 0, past CHUNK_DH (256) as column
chunks of at most 256, a grid axis of their own: ceil(Dh / 256) x G may
not pass 65,535).
`launches` counts the kernel calls: "flash_attention_fwd" one per forward,
"flash_attention_bwd" one per gradient (a call launches three CUDA kernels:
the dO.O row pre-pass, dK/dV, dQ); `route_launches` counts the same calls
per route.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from .. import build
from ...distributed.sharding import is_distributed, merge_dims, split_dim
from .ref import blockwise_attention, mha_reference

launches: Dict[str, int] = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
route_launches: Dict[str, int] = {f"{k}_{r}": 0 for k in launches for r in ("tc", "simt")}
MAX_GROUP = 16
MAX_BH = 65535        # KV heads (B x Hkv) a launch holds: the CUDA-core grids' z axis
CHUNK_DH = 256        # output columns a CUDA-core CTA holds; more run as chunks
MAX_GRID_Y = 65535    # the forward and dQ grids' y axis: G x chunks
TC_HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128, 256)   # the tensor-core bodies' widths
WIDE_STEP = 128       # past 256 the tensor-core bodies take multiples of this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for d in (launches, route_launches):
        for k in d:
            d[k] = 0


def head_groups(G: int, most: int = MAX_GROUP) -> list:
    """Sizes of the groups, at most `most` query heads each and as even as
    can be, that G query heads of one KV head are launched in."""
    n = -(-G // most)
    return [G // n + (i < G % n) for i in range(n)]


def route(dtype: torch.dtype, head_dim: int) -> str:
    """"tc" (tensor-core kernels) for bfloat16 at every head dim, "simt"
    (CUDA-core kernels) for float32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def head_dim_for(dtype: torch.dtype, head_dim: int) -> int:
    """The width the kernels run `head_dim` at: for bfloat16 the least of
    TC_HEAD_DIMS at or above it, past 256 the next multiple of WIDE_STEP;
    for float32 the next multiple of 4 (the CUDA-core kernels' 16-byte
    loads)."""
    if head_dim < 1:
        raise ValueError(f"flash_attention: Dh={head_dim} (at least 1)")
    if route(dtype, head_dim) == "simt":
        return -(-head_dim // 4) * 4
    for d in TC_HEAD_DIMS:
        if head_dim <= d:
            return d
    return -(-head_dim // WIDE_STEP) * WIDE_STEP


def pad_head_dim(width: int, *ts):
    """`ts` with the last (head) dim zero-padded to `width`; a tensor that
    already has it is returned as it is."""
    return tuple(t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
                 for t in ts)


def _sliced(t, head_dim: int):
    return t if t.shape[-1] == head_dim else t[..., :head_dim].contiguous()


def _lib(which: str):
    """The (forward, gradient) C functions of a route, typed; both routes
    share one interface."""
    if which == "tc":
        lib = build.load("flash_attention_tc")
        fwd, bwd = lib.fa_tc_forward, lib.fa_tc_backward
    else:
        lib = build.load("flash_attention")
        fwd, bwd = lib.fa_forward, lib.fa_backward
    if fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [P] * 5 + [I] * 8 + [ctypes.c_float, P]
        fwd.restype = I
        bwd.argtypes = [P] * 10 + [I] * 8 + [ctypes.c_float, P]
        bwd.restype = I
    return fwd, bwd


def _check(q, k, v, name):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: q is on {dev}; the kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}; "
                         "expected [BH, G, Tq, Dh] and [BH, 1, Tk, Dh]")
    BH, G, Tq, Dh = q.shape
    Tk = k.shape[2]
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{name}: G={G} (max {MAX_GROUP})")
    width = head_dim_for(q.dtype, Dh)
    if G * -(-width // CHUNK_DH) > MAX_GRID_Y:
        raise ValueError(f"{name}: G={G} x {-(-width // CHUNK_DH)} column chunks of "
                         f"Dh={Dh} pass the grid's {MAX_GRID_Y}")
    if BH < 1 or BH > MAX_BH or Tq < 1 or Tk < 1:
        raise ValueError(f"{name}: BH={BH} (1..{MAX_BH}), Tq={Tq}, Tk={Tk}")
    for n, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (BH, 1, Tk, Dh):
            raise ValueError(f"{name}: {n} {tuple(t.shape)}, expected {(BH, 1, Tk, Dh)}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} storage is not 16-byte aligned")
    return BH, G, Tq, Tk, Dh


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def forward_cuda(q, k, v, causal: bool, window: int):
    """The forward kernel: (o [BH, G, Tq, Dh] in q's dtype, lse [BH, G, Tq]
    float32), run at `head_dim_for(dtype, Dh)` with Dh's scale."""
    BH, G, Tq, Tk, Dh = _check(q, k, v, "flash_attention_fwd")
    r, width, scale = route(q.dtype, Dh), head_dim_for(q.dtype, Dh), Dh ** -0.5
    q, k, v = pad_head_dim(width, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
    err = _lib(r)[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), BH, G, Tq, Tk, width, _DTYPE_CODE[q.dtype], int(causal),
                     int(window), scale, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err} at launch ({r} route)")
    launches["flash_attention_fwd"] += 1
    route_launches[f"flash_attention_fwd_{r}"] += 1
    return _sliced(o, Dh), lse


def backward_cuda(q, k, v, o, lse, do, causal: bool, window: int):
    """The gradient kernels: (dq, dk, dv) in the inputs' dtype, dq of q's
    shape and dk, dv of k's (zeros for keys that no query sees)."""
    BH, G, Tq, Tk, Dh = _check(q, k, v, "flash_attention_bwd")
    for n, t, shape, dt in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                            ("lse", lse, (BH, G, Tq), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != tuple(shape) or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {n} {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, expected {dt} {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {n} is not contiguous and aligned")
    r, width, scale = route(q.dtype, Dh), head_dim_for(q.dtype, Dh), Dh ** -0.5
    q, k, v, o, do = pad_head_dim(width, q, k, v, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D = rowsum(dO * O) [BH, G, Tq], then [BH, width] for the rows that see no key
    scratch = torch.empty(BH * G * Tq + BH * width, dtype=torch.float32, device=q.device)
    err = _lib(r)[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), scratch.data_ptr(), BH, G, Tq, Tk, width,
                     _DTYPE_CODE[q.dtype], int(causal), int(window), scale,
                     _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err} at launch ({r} route)")
    launches["flash_attention_bwd"] += 1
    route_launches[f"flash_attention_bwd_{r}"] += 1
    return tuple(_sliced(t, Dh) for t in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = forward_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = backward_cuda(q, k, v, o, lse, do.contiguous(), ctx.causal,
                                   ctx.window)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0):
    """The kernels, forced: q [BH, G, Tq, Dh], k/v [BH, 1, Tk, Dh] on a CUDA
    device -> [BH, G, Tq, Dh], differentiable through the gradient kernels;
    BH above MAX_BH runs in slices of at most MAX_BH rows and G above
    MAX_GROUP in `head_groups`, a launch each."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: q is on {q.device}; the kernel "
                         "needs CUDA tensors")
    causal, window = bool(causal), int(window)
    if q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0]:
        return _FlashAttention.apply(q, k, v, causal, window)   # _check says what is wrong
    if q.shape[0] <= MAX_BH:
        return _grouped(q, k, v, causal, window)
    return torch.cat([_grouped(q[i:i + MAX_BH], k[i:i + MAX_BH], v[i:i + MAX_BH], causal,
                               window) for i in range(0, q.shape[0], MAX_BH)], dim=0)


def _grouped(q, k, v, causal, window):
    if q.shape[1] <= MAX_GROUP:
        return _FlashAttention.apply(q, k, v, causal, window)
    return torch.cat([_FlashAttention.apply(qg.contiguous(), k, v, causal, window)
                      for qg in q.split(head_groups(q.shape[1]), dim=1)], dim=1)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Model layout: q [B, Hq, Tq, Dh], k/v [B, Hkv, Tk, Dh] -> [B, Hq, Tq, Dh]
    (query head h uses KV head h // (Hq / Hkv)); window <= 0 means none.
    The causal mask is the reference's top-left one: query i sees keys
    j <= i, so with Tq > Tk the rows at and past Tk see every key."""
    B, Hq, Tq, Dh = q.shape
    if (k.dim() != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != Dh
            or k.shape[1] < 1 or Hq % k.shape[1]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    Hkv, Tk = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type == "meta" or is_distributed(q):
        return grouped_attention(q, k, v, causal, int(window))
    qr = q.reshape(B * Hkv, Hq // Hkv, Tq, Dh)
    kr = k.reshape(B * Hkv, 1, Tk, Dh)
    vr = v.reshape(B * Hkv, 1, Tk, Dh)
    if dev.type == "cpu":
        out = mha_reference(qr, kr, vr, causal=causal, window=int(window))
    elif dev.type == "cuda":
        out = flash_attention_cuda(qr.contiguous(), kr.contiguous(), vr.contiguous(),
                                   causal, int(window))
    else:
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    return out.reshape(B, Hq, Tq, Dh)


def grouped_attention(q, k, v, causal: bool = True, window: int = 0):
    """The reference's model attention in its own shape
    (`src/repro/models/layers.py:109-180`, `ref.blockwise_attention`): q
    [B, Hq, Tq, Dh] split into [B, Hkv, G, Tq, Dh] (`sharding.split_dim`,
    which lays a DTensor out for the split as GSPMD would), k/v [B, Hkv, 1,
    Tk, Dh], the online softmax over key blocks, then the heads merged back
    (`merge_dims`).  On `meta` one block runs, counted by the loop's trip
    count (unless `step_trace.unrolled()`).  A DTensor runs the loop on
    each device's shard (`local_map`): q keeps its layout (batch, KV heads
    and the sequence may be split), K and V follow it on batch and heads
    and are whole over the sequence, and a shard of the sequence attends
    from its own offset.  No kernel runs here: a DTensor on a CUDA device
    raises."""
    from ...launch import step_trace
    B, Hq, Tq, Dh = q.shape
    Hkv = k.shape[1]
    qg = split_dim(q, 1, (Hkv, Hq // Hkv))
    kg, vg = k.unsqueeze(2), v.unsqueeze(2)
    trips = q.device.type == "meta" and step_trace.by_trip_count()
    kw = dict(causal=bool(causal), window=max(int(window), 0), by_trip_count=trips)
    if not is_distributed(qg):
        return blockwise_attention(qg, kg, vg, **kw).reshape(B, Hq, Tq, Dh)
    if q.device.type == "cuda":
        raise ValueError("flash_attention: a DTensor on a CUDA device; the kernels "
                         "take the local shards' plain tensors")
    return merge_dims(_per_shard(qg, kg, vg, kw), 1, 2)


def _per_shard(qg, kg, vg, kw):
    """`blockwise_attention` on each device's shard of the grouped q (batch,
    KV heads or the query sequence split, G whole) and of k/v (split as q
    on batch and heads, whole over the sequence).  K and V's gradients are
    partial over the mesh dimensions that split the query sequence."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = qg.device_mesh
    q_pl = tuple(qg.placements)
    if any(p != Replicate() and p not in (Shard(0), Shard(1), Shard(3)) for p in q_pl):
        raise ValueError(f"flash_attention: q laid out as {q_pl}; the attention takes "
                         "batch, KV heads and the query sequence split, G whole")
    kv_pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in q_pl)
    kv_grad = tuple(Partial() if p == Shard(3) else r for p, r in zip(q_pl, kv_pl))
    seq = [i for i, p in enumerate(q_pl) if p == Shard(3)]

    def body(ql, kl, vl):
        chunk = 0                       # this shard's place along the sequence
        for i in seq:
            chunk = chunk * mesh.size(i) + mesh.get_local_rank(i)
        return blockwise_attention(ql, kl, vl, q_offset=chunk * ql.shape[3], **kw)

    return local_map(body, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(qg, kg, vg)
