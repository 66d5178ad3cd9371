"""Wrappers of the WKV CUDA kernels, forward and gradient.

`wkv(r, k, v, w, u, state=None, need_state=False)` takes the model's layout
(r, k, v, w [B, H, T, D] float32, u [H, D], state [B, H, D, D] or None for
zeros) and returns (y [B, H, T, D], the final state or None).  It is
differentiable in r, k, v, w, u and state.  For tensors on the CPU it runs
the plain version in `ref.py` (autograd through it is the plain gradient);
for CUDA tensors it runs `wkv_cuda`; any other device raises.

`wkv_cuda` is the kernels, forced: a `torch.autograd.Function` whose
forward launches the forward kernel (saving the state entering every
`CHECKPOINT`-th step when a gradient will be asked for) and whose backward
launches the gradient kernels.  It raises for tensors that are not on a
CUDA device.  The kernels take float32, contiguous tensors with D in
`HEAD_DIMS`; `wkv_cuda` runs any other D up to 256 at the next of them,
zero-padded (`run_padded`), and raises above 256 (at D 512 the forward's
column group of D / 8 threads would pass a warp, and its chunk buffers
196 KB of shared memory).  `launches` counts the kernel calls: "wkv_forward" one per
forward, "wkv_backward" one per gradient (a call launches two CUDA kernels:
dv split over the state's columns, then dr/dk/dw/du and the initial state's
gradient split over its rows; neither needs scratch in device memory).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import build
from .ref import wkv_reference

launches: Dict[str, int] = {"wkv_forward": 0, "wkv_backward": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)
CHECKPOINT = 64          # steps between saved states (csrc/wkv6.cu: CK)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = build.load("wkv6")
    if lib.wkv_forward.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.wkv_forward.argtypes = [P] * 9 + [I] * 4 + [P]
        lib.wkv_forward.restype = I
        lib.wkv_backward.argtypes = [P] * 14 + [I] * 4 + [P]
        lib.wkv_backward.restype = I
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name, r, k, v, w, u, state):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: r is on {dev}; the kernel needs CUDA tensors")
    if r.dim() != 4:
        raise ValueError(f"{name}: r {tuple(r.shape)}; expected [B, H, T, D]")
    B, H, T, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: D={D} (one of {HEAD_DIMS})")
    if B < 1 or H < 1 or T < 1:
        raise ValueError(f"{name}: B={B}, H={H}, T={T}")
    shapes = (("r", r, (B, H, T, D)), ("k", k, (B, H, T, D)), ("v", v, (B, H, T, D)),
              ("w", w, (B, H, T, D)), ("u", u, (H, D)))
    if state is not None:
        shapes += (("state", state, (B, H, D, D)),)
    for n, t, shape in shapes:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {n} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {n} {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, r on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} storage is not 16-byte aligned")
    return B, H, T, D


def head_dim_for(D: int) -> int:
    """The kernels' head size that runs D: the least of `HEAD_DIMS` >= D."""
    for d in HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"wkv: D={D} is above {HEAD_DIMS[-1]}, the largest head size "
                     "the kernels take")


def run_padded(fn, r, k, v, w, u, state=None):
    """fn(r, k, v, w, u, state) -> (y, final state or None) run at D
    zero-padded to `head_dim_for(D)`, its outputs sliced back to D.  Exact:
    padded rows of S start at zero and stay there (k_i = 0), and add nothing
    to y (r_i = 0); padded columns carry v_j = 0 and are sliced away, so
    they take no gradient either."""
    D = r.shape[-1]
    Dp = head_dim_for(D)
    if Dp == D:
        return fn(r, k, v, w, u, state)
    p = (0, Dp - D)
    y, s = fn(*(F.pad(t, p) for t in (r, k, v, w, u)),
              None if state is None else F.pad(state, p + p))
    return y[..., :D], None if s is None else s[..., :D, :D]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with 16-byte aligned storage (the kernels load float4s);
    an incoming gradient can be a view at any offset."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def n_checkpoints(T: int) -> int:
    return -(-T // CHECKPOINT)


def forward_cuda(r, k, v, w, u, state=None, need_state=False, checkpoints=False):
    """The forward kernel: (y, final state or None, saved states or None);
    the saved states are [B, H, ceil(T / CHECKPOINT), D, D]."""
    B, H, T, D = _check("wkv_forward", r, k, v, w, u, state)
    dev = r.device
    y = torch.empty_like(r)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=dev) if need_state else None
    ckpt = (torch.empty((B, H, n_checkpoints(T), D, D), dtype=torch.float32, device=dev)
            if checkpoints else None)
    err = _lib().wkv_forward(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), _ptr(state), y.data_ptr(), _ptr(s_out),
                             _ptr(ckpt), B * H, H, T, D, _stream(dev))
    _raise_on(err, "wkv_forward")
    launches["wkv_forward"] += 1
    return y, s_out, ckpt


def backward_cuda(r, k, v, w, u, ckpt, dy, dstate=None, need_dstate0=False):
    """The gradient kernels: (dr, dk, dv, dw [B, H, T, D], du [H, D], the
    initial state's gradient or None).  `dstate` is the final state's
    gradient (None: zero); `ckpt` the forward's saved states."""
    B, H, T, D = _check("wkv_backward", r, k, v, w, u, None)
    dev = r.device
    for n, t, shape in (("dy", dy, (B, H, T, D)),
                        ("ckpt", ckpt, (B, H, n_checkpoints(T), D, D)),
                        ("dstate", dstate, (B, H, D, D))):
        if t is None and n == "dstate":
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"wkv_backward: {n} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous 16-byte aligned "
                             f"float32 {shape}")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=dev) if need_dstate0 else None
    err = _lib().wkv_backward(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(), _ptr(dstate),
                              dr.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), _ptr(ds0),
                              B * H, H, T, D, _stream(dev))
    _raise_on(err, "wkv_backward")
    launches["wkv_backward"] += 1
    return dr, dk, dv, dw, du_part.sum(0), ds0


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state, need_state):
        ctx.set_materialize_grads(False)
        grad = any(ctx.needs_input_grad[:6])
        y, s_out, ckpt = forward_cuda(r, k, v, w, u, state, need_state, checkpoints=grad)
        if grad:
            ctx.save_for_backward(r, k, v, w, u, ckpt)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        need0 = ctx.needs_input_grad[5]
        dr, dk, dv, dw, du, ds0 = backward_cuda(
            r, k, v, w, u, ckpt, _aligned(dy), None if dstate is None else _aligned(dstate),
            need0)
        return dr, dk, dv, dw, du, ds0, None


def wkv_cuda(r, k, v, w, u, state=None, need_state=False):
    """The kernels, forced: r, k, v, w [B, H, T, D], u [H, D], state
    [B, H, D, D] or None, float32 on a CUDA device, D at most 256 -> (y,
    final state or None), differentiable through the gradient kernels."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv_cuda: r is on {r.device}; the kernel needs CUDA tensors")
    need = bool(need_state)
    return run_padded(lambda *a: _WKV.apply(*a, need), r, k, v, w, u, state)


def wkv(r, k, v, w, u, state=None, need_state=False):
    """Model layout -> (y [B, H, T, D] float32, final state [B, H, D, D] or
    None): the kernels on a CUDA device, the plain version on the CPU (and
    on `meta`, the dry-run's shape-only tensors, where it runs one step
    under `step_trace.repeat(T)` unless `step_trace.unrolled()` asks for
    every step).
    r, k, v are cast to float32 (as `wkv_scan` casts them), or, where r is
    float64, all to float64 (a float64 model on the CPU)."""
    dev = r.device
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    r, k, v, w, u = (t.to(ct) for t in (r, k, v, w, u))
    if state is not None:
        state = state.to(ct)
    if dev.type == "meta":
        from ...launch import step_trace
        if step_trace.by_trip_count():
            # the dry-run: one step of the recurrence, counted T times
            B, H, T, D = r.shape
            y, s = step_trace.scan_by_trip_count(
                wkv_reference, T, *(t[:, :, :1] for t in (r, k, v, w)), u, state)
            return y.expand(B, H, T, D), (s if need_state else None)
    if dev.type in ("cpu", "meta"):
        y, s = wkv_reference(r, k, v, w, u, state)
        return y, (s if need_state else None)
    if dev.type != "cuda":
        raise ValueError(f"wkv: no kernel for device {dev}")
    c = [t.contiguous() for t in (r, k, v, w, u)]
    return wkv_cuda(*c, None if state is None else state.contiguous(), need_state)
