"""Wrappers of the F2 probe/write CUDA kernels (and the legacy first-hop
probe).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current CUDA stream and raises
if the C entry point reports a CUDA error.  For tensors on the CPU (the
tests) it runs the plain version in `ref.py`; for any other device it
raises.  `launches[name]` counts the CUDA kernel launches of each wrapper:
one per `fused_probe` or `probe` call, `WRITE_KERNELS_PER_CALL` per
`fused_write` call (clearing its group table, grouping lanes by key, the RMW
sums, the per-lane plan with its walks, and the append offsets with the slot
chaining).

Every wrapper takes a stacked store's tensors with a leading shard axis
(lanes [S, B], columns [S, C, ...], per-shard scalars [S]) and resolves all S
shards in the launches of one call, or one store's tensors without the axis.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import build
from . import ref

launches: Dict[str, int] = {"fused_probe": 0, "fused_write": 0, "probe": 0}
WRITE_KERNELS_PER_CALL = 5   # f2_fused_write launches five kernels

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_bound: Dict[str, object] = {}   # C function name -> its bound ctypes function


def _bind(name: str, fn: str, n_ptr_in: int, n_int: int, n_ptr_out: int):
    f = _bound.get(fn)
    if f is None:
        f = getattr(build.load(name), fn)
        f.argtypes = [_P] * n_ptr_in + [_I] * n_int + [_P] * n_ptr_out + [_P]
        f.restype = _I
        _bound[fn] = f
    return f


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _pow2(n: int, what: str) -> None:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{what}={n} must be a power of two")


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev) -> int:
    """The current CUDA stream of `dev` as an int (the raw handle, without
    building a `torch.cuda.Stream`, where this PyTorch has the call)."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _shards(keys) -> tuple:
    """(leading shape, S) of a lane batch: ((S,), S) for [S, B], ((), 1) for
    one store's [B]."""
    if keys.ndim not in (1, 2):
        raise ValueError(f"keys: {keys.ndim} dims, expected [B] or [S, B]")
    lead = tuple(keys.shape[:-1])
    return lead, (lead[0] if lead else 1)


def probe_cuda(keys, index_addr):
    """The first-hop kernel, forced: keys [S, B], index_addr [S, E] (E a
    power of two; or [B], [E]) contiguous int32 on a CUDA device -> (addr,
    is_rc) int32 of the keys' shape, as in `ref.probe_reference`."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"probe_cuda: keys are on {dev}; the kernel needs CUDA tensors")
    lead, S = _shards(keys)
    B, E = keys.shape[-1], index_addr.shape[-1]
    _pow2(E, "index size")
    _check("keys", keys, torch.int32, lead + (B,), dev)
    _check("index", index_addr, torch.int32, lead + (E,), dev)
    addr = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    is_rc = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return addr, is_rc
    fn = _bind("probe", "f2_probe", 2, 3, 2)
    err = fn(_ptr(keys), _ptr(index_addr), S, B, E, _ptr(addr), _ptr(is_rc),
             _stream(dev))
    _raise_on(err, "probe")
    launches["probe"] += 1
    return addr, is_rc


def probe(keys, index_addr):
    """The first hop of a key batch: the plain version for CPU tensors, the
    kernel for CUDA tensors; any other device raises."""
    dev = keys.device
    if dev.type == "cpu":
        return ref.probe_reference(keys, index_addr)
    if dev.type != "cuda":
        raise ValueError(f"probe: no kernel for device {dev}")
    return probe_cuda(keys, index_addr)


def _check_probe_inputs(keys, heads_src, lower, active, hb, cols, target,
                        probe_index):
    """fused_probe's input checks (device, dtype, shape, contiguity, powers
    of two) against the device and leading (shard) shape of `keys`, with hb
    the head boundaries as [..., 1]; returns B, E, C, R, V."""
    dev = keys.device
    lead, _ = _shards(keys)
    B, E = keys.shape[-1], heads_src.shape[-1]
    C, R, V = cols[0].shape[-1], cols[4].shape[-1], cols[1].shape[-1]
    _pow2(C, "log capacity")
    _pow2(R, "read-cache capacity")
    i32 = torch.int32
    _check("keys", keys, i32, lead + (B,), dev)
    if probe_index:
        _pow2(E, "index size")
        _check("index", heads_src, i32, lead + (E,), dev)
    else:
        _check("heads", heads_src, i32, lead + (B,), dev)
    _check("lower", lower, i32, lead + (B,), dev)
    _check("active", active, torch.bool, lead + (B,), dev)
    _check("head_boundary", hb, i32, lead + (1,), dev)
    if target is not None:
        _check("target", target, i32, lead + (B,), dev)
    for n, t, shp in zip(("log_key", "log_val", "log_prev", "log_meta",
                          "rc_key", "rc_val", "rc_prev", "rc_meta"), cols,
                         ((C,), (C, V), (C,), (C,), (R,), (R, V), (R,), (R,))):
        _check(n, t, i32, lead + shp, dev)
    return B, E, C, R, V


def fused_probe(keys, heads_src, lower, active, head_boundary,
                log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, *,
                chain_max: int, rc_match: bool = True, has_rc: bool = True,
                probe_index: bool = True, target=None):
    """The fused probe over a key batch of every shard; arguments and
    results as in `ref.fused_probe_body` (head_boundary int32 [S], or 0-d
    for one store).  On a CUDA device the int32 outputs are views of one
    allocation, and the two bool outputs of another."""
    dev = keys.device
    if dev.type == "cpu":
        return ref.fused_probe_body(
            keys, heads_src, lower, active, head_boundary, log_key, log_val, log_prev,
            log_meta, rc_key, rc_val, rc_prev, rc_meta, chain_max=chain_max,
            rc_match=rc_match, has_rc=has_rc, probe_index=probe_index, target=target,
            early_exit=True)
    if dev.type != "cuda":
        raise ValueError(f"fused_probe: no kernel for device {dev}")
    cols = (log_key, log_val, log_prev, log_meta, rc_key, rc_val, rc_prev, rc_meta)
    lead, S = _shards(keys)
    hb = head_boundary.reshape(lead + (1,))
    B, E, C, R, V = _check_probe_inputs(keys, heads_src, lower, active, hb, cols,
                                        target, probe_index)

    n = S * B
    shape = keys.shape
    *lane_outs, value = torch.empty((n * (5 + V),), dtype=torch.int32,
                                    device=dev).split((n, n, n, n, n, n * V))
    addr, heads, meta, hops, ios = (t.view(shape) for t in lane_outs)
    value = value.view(shape + (V,))
    found, exhausted = (t.view(shape) for t in torch.empty(
        (2 * n,), dtype=torch.bool, device=dev).split((n, n)))
    if n == 0:
        return found, addr, heads, value, meta, hops, ios, exhausted
    err = _bind("fused_probe", "f2_fused_probe", 14, 11, 8)(
        keys.data_ptr(), heads_src.data_ptr(), lower.data_ptr(), active.data_ptr(),
        _ptr(target), hb.data_ptr(), *(t.data_ptr() for t in cols),
        S, B, E, C, R, V, chain_max, int(rc_match), int(has_rc), int(probe_index),
        int(target is not None),
        found.data_ptr(), addr.data_ptr(), heads.data_ptr(), value.data_ptr(),
        meta.data_ptr(), hops.data_ptr(), ios.data_ptr(), exhausted.data_ptr(),
        _stream(dev))
    _raise_on(err, "fused_probe")
    launches["fused_probe"] += 1
    return found, addr, heads, value, meta, hops, ios, exhausted


def _write_scratch_words(B: int) -> int:
    f = build.load("fused_write").f2_fused_write_scratch_words
    if f.argtypes is None:
        f.argtypes = [_I]
        f.restype = ctypes.c_longlong
    return int(f(B))


def fused_write(keys, ops, vals, index, begin, head_boundary, ro_addr, tail,
                log_key, log_val, log_prev, log_meta,
                rc_key, rc_val, rc_prev, rc_meta, *, chain_max: int):
    """The fused write-plan pass over the lanes of every shard; arguments
    and the 19-tuple result as in `ref.fused_write_body` (begin/
    head_boundary/ro_addr/tail int32 [S], or 0-d for one store).  The hash
    tables and lane scratch are per shard, `_write_scratch_words(B)` each."""
    cols = (log_key, log_val, log_prev, log_meta, rc_key, rc_val, rc_prev,
            rc_meta)
    dev = keys.device
    if dev.type == "cpu":
        return ref.fused_write_body(keys, ops, vals, index, begin,
                                    head_boundary, ro_addr, tail, *cols,
                                    chain_max=chain_max, early_exit=True)
    if dev.type != "cuda":
        raise ValueError(f"fused_write: no kernel for device {dev}")
    lead, S = _shards(keys)
    B, V = vals.shape[-2:]
    E = index.shape[-1]
    C, R = log_key.shape[-1], rc_key.shape[-1]
    _pow2(C, "log capacity")
    _pow2(R, "read-cache capacity")
    _pow2(E, "index size")
    i32 = torch.int32
    _check("keys", keys, i32, lead + (B,), dev)
    _check("ops", ops, i32, lead + (B,), dev)
    _check("vals", vals, i32, lead + (B, V), dev)
    _check("index", index, i32, lead + (E,), dev)
    for n, t, shp in (("log_key", log_key, (C,)), ("log_val", log_val, (C, V)),
                      ("log_prev", log_prev, (C,)), ("log_meta", log_meta, (C,)),
                      ("rc_key", rc_key, (R,)), ("rc_val", rc_val, (R, V)),
                      ("rc_prev", rc_prev, (R,)), ("rc_meta", rc_meta, (R,))):
        _check(n, t, i32, lead + shp, dev)
    bounds = torch.stack([begin, head_boundary, ro_addr, tail], -1).to(i32)
    _check("bounds", bounds, i32, lead + (4,), dev)

    def lanes(dtype):
        return torch.empty(keys.shape, dtype=dtype, device=dev)

    b, n = torch.bool, i32
    out = (lanes(b), lanes(n), torch.empty(vals.shape, dtype=n, device=dev),
           lanes(b), lanes(b), lanes(b), lanes(b), lanes(n), lanes(b),
           lanes(b), lanes(n), lanes(n), lanes(n), lanes(b), lanes(n),
           lanes(b), lanes(n), lanes(n), lanes(b))
    if B == 0 or S == 0:
        return out
    scratch = torch.empty((S * _write_scratch_words(B),), dtype=n, device=dev)
    fn = _bind("fused_write", "f2_fused_write", 13, 7, 20)
    err = fn(_ptr(keys), _ptr(ops), _ptr(vals), _ptr(index), _ptr(bounds),
             *(_ptr(t) for t in cols), S, B, E, C, R, V, chain_max,
             *(_ptr(t) for t in out), _ptr(scratch), _stream(dev))
    _raise_on(err, "fused_write")
    launches["fused_write"] += WRITE_KERNELS_PER_CALL
    return out
