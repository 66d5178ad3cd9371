"""The port's WKV recurrence (`kernels/rwkv6_wkv`) on the CPU against the
JAX package's: the forward against `wkv_ref` and the Pallas kernel in
interpret mode at tests/test_kernels.py's shapes, and against
`models/rwkv6.wkv_scan` (y and the final state) from a non-zero initial
state, at T = 1, and with decays down to 1e-3; the gradients of r, k, v, w
and u (autograd through the port's plain version, and the plain reverse
recurrence the gradient kernels run) against `jax.grad` of wkv_scan.  The
stated tolerance is tests/test_kernels.py's 2e-3 (absolute and relative);
the differences observed are float32 rounding, below 1e-4.  Last, that the
plain gradient splits over the state's rows and columns, as the gradient
kernels' CTAs do."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.rwkv6_wkv import ops as jwkv
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels.rwkv6_wkv import ops, ref

TOL = 2e-3


def _inputs(B, H, T, D, seed, w_lo=0.8, w_hi=0.999, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (B, H, T, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)).astype(np.float32) if state
          else np.zeros((B, H, D, D), np.float32))
    return r, k, v, w, u, s0


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,H,T,D,chunk", [
    (2, 3, 256, 64, 64), (1, 2, 128, 64, 128), (2, 1, 64, 128, 32),
])
def test_forward_matches_wkv_ref_and_interpret_kernel(B, H, T, D, chunk):
    r, k, v, w, u, _ = _inputs(B, H, T, D, seed=T + D)
    y, s = ops.wkv(*_t(r, k, v, w, u))
    assert s is None and y.dtype == torch.float32 and y.shape == (B, H, T, D)
    jin = [jnp.asarray(a) for a in (r, k, v, w, u)]
    _close(y, jwkv.wkv_ref(*jin))
    _close(y, jwkv.wkv(*jin, chunk=chunk, interpret=True))


@pytest.mark.parametrize("B,H,T,D,w_lo,state", [
    (2, 3, 40, 16, 0.8, True),      # non-zero initial state
    (3, 2, 1, 64, 0.8, True),       # one decode step
    (1, 2, 33, 32, 1e-3, False),    # decays down to 1e-3, ragged T
    (2, 2, 70, 16, 1e-3, True),     # both, over a checkpoint boundary
], ids=["state", "t1", "small_w", "small_w_state"])
def test_forward_matches_wkv_scan(B, H, T, D, w_lo, state):
    r, k, v, w, u, s0 = _inputs(B, H, T, D, seed=7 * T, w_lo=w_lo, state=state)
    y, s = ops.wkv(*_t(r, k, v, w, u), torch.from_numpy(s0) if state else None,
                   need_state=True)
    jy, js = jrwkv.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("B,H,T,D,w_lo,state", [
    (2, 3, 24, 16, 0.8, False), (1, 2, 70, 16, 1e-3, True), (2, 1, 1, 32, 0.5, True),
], ids=["zero_state", "small_w_state", "t1"])
def test_gradients_match_jax_grad_of_wkv_scan(B, H, T, D, w_lo, state):
    """d/d(r, k, v, w, u) of sum(y * c) + sum(S_T * cs), and the initial
    state's gradient from the plain reverse recurrence."""
    r, k, v, w, u, s0 = _inputs(B, H, T, D, seed=11 * T + D, w_lo=w_lo, state=state)
    rng = np.random.default_rng(5)
    c = rng.standard_normal((B, H, T, D)).astype(np.float32)
    cs = rng.standard_normal((B, H, D, D)).astype(np.float32)

    def loss(r, k, v, w, u, s0):
        y, s = jrwkv.wkv_scan(r, k, v, w, u, s0)
        return jnp.sum(y * c) + jnp.sum(s * cs)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    ins = [x.requires_grad_(True) for x in _t(r, k, v, w, u)]
    y, s = ops.wkv(*ins, torch.from_numpy(s0), need_state=True)
    got = torch.autograd.grad((y * torch.from_numpy(c)).sum()
                              + (s * torch.from_numpy(cs)).sum(), ins)
    plain = ref.wkv_backward_reference(*_t(r, k, v, w, u, c, s0, cs))
    for name, a, p, b in zip("rkvwu", got, plain, want):
        _close(a, b)
        _close(p, b)
    _close(plain[5], want[5])


def test_wrappers_refuse_and_count_nothing_on_the_cpu():
    r, k, v, w, u, _ = _t(*_inputs(1, 1, 4, 16, seed=0))
    ops.reset_launches()
    ops.wkv(r, k, v, w, u)
    assert ops.launches == {"wkv_forward": 0, "wkv_backward": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.wkv_cuda(r, k, v, w, u)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.forward_cuda(r, k, v, w, u)
    # meta tensors (the dry-run's) take the plain version too
    meta = r.to("meta")
    y, _ = ops.wkv(meta, meta, meta, meta, u.to("meta"))
    assert y.device.type == "meta" and y.shape == r.shape
    assert ops.launches == {"wkv_forward": 0, "wkv_backward": 0}


def _rows_alone(r, k, v, w, u, dy, s0, ds, rows):
    """The reverse recurrence run on rows `rows` of S and G alone (all of v
    and dy): (dr, dk, dw, du) of those rows and their initial-state rows."""
    T = r.shape[2]
    rr, kk, ww = (x[..., rows] for x in (r, k, w))
    ur = u[:, rows]
    S = s0[:, :, rows, :]
    prev = []
    for t in range(T):
        prev.append(S)
        S = ww[:, :, t, :, None] * S + kk[:, :, t, :, None] * v[:, :, t, None, :]
    G = ds[:, :, rows, :].clone()
    dr, dk, dw = (torch.empty_like(rr) for _ in range(3))
    du = torch.zeros_like(rr[:, :, 0])
    for t in reversed(range(T)):
        vt, dyt = v[:, :, t], dy[:, :, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", prev[t], dyt) + ur * kk[:, :, t] * vdy
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", G, vt) + ur * rr[:, :, t] * vdy
        dw[:, :, t] = (G * prev[t]).sum(-1)
        du += rr[:, :, t] * kk[:, :, t] * vdy
        G = ww[:, :, t, :, None] * G + rr[:, :, t, :, None] * dyt[..., None, :]
    return dr, dk, dw, du.sum(0), G


def _columns_alone(r, k, w, u, dy, ds, cols):
    """The reverse recurrence run on columns `cols` of G alone (all of r, k,
    w): dv of those columns and their initial-state columns."""
    T = r.shape[2]
    G = ds[..., cols].clone()
    dv = torch.empty_like(dy[..., cols])
    for t in reversed(range(T)):
        rt, kt, wt, dyt = r[:, :, t], k[:, :, t], w[:, :, t], dy[:, :, t, cols]
        ruk = (u * rt * kt).sum(-1, keepdim=True)
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", G, kt) + ruk * dyt
        G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return dv, G


@pytest.mark.parametrize("T", [1, 70])
@pytest.mark.parametrize("D", [16, 64])
def test_plain_gradient_is_separable_over_rows_and_columns(D, T):
    """What the gradient kernels rely on to split the state over CTAs: rows
    of S and G evolve alone (dr, dk, dw, du of a block of rows need only
    those rows, with all of v and dy), and columns of G evolve alone (dv of
    a block of columns needs only those columns).  Each block, run alone,
    equals the full plain gradient's rows (columns) within 1e-6."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 3, T, D, seed=D + T, w_lo=1e-3, state=True))
    rng = np.random.default_rng(D * T)
    dy, ds = _t(rng.standard_normal((2, 3, T, D)).astype(np.float32),
                rng.standard_normal((2, 3, D, D)).astype(np.float32))
    dr, dk, dv, dw, du, ds0 = ref.wkv_backward_reference(r, k, v, w, u, dy, s0, ds)
    blk = D // 4
    for b0 in range(0, D, blk):
        sl = slice(b0, b0 + blk)
        got = _rows_alone(r, k, v, w, u, dy, s0, ds, sl)
        for a, want in zip(got, (dr[..., sl], dk[..., sl], dw[..., sl], du[:, sl],
                                 ds0[:, :, sl, :])):
            torch.testing.assert_close(a, want, atol=1e-6, rtol=1e-6)
        gdv, gds0 = _columns_alone(r, k, w, u, dy, ds, sl)
        torch.testing.assert_close(gdv, dv[..., sl], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(gds0, ds0[..., sl], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T", [1, 70])
@pytest.mark.parametrize("D", [16, 64])
def test_plain_forward_is_separable_over_columns(D, T):
    """What the forward kernel relies on to split the state's columns over
    CTAs: column j of S evolves alone, and y_j needs only it (with all of
    r, k and w).  Each block of columns, run alone from its columns of the
    initial state, equals the full y's and final state's columns within
    1e-6."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 3, T, D, seed=3 * D + T, w_lo=1e-3, state=True))
    y, s = ref.wkv_reference(r, k, v, w, u, s0)
    blk = D // 4
    for b0 in range(0, D, blk):
        sl = slice(b0, b0 + blk)
        S = s0[..., sl].clone()
        ys = []
        for t in range(T):
            rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t, sl], w[:, :, t]
            kv = kt[..., :, None] * vt[..., None, :]
            ys.append(torch.einsum("bhi,bhij->bhj", rt, S + u[None, :, :, None] * kv))
            S = wt[..., :, None] * S + kv
        torch.testing.assert_close(torch.stack(ys, 2), y[..., sl], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(S, s[..., sl], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("D", [24, 48, 100])
def test_padding_to_a_kernel_head_size_is_exact(D):
    """`ops.run_padded` runs a head size the kernels lack at the next one,
    zero-padded, and slices back: around the plain version it equals the
    plain version at the native D (y, the final state, and the gradients of
    r, k, v, w, u and the initial state) within 1e-6.  Both run in float64,
    so that what is compared is the padding, not the float32 rounding of
    sums over D and over the padded size, which add in other orders."""
    assert ops.head_dim_for(D) == min(d for d in ops.HEAD_DIMS if d >= D)
    r, k, v, w, u, s0 = (x.double() for x in _t(*_inputs(2, 2, 21, D, seed=D, w_lo=1e-3,
                                                          state=True)))
    rng = np.random.default_rng(D)
    dy, ds = _t(rng.standard_normal((2, 2, 21, D)), rng.standard_normal((2, 2, D, D)))

    def run(fn):
        ins = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s0)]
        y, s = fn(*ins)
        assert y.shape == (2, 2, 21, D) and s.shape == (2, 2, D, D)
        grads = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
        return (y.detach(), s.detach()) + grads

    want = run(ref.wkv_reference)
    got = run(lambda *a: ops.run_padded(ref.wkv_reference, *a))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_head_sizes_above_the_largest_kernel_raise():
    assert ops.head_dim_for(128) == 128
    assert ops.head_dim_for(160) == ops.head_dim_for(256) == 256
    with pytest.raises(ValueError, match="D=300"):
        ops.head_dim_for(300)
