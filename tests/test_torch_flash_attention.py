"""The port's flash attention on the CPU (its plain version, `ref.py`, and
autograd through it) against the JAX package: the Pallas kernel in
interpret mode and its oracle `flash_attention_reference`, at
tests/test_kernels.py's eight cases and at query and key lengths that
differ (Tq != Tk: cross-attention, causal with either longer, a window, and
rows that see no key), within that file's tolerances (2e-5 in float32, 2e-2
in bfloat16); at a ragged T, against the oracle and the models' blockwise
`layers.flash_attention` (the Pallas kernel does not mask past Tk and
interpret mode pads its last block with NaN, so it is held only where
min(512, Tk) divides Tk); and the gradients against `jax.grad` of
`repro.models.layers.flash_attention` (the blockwise jnp loop the JAX
models train through) and of the oracle at 1e-5 in float32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.models import layers as jl
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import layers as tl

# (B, Hq, Hkv, Tq, Tk, Dh, causal, window): tests/test_kernels.py's shapes,
# then query and key lengths that differ: non-causal cross-attention, causal
# with Tq > Tk (rows at and past Tk see every key), causal with a window and
# Tk > Tq (keys past Tq are seen by no query: exact-zero dK and dV), a
# whisper-like cross shape (7 decoder tokens over 150 encoder frames), and a
# window with Tq > Tk whose rows 79 and up see no key (the reference
# averages V over all Tk keys there)
SHAPES = [(2, 4, 2, 256, 256, 64, True, 0),
          (1, 2, 1, 128, 128, 128, True, 64),
          (2, 2, 2, 256, 256, 64, False, 0),
          (1, 8, 1, 512, 512, 64, True, 0),      # MQA
          (1, 4, 2, 64, 128, 32, False, 0),
          (1, 4, 2, 128, 64, 32, True, 0),
          (1, 4, 2, 64, 256, 32, True, 40),
          (1, 4, 2, 7, 150, 64, False, 0),
          (1, 4, 2, 300, 64, 32, True, 16)]
SHAPE_IDS = ["gqa", "window", "noncausal", "mqa", "cross_q64_k128", "causal_q128_k64",
             "causal_window_q64_k256", "whisper_q7_k150", "blind_rows_q300_k64"]
RAGGED = (1, 4, 2, 600, 600, 32, True, 40)


def _inputs(shape, seed):
    B, Hq, Hkv, Tq, Tk, Dh = shape[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, Tq, Dh), (B, Hkv, Tk, Dh), (B, Hkv, Tk, Dh),
                           (B, Hq, Tq, Dh)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas_kernel_and_oracle(shape, dtype):
    Tk, causal, window = shape[4], shape[6], shape[7]
    assert Tk % min(512, Tk) == 0       # where the Pallas kernel is defined
    q, k, v, _ = _inputs(shape, 0)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True), tol)
    _close(got, jfa.flash_attention_reference(jq, jk, jv, causal=causal,
                                              window=window), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_ragged_t(dtype):
    """T = 600, which no 512- or 1024-key block divides."""
    causal, window = RAGGED[6], RAGGED[7]
    q, k, v, _ = _inputs(RAGGED, 1)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jl.flash_attention(jq, jk, jv, causal=causal, block_kv=512,
                                   window=jnp.asarray(window, jnp.int32)), tol)
    _close(got, jfa.flash_attention_reference(jq, jk, jv, causal=causal,
                                              window=window), tol)


@pytest.mark.parametrize("shape", SHAPES + [RAGGED], ids=SHAPE_IDS + ["ragged"])
def test_gradients_match_jax_models_attention(shape):
    """Against jax.grad of the models' blockwise attention and of the
    oracle; where causal with Tk > Tq, dK and dV of the keys that no query
    sees are exact zeros."""
    Tq, Tk, causal, window = shape[3], shape[4], shape[6], shape[7]
    q, k, v, do = _inputs(shape, 2)

    def models_loss(q, k, v):
        out = jl.flash_attention(q, k, v, causal=causal,
                                 window=jnp.asarray(window, jnp.int32))
        return jnp.sum(out * do)

    def oracle_loss(q, k, v):
        out = jfa.flash_attention_reference(q, k, v, causal=causal, window=window)
        return jnp.sum(out * do)

    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tl.flash_attention(*ts, causal=causal, window=window)
    tgrads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for loss in (models_loss, oracle_loss):
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        for name, g, jg in zip("qkv", tgrads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} ({loss.__name__})")
    if causal and Tk > Tq:
        for name, g in zip("kv", tgrads[1:]):
            assert torch.count_nonzero(g[:, :, Tq:]) == 0, name


def test_cpu_tensors_take_the_plain_version():
    q, k, v, _ = _inputs(SHAPES[0], 3)
    tfa.reset_launches()
    tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert tfa.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_cuda(*(torch.from_numpy(x) for x in (q, k, v)))
    # meta tensors (the dry-run's) take the plain version too
    meta = torch.empty((1, 2, 8, 16), device="meta")
    out = tfa.flash_attention(meta, meta[:, :1], meta[:, :1])
    assert out.device.type == "meta" and out.shape == meta.shape
    assert tfa.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("dtype,head_dim,want",
                         [(torch.bfloat16, d, "tc") for d in tfa.TC_HEAD_DIMS]
                         + [(torch.float32, d, "simt") for d in (64, 112, 128, 256)]
                         + [(torch.bfloat16, d, "tc") for d in (4, 60, 96, 200)])
def test_route_picks_tensor_cores_for_bf16_at_instantiated_head_dims(dtype, head_dim, want):
    assert tfa.route(dtype, head_dim) == want


# the tensor-core route's shapes that SHAPES lacks (B, Hq, Hkv, Tq, Tk, Dh,
# causal, window): GLM-4-9B's grouping (G 16 at Dh 128), Kimi's Dh 112,
# Gemma-7B's Dh 256
TC_SHAPES = [(1, 16, 1, 256, 256, 128, True, 0),
             (2, 8, 2, 256, 256, 112, True, 0),
             (1, 4, 2, 256, 256, 256, True, 0)]


@pytest.mark.parametrize("shape", TC_SHAPES, ids=["g16", "dh112", "dh256"])
def test_forward_at_tensor_core_shapes_matches_pallas_kernel_and_oracle(shape):
    causal, window = shape[6], shape[7]
    q, k, v, _ = _inputs(shape, 4)
    jq, jk, jv = (jnp.asarray(x, "bfloat16") for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, jfa.flash_attention_reference(jq, jk, jv, causal=causal, window=window),
           2e-2)
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True), 2e-2)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tc_gradient(q, k, v, do, causal, window):
    """The tensor-core kernels' gradient in plain torch: bf16 inputs, float32
    scores and accumulators, P rounded to bf16 before P.V and P^T.dO, dS
    rounded to bf16 before dS.K and dS^T.Q, outputs rounded to bf16.  Kernel
    layout: q [BH, G, T, Dh], k/v [BH, 1, T, Dh], all float32 holding bf16
    values."""
    T, Dh = q.shape[2], q.shape[3]
    scale = Dh ** -0.5
    i = torch.arange(T)
    mask = torch.ones(T, T, dtype=torch.bool)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    s = torch.where(mask, q @ k.transpose(-1, -2) * scale, torch.tensor(-1e30))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), torch.tensor(0.0))
    o = _bf16(_bf16(p) @ v)
    d = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - d)
    dq = _bf16(_bf16(ds) @ k * scale)
    dk = _bf16((_bf16(ds).transpose(-1, -2) @ q).sum(1, keepdim=True) * scale)
    dv = _bf16((_bf16(p).transpose(-1, -2) @ do).sum(1, keepdim=True))
    return dq, dk, dv


@pytest.mark.parametrize("window", [0, 100], ids=["causal", "windowed"])
def test_bf16_rounded_gradient_within_tolerance_of_float32_gradient(window):
    """P and dS rounded to bf16 before their products, as the tensor-core
    kernels round them, keep every gradient within 2e-2 of the largest
    float32 gradient of the JAX models' attention (the card's bf16
    tolerance), at T 1024, Dh 128, G 4."""
    shape = (1, 4, 1, 1024, 1024, 128, True, window)
    q, k, v, do = (_bf16(torch.from_numpy(x)).numpy() for x in _inputs(shape, 5))

    def jloss(q, k, v):
        out = jl.flash_attention(q, k, v, causal=True, window=jnp.asarray(window, jnp.int32))
        return jnp.sum(out * do)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    G = shape[1] // shape[2]
    kr = [torch.from_numpy(x).reshape(1, G, 1024, 128) for x in (q, do)]
    kv = [torch.from_numpy(x).reshape(1, 1, 1024, 128) for x in (k, v)]
    got = _tc_gradient(kr[0], kv[0], kv[1], kr[1], True, window)
    for name, g, jg in zip("qkv", got, jgrads):
        ref = np.asarray(jg).reshape(g.shape)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 2e-2 * float(np.abs(ref).max()), (name, err)
        assert err > 0, name          # the rounding is there
