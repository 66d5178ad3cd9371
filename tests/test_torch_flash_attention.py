"""The port's flash attention on the CPU (its plain version, `ref.py`, and
autograd through it) against the JAX package: the Pallas kernel in
interpret mode and its oracle `flash_attention_reference`, at
tests/test_kernels.py's eight cases, within that file's tolerances (2e-5 in
float32, 2e-2 in bfloat16); at a ragged T, against the oracle and the
models' blockwise `layers.flash_attention` (the Pallas kernel reads past T
and interpret mode pads its last block with NaN); and the gradients against
`jax.grad` of `repro.models.layers.flash_attention` (the blockwise jnp loop
the JAX models train through) at 1e-5 in float32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.models import layers as jl
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import layers as tl

# tests/test_kernels.py's shapes, then a T that no kv block divides
SHAPES = [(2, 4, 2, 256, 64, True, 0),
          (1, 2, 1, 128, 128, True, 64),
          (2, 2, 2, 256, 64, False, 0),
          (1, 8, 1, 512, 64, True, 0)]       # MQA
RAGGED = (1, 4, 2, 600, 32, True, 40)


def _inputs(shape, seed):
    B, Hq, Hkv, T, Dh = shape[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, T, Dh), (B, Hkv, T, Dh), (B, Hkv, T, Dh),
                           (B, Hq, T, Dh)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=["gqa", "window", "noncausal", "mqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas_kernel_and_oracle(shape, dtype):
    causal, window = shape[5], shape[6]
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
    causal, window = RAGGED[5], RAGGED[6]
    q, k, v, _ = _inputs(RAGGED, 1)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jl.flash_attention(jq, jk, jv, causal=causal, block_kv=512,
                                   window=jnp.asarray(window, jnp.int32)), tol)
    _close(got, jfa.flash_attention_reference(jq, jk, jv, causal=causal,
                                              window=window), tol)


@pytest.mark.parametrize("shape", SHAPES + [RAGGED],
                         ids=["gqa", "window", "noncausal", "mqa", "ragged"])
def test_gradients_match_jax_models_attention(shape):
    causal, window = shape[5], shape[6]
    q, k, v, do = _inputs(shape, 2)

    def jloss(q, k, v):
        out = jl.flash_attention(q, k, v, causal=causal,
                                 window=jnp.asarray(window, jnp.int32))
        return jnp.sum(out * do)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tl.flash_attention(*ts, causal=causal, window=window)
    tgrads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for name, g, jg in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, _ = _inputs(SHAPES[0], 3)
    tfa.reset_launches()
    tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert tfa.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_cuda(*(torch.from_numpy(x) for x in (q, k, v)))
    meta = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention(meta, meta[:, :1], meta[:, :1])
