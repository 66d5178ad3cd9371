"""Head dims that the kernels lack, and the limits the wrappers lift.

The flash wrapper runs any head dim at `ops.head_dim_for(dtype, Dh)`: for
bfloat16 the least tensor-core width at or above Dh (past 256 a multiple
of 128), for float32 the next multiple of 4.  It zero-pads q, k and v
there (`ops.pad_head_dim`), launches with the true Dh's scale, and slices
the output and the gradients back.  Here that padding runs around the
plain version (`ref.mha_reference` with `scale=`) at Dh 6, 50, 60, 80 and
300, at both dtypes' widths, against the JAX package:
`repro.models.layers.flash_attention` (the models' blockwise attention)
and the Pallas kernel in interpret mode, forward within 2e-5 and the loss
gradient against `jax.grad` within 1e-5, in float32, as
tests/test_torch_flash_attention.py holds them; the padded head dim's own
scale misses the reference.  Then the paged wrapper's head groups where q
would pass the split kernel's shared memory (`group_limit`), and the WKV
wrapper's padding to D 256 (`run_padded` at D 160) against the reference's
Pallas kernel in interpret mode."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.rwkv6_wkv import ops as jwkv
from repro.models import layers as jl
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tfa_ref
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.rwkv6_wkv import ops as twkv
from repro_torch.kernels.rwkv6_wkv import ref as twkv_ref

HEAD_DIMS = [6, 50, 60, 80, 300]
DTYPES = [torch.bfloat16, torch.float32]     # whose widths the padding takes
# (B, Hq, Hkv, T, causal, window)
SHAPE = (1, 4, 2, 64, True, 24)


def _inputs(dh, seed):
    B, Hq, Hkv, T = SHAPE[:4]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, T, dh), (B, Hkv, T, dh), (B, Hkv, T, dh),
                           (B, Hq, T, dh)))


def _padded_plain(q, k, v, width, scale=None):
    """The wrapper's padding around the plain version, model layout."""
    B, Hq, T, dh = q.shape
    Hkv = k.shape[1]
    qp, kp, vp = tfa.pad_head_dim(width, q.reshape(B * Hkv, Hq // Hkv, T, dh),
                                  k.reshape(B * Hkv, 1, T, dh), v.reshape(B * Hkv, 1, T, dh))
    out = tfa_ref.mha_reference(qp, kp, vp, causal=SHAPE[4], window=SHAPE[5],
                                scale=dh ** -0.5 if scale is None else scale)
    return out[..., :dh].reshape(B, Hq, T, dh)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_every_bf16_head_dim_takes_the_tensor_cores():
    """bf16 runs on the tensor cores at every head dim, float32 on the CUDA
    cores; the widths: the instantiated ones, multiples of 128 past 256,
    multiples of 4 in float32."""
    for dh in (1, 6, 50, 60, 80, 96, 100, 255, 300, 512, 1000):
        assert tfa.route(torch.bfloat16, dh) == "tc"
        assert tfa.route(torch.float32, dh) == "simt"
    got = [tfa.head_dim_for(torch.bfloat16, d) for d in (6, 50, 60, 80, 96, 100, 129, 257,
                                                         300, 512, 513)]
    assert got == [16, 64, 64, 80, 96, 112, 256, 384, 384, 512, 640]
    assert [tfa.head_dim_for(torch.float32, d) for d in (1, 6, 50, 64, 300)] == [
        4, 8, 52, 64, 300]
    assert set(tfa.TC_HEAD_DIMS) >= {80, 96}
    with pytest.raises(ValueError, match="Dh=0"):
        tfa.head_dim_for(torch.bfloat16, 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16_width", "f32_width"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_padded_forward_matches_reference(dh, dtype):
    """Zero-padded to the route's width, with Dh's scale, and sliced back:
    the models' attention and the Pallas kernel in interpret mode."""
    width = tfa.head_dim_for(dtype, dh)
    q, k, v, _ = _inputs(dh, dh)
    got = _padded_plain(*(torch.from_numpy(x) for x in (q, k, v)), width)
    assert got.shape == q.shape
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    causal, window = SHAPE[4], SHAPE[5]
    _close(got, jl.flash_attention(jq, jk, jv, causal=causal,
                                   window=jnp.asarray(window, jnp.int32)), 2e-5)
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True), 2e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16_width", "f32_width"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_padded_gradients_match_reference(dh, dtype):
    """Autograd through the padding, the plain version and the slice (the
    gradients sliced back to Dh) against jax.grad of the models'
    attention."""
    width = tfa.head_dim_for(dtype, dh)
    q, k, v, do = _inputs(dh, dh + 1)
    causal, window = SHAPE[4], SHAPE[5]

    def loss(q, k, v):
        out = jl.flash_attention(q, k, v, causal=causal,
                                 window=jnp.asarray(window, jnp.int32))
        return jnp.sum(out * do)

    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(_padded_plain(*ts, width), ts, torch.from_numpy(do))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for name, g, jg, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dh", [6, 50, 300])
def test_padded_width_scale_misses_reference(dh):
    """The scale must stay the true head dim's: the padded width's Dh^-0.5
    gives another softmax."""
    width = tfa.head_dim_for(torch.bfloat16, dh)
    assert width != dh
    q, k, v, _ = _inputs(dh, dh)
    got = _padded_plain(*(torch.from_numpy(x) for x in (q, k, v)), width,
                        scale=width ** -0.5)
    want = np.asarray(jl.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal=SHAPE[4],
                                         window=jnp.asarray(SHAPE[5], jnp.int32)))
    assert np.abs(got.numpy() - want).max() > 1e-2


def test_paged_head_groups_fit_shared_memory():
    """Where G query heads' q would pass the split kernel's shared memory,
    the wrapper launches the largest groups that fit: G 16 at Dh 4,096
    (float32 pools) as two groups of 8, each within SMEM_LIMIT; at the
    head dims that fitted before, MAX_GROUP; and no group where one head
    does not fit."""
    most = tpa.group_limit(4096, 4)
    assert most == 8
    assert tpa.split_smem_bytes(most, 4096, 4) <= tpa.SMEM_LIMIT
    assert tpa.split_smem_bytes(most + 1, 4096, 4) > tpa.SMEM_LIMIT
    assert tfa.head_groups(16, most) == [8, 8]
    for dh, elem in ((128, 4), (512, 4), (1024, 4), (1024, 2)):
        assert tpa.group_limit(dh, elem) == tpa.MAX_GROUP
    assert 1 <= tpa.group_limit(2048, 4) < tpa.MAX_GROUP
    assert tpa.group_limit(40000, 4) == 0


def test_wkv_run_padded_at_d160_matches_interpret_kernel():
    """D 160 runs at 256 zero-padded (`run_padded` around the plain
    version): y against the reference's Pallas kernel in interpret mode and
    its `wkv_ref`, at tests/test_kernels.py's 2e-3."""
    assert twkv.head_dim_for(160) == 256
    B, H, T, D = 1, 2, 32, 160
    rng = np.random.default_rng(D)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, H, T, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    y, s = twkv.run_padded(twkv_ref.wkv_reference,
                           *(torch.from_numpy(a) for a in (r, k, v, w, u)))
    assert y.shape == (B, H, T, D) and s.shape == (B, H, D, D)
    jin = [jnp.asarray(a) for a in (r, k, v, w, u)]
    for want in (jwkv.wkv(*jin, chunk=32, interpret=True), jwkv.wkv_ref(*jin)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
