"""The port's selective SSM (`repro_torch.models.ssm`) against the JAX
package's `models/ssm.py`, on the CPU in float32 at the reduced Hymba
config, with the weights carried across by `interop.params_from_numpy`
(the conv and the step-size weights randomised, so the state and the
selective step reach the output).  Tolerance 1e-5, absolute and relative
(float32 summation order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.models import ssm
from torch_parity import model_configs

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def twin():
    jcfg, cfg = model_configs("hymba_1_5b")
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    S = dict(params["blocks"]["ssm"])
    S["wdt"] = rng.normal(0, 1.0, S["wdt"].shape).astype(np.float32)
    S["dt_bias"] = rng.uniform(-3, 1, S["dt_bias"].shape).astype(np.float32)
    S["dskip"] = rng.normal(1, 0.5, S["dskip"].shape).astype(np.float32)
    params = dict(params, blocks=dict(params["blocks"], ssm=S))
    return jcfg, cfg, params, interop.params_from_numpy(params, cfg)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jp(params, l):
    return jax.tree.map(lambda a: jnp.asarray(a[l]), params["blocks"]["ssm"])


def _state(cfg, B, seed):
    din = cfg.ssm_expand * cfg.d_model
    return (_x((B, ssm.CONV_K - 1, din), seed), _x((B, din, cfg.ssm_state), seed + 1))


def test_causal_conv_matches_reference():
    x, w, st = _x((2, 7, 12), 1), _x((ssm.CONV_K, 12), 2), _x((2, ssm.CONV_K - 1, 12), 3)
    out, new = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(st))
    jout, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert np.array_equal(new.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("T", [1, 11])
def test_ssm_mix_matches_reference(twin, T):
    jcfg, cfg, params, model = twin
    B = 2
    x = _x((B, T, cfg.d_model), 4)
    conv, h = _state(cfg, B, 5)
    y, st = ssm.ssm_mix(cfg, model.blocks[1].ssm, torch.from_numpy(x),
                        {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)})
    jy, jst = jssm.ssm_mix(jcfg, _jp(params, 1), jnp.asarray(x),
                           {"conv": jnp.asarray(conv), "h": jnp.asarray(h)})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]), **TOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]), **TOL)


def test_sequence_equals_token_by_token(twin):
    """One ssm_mix over T tokens equals T one-token calls that carry the
    conv tail and the state (the decode path against prefill's)."""
    _, cfg, _, model = twin
    B, T = 3, 9
    p = model.blocks[0].ssm
    x = torch.from_numpy(_x((B, T, cfg.d_model), 6))
    st0 = ssm.init_ssm_state(cfg, B, torch.float32)
    y, st = ssm.ssm_mix(cfg, p, x, st0)
    carry, ys = ssm.init_ssm_state(cfg, B, torch.float32), []
    for t in range(T):
        yt, carry = ssm.ssm_mix(cfg, p, x[:, t:t + 1], carry)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(carry["h"].numpy(), st["h"].numpy(), **TOL)
    np.testing.assert_allclose(carry["conv"].numpy(), st["conv"].numpy(), **TOL)


def test_softplus_is_the_references_above_twenty():
    """jax.nn.softplus is logaddexp(x, 0): log1p(exp(-x)) is still added
    above 20, where torch's F.softplus returns x itself."""
    v = np.array([-30.0, -1.0, 0.0, 5.0, 20.5, 25.0, 80.0], np.float32)
    got = torch.logaddexp(torch.from_numpy(v), torch.zeros(()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.nn.softplus(jnp.asarray(v))))


def test_params_keep_the_reference_dtypes(twin):
    _, cfg, params, _ = twin
    import dataclasses
    bf = interop.params_from_numpy(params, dataclasses.replace(cfg, dtype="bfloat16"))
    s = bf.blocks[0].ssm
    for n in ssm.NAMES:
        want = torch.bfloat16 if n in ssm.CAST else torch.float32
        assert getattr(s, n).dtype == want, n
    made = ssm.ssm_params(dataclasses.replace(cfg, dtype="bfloat16"),
                          torch.Generator().manual_seed(0), cfg.d_model)
    for n in ssm.NAMES:
        assert getattr(made, n).dtype == getattr(s, n).dtype, n
        assert getattr(made, n).shape == getattr(s, n).shape, n
