"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
`models/moe.py`, on the CPU in float32, at the reduced Phi-3.5-MoE and
Kimi-K2 configs (Kimi's with its shared expert), with the weights carried
across by `interop.params_from_numpy`.

Routing is exact: the chosen experts and their capacity slots (drops
included) equal the reference's; outputs are within 1e-5 (absolute and
relative: float32 summation order)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.models import moe
from torch_parity import model_configs

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("phi35_moe_42b_a6_6b", "kimi_k2_1t_a32b")


def _twin(arch, **over):
    jcfg, cfg = model_configs(arch, **over)
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params, interop.params_from_numpy(params, cfg)


def _layer(params, l=0):
    return jax.tree.map(lambda a: jnp.asarray(a[l]), params["blocks"]["moe"])


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference_routing(jcfg, jp, xs):
    """(experts [t, K], slots [t*K]) as the reference's `_moe_local` makes them."""
    gates = jnp.einsum("td,de->te", jnp.asarray(xs), jp["router"].astype(jnp.float32))
    _, tope = jax.lax.top_k(jax.nn.softmax(gates, axis=-1), jcfg.top_k)
    t = xs.shape[0]
    cap = max(8, int(jcfg.capacity_factor * t * jcfg.top_k / jcfg.n_experts))
    slot = jmoe._slot_by_group(tope.reshape(-1).astype(jnp.int32), jcfg.n_experts, cap)
    return np.asarray(tope), np.asarray(slot)


@pytest.mark.parametrize("n,groups,cap,seed", [
    (64, 4, 8, 0),        # drops past capacity
    (200, 16, 8, 1),
    (37, 3, 20, 2),       # no drops
    (1, 4, 8, 3),
    (128, 1, 8, 4),       # one group, most dropped
])
def test_slot_by_group_is_bit_exact(n, groups, cap, seed):
    """gid in [0, groups]: the drop bucket (= groups) included."""
    gid = np.random.default_rng(seed).integers(0, groups + 1, n).astype(np.int32)
    want = np.asarray(jmoe._slot_by_group(jnp.asarray(gid), groups, cap))
    got = moe.slot_by_group(torch.from_numpy(gid), groups, cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want == -1).any() == ((np.bincount(gid, minlength=groups + 1)[:groups] > cap).any()
                                  or (gid == groups).any())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_and_ffn_match_reference(arch):
    jcfg, cfg, params, model = _twin(arch)
    jp, p = _layer(params, 1), model.blocks[1].moe
    assert hasattr(p, "shared_wi") == bool(cfg.n_shared_experts)
    xs = _x((40, cfg.d_model), 1)
    tope, topw = moe.route(cfg, p, torch.from_numpy(xs))
    want_e, want_slot = _reference_routing(jcfg, jp, xs)
    assert np.array_equal(tope.numpy(), want_e)
    cap = max(8, int(cfg.capacity_factor * 40 * cfg.top_k / cfg.n_experts))
    slot = moe.slot_by_group(tope.reshape(-1), cfg.n_experts, cap)
    assert np.array_equal(slot.numpy(), want_slot)
    got = moe.moe_local(cfg, p, torch.from_numpy(xs))
    want = jmoe._moe_local(jcfg, jp, jnp.asarray(xs), 0, 1, psum=lambda v: v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = _x((2, 9, cfg.d_model), 2)
    np.testing.assert_allclose(moe.moe_ffn(cfg, p, torch.from_numpy(x)).numpy(),
                               np.asarray(jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch):
    """A router biased towards expert 0 (on inputs with a positive mean):
    every token picks it, more than its capacity holds; the dropped
    assignments and the output equal the reference's."""
    jcfg, cfg, params, _ = _twin(arch)
    moe_p = dict(params["blocks"]["moe"])
    router = moe_p["router"].copy()
    router[:, :, 0] += 0.5
    moe_p["router"] = router
    params = dict(params, blocks=dict(params["blocks"], moe=moe_p))
    model = interop.params_from_numpy(params, cfg)
    jp, p = _layer(params, 0), model.blocks[0].moe
    xs = _x((64, cfg.d_model), 3) + 1.0
    want_e, want_slot = _reference_routing(jcfg, jp, xs)
    assert (want_slot == -1).sum() > 0
    tope, _ = moe.route(cfg, p, torch.from_numpy(xs))
    cap = max(8, int(cfg.capacity_factor * 64 * cfg.top_k / cfg.n_experts))
    slot = moe.slot_by_group(tope.reshape(-1), cfg.n_experts, cap)
    assert np.array_equal(tope.numpy(), want_e)
    assert np.array_equal(slot.numpy(), want_slot)
    got = moe.moe_local(cfg, p, torch.from_numpy(xs))
    want = jmoe._moe_local(jcfg, jp, jnp.asarray(xs), 0, 1, psum=lambda v: v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_combine_is_deterministic_and_in_k_order():
    """Two calls give the same bits; a token's output is the sum of its K
    weighted expert rows taken in k order."""
    _, cfg, _, model = _twin(ARCHS[0])
    p = model.blocks[0].moe
    xs = torch.from_numpy(_x((24, cfg.d_model), 4))
    a, b = moe.moe_local(cfg, p, xs), moe.moe_local(cfg, p, xs)
    assert torch.equal(a, b)


def test_params_keep_the_reference_dtypes():
    """bfloat16: the router stays float32, the experts take the model dtype;
    the expert-by-expert draw fills every expert."""
    _, cfg = model_configs("kimi_k2_1t_a32b", dtype="bfloat16")
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0), cfg.d_model)
    assert p.router.dtype == torch.float32
    for n in ("wi", "wo", "shared_wi", "shared_wo"):
        assert getattr(p, n).dtype == torch.bfloat16, n
    assert p.wi.shape == (cfg.n_experts, cfg.d_model, 2, cfg.moe_d_ff)
    assert all(float(p.wi[e].float().std()) > 0 for e in range(cfg.n_experts))
    std = float(p.wi.float().std()) * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1
