"""MoE's expert-parallel branch (`repro_torch.models.moe.moe_ffn` under an
active mesh) on two gloo ranks of a 1 x 2 (data x model) CPU mesh, at the
reduced Phi-3.5-MoE config in float32: each rank slots the assignments of
its E/2 experts and an all-reduce over `model` sums the partial outputs.

The output equals the sum over s = 0, 1 of the JAX package's
`_moe_local(cfg, p_s, xs, s, 2, psum=identity)` within 1e-6 relative
(float32; the two packages' matmuls round differently), and equals the
port's one-device path bit for bit (a token's contributions meet in the
same k order, each with exact zeros from the rank that lacks its expert).
The gradient with respect to the tokens sums the ranks' partial shares
over `model` and is within 1e-6 relative of the one-device gradient."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.distributed import sharding
from repro_torch.models import moe
from torch_parity import model_configs

ARCH = "phi35_moe_42b_a6_6b"


def _spawn_ranks(tmp_path, payload, world=2):
    import torch.multiprocessing as mp
    import torch_ep_worker
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **payload)
    mp.spawn(torch_ep_worker.run, nprocs=world,
             args=(world, str(tmp_path / "init"), str(inp), str(out)))
    return np.load(out)


def test_expert_parallel_matches_reference_two_shards(tmp_path):
    jcfg, cfg = model_configs(ARCH)
    assert cfg.n_experts % 2 == 0
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    lp = {k: np.asarray(v[0], np.float32)
          for k, v in params["blocks"]["moe"].items()}
    B, T, D = 2, 16, cfg.d_model
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    res = _spawn_ranks(tmp_path, dict(cfg=np.array(interop.model_config_to_dict(cfg),
                                                   dtype=object),
                                      router=lp["router"], wi=lp["wi"],
                                      wo=lp["wo"], x=x))
    E_loc = cfg.n_experts // 2
    ref = sum(np.asarray(jmoe._moe_local(
        jcfg, {"router": jnp.asarray(lp["router"]),
               "wi": jnp.asarray(lp["wi"][s * E_loc:(s + 1) * E_loc]),
               "wo": jnp.asarray(lp["wo"][s * E_loc:(s + 1) * E_loc])},
        jnp.asarray(x.reshape(-1, D)), s, 2, psum=lambda v: v))
        for s in range(2)).reshape(B, T, D)
    np.testing.assert_allclose(res["ep"], ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the output bit-exact with the port's one-device path; the gradient
    # sums the ranks' partial shares, in another order: within 1e-6
    assert np.array_equal(res["ep"], res["local"])
    np.testing.assert_allclose(res["g_ep"], res["g_local"], rtol=1e-6,
                               atol=1e-6 * np.abs(res["g_local"]).max())
    # and the one-device path in this process agrees with the ranks'
    p = moe.MoE(*(torch.from_numpy(lp[k]) for k in ("router", "wi", "wo")))
    assert np.array_equal(moe.moe_ffn(cfg, p, torch.from_numpy(x)).numpy(), res["local"])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_moe_local_shards_sum_to_one_device(n_shards):
    """`moe_local` with shard_id/n_shards, psum left to the caller: the
    shards' partial outputs sum to the one-device output bit for bit, and
    each equals the reference's `_moe_local` shard within 1e-6."""
    jcfg, cfg = model_configs(ARCH)
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(1)))
    lp = {k: np.asarray(v[0], np.float32) for k, v in params["blocks"]["moe"].items()}
    xs = np.random.default_rng(1).standard_normal((40, cfg.d_model)).astype(np.float32)
    E_loc = cfg.n_experts // n_shards
    whole = moe.moe_local(cfg, moe.MoE(*(torch.from_numpy(lp[k]) for k in
                                         ("router", "wi", "wo"))), torch.from_numpy(xs))
    parts = []
    for s in range(n_shards):
        sl = slice(s * E_loc, (s + 1) * E_loc)
        p_s = moe.MoE(torch.from_numpy(lp["router"]), torch.from_numpy(lp["wi"][sl]),
                      torch.from_numpy(lp["wo"][sl]))
        y = moe.moe_local(cfg, p_s, torch.from_numpy(xs), s, n_shards)
        ref = np.asarray(jmoe._moe_local(
            jcfg, {"router": jnp.asarray(lp["router"]), "wi": jnp.asarray(lp["wi"][sl]),
                   "wo": jnp.asarray(lp["wo"][sl])}, jnp.asarray(xs), s, n_shards,
            psum=lambda v: v))
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(ref).max(), 1e-30))
        parts.append(y)
    total = parts[0]
    for y in parts[1:]:
        total = total + y
    assert torch.equal(total, whole)


def test_no_mesh_or_indivisible_model_axis_keeps_the_local_path():
    """With no active mesh, or a mesh whose model axis does not divide the
    experts, `moe_ffn` takes the one-device path."""
    _, cfg = model_configs(ARCH)

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": cfg.n_experts + 1}
    assert not moe._ep_ready(cfg, None)
    assert not moe._ep_ready(cfg, FakeMesh())
    FakeMesh.shape = {"data": 1, "model": 2}
    assert moe._ep_ready(cfg, FakeMesh())
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(cfg, gen, cfg.d_model)
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    with sharding.use_mesh(None):
        a = moe.moe_ffn(cfg, p, x)
    assert torch.equal(a, moe.moe_ffn(cfg, p, x))
