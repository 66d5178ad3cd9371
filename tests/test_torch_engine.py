"""The port's serving engine against the JAX package's, on
tests/test_engine.py's two scenarios (granite reduced, page_size 8): the
same weights (carried by `interop.params_from_numpy`) and prompts give the
same tokens and the same tiering counters.  Also: the port's paged backend
equals its contiguous backend on three dense configs, the weight interop
round trip, and `init_params` against the reference's shapes and spreads."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.models import transformer as jtf
from repro.models.registry import get_config as jget
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch import interop
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine, Request


def _model(arch):
    jcfg = jget(arch).reduced()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = interop.model_config_from_dict(interop.model_config_to_dict(jcfg))
    return jcfg, params, cfg, interop.params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


@pytest.fixture(scope="module")
def granite():
    return _model("granite_3_8b")


def _prompts_equal(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, 5).astype(np.int32) for _ in range(4)]


def _prompts_ragged(cfg):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(6):
        plen = int(rng.integers(3, 12))
        out.append(rng.integers(1, cfg.vocab_size, plen).astype(np.int32))
    return out


def _run(make, req_cls, prompts, new_tokens):
    eng = make()
    for i, pr in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=pr, max_new_tokens=new_tokens))
    fin = eng.run()
    return eng, {r.rid: r.out_tokens for r in fin}


def _port_engine(cfg, model, backend):
    return lambda: Engine(cfg, model, max_batch=2, max_len=64, backend=backend,
                          page_size=8, device="cpu")


def test_paged_matches_contiguous_and_reference(granite):
    jcfg, params, cfg, model = granite
    prompts = _prompts_equal(cfg)
    _, want = _run(lambda: JEngine(jcfg, params, max_batch=2, max_len=64,
                                   backend="paged", page_size=8),
                   JRequest, prompts, 6)
    for backend in ("paged", "contiguous"):
        _, got = _run(_port_engine(cfg, model, backend), Request, prompts, 6)
        assert got == want, backend


def test_ragged_continuous_batching_with_tiering(granite):
    jcfg, params, cfg, model = granite
    prompts = _prompts_ragged(cfg)
    je, want = _run(lambda: JEngine(jcfg, params, max_batch=2, max_len=64,
                                    backend="paged", page_size=8),
                    JRequest, prompts, 10)
    te, got = _run(_port_engine(cfg, model, "paged"), Request, prompts, 10)
    assert got == want
    assert len(got) == 6 and all(len(t) == 10 for t in got.values())
    assert (te.pkv.demotions, te.pkv.promotions, int(te.pkv.state.cold_reads)) == \
        (je.pkv.demotions, je.pkv.promotions, int(je.pkv.state.cold_reads))
    assert te.pkv.demotions > 0 and int(te.pkv.state.cold_reads) > 0
    assert np.array_equal(te.pkv.state.ref_count.numpy(),
                          np.asarray(je.pkv.state.ref_count))
    np.testing.assert_allclose(te.pkv.state.k_pool.numpy(),
                               np.asarray(je.pkv.state.k_pool), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["glm4_9b", "gemma_7b"])
def test_paged_matches_contiguous_other_dense(arch):
    """glm4: half rotary, KV=2; gemma: GeGLU, embedding scale, head_dim."""
    _, _, cfg, model = _model(arch)
    prompts = _prompts_equal(cfg)
    outs = {b: _run(_port_engine(cfg, model, b), Request, prompts, 6)[1]
            for b in ("paged", "contiguous")}
    assert outs["paged"] == outs["contiguous"]


def test_interpret_switch_gives_the_same_tokens(granite):
    _, _, cfg, model = granite
    prompts = _prompts_ragged(cfg)
    outs = [_run(lambda: Engine(cfg, model, max_batch=2, max_len=64,
                                backend="paged", page_size=8, device="cpu",
                                interpret=itp), Request, prompts, 4)[1]
            for itp in (False, True)]
    assert outs[0] == outs[1]


def test_params_round_trip(granite):
    _, params, cfg, model = granite
    tree = jax.tree.map(np.asarray, params)
    back = interop.params_to_numpy(interop.params_from_numpy(tree, cfg))
    fa = jax.tree_util.tree_flatten_with_path(tree)[0]
    fb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (_, a), (_, b) in zip(fa, fb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bf16_weights_round_to_nearest_even():
    """At cfg.dtype bfloat16 the carried weights are the reference's
    `.astype(bfloat16)` of its float32 masters, bit for bit."""
    jcfg = dataclasses.replace(jget("granite_3_8b").reduced(), dtype="bfloat16")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = interop.model_config_from_dict(interop.model_config_to_dict(jcfg))
    model = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    assert model.blocks[1].mlp.wi.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    want = np.asarray(params["blocks"]["mlp"]["wi"][1].astype(jax.numpy.bfloat16)
                      .astype(jax.numpy.float32))
    assert np.array_equal(model.blocks[1].mlp.wi.float().numpy(), want)


@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma3_27b"])
def test_init_params_matches_reference_distributions(arch):
    jcfg = jget(arch).reduced()
    cfg = interop.model_config_from_dict(interop.model_config_to_dict(jcfg))
    want = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    got = interop.params_to_numpy(
        ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        if a.std() == 0:            # norm scales: constants
            assert np.array_equal(a, b), jax.tree_util.keystr(path)
        else:
            assert abs(b.std() / a.std() - 1) < 0.05, jax.tree_util.keystr(path)
            assert abs(b.mean()) < 0.05 * a.std() + 1e-3, jax.tree_util.keystr(path)
