"""The port's moe, hybrid, audio and vlm families against the JAX package's,
at each arch's reduced config (float32) on the CPU, with the weights (and
the TrainState) carried across by `interop`: forward logits and prefill,
the loss and its gradients, four decode steps with every cache leaf
(Whisper's cross cache filled from each package's own encoder, as
tests/test_models.py fills the reference's), the serving engine's tokens
(contiguous for every family, paged for LLaVA), three Trainer steps'
losses, and the paged backend refusing moe, hybrid and audio.

Tolerances (as tests/test_torch_rwkv6.py's): logits, prefill and the
decode caches within 1e-5 (absolute and relative: float32 summation
order); the loss within 1e-4 relative and each gradient leaf within 1e-3
of its largest magnitude; tokens equal; train-step losses within 1e-4
relative."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.serve import serve_step as jss
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import layers, transformer as ttf
from repro_torch.optim import adamw
from repro_torch.serve import serve_step
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_parity import assert_trees_close, model_configs, named_leaves

ARCHS = ("phi35_moe_42b_a6_6b", "kimi_k2_1t_a32b", "hymba_1_5b",
         "whisper_large_v3", "llava_next_34b")
TOL = 1e-5
_TWINS = {}


def _twin(arch):
    """(reference config, port config, reference params (jax), port model),
    built once per arch."""
    if arch not in _TWINS:
        jcfg, cfg = model_configs(arch)
        tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        _TWINS[arch] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                        interop.params_from_numpy(tree, cfg))
    return _TWINS[arch]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _batch(cfg, B=2, T=16, seed=0):
    """numpy inputs: tokens [B, T], plus the stub frontend's patches or the
    encoder's frames where the family takes them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.frontend == "patches":
        b["frontend"] = rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, cfg, params, model = _twin(arch)
    tree = jax.tree.map(np.asarray, params)
    back = interop.params_to_numpy(model)
    fa = jax.tree_util.tree_flatten_with_path(tree)[0]
    fb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in fa] == \
        [jax.tree_util.keystr(p) for p, _ in fb]
    for (_, a), (_, b) in zip(fa, fb):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_prefill(arch):
    jcfg, cfg, params, model = _twin(arch)
    jb, tb = _both(_batch(cfg))
    with torch.no_grad():
        got = ttf.forward(cfg, model, tb)
    want = jtf.forward(jcfg, params, jb)
    assert tuple(got.shape) == want.shape == (2, 16, cfg.padded_vocab)
    _close(got, want)
    _close(serve_step.prefill_step(cfg, model, tb), jss.prefill_step(jcfg, params, jb))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(arch):
    jcfg, cfg, params, _ = _twin(arch)
    b = _batch(cfg, T=17, seed=2)
    b["loss_mask"] = (np.random.default_rng(3).random(b["tokens"].shape) < 0.8
                      ).astype(np.float32)
    jb, tb = _both(b)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jb, loss_chunk=8))(params)
    m = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    tp = ts.trainable(m)
    loss = ttf.loss_fn(cfg, m, tb, loss_chunk=8)
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = named_leaves(jgrads, tp)
    for name, g in zip(tp, grads):
        assert_trees_close(g, want[name], 1e-3, name)


def _fill_cross(cfg, model, cache, frames):
    """The port's cross cache from its own encoder (tests/test_models.py's
    filling of the reference's)."""
    enc = ttf.encode(cfg, model, frames, remat=False)
    for l, blk in enumerate(model.blocks):
        cache["xk"][l] = layers._heads(enc, blk.cross.wk)
        cache["xv"][l] = layers._heads(enc, blk.cross.wv)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_with_their_caches(arch):
    jcfg, cfg, params, model = _twin(arch)
    B = 3
    b = _batch(cfg, B=B, T=4, seed=4)
    toks = b["tokens"]
    jc = jtf.init_cache(jcfg, B, 16)
    with torch.no_grad():
        tc = ttf.init_cache(cfg, B, 16, device="cpu")
        assert set(tc) == set(jc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape and str(tc[k].dtype)[6:] == str(jc[k].dtype), k
        if cfg.is_encoder_decoder:
            enc = jtf.encode(jcfg, params, jnp.asarray(b["frames"]))
            jc["xk"] = jnp.einsum("btd,ldhk->lbhtk", enc, params["blocks"]["cross"]["wk"])
            jc["xv"] = jnp.einsum("btd,ldhk->lbhtk", enc, params["blocks"]["cross"]["wv"])
            _fill_cross(cfg, model, tc, torch.from_numpy(b["frames"]))
    step = jax.jit(lambda p, c, t: jss.decode_step(jcfg, p, c, t))
    for t in range(4):
        jl, jc = step(params, jc, jnp.asarray(toks[:, t]))
        tl, tc = serve_step.decode_step(cfg, model, tc, torch.from_numpy(toks[:, t]))
        _close(tl, jl)
        for k in jc:
            if k != "len":
                _close(tc[k], jc[k])
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [t + 1] * B


def _run(eng, req, prompts, new):
    for i, p in enumerate(prompts):
        eng.submit(req(rid=i, prompt=p, max_new_tokens=new))
    return {r.rid: r.out_tokens for r in eng.run()}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_reference(arch):
    """Contiguous for every family (Whisper's cross cache left at zeros in
    both, as the reference's engine leaves it); paged too for LLaVA."""
    jcfg, cfg, params, model = _twin(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, 6).astype(np.int32) for _ in range(5)]
    backends = ("contiguous", "paged") if cfg.family == "vlm" else ("contiguous",)
    for backend in backends:
        kw = dict(max_batch=2, max_len=32, backend=backend, page_size=8)
        want = _run(JEngine(jcfg, params, **kw), JRequest, prompts, 5)
        got = _run(Engine(cfg, model, device="cpu", **kw), Request, prompts, 5)
        assert got == want and len(got) == 5, backend


@pytest.mark.parametrize("arch", ["phi35_moe_42b_a6_6b", "hymba_1_5b", "whisper_large_v3"])
def test_paged_backend_refuses_the_family(arch):
    _, cfg, _, model = _twin(arch)
    with pytest.raises(ValueError, match="contiguous"):
        Engine(cfg, model, backend="paged", device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match_reference(arch, tmp_path):
    """Three steps of the port's Trainer, from the reference's carried
    TrainState, on the pipeline's batches (patches and frames included),
    against the reference's train step on the same batches."""
    jcfg, cfg, params, _ = _twin(arch)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = jts.init_state(jcfg, jadamw.AdamWConfig(**ocfg), jax.random.PRNGKey(0))
    jstate = jstate._replace(params=params,
                             opt=jadamw.init(jadamw.AdamWConfig(**ocfg), params))
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    pipe_kw = dict(batch=2, seq_len=16, seed=3, frontend_tokens=cfg.num_frontend_tokens,
                   d_model=cfg.d_model,
                   frames=cfg.encoder_len if cfg.is_encoder_decoder else 0)
    tr = Trainer(cfg, adamw.AdamWConfig(**ocfg),
                 TrainerConfig(total_steps=3, ckpt_every=10, ckpt_dir=str(tmp_path),
                               log_every=1),
                 TokenPipeline(cfg.vocab_size, **pipe_kw), device="cpu")
    state = tr.run(state)
    jpipe = JTokenPipeline(jcfg.vocab_size, **pipe_kw)
    jstep = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg)))
    want = []
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jpipe.batch_at(i).items()})
        want.append(float(jm["loss"]))
    np.testing.assert_allclose([r["loss"] for r in tr.metrics_log], want, rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 3
    assert_trees_close(interop.train_state_to_numpy(state)["params"],
                       jax.tree.map(np.asarray, jstate.params), 1e-3, "params")
