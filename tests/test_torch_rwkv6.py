"""The port's RWKV-6 family against the JAX package's, at rwkv6_7b reduced
(float32) on the CPU, with the weights (and the TrainState) carried across
by `interop`.  The initialisation's zero token-shift mixes, zero bonus and
constant decay would hide the token shift and the bonus term, so `mu`,
`mu_c`, `u` and `w0` are randomised first.

Tolerances: time_mix / channel_mix / rmsnorm_heads, the logits, prefill and
four decode steps (logits, WKV state, token shift) within 1e-5 (absolute
and relative: float32 summation order); the loss within 1e-4 relative and
each gradient leaf within 1e-3 of its largest magnitude (as
tests/test_torch_train.py holds the training path); the serving engine's
tokens equal; three train steps' losses within 1e-4 relative."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.serve import serve_step as jss
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.models import rwkv6, transformer as ttf
from repro_torch.optim import adamw
from repro_torch.serve import serve_step
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import train_step as ts
from torch_parity import assert_trees_close, model_configs, named_leaves

ARCH = "rwkv6_7b"
TOL = 1e-5


def _randomise(params, seed=0):
    """mu, mu_c in [0, 1), u ~ N(0, 0.5), w0 ~ U(-3, 1): the token shift,
    the bonus and a spread of decays all reach the output."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, params)
    rw = dict(p["blocks"]["rwkv"])
    for name, draw in (("mu", lambda s: rng.random(s)),
                       ("mu_c", lambda s: rng.random(s)),
                       ("u", lambda s: rng.normal(0, 0.5, s)),
                       ("w0", lambda s: rng.uniform(-3, 1, s))):
        rw[name] = draw(rw[name].shape).astype(np.float32)
    p = dict(p, blocks=dict(p["blocks"], rwkv=rw))
    return p


@pytest.fixture(scope="module")
def twin():
    """(reference config, port config, reference params (jax), port model)."""
    jcfg, cfg = model_configs(ARCH)
    tree = _randomise(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            interop.params_from_numpy(tree, cfg))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want), atol=tol, rtol=tol)


def _tokens(cfg, B=2, T=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _layer(params, l):
    return jax.tree.map(lambda a: a[l], params["blocks"]["rwkv"])


def test_params_carry_the_reference_tree_and_dtypes(twin):
    jcfg, cfg, params, model = twin
    back = interop.params_to_numpy(model)
    assert_trees_close(back, jax.tree.map(np.asarray, params), 0.0, "params")
    bf = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                   dataclasses.replace(cfg, dtype="bfloat16"))
    r = bf.blocks[0].rwkv
    for n in rwkv6.NAMES:
        want = torch.bfloat16 if n in rwkv6.CAST else torch.float32
        assert getattr(r, n).dtype == want, n


def test_time_mix_channel_mix_and_head_norm(twin):
    jcfg, cfg, params, model = twin
    rng = np.random.default_rng(1)
    B, T, D = 2, 9, cfg.d_model
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    xp = rng.standard_normal((B, D)).astype(np.float32)
    st = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    p = model.blocks[1].rwkv
    jp = _layer(params, 1)
    out, sh, new = rwkv6.time_mix(cfg, p, torch.from_numpy(x), torch.from_numpy(xp),
                                  torch.from_numpy(st))
    jout, jsh, jnew = jrwkv.time_mix(jcfg, jp, jnp.asarray(x), jnp.asarray(xp),
                                     jnp.asarray(st))
    for a, b in ((out, jout), (sh, jsh), (new, jnew)):
        _close(a, b)
    cm, csh = rwkv6.channel_mix(cfg, p, torch.from_numpy(x), torch.from_numpy(xp))
    jcm, jcsh = jrwkv.channel_mix(jcfg, jp, jnp.asarray(x), jnp.asarray(xp))
    _close(cm, jcm)
    _close(csh, jcsh)
    y = rng.standard_normal((B, H, T, hd)).astype(np.float32)
    _close(rwkv6.rmsnorm_heads(torch.from_numpy(y), p.ln_x),
           jrwkv.rmsnorm_heads(jnp.asarray(y), jp["ln_x"]))


def test_forward_logits_and_prefill(twin):
    jcfg, cfg, params, model = twin
    toks = _tokens(cfg)
    with torch.no_grad():
        got = ttf.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    _close(got, jtf.forward(jcfg, params, {"tokens": jnp.asarray(toks)}))
    _close(serve_step.prefill_step(cfg, model, {"tokens": torch.from_numpy(toks)}),
           jss.prefill_step(jcfg, params, {"tokens": jnp.asarray(toks)}))


def test_loss_and_gradients(twin):
    jcfg, cfg, params, model = twin
    toks = _tokens(cfg, T=33, seed=2)
    mask = (np.random.default_rng(3).random(toks.shape) < 0.8).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks),
                                        "loss_mask": jnp.asarray(mask)},
                              loss_chunk=16))(params)
    m = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    tp = ts.trainable(m)
    loss = ttf.loss_fn(cfg, m, {"tokens": torch.from_numpy(toks),
                                "loss_mask": torch.from_numpy(mask)}, loss_chunk=16)
    grads = torch.autograd.grad(loss, list(tp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = named_leaves(jgrads, tp)
    for name, g in zip(tp, grads):
        assert_trees_close(g, want[name], 1e-3, name)


def test_decode_steps_match_with_their_caches(twin):
    """A prefix through four decode steps: logits, WKV state and token shift
    after every step; then the last logits equal prefill's over the same
    tokens (sequence mode against the T = 1 mode of the recurrence)."""
    jcfg, cfg, params, model = twin
    B = 3
    toks = _tokens(cfg, B=B, T=4, seed=4)
    jc = jtf.init_cache(jcfg, B, 16)
    tc = ttf.init_cache(cfg, B, 16, device="cpu")
    assert set(tc) == set(jc) == {"len", "wkv", "shift"}
    for a, b in ((tc["wkv"], jc["wkv"]), (tc["shift"], jc["shift"])):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    step = jax.jit(lambda p, c, t: jss.decode_step(jcfg, p, c, t))
    for t in range(4):
        jl, jc = step(params, jc, jnp.asarray(toks[:, t]))
        tl, tc = serve_step.decode_step(cfg, model, tc, torch.from_numpy(toks[:, t]))
        _close(tl, jl)
        _close(tc["wkv"], jc["wkv"])
        _close(tc["shift"], jc["shift"])
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [t + 1] * B
    pre = serve_step.prefill_step(cfg, model, {"tokens": torch.from_numpy(toks)})
    _close(pre, tl, 1e-4)


def test_engine_tokens_equal_reference(twin):
    jcfg, cfg, params, model = twin
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, 6).astype(np.int32) for _ in range(5)]

    def run(eng, req):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=5))
        return {r.rid: r.out_tokens for r in eng.run()}

    want = run(JEngine(jcfg, params, max_batch=2, max_len=32, backend="contiguous"),
               JRequest)
    got = run(Engine(cfg, model, max_batch=2, max_len=32, backend="contiguous",
                     device="cpu"), Request)
    assert got == want and len(got) == 5


def test_paged_backend_refuses_the_ssm_family(twin):
    _, cfg, _, model = twin
    with pytest.raises(ValueError, match="no K/V|has none"):
        Engine(cfg, model, backend="paged", device="cpu")


def test_train_steps_match_reference(twin):
    jcfg, cfg, params, _ = twin
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = jts.init_state(jcfg, jadamw.AdamWConfig(**ocfg), jax.random.PRNGKey(0))
    jstate = jstate._replace(params=params,
                             opt=jadamw.init(jadamw.AdamWConfig(**ocfg), params))
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    jstep = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg)))
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**ocfg))
    rng = np.random.default_rng(6)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 3
    assert_trees_close(interop.train_state_to_numpy(state)["params"],
                       jax.tree.map(np.asarray, jstate.params), 1e-3, "params")


def test_train_state_takes_the_reference_dtypes():
    """bfloat16: the reference's init_state casts every float32 leaf of two
    or more dimensions (RWKV-6's w0, wB, u, ln_x too); the port's init_state
    and the carried state give the same dtype leaf for leaf."""
    jcfg, cfg = model_configs(ARCH, dtype="bfloat16")
    jstate = jts.init_state(jcfg, jadamw.AdamWConfig(), jax.random.PRNGKey(0))
    carried = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    made = ts.init_state(cfg, adamw.AdamWConfig(), torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(carried.params.named_parameters(),
                              made.params.named_parameters()):
        ref = interop.reference_leaf(jstate.params, n)
        assert str(a.dtype)[6:] == str(b.dtype)[6:] == str(ref.dtype), n
