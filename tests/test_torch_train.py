"""The port's training path against the JAX package's, at granite_3_8b
reduced (float32) on the CPU, with the weights and the TrainState carried
across by `interop`: forward logits within 1e-5, the loss within 1e-6
relative, every gradient leaf and every AdamW leaf within 1e-5 and 1e-6 of
its largest magnitude, five train steps' losses within 1e-4 relative.  Then
tests/test_trainer.py's and test_models.py's training scenarios run against
the port, and its data pipeline is held bit for bit against the
reference's."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.testing import faults
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_parity import assert_trees_close, model_configs, named_leaves

ARCH = "granite_3_8b"


@pytest.fixture(scope="module")
def twin():
    """(reference config, port config, reference TrainState)."""
    jcfg, cfg = model_configs(ARCH)
    jstate = jts.init_state(jcfg, jadamw.AdamWConfig(), jax.random.PRNGKey(0))
    return jcfg, cfg, jstate


def _port_state(jstate, cfg):
    return interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)


def _tokens(cfg, B=2, T=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)


def test_forward_last_only_logits(twin):
    jcfg, cfg, jstate = twin
    toks = _tokens(cfg)[:, :-1]
    want = jtf.forward(jcfg, jstate.params, {"tokens": jnp.asarray(toks)},
                       last_only=True)
    model = _port_state(jstate, cfg).params
    with torch.no_grad():
        got = ttf.forward(cfg, model, {"tokens": torch.from_numpy(toks)},
                          last_only=True)
    assert got.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_loss_and_gradients(twin):
    """A masked loss over two 16-token chunks."""
    jcfg, cfg, jstate = twin
    toks = _tokens(cfg, seed=1)
    mask = (np.random.default_rng(2).random(toks.shape) < 0.8).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks),
                                        "loss_mask": jnp.asarray(mask)},
                              loss_chunk=16))(jstate.params)
    state = _port_state(jstate, cfg)
    params = ts.trainable(state.params)
    loss = ttf.loss_fn(cfg, state.params, {"tokens": torch.from_numpy(toks),
                                           "loss_mask": torch.from_numpy(mask)},
                       loss_chunk=16)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = named_leaves(jgrads, params)
    for (name, g) in zip(params, grads):
        assert_trees_close(g, want[name], 1e-5, name)


@pytest.mark.parametrize("opt,applies", [({}, 2), ({"compress_grads": True}, 2),
                                         ({"state_dtype": "bfloat16"}, 1)],
                         ids=["f32", "compressed", "bf16_state"])
def test_adamw_apply(twin, opt, applies):
    """AdamW applies of the same gradients (the second from non-zero
    moments) on the reference's and the port's copy of one state, every
    leaf within 1e-6 of its largest magnitude.  The two packages sum the
    global norm in different orders, so their float32 moments differ in the
    last bit; rounded to bfloat16 a few of them fall on the two sides of a
    tie, one bfloat16 ulp apart, and move the next update by up to
    lr * 2^-8.  So the bfloat16 state is held after one apply, whose update
    reads the unrounded moments, and its moments to 1e-6 or one ulp."""
    jcfg, cfg, jstate = twin
    ocfg = dict(lr=1e-2, warmup_steps=1, **opt)
    jocfg = jadamw.AdamWConfig(**ocfg)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.3), jstate.params)
    params, jopt = jstate.params, jadamw.init(jocfg, jstate.params)
    state = _port_state(jstate._replace(opt=jopt), cfg)
    tparams = ts.trainable(state.params)
    tgrads = {n: torch.from_numpy(np.array(a))
              for n, a in named_leaves(grads, tparams).items()}
    topt = state.opt
    for _ in range(applies):
        params, jopt, jm = jadamw.apply(jocfg, grads, jopt, params)
        _, topt, tm = adamw.apply(adamw.AdamWConfig(**ocfg), tgrads, topt, tparams)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    got = interop.train_state_to_numpy(ts.TrainState(state.params, topt, state.step))
    want = jax.tree.map(np.asarray, jts.TrainState(params, jopt, jstate.step))
    assert int(got["opt"]["count"]) == int(want.opt.count) == applies
    assert_trees_close(got["params"], want.params, 1e-6, "params")
    assert_trees_close(got["opt"]["err"], want.opt.err, 1e-6, "err")
    for f in ("mu", "nu"):
        if opt.get("state_dtype") == "bfloat16":
            for n in tparams:
                a = getattr(topt, f)[n]
                b = torch.from_numpy(np.asarray(interop.reference_leaf(
                    getattr(want.opt, f), n), np.float32)).to(torch.bfloat16)
                near = (a.float() - b.float()).abs() <= 1e-6 * float(b.float().abs().max())
                ulp = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs() == 1
                assert bool((near | ulp).all()), (f, n)
                assert int((~near).sum()) <= max(1, a.numel() // 1000), (f, n)
        else:
            assert_trees_close(got["opt"][f], getattr(want.opt, f), 1e-6, f)


def _pipe(cfg, **kw):
    return TokenPipeline(cfg.vocab_size, batch=8, seq_len=32, seed=7, **kw)


def _batch(pipe, step):
    return {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}


def test_train_steps_match_reference(twin):
    jcfg, cfg, jstate = twin
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=50)
    jstep = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg)))
    state = _port_state(jstate, cfg)
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**ocfg))
    pipe = _pipe(cfg)
    for i in range(5):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        state, m = step(state, _batch(pipe, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(state.step) == int(jstate.step) == 5


def test_microbatches_match_one_batch(twin):
    jcfg, cfg, jstate = twin
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=50)
    pipe = _pipe(cfg)
    out = {}
    for mb in (1, 2):
        state = _port_state(jstate, cfg)
        step = ts.make_train_step(cfg, ocfg, microbatches=mb)
        losses = []
        for i in range(2):
            state, m = step(state, _batch(pipe, i))
            losses.append(float(m["loss"]))
        out[mb] = losses, interop.train_state_to_numpy(state)
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    assert_trees_close(out[2][1]["params"], out[1][1]["params"], 1e-5, "params")


# --- tests/test_trainer.py and tests/test_models.py, against the port -------

def _mk(tmp, total=10, fail_at=None, ckpt_every=4):
    _, cfg = model_configs(ARCH)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=50)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                         ckpt_dir=str(tmp), log_every=100, fail_at_step=fail_at)
    return Trainer(cfg, ocfg, tcfg, _pipe(cfg), device="cpu")


def test_restart_is_bit_exact(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    tr = _mk(d1, total=10, fail_at=6)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run()
    tr.ckpt.wait()
    assert tr.ckpt.latest_step() == 4
    state = _mk(d1, total=10).run()          # restart from step 4 ckpt
    assert int(state.step) == 10
    straight = _mk(d2, total=10).run()
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              straight.params.named_parameters()):
        assert torch.equal(a, b), n


def test_incomplete_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"x": torch.arange(4)}, blocking=True)
    # simulate a crash mid-save: directory without a manifest
    os.makedirs(tmp_path / "step_9")
    np.save(tmp_path / "step_9" / "leaf_0.npy", np.arange(4))
    assert ck.latest_step() == 5


def test_crash_before_manifest_keeps_previous_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(3, dtype=torch.bfloat16)}, blocking=True)
    faults.arm("checkpoint.before_manifest")
    try:
        with pytest.raises(faults.InjectedCrash):
            ck.save(2, {"x": torch.ones(3, dtype=torch.bfloat16)}, blocking=True)
    finally:
        faults.reset()
    ck = Checkpointer(str(tmp_path))
    assert ck.available_steps() == [1]
    like = {"x": torch.full((3,), 7.0, dtype=torch.bfloat16)}
    assert torch.equal(ck.restore(like)[0]["x"], torch.zeros(3, dtype=torch.bfloat16))


def test_restore_into_structure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    ck.save(3, state, blocking=True)
    like = {"w": torch.zeros((4, 4)), "b": torch.ones((4,))}
    restored, step = ck.restore(like)
    assert step == 3
    np.testing.assert_array_equal(restored["w"].numpy(), np.ones((4, 4)))
    # structure mismatch is an error, not silent corruption
    with pytest.raises(AssertionError):
        ck.restore({"w": torch.zeros((4, 4))})


def test_training_reduces_loss(twin):
    """End-to-end: a few steps of AdamW reduce loss on a fixed batch."""
    _, cfg, _ = twin
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    state = ts.init_state(cfg, ocfg, torch.Generator().manual_seed(0), "cpu")
    step = ts.make_train_step(cfg, ocfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, B=4, T=32, seed=4))}
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_pipeline_batches_equal_the_reference():
    for kw in ({}, {"n_shards": 2, "shard": 1}):
        tp = TokenPipeline(100, batch=8, seq_len=16, seed=3, **kw)
        jp = JTokenPipeline(100, batch=8, seq_len=16, seed=3, **kw)
        for step in (0, 5, 17):
            a, b = tp.batch_at(step)["tokens"], jp.batch_at(step)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (kw, step)
