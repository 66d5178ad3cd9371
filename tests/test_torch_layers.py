"""The port's decode-path layers against the JAX package's `models/layers.py`
and `transformer.decode_step`, at reduced sizes in float32, with weights
carried across by `interop.params_from_numpy`.  Tolerance 1e-5: the same
float32 arithmetic, summed in another order."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models.registry import get_config as jget
from repro_torch import interop
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf

TOL = dict(atol=1e-5, rtol=1e-5)


def _model(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = interop.model_config_from_dict(interop.model_config_to_dict(jcfg))
    return jcfg, params, cfg, interop.params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _block0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_norms():
    x = _x((2, 3, 64))
    s, b = _x((64,), 1), _x((64,), 2)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    _close(tl.layernorm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)),
           jl.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    x = _x((2, 4, 3, 16))
    pos = np.array([[5, 6, 7], [0, 100, 2047]], np.int32)[:, None, :]
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, fraction),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, fraction))


@pytest.mark.parametrize("arch", ["granite_3_8b", "glm4_9b", "gemma3_27b"])
def test_project_qkv(arch):
    """granite: plain GQA; glm4: half rotary, KV=2; gemma3: qk-norm."""
    jcfg, params, cfg, model = _model(arch)
    if arch == "gemma3_27b":     # non-zero qk-norm scales
        blocks = dict(params["blocks"])
        attn = dict(blocks["attn"])
        attn["q_norm"] = jnp.asarray(_x(attn["q_norm"].shape, 3))
        attn["k_norm"] = jnp.asarray(_x(attn["k_norm"].shape, 4))
        params = dict(params, blocks=dict(blocks, attn=attn))
        model = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
        assert cfg.qk_norm
    x = _x((2, 1, cfg.d_model))
    pos = np.array([[3], [17]], np.int32)
    got = tl.project_qkv(cfg, model.blocks[0].attn, torch.from_numpy(x),
                         torch.from_numpy(pos))
    want = jl.project_qkv(jcfg, _block0(params)["attn"], jnp.asarray(x),
                          jnp.asarray(pos))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    jcfg, params, cfg, model = _model("granite_3_8b", mlp_act=act)
    x = _x((2, 1, cfg.d_model))
    _close(tl.mlp(cfg, model.blocks[0].mlp, torch.from_numpy(x)),
           jl.mlp(jcfg, _block0(params)["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["gemma_7b", "granite_3_8b"])
def test_embed_and_padded_logits(arch):
    """gemma scales the embedding by sqrt(d_model) (by name); a vocab of 250
    pads to 256 and the pad logits are NEG_INF."""
    jcfg, params, cfg, model = _model(arch, vocab_size=250)
    assert cfg.padded_vocab == 256
    toks = np.array([[0], [249], [17]], np.int32)
    x = tl.embed(cfg, model.embed, torch.from_numpy(toks))
    _close(x, jl.embed(jcfg, params["embed"], jnp.asarray(toks)))
    lg = tl.logits(cfg, model.embed, x)
    _close(lg, jl.logits(jcfg, params["embed"], jnp.asarray(x.numpy())))
    assert bool((lg[..., 250:] == tl.NEG_INF).all())


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_window(window):
    q = _x((3, 4, 16))
    k, v = _x((3, 2, 12, 16), 1), _x((3, 2, 12, 16), 2)
    ln = np.array([1, 7, 12], np.int32)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(ln), window=jnp.int32(window))
    for w in (window, torch.tensor(window, dtype=torch.int32)):
        _close(tl.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(ln),
                                   window=w), want)


def test_layer_flags():
    for arch in ("granite_3_8b", "gemma3_27b"):
        cfg = jget(arch)
        t = ttf.layer_flags(interop.model_config_from_dict(interop.model_config_to_dict(cfg)))
        assert t["window"].tolist() == np.asarray(jtf.layer_flags(cfg)["window"]).tolist()


@pytest.mark.parametrize("arch", ["granite_3_8b", "gemma3_27b"])
def test_decode_step_contiguous_cache(arch):
    """Three decode steps against a dense cache: logits and K/V caches.
    gemma3 brings local/global sliding windows and qk-norm."""
    jcfg, params, cfg, model = _model(arch)
    B, S = 2, 16
    jc = jtf.init_cache(jcfg, B, S)
    tc = ttf.init_cache(cfg, B, S, device="cpu")
    step = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t))
    rng = np.random.default_rng(5)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        jl_, jc = step(params, jc, jnp.asarray(toks))
        tl_, tc = ttf.decode_step(cfg, model, tc, torch.from_numpy(toks))
        _close(tl_, jl_)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()


FAMILY_ARCH = {"moe": "phi35_moe_42b_a6_6b", "hybrid": "hymba_1_5b",
               "audio": "whisper_large_v3", "vlm": "llava_next_34b"}


@pytest.mark.parametrize("family", ["moe", "hybrid", "audio", "vlm"])
def test_other_families_build_and_run_forward(family):
    """Each family's reduced config builds from a generator and runs one
    forward: finite logits over the token positions (LLaVA's patch prefix
    cut off again, Whisper's encoder run on its frames)."""
    cfg = interop.model_config_from_dict(interop.model_config_to_dict(
        jget(FAMILY_ARCH[family]).reduced()))
    assert cfg.family == family and family in ttf.PORTED_FAMILIES
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))}
    if family == "vlm":
        batch["frontend"] = torch.from_numpy(_x((2, cfg.num_frontend_tokens, cfg.d_model)))
    if family == "audio":
        batch["frames"] = torch.from_numpy(_x((2, cfg.encoder_len, cfg.d_model)))
    with torch.no_grad():
        lg = ttf.forward(cfg, model, batch)
    assert lg.shape == (2, 8, cfg.padded_vocab)
    assert torch.isfinite(lg[..., :cfg.vocab_size]).all()


def test_unknown_family_is_refused():
    cfg = dataclasses.replace(
        interop.model_config_from_dict(interop.model_config_to_dict(
            jget("granite_3_8b").reduced())), family="diffusion")
    with pytest.raises(ValueError, match="unknown family"):
        ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("d,positions,atol", [
    (64, [[0, 1, 2, 15], [7, 30, 40, 63]], 1e-5),   # the reduced configs' range
    (1280, [[0, 3, 17, 63]], 1e-5),                  # Whisper-large's width
    (3, [[0, 5]], 1e-5),                             # odd d: half 1, max(half - 1, 1)
    # Whisper's frame positions up to 1499: the two libraries' float32 exp
    # differ by up to one ulp in a frequency (<= 2**-23 relative, f <= 1),
    # so an angle differs by up to p * 2**-23 = 1.8e-4 at p = 1499
    (1280, [[100, 448, 1000, 1499]], 1499 * 2.0 ** -23),
])
def test_sinusoid_pos(d, positions, atol):
    pos = np.array(positions, np.int32)
    got = tl.sinusoid_pos(torch.from_numpy(pos), d, torch.float32)
    want = jl.sinusoid_pos(jnp.asarray(pos), d, jnp.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("Tq,Tk,causal", [(5, 16, False), (16, 5, False), (12, 12, True)])
def test_flash_attention_cross(Tq, Tk, causal):
    """cross=True drops the causal mask over Tq != Tk keys (the reference
    pads a ragged Tk to its key block; here the kernel takes any Tk)."""
    q = _x((2, 4, Tq, 16))
    k, v = _x((2, 2, Tk, 16), 1), _x((2, 2, Tk, 16), 2)
    got = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, cross=True)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, cross=True, block_kv=8)
    _close(got, want)
    plain = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=False)
    assert torch.equal(got, plain)
