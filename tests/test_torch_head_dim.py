"""Head dims past 256 and the reference's grouped, blockwise attention.

On the CPU the port's flash attention (forward and gradient) and paged
attention run their plain versions at Dh 288, 512 and 1,024 against the JAX
package: `repro.models.layers.flash_attention` (the models' blockwise loop)
and the Pallas kernels in interpret mode, within tests/test_kernels.py's
tolerances (2e-5 in float32, 2e-2 in bfloat16; gradients 1e-5 in float32,
as tests/test_torch_flash_attention.py holds them).  A reduced dense config
with `head_dim` 512 runs its forward, its loss gradient and paged decodes
against the reference's, weights carried by `interop`.

Then the attention that a DTensor or a `meta` tensor takes
(`ops.grouped_attention`): its loop over key blocks against the
reference's on the same inputs; on the dry-run's fake group of 16 ranks,
the reduced Hymba prefill and train cells with the query heads split into
(Hkv, G) and never folded into the batch; a prefill cell's temporaries
growing with the key block, not with Tk; and its FLOPs equal to the plain
attention's, up to the padding of a ragged Tk to the block."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.paged_attention import ops as jpa
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch import interop
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tfa_ref
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.launch import dryrun, step_trace
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import train_step as ts
from torch_parity import assert_trees_close, model_configs, named_leaves

HEAD_DIMS = [288, 512, 1024]

# (B, Hq, Hkv, Tq, Tk, Dh, causal, window): a ragged second column chunk
# with a window, Dh 512 causal, and Dh 1,024 non-causal at Tq != Tk
SHAPES = [(1, 4, 2, 128, 128, 288, True, 40),
          (1, 4, 2, 128, 128, 512, True, 0),
          (1, 4, 2, 64, 128, 1024, False, 0)]
SHAPE_IDS = [f"dh{s[5]}" for s in SHAPES]


def _inputs(shape, seed):
    B, Hq, Hkv, Tq, Tk, Dh = shape[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, Tq, Dh), (B, Hkv, Tk, Dh), (B, Hkv, Tk, Dh),
                           (B, Hq, Tq, Dh)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_past_dh256_matches_reference(shape, dtype):
    """The port's flash attention at Dh 288, 512, 1,024 against the models'
    blockwise attention and the Pallas kernel in interpret mode."""
    causal, window = shape[6], shape[7]
    q, k, v, _ = _inputs(shape, 0)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jl.flash_attention(jq, jk, jv, causal=causal,
                                   window=jnp.asarray(window, jnp.int32)), tol)
    _close(got, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True), tol)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_flash_gradients_past_dh256_match_reference(shape):
    """Autograd through the port's attention (the plain version of the
    gradient kernels) against jax.grad of the models' blockwise attention."""
    causal, window = shape[6], shape[7]
    q, k, v, do = _inputs(shape, 1)

    def loss(q, k, v):
        out = jl.flash_attention(q, k, v, causal=causal,
                                 window=jnp.asarray(window, jnp.int32))
        return jnp.sum(out * do)

    ts_ = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tl.flash_attention(*ts_, causal=causal, window=window)
    got = torch.autograd.grad(out, ts_, torch.from_numpy(do))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for name, g, jg in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_past_dh256_matches_reference(dh, q_dtype):
    """The port's paged attention at Dh 288, 512, 1,024 (float32 pools, q
    in either dtype) against the Pallas kernel in interpret mode and its
    oracle; lengths of 1 and of the whole table among the random ones."""
    rng = np.random.default_rng(dh)
    B, Hkv, G, page, n_pool, max_pages = 3, 2, 4, 8, 6, 3
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    kp = rng.standard_normal((Hkv, n_pool, page, dh)).astype(np.float32)
    vp = rng.standard_normal((Hkv, n_pool, page, dh)).astype(np.float32)
    pt = rng.integers(0, n_pool, (B, max_pages)).astype(np.int32)
    ln = np.array([1, 13, page * max_pages], np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, ln)]
    t[0] = t[0].to(getattr(torch, q_dtype))
    got = tpa.paged_attention(*t)
    assert got.dtype == t[0].dtype and got.shape == (B, Hkv, G, dh)
    jin = [jnp.asarray(a) for a in (q, kp, vp, pt, ln)]
    jin[0] = jin[0].astype(q_dtype)
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    for want in (jpa.paged_attention(*jin, interpret=True), jpa.paged_attention_ref(*jin)):
        _close(got, want.astype(jnp.float32), tol)


def test_paged_shared_memory_limit():
    """The split kernel's shared memory: three stages of K and V rows at Dh
    128 and two at 256, as before; past 256 three [32][256] units, q whole
    in float32, which fits a CTA at G 16 up to Dh 1,024 and not at 4,096."""
    assert tpa.split_smem_bytes(4, 128, 4) == 3 * (4 * 2 * 32 * 132) + 4 * 4 * (128 + 33)
    assert tpa.split_smem_bytes(4, 256, 4) == 2 * (4 * 2 * 32 * 260) + 4 * 4 * (256 + 33)
    assert tpa.split_smem_bytes(16, 512, 4) == 3 * (4 * 32 * 260) + 4 * 16 * (512 + 33)
    for dh, elem in ((512, 4), (1024, 4), (1024, 2)):
        assert tpa.split_smem_bytes(16, dh, elem) <= tpa.SMEM_LIMIT
    assert tpa.split_smem_bytes(16, 4096, 4) > tpa.SMEM_LIMIT


# ---------------------------------------------------------------------------
# a reduced dense config at head_dim 512
# ---------------------------------------------------------------------------

ARCH = "granite_3_8b"


@pytest.fixture(scope="module")
def wide():
    """(reference config, port config, reference params, port params):
    Granite-3-8B reduced with head_dim 512 (four query heads, two KV heads)."""
    jcfg, cfg = model_configs(ARCH, head_dim=512)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, interop.params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def test_dh512_forward_and_loss_gradient(wide):
    """Forward logits within 1e-5, the loss within 1e-6 relative and every
    gradient leaf within 1e-5 of its largest magnitude, as
    tests/test_torch_train.py holds the Dh-16 config."""
    jcfg, cfg, params, model = wide
    assert cfg.resolved_head_dim == 512
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    want = jtf.forward(jcfg, params, {"tokens": jnp.asarray(toks[:, :-1])})
    with torch.no_grad():
        got = ttf.forward(cfg, model, {"tokens": torch.from_numpy(toks[:, :-1])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}, loss_chunk=16))(params)
    trainable = ts.trainable(model)
    loss = ttf.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks)}, loss_chunk=16)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    named = named_leaves(jgrads, trainable)
    for name, g in zip(trainable, grads):
        assert_trees_close(g, named[name], 1e-5, name)


def test_dh512_paged_decode_matches_reference(wide):
    """The paged engine (the paged-attention kernel's plain version at Dh
    512, pages of 8) against the reference's paged engine (its Pallas
    kernel in interpret mode): the same tokens from the same prompts."""
    jcfg, cfg, params, model = wide
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 11, 3)]

    def run(make, req):
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=4))
        return {r.rid: r.out_tokens for r in eng.run()}

    want = run(lambda: JEngine(jcfg, params, max_batch=2, max_len=32, backend="paged",
                               page_size=8), JRequest)
    got = run(lambda: Engine(cfg, model, max_batch=2, max_len=32, backend="paged",
                             page_size=8, device="cpu"), Request)
    assert got == want


# ---------------------------------------------------------------------------
# the grouped, blockwise attention of DTensors and meta tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_blockwise_attention_matches_reference_loop(monkeypatch, dtype, causal, window):
    """`ref.blockwise_attention` over key blocks of 32 with a ragged Tk of
    80 (padded to 96, as the reference pads it) against the reference's
    loop at the same block, and `grouped_attention` on a plain tensor at
    the default block against the plain version."""
    q, k, v, _ = _inputs((2, 6, 2, 80, 80, 16), 2)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    monkeypatch.setattr(tfa_ref, "BLOCK_KV", 32)
    got = tfa_ref.blockwise_attention(tq.reshape(2, 2, 3, 80, 16), tk[:, :, None],
                                      tv[:, :, None], causal=causal, window=window)
    monkeypatch.undo()
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got.reshape(2, 6, 80, 16),
           jl.flash_attention(jq, jk, jv, causal=causal, block_kv=32,
                              window=jnp.asarray(window, jnp.int32)), tol)
    grouped = tfa.grouped_attention(tq, tk, tv, causal, window)
    _close(grouped, tfa.flash_attention(tq, tk, tv, causal=causal, window=window).float(),
           tol)


def _meta_counts(fn, grad):
    q = torch.empty(2, 8, 300, 32, device="meta", requires_grad=grad)
    k, v = (torch.empty(2, 2, 300, 32, device="meta", requires_grad=grad) for _ in range(2))
    trace = step_trace.StepTrace()
    with trace:
        out = fn(q, k, v)
        assert out.shape == q.shape
        if grad:
            torch.autograd.grad(out.float().sum(), (q, k, v))
    return trace.flops, trace.temp_peak


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
def test_meta_attention_counts_by_trip_count(monkeypatch, grad):
    """On `meta` tensors (Tk 300, key blocks of 128: three, the last padded
    by 84 keys) one block counted three times gives the FLOPs of the
    unrolled loop, which are the plain attention's plus the padding's; the
    temporaries hold one block's scores, below the plain version's."""
    monkeypatch.setattr(tfa_ref, "BLOCK_KV", 128)
    grouped = lambda q, k, v: tfa.flash_attention(q, k, v, causal=True)
    by_trips, temp = _meta_counts(grouped, grad)
    with step_trace.unrolled():
        unrolled, _ = _meta_counts(grouped, grad)
    plain = lambda q, k, v: tfa_ref.mha_reference(
        q.reshape(4, 4, 300, 32), k.reshape(4, 1, 300, 32), v.reshape(4, 1, 300, 32)
    ).reshape(q.shape)
    plain_flops, plain_temp = _meta_counts(plain, grad)
    per_key = 2 * 2 * (2 * 8 * 300 * 32) * (3 if grad else 1)   # QK^T and PV, x3 with dQ, dK, dV
    assert by_trips == unrolled == plain_flops + per_key * (3 * 128 - 300)
    assert temp < plain_temp


@pytest.fixture(scope="module")
def fake16():
    """This process as rank 0 of a fake group of 16 ranks, and a 4 x 4 mesh."""
    import torch.distributed as dist
    dryrun.fake_world(16)
    yield make_mesh((4, 4), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


def _reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")


class _Views(TorchDispatchMode):
    """The target shapes of the views and reshapes applied to DTensors."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if func in (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
                        torch.ops.aten.reshape.default):
                self.shapes.append(tuple(args[1]))
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_hymba_cells_group_heads_without_folding_the_batch(fake16, kind):
    """Hymba-1.5B reduced (8 x 8 tokens, Hq 4 over a model axis of 4, Hkv
    2, G 2): q goes to [B, Hkv, G, T, Dh] through `split_dim`, and no
    DTensor is viewed as [B * Hkv, G, T, Dh] (the flatten PyTorch 2.11's
    DTensor refuses); the cell runs."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _reduced("hymba_1_5b")
    B, T, Dh = 8, 8, cfg.resolved_head_dim
    Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    shape = ShapeSpec(f"{kind}_tiny", T, B, kind)
    views = _Views()
    with sharding.use_mesh(fake16), implicit_replication():
        fn, args = dryrun.build_cell("hymba_1_5b", shape.name, fake16, cfg=cfg,
                                     shape=shape)
        with views:
            fn(*args)
    assert (B, Hkv, G, T, Dh) in views.shapes
    assert not any(s[:2] == (B * Hkv, G) and len(s) == 4 for s in views.shapes)
    rec = dryrun.run_cell("hymba_1_5b", shape.name, False, verbose=False, cfg=cfg,
                          shape=shape, mesh_shape=(4, 4))
    assert rec["status"] == "ok", rec.get("error")


def _prefill(T):
    shape = ShapeSpec("prefill_tiny", T, 8, "prefill")
    rec = dryrun.run_cell(ARCH, shape.name, False, verbose=False, cfg=_reduced(ARCH),
                          shape=shape, mesh_shape=(4, 4))
    assert rec["status"] == "ok", rec.get("error")
    return rec["memory"]["temp_bytes_per_device"], rec["cost"]["flops_per_device"]


def test_prefill_temporaries_grow_with_the_block_not_tk(fake16):
    """Granite reduced, prefill of 8 x 2,048 and 8 x 4,096 tokens: doubling
    Tk adds less to the temporaries than one [B, H, Tq, Tk] float32 score
    tensor of a device at 4,096 (B 2 of 8 over `data`; the 4 heads whole,
    since 2 KV heads do not split over a model axis of 4)."""
    t1, _ = _prefill(2048)
    t2, _ = _prefill(4096)
    assert 0 < t2 - t1 < (8 // 4) * 4 * 4096 * 4096 * 4


def test_prefill_flops_equal_plain_attention_up_to_padding(fake16, monkeypatch):
    """Granite reduced, prefill of 8 x 3,000 tokens: with key blocks of
    1,024 (three, the last padded by 72 keys) its FLOPs are those of one
    block spanning every key (the plain attention's count) plus the
    padding's: 2 layers x QK^T and PV x 2 x B 2 x 4 heads x Tq 3,000 x 72
    keys x Dh 16; at 4,096 tokens (four whole blocks), none."""
    _, padded = _prefill(3000)
    _, blocks = _prefill(4096)
    monkeypatch.setattr(tfa_ref, "BLOCK_KV", 1 << 20)
    _, whole = _prefill(3000)
    assert padded - whole == 2 * 2 * 2 * 2 * 4 * 3000 * 72 * 16
    assert _prefill(4096)[1] == blocks
