"""The CUDA kernels on the card: the F2 kernels held bit for bit against
their plain PyTorch versions (fused_write also on one key in every lane
with wrapping RMW sums, all RMW on one key, Zipf 0.99, 1024 keys on one
index slot, and B of 1, 77, 16384 and 20000, and two calls bit for bit
equal),
the kernel-backed store held leaf for leaf
against the plain-engine store on the same op stream, and the
paged-attention kernel held against its plain version within
tests/test_kernels.py's tolerances (2e-5 in float32, 2e-2 in bfloat16), and
the flash-attention kernels held against autograd through their plain
version (forward as above; gradients 1e-4 in float32, and in bfloat16 2e-2
of the largest reference gradient, the reference run in float32 on the
same bfloat16 inputs); the WKV forward and gradient kernels against the
plain recurrence and autograd through it (the forward 2e-3 absolute and
relative, the JAX package's tolerance; each gradient within 2e-3 of its
largest magnitude, since dw sums D products of two accumulated states and
its float32 rounding scales with them; two gradient calls bit for bit
equal), and the legacy first-hop probe bit for bit; the three store kernels
over a stacked store's shard axis (S of 1, 2 and 4 in one launch, equal to
their plain versions and to S single-shard calls) and over a replicated
state's R*S = 8 rows, the kernel-backed ShardedKV and ReplicatedKV (through
a drop and resync) against the plain-engine ones, the session service
over ReplicatedKV against a dict model (and its rounds' host syncs with
observability on and off), a DurableKV over the
kernel-backed ShardedKV recovering bit-exact against its twin, and the
moe, hybrid, audio and vlm families at their reduced sizes: the kernel
path against the plain path on the CPU (logits 1e-4, the loss 1e-4
relative, each gradient leaf 1e-3 of its largest magnitude), two decodes
bit-equal, and `layers.flash_attention` at Dh 112 and with `cross=True`
at Tq != Tk; and the flash and paged kernels past Dh 256 (column chunks:
Dh 288, 512 and 1,024 in float32 and bfloat16, causal, windowed, Tq !=
Tk, G > 16), against their plain versions with two calls bit-equal; flash
at head dims the kernels lack (run zero-padded: bf16 at Dh 50 to 1,024 on
the tensor cores, float32 at Dh 6 and 50), above 65,535 KV heads (two
launches), the paged kernel at G 16 past a CTA's shared memory (head
groups that fit), and the WKV kernels at D 160 (padded) and 256.

These tests need a CUDA device and nvcc and skip without them.  They import
neither JAX nor the JAX package, so they also run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import hybrid_log  # noqa: E402
from repro_torch.kernels.f2_probe import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# tests/conftest.py::small_cfg sizes with the paper's 100-byte values
CFG = T.F2Config(hot_index_size=1 << 9, hot_capacity=1 << 11, hot_mem=1 << 8,
                 cold_capacity=1 << 13, cold_mem=1 << 7, n_chunks=1 << 7,
                 chunklog_capacity=1 << 11, chunklog_mem=1 << 6,
                 rc_capacity=1 << 7, value_width=25, chain_max=48)
B = 96


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stream(seed, n_steps, n_keys=3000):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        keys = rng.integers(0, n_keys, B).astype(np.int32)
        ops_ = rng.choice([T.OP_READ, T.OP_UPSERT, T.OP_RMW, T.OP_DELETE], B,
                          p=[.3, .4, .2, .1]).astype(np.int32)
        vals = rng.integers(-2**31, 2**31, (B, CFG.value_width),
                            dtype=np.int64).astype(np.int32)
        yield keys, ops_, vals


def test_kernel_store_matches_plain_store(cuda):
    twins = {e: T.KV(dataclasses.replace(CFG, engine=e), device=cuda,
                     compact_batch=128) for e in ("fused", "fused_ref")}
    ops.reset_launches()
    for i, (k, o, v) in enumerate(_stream(0, 120)):
        out = {e: kv.apply(k, o, v) for e, kv in twins.items()}
        for a, b in zip(out["fused"], out["fused_ref"]):
            assert torch.equal(a, b), i
        la = interop.state_leaves(twins["fused"].state)
        lb = interop.state_leaves(twins["fused_ref"].state)
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), i
    assert ops.launches["fused_probe"] > 0 and ops.launches["fused_write"] > 0
    assert twins["fused"].compactions > 0
    for kv in twins.values():
        kv.check_invariants()


@pytest.mark.parametrize("b", [1, 77, 96, 1000])
def test_kernels_match_plain_versions(cuda, b):
    kv = T.KV(CFG, device=cuda, compact_batch=128)
    for k, o, v in _stream(1, 40):
        kv.apply(k, o, v)
    st = kv.state
    hot, rc = st.hot, st.rc
    cols = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    rng = np.random.default_rng(b)
    keys = torch.as_tensor(rng.integers(0, 3500, b).astype(np.int32), device=cuda)
    hb = hybrid_log.head_addr(hot, CFG.hot_mem)
    lower = hot.begin.repeat(b)
    act = torch.as_tensor(rng.random(b) < 0.9, device=cuda)
    for rc_match in (True, False):
        args = (keys, st.hot_index, lower, act, hb, *cols)
        kw = dict(chain_max=CFG.chain_max, rc_match=rc_match)
        for x, y in zip(ref.fused_probe_body(*args, **kw), ops.fused_probe(*args, **kw)):
            assert torch.equal(x, y)
    addrs = hot.begin + torch.arange(b, dtype=torch.int32, device=cuda)
    k, _, _, _ = hybrid_log.gather(hot, addrs)
    args = (k, st.hot_index, addrs, addrs < hot.tail, hb, *cols)
    kw = dict(chain_max=CFG.chain_max, rc_match=False, target=addrs)
    for x, y in zip(ref.fused_probe_body(*args, **kw), ops.fused_probe(*args, **kw)):
        assert torch.equal(x, y)
    opsv = torch.as_tensor(rng.choice([0, 1, 2, 3, 4], b).astype(np.int32), device=cuda)
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, (b, CFG.value_width),
                                        dtype=np.int64).astype(np.int32), device=cuda)
    dup = keys.clone()
    dup[1::2] = dup[0]                         # one key many times
    ro = hybrid_log.read_only_addr(hot, CFG.hot_mem, CFG.hot_mutable_frac)
    ops.reset_launches()
    for kk in (keys, dup):
        args = (kk, opsv, vals, st.hot_index, hot.begin, hb, ro, hot.tail, *cols)
        for x, y in zip(ref.fused_write_body(*args, chain_max=CFG.chain_max),
                        ops.fused_write(*args, chain_max=CFG.chain_max)):
            assert torch.equal(x, y)
    assert ops.launches["fused_write"] == 2 * ops.WRITE_KERNELS_PER_CALL


def _probe_args(kv, keys, lower=None):
    st, hot, rc = kv.state, kv.state.hot, kv.state.rc
    b = keys.shape[0]
    return (keys, st.hot_index, hot.begin.repeat(b) if lower is None else lower,
            torch.ones(b, dtype=torch.bool, device=keys.device),
            hybrid_log.head_addr(hot, CFG.hot_mem),
            hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)


def _probe_equal(args, kw):
    """fused_probe bit for bit against its plain version, twice."""
    want = ref.fused_probe_body(*args, **kw)
    runs = [ops.fused_probe(*args, **kw), ops.fused_probe(*args, **kw)]
    torch.cuda.synchronize()
    for got in runs:
        for n, (x, y) in enumerate(zip(want, got)):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), n


@pytest.mark.parametrize("b", [1, 33, 8191])
def test_fused_probe_batches_match_plain_version(cuda, loaded, b):
    """Batches of one lane, of a warp and one, and of one lane short of
    8192 (the last CTA's last warp ragged), in index and heads mode."""
    rng = np.random.default_rng(b)
    keys = torch.as_tensor(rng.integers(0, 3500, b).astype(np.int32), device=cuda)
    args = _probe_args(loaded, keys)
    for rc_match in (True, False):
        _probe_equal(args, dict(chain_max=CFG.chain_max, rc_match=rc_match))
    heads = ref.fused_probe_body(*args, chain_max=CFG.chain_max)[2]
    _probe_equal((keys, heads) + args[2:], dict(chain_max=CFG.chain_max, probe_index=False))


def test_fused_probe_longest_chains_match_plain_version(cuda):
    """Every key on one index slot: 600 keys chain through one slot, past
    chain_max, so lanes walk the longest chains, end exhausted or absent,
    and hit records deep in the chain."""
    kv = T.KV(CFG, device=cuda, compact_batch=128)
    E = CFG.hot_index_size
    keys = _unmix32(np.uint64(5) + np.arange(600, dtype=np.uint64) * np.uint64(E))
    rng = np.random.default_rng(3)
    for i in range(0, 400, B):
        k = keys[i:i + B]
        kv.apply(k, np.full(len(k), T.OP_UPSERT, np.int32),
                 rng.integers(0, 100, (len(k), CFG.value_width)).astype(np.int32))
    q = torch.as_tensor(keys[rng.permutation(600)], device=cuda)
    args = _probe_args(kv, q)
    out = ref.fused_probe_body(*args, chain_max=CFG.chain_max)
    assert int(out[7].sum()) > 0 and int(out[0].sum()) > 0   # exhausted lanes, hits
    for rc_match in (True, False):
        _probe_equal(args, dict(chain_max=CFG.chain_max, rc_match=rc_match))


def _unmix32(h):
    """Inverse of the store's slot hash: keys whose hash is chosen."""
    x = np.asarray(h, np.uint64) & np.uint64(0xFFFFFFFF)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(pow(0x846CA68B, -1, 2**32))) & m
    x ^= (x >> np.uint64(15)) ^ (x >> np.uint64(30))
    x = (x * np.uint64(pow(0x7FEB352D, -1, 2**32))) & m
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32).view(np.int32)


def _write_batch(case, rng):
    """(keys, ops) of one fused_write case: every lane one key with mixed
    ops, every lane an RMW of one key, Zipf 0.99 over 3500 keys (the YCSB
    skew), 1024 keys on one index slot eight times each, mixed batches of
    1, 77 and 16384 lanes, and 20000 lanes of mostly distinct keys, whose
    appends crowd the 512-slot index past the shared-memory sort (the
    sort then runs in device memory)."""
    from repro_torch.workload import Zipf
    n = {"b1": 1, "b77": 77, "b16384": 16384, "b20000": 20000}.get(case, 8192)
    mixed_ops = rng.choice([T.OP_READ, T.OP_UPSERT, T.OP_RMW, T.OP_DELETE], n)
    if case == "one_hot_key":
        hot_ops = rng.choice([T.OP_UPSERT, T.OP_RMW, T.OP_RMW, T.OP_DELETE], n)
        hot_ops[-9:] = T.OP_RMW      # RMWs after the last set
        return np.full(n, 1234), hot_ops
    if case == "all_rmw_one_key":
        return np.full(n, 77), np.full(n, T.OP_RMW)
    if case == "zipf_099":
        return Zipf(3500, 0.99).sample(rng, n), mixed_ops
    if case == "all_colliding_slot":
        E = CFG.hot_index_size
        keys = _unmix32(np.uint64(7) + np.arange(n // 8, dtype=np.uint64) * np.uint64(E))
        return (np.concatenate([keys] * 8),
                rng.choice([T.OP_UPSERT, T.OP_RMW, T.OP_DELETE], n))
    if case == "b20000":
        return rng.integers(0, 1 << 20, n), mixed_ops
    return rng.integers(0, 3500, n), mixed_ops


WRITE_CASES = ["one_hot_key", "all_rmw_one_key", "zipf_099", "all_colliding_slot",
               "b1", "b77", "b16384", "b20000"]


@pytest.fixture(scope="module")
def loaded(cuda):
    kv = T.KV(CFG, device=cuda, compact_batch=128)
    for k, o, v in _stream(1, 40):
        kv.apply(k, o, v)
    return kv


def _write_args(kv, keys, ops_, rng, big_values):
    st, hot, rc = kv.state, kv.state.hot, kv.state.rc
    dev = kv.device
    b = len(keys)
    lo, hi = (-2**31, 2**31) if big_values else (0, 100)
    vals = rng.integers(lo, hi, (b, CFG.value_width), dtype=np.int64).astype(np.int32)
    if big_values:   # near +-2^31 (mostly +), so sums of a few wrap
        near = vals % 97
        vals = np.where(near < 12, -2**31 + near, 2**31 - 1 - near)
    return (torch.as_tensor(np.asarray(keys, np.int32), device=dev),
            torch.as_tensor(np.asarray(ops_, np.int32), device=dev),
            torch.as_tensor(vals.astype(np.int32), device=dev), st.hot_index, hot.begin,
            hybrid_log.head_addr(hot, CFG.hot_mem),
            hybrid_log.read_only_addr(hot, CFG.hot_mem, CFG.hot_mutable_frac), hot.tail,
            hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)


@pytest.mark.parametrize("case", WRITE_CASES)
def test_fused_write_cases_match_plain_version(cuda, loaded, case):
    rng = np.random.default_rng(WRITE_CASES.index(case))
    keys, ops_ = _write_batch(case, rng)
    args = _write_args(loaded, keys, ops_, rng, big_values=True)
    ops.reset_launches()
    got = ops.fused_write(*args, chain_max=CFG.chain_max)
    want = ref.fused_write_body(*args, chain_max=CFG.chain_max)
    torch.cuda.synchronize()
    assert ops.launches["fused_write"] == ops.WRITE_KERNELS_PER_CALL
    for n, (x, y) in enumerate(zip(want, got)):
        assert x.dtype == y.dtype and torch.equal(x, y), (case, n)
    if case in ("one_hot_key", "all_rmw_one_key"):
        assert int(got[0].sum()) == 1      # one representative
        # the RMWs after the last set sum beyond int32, so the kernel's must wrap
        after = np.flatnonzero(np.asarray(ops_) != T.OP_RMW).max(initial=-1) + 1
        assert int(args[2][after:, 0].to(torch.int64).sum()) > 2**31


@pytest.mark.parametrize("case", ["one_hot_key", "zipf_099", "b16384"])
def test_fused_write_is_deterministic(cuda, loaded, case):
    rng = np.random.default_rng(100 + WRITE_CASES.index(case))
    keys, ops_ = _write_batch(case, rng)
    args = _write_args(loaded, keys, ops_, rng, big_values=True)
    a = ops.fused_write(*args, chain_max=CFG.chain_max)
    b = ops.fused_write(*args, chain_max=CFG.chain_max)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# (B, Hkv, G, Dh, page, n_pool, max_pages, q dtype, pool dtype[, lengths]):
# the serving path's shape (Granite-3-8B, pools float32, q bfloat16), tests/
# test_kernels.py's first shape, and head_dim 256 with bf16 pools and odd B;
# then a long table (256 pages of 16, lengths 1 to 4096 spread over the
# batch, so many splits are live), lengths of 0 with max_pages above one
# split (every key of the table, p = 1), lengths exactly at the split
# boundaries (and one key either side), the serving shape with bf16
# pools, and bf16 pools at Dh 36, whose 72-byte rows the kernel copies
# element by element instead of in 16-byte vectors.  Lengths are random in [1, page * max_pages] with the first 1 and
# the last page * max_pages unless given.
PA_SHAPES = [(8, 8, 4, 128, 16, 288, 33, torch.bfloat16, torch.float32),
             (3, 2, 4, 64, 64, 16, 4, torch.float32, torch.float32),
             (5, 2, 1, 256, 16, 12, 5, torch.bfloat16, torch.bfloat16),
             (8, 8, 4, 128, 16, 512, 256, torch.bfloat16, torch.float32),
             (8, 8, 4, 128, 16, 64, 40, torch.float32, torch.float32,
              [0, 0, 5, 640, 0, 1, 17, 0]),
             (8, 8, 4, 128, 16, 64, 40, torch.float32, torch.float32, "split_boundaries"),
             (8, 8, 4, 128, 16, 288, 33, torch.bfloat16, torch.bfloat16),
             (3, 2, 4, 36, 16, 12, 5, torch.bfloat16, torch.bfloat16)]
PA_IDS = ["serve", "kernels_a", "dh256", "long_4096", "len_0_multi_split",
          "split_boundaries", "bf16_pools", "dh36_element_copies"]


def _pa_inputs(shape, dev, seed=0):
    B, Hkv, G, Dh, ps, npool, mp, qdt, pdt = shape[:9]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Hkv, G, Dh), generator=g).to(dev, qdt)
    kp = torch.randn((Hkv, npool, ps, Dh), generator=g).to(dev, pdt)
    vp = torch.randn((Hkv, npool, ps, Dh), generator=g).to(dev, pdt)
    pt = torch.randint(0, npool, (B, mp), generator=g, dtype=torch.int32).to(dev)
    ln = torch.randint(1, ps * mp + 1, (B,), generator=g, dtype=torch.int32)
    ln[0] = 1
    ln[-1] = ps * mp
    lens = shape[9] if len(shape) > 9 else None
    if lens == "split_boundaries":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        span = pa_ops.splits(B * Hkv, mp, sms)[0] * ps
        lens = [span, 2 * span, span - 1, span + 1, 3 * span, ps * mp, 1, 2 * span + 1]
    if lens is not None:
        ln = torch.tensor(lens, dtype=torch.int32)
    return q, kp, vp, pt, ln.to(dev)


@pytest.mark.parametrize("shape", PA_SHAPES, ids=PA_IDS)
def test_paged_attention_matches_plain_version(cuda, shape):
    args = _pa_inputs(shape, cuda)
    pa_ops.reset_launches()
    got = pa_ops.paged_attention(*args)
    want = pa_ref.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert pa_ops.launches["paged_attention"] == 1
    assert got.dtype == want.dtype == args[0].dtype
    tol = 2e-5 if got.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [PA_SHAPES[0], PA_SHAPES[3]], ids=["serve", "long_4096"])
def test_paged_attention_is_deterministic(cuda, shape):
    """Two calls on the same inputs give bit-equal outputs (the partials are
    merged in split order, with no float atomics)."""
    args = _pa_inputs(shape, cuda, seed=1)
    first = pa_ops.paged_attention(*args)
    again = pa_ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("qdt,pdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.float32)], ids=["bf16_q", "f32"])
def test_paged_attention_head_groups_above_16(cuda, qdt, pdt):
    """G 20 query heads a KV head run as two launches of 10 (`head_groups`):
    within the plain version's tolerances, and two calls bit-equal."""
    args = _pa_inputs((4, 2, 20, 128, 16, 64, 12, qdt, pdt), cuda)
    pa_ops.reset_launches()
    got = pa_ops.paged_attention(*args)
    again = pa_ops.paged_attention(*args)
    want = pa_ref.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert pa_ops.launches["paged_attention"] == 4
    assert got.dtype == want.dtype == qdt
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)


def test_paged_attention_wrapper_refuses(cuda):
    args = _pa_inputs(PA_SHAPES[1], cuda)
    pa_ops.reset_launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pa_ops.paged_attention_cuda(*(a.cpu() for a in args))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa_ops.paged_attention(args[0].half(), *args[1:])
    with pytest.raises(TypeError, match="int32"):
        pa_ops.paged_attention(*args[:3], args[3].long(), args[4])
    assert pa_ops.launches["paged_attention"] == 0


# (BH, G, T, Dh, dtype, causal, window[, Tk]): a bfloat16 causal shape of the
# training path's widths at a short T, and a ragged float32 one whose window
# edge falls inside a kv block; then head_dim 256, non-causal, MQA's G 8;
# then the tensor-core route's shapes: GLM-4-9B's G 16, Kimi's Dh 112,
# Gemma-7B's Dh 256, T 1, 17 and 1000, a window edge inside a 128-key tile,
# Dh 32 non-causal, the reduced configs' Dh 16, a bf16 Dh off the
# tensor-core widths (60, run at 64 zero-padded; its id names the CUDA-core
# route it took until every bf16 Dh went to the tensor cores), and the
# wgmma forward's Dh 128 non-causal, with and
# without a window; then key lengths Tk that differ from the query length T
# on both routes (float32 on the CUDA cores, bf16 at Dh 64 on mma.sync and at
# Dh 128 on wgmma): cross-attention, a whisper-like 7 x 150, causal with
# T > Tk (rows past Tk see every key) and with Tk > T (keys past T get
# exact-zero dK and dV), and a window with T > Tk, whose rows at and past
# Tk - 1 + window see no key
FA_SHAPES = [(4, 4, 300, 128, torch.bfloat16, True, 0),
             (3, 2, 257, 64, torch.float32, True, 48),
             (2, 2, 130, 256, torch.float32, False, 0),
             (1, 8, 200, 64, torch.bfloat16, False, 37),
             (2, 16, 256, 128, torch.bfloat16, True, 0),
             (2, 4, 300, 112, torch.bfloat16, True, 0),
             (2, 2, 200, 256, torch.bfloat16, True, 0),
             (2, 4, 1, 128, torch.bfloat16, True, 0),
             (2, 4, 17, 64, torch.bfloat16, True, 0),
             (1, 4, 1000, 128, torch.bfloat16, True, 0),
             (1, 4, 700, 128, torch.bfloat16, True, 100),
             (2, 2, 160, 32, torch.bfloat16, False, 0),
             (2, 2, 64, 16, torch.bfloat16, True, 0),
             (1, 2, 100, 60, torch.bfloat16, True, 0),
             (2, 4, 333, 128, torch.bfloat16, False, 0),
             (2, 4, 333, 128, torch.bfloat16, False, 70),
             (2, 2, 64, 64, torch.float32, False, 0, 128),
             (2, 2, 64, 64, torch.float32, True, 40, 256),
             (1, 4, 300, 64, torch.float32, True, 16, 64),
             (2, 2, 7, 64, torch.bfloat16, False, 0, 150),
             (2, 4, 128, 64, torch.bfloat16, True, 0, 64),
             (1, 4, 300, 64, torch.bfloat16, True, 16, 64),
             (2, 4, 64, 128, torch.bfloat16, False, 0, 128),
             (2, 4, 1000, 128, torch.bfloat16, True, 0, 300),
             (2, 4, 200, 128, torch.bfloat16, True, 40, 1000),
             (1, 4, 300, 128, torch.bfloat16, True, 16, 64)]
FA_IDS = ["bf16_causal", "f32_window", "dh256", "mqa_bf16", "bf16_g16", "bf16_dh112",
          "bf16_dh256", "bf16_t1", "bf16_t17", "bf16_t1000", "bf16_window_in_tile",
          "bf16_dh32_noncausal", "bf16_dh16", "bf16_dh60_simt", "bf16_dh128_noncausal",
          "bf16_dh128_noncausal_window", "f32_cross_q64_k128", "f32_causal_window_q64_k256",
          "f32_blind_rows_q300_k64", "bf16_dh64_whisper_q7_k150", "bf16_dh64_causal_q128_k64",
          "bf16_dh64_blind_rows_q300_k64", "bf16_dh128_cross_q64_k128",
          "bf16_dh128_causal_q1000_k300", "bf16_dh128_causal_window_q200_k1000",
          "bf16_dh128_blind_rows_q300_k64"]


def _fa_inputs(shape, dev, seed=0):
    BH, G, T, Dh, dt = shape[:5]
    Tk = shape[7] if len(shape) > 7 else T
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((BH, G, T, Dh), generator=g).to(dev, dt)
    k = torch.randn((BH, 1, Tk, Dh), generator=g).to(dev, dt)
    v = torch.randn((BH, 1, Tk, Dh), generator=g).to(dev, dt)
    do = torch.randn((BH, G, T, Dh), generator=g).to(dev, dt)
    return q, k, v, do


@pytest.mark.parametrize("shape", FA_SHAPES, ids=FA_IDS)
def test_flash_attention_matches_plain_version(cuda, shape):
    _flash_against_plain(cuda, shape)


# G 20 query heads a KV head: two launches of 10 (`head_groups`), forward
# and gradient, on both routes
FA_G20_SHAPES = [(2, 20, 200, 128, torch.bfloat16, True, 0),
                 (2, 20, 130, 64, torch.float32, True, 48)]


@pytest.mark.parametrize("shape", FA_G20_SHAPES, ids=["bf16_g20", "f32_g20"])
def test_flash_attention_head_groups_above_16(cuda, shape):
    """Above MAX_GROUP the wrapper launches the kernels once a head group:
    within the plain version's tolerances, and two calls bit-equal."""
    assert fa_ops.head_groups(20) == [10, 10]
    out, grads = _flash_against_plain(cuda, shape, launches=2)
    again, grads_again = _flash_against_plain(cuda, shape, launches=2)
    assert torch.equal(out, again)
    for name, a, b in zip("qkv", grads, grads_again):
        assert torch.equal(a, b), name


def _flash_against_plain(cuda, shape, launches=1):
    """flash_attention_cuda's output and gradient at `shape` against
    `ref.py` (its launches per route counted); returns them."""
    q, k, v, do = _fa_inputs(shape, cuda)
    causal, window = shape[5], shape[6]
    fa_ops.reset_launches()
    qk = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention_cuda(*qk, causal=causal, window=window)
    grads = torch.autograd.grad(out, qk, do)
    torch.cuda.synchronize()
    assert fa_ops.launches == {"flash_attention_fwd": launches,
                               "flash_attention_bwd": launches}
    r = fa_ops.route(q.dtype, q.shape[-1])
    assert r == ("simt" if q.dtype == torch.float32 else "tc")
    assert {k: n for k, n in fa_ops.route_launches.items() if n} == {
        f"flash_attention_fwd_{r}": launches, f"flash_attention_bwd_{r}": launches}
    want = fa_ref.mha_reference(q, k, v, causal=causal, window=window)
    assert out.dtype == want.dtype == q.dtype
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    # the reference gradient, in float32 from the same inputs
    r = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(
        fa_ref.mha_reference(*r, causal=causal, window=window), r, do.float())
    for name, got, ref in zip("qkv", grads, ref_grads):
        assert got.dtype == q.dtype, name
        if q.dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4, msg=name)
        else:
            err = float((got.float() - ref).abs().max())
            # a gradient that is identically zero (dq and dk at T 1: the
            # softmax over one key has no derivative) is held to the largest
            # of the three reference gradients
            scale = float(ref.abs().max()) or max(float(g.abs().max()) for g in ref_grads)
            assert err <= 2e-2 * scale, (name, err)
    if causal and k.shape[2] > q.shape[2]:      # keys that no query sees
        for name, got in zip("kv", grads[1:]):
            assert torch.count_nonzero(got[:, :, q.shape[2]:]) == 0, name
    return out, grads


@pytest.mark.parametrize("shape", [FA_SHAPES[0], FA_SHAPES[1], FA_SHAPES[10], FA_SHAPES[24]],
                         ids=["bf16_tc", "f32_simt", "bf16_tc_window",
                              "bf16_tc_causal_window_q200_k1000"])
def test_flash_attention_gradient_is_deterministic(cuda, shape):
    """Two gradient calls on the same inputs give bit-equal dq, dk, dv (no
    float atomics; the trainer's bit-exact restart relies on it)."""
    q, k, v, do = _fa_inputs(shape, cuda, seed=1)
    causal, window = shape[5], shape[6]
    o, lse = fa_ops.forward_cuda(q, k, v, causal, window)
    first = fa_ops.backward_cuda(q, k, v, o, lse, do, causal, window)
    again = fa_ops.backward_cuda(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


def test_flash_attention_wrapper_refuses(cuda):
    q, k, v, _ = _fa_inputs(FA_SHAPES[1], cuda)
    fa_ops.reset_launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa_ops.flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="Dh="):
        fa_ops.flash_attention_cuda(q[..., :0].contiguous(), k[..., :0].contiguous(),
                                    v[..., :0].contiguous())
    with pytest.raises(ValueError, match="G="):     # a launch holds G <= 16
        fa_ops.forward_cuda(q.repeat(1, 9, 1, 1), k, v, True, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="not contiguous"):
        fa_ops.flash_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    assert fa_ops.launches == {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


# Head dims past 256 (column chunks of at most 256: the wide tensor-core
# bodies in bf16, the CUDA cores in float32), as FA_SHAPES: a ragged second
# chunk (288, run at 384 in bf16) causal, 512 with a
# window inside a kv block, 1,024 non-causal, 512 in bf16 at a ragged T,
# 288 cross-attention at Tq != Tk, rows that see no key at 512, and a
# window with Tk > T (exact-zero dK and dV past T) at 1,024
FA_WIDE_SHAPES = [(2, 2, 130, 288, torch.float32, True, 0),
                  (2, 4, 200, 512, torch.float32, True, 48),
                  (1, 2, 100, 1024, torch.float32, False, 0),
                  (2, 4, 257, 512, torch.bfloat16, True, 0),
                  (1, 2, 64, 288, torch.bfloat16, False, 0, 150),
                  (1, 4, 300, 512, torch.float32, True, 16, 64),
                  (2, 2, 64, 1024, torch.bfloat16, True, 40, 256)]
FA_WIDE_IDS = ["f32_dh288", "f32_dh512_window", "f32_dh1024_noncausal", "bf16_dh512",
               "bf16_dh288_cross_q64_k150", "f32_dh512_blind_rows_q300_k64",
               "bf16_dh1024_causal_window_q64_k256"]


@pytest.mark.parametrize("shape", FA_WIDE_SHAPES, ids=FA_WIDE_IDS)
def test_flash_attention_past_dh256_matches_plain_version(cuda, shape):
    """The wide kernels at Dh 288, 512 and 1,024 (tensor cores in bf16,
    CUDA cores in float32): forward and gradient within the plain
    version's tolerances, one launch each, and two forward and two
    gradient calls bit-equal."""
    assert fa_ops.route(shape[4], shape[3]) == ("tc" if shape[4] == torch.bfloat16
                                                 else "simt")
    out, grads = _flash_against_plain(cuda, shape)
    again, grads_again = _flash_against_plain(cuda, shape)
    assert torch.equal(out, again)
    for name, a, b in zip("qkv", grads, grads_again):
        assert torch.equal(a, b), name


# Head dims the kernels lack, run zero-padded to the route's width with the
# true head dim's scale (bf16: the least tensor-core width at or above it,
# past 256 a multiple of 128; float32: a multiple of 4), as FA_SHAPES: bf16
# at Dh 50 (causal, window), 80 and 96 (Phi-2's and Phi-3-mini's, now
# instantiated) causal and as cross-attention at Tq != Tk, 300 with a window
# and rows that see no key, 512 causal with Tk > T, 288 and 1,024, and
# float32 at Dh 6 and 50
FA_PAD_SHAPES = [(2, 4, 200, 50, torch.bfloat16, True, 40),
                 (2, 4, 300, 80, torch.bfloat16, True, 0),
                 (2, 2, 64, 96, torch.bfloat16, False, 0, 150),
                 (2, 4, 257, 96, torch.bfloat16, True, 0),
                 (1, 4, 300, 300, torch.bfloat16, True, 16, 64),
                 (1, 2, 100, 512, torch.bfloat16, True, 0, 300),
                 (2, 2, 130, 288, torch.bfloat16, True, 0),
                 (1, 2, 100, 1024, torch.bfloat16, False, 0),
                 (2, 4, 130, 6, torch.float32, True, 0),
                 (2, 2, 200, 50, torch.float32, True, 48, 300)]
FA_PAD_IDS = ["bf16_dh50_window", "bf16_dh80", "bf16_dh96_cross_q64_k150", "bf16_dh96",
              "bf16_dh300_blind_rows_q300_k64", "bf16_dh512_causal_q100_k300",
              "bf16_dh288", "bf16_dh1024_noncausal", "f32_dh6", "f32_dh50_window_q200_k300"]


@pytest.mark.parametrize("shape", FA_PAD_SHAPES, ids=FA_PAD_IDS)
def test_flash_attention_any_head_dim_matches_plain_version(cuda, shape):
    """Every bf16 head dim on the tensor cores and every float32 one on the
    CUDA cores: forward and gradient within the plain version's tolerances
    (at the true head dim), one launch each on the expected route, and two
    forward and two gradient calls bit-equal."""
    out, grads = _flash_against_plain(cuda, shape)
    assert out.shape[-1] == shape[3] and all(g.shape[-1] == shape[3] for g in grads)
    again, grads_again = _flash_against_plain(cuda, shape)
    assert torch.equal(out, again)
    for name, a, b in zip("qkv", grads, grads_again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", [(1, 20, 96, 80, torch.bfloat16, True, 0),
                                   (1, 20, 96, 300, torch.bfloat16, True, 32)],
                         ids=["bf16_dh80", "bf16_dh300_window"])
def test_flash_attention_any_head_dim_head_groups_above_16(cuda, shape):
    """G 20 at padded head dims: two head groups of 10, bit-equal twice."""
    out, grads = _flash_against_plain(cuda, shape, launches=2)
    again, grads_again = _flash_against_plain(cuda, shape, launches=2)
    assert torch.equal(out, again)
    for name, a, b in zip("qkv", grads, grads_again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", [(fa_ops.MAX_BH + 65, 1, 5, 16, torch.bfloat16, True, 0),
                                   (fa_ops.MAX_BH + 3, 2, 3, 8, torch.float32, False, 0)],
                         ids=["bf16", "f32"])
def test_flash_attention_rows_above_the_grid_limit(cuda, shape):
    """More than MAX_BH (65,535) KV heads: two launches of at most MAX_BH
    rows each, forward and gradient, within the plain version's
    tolerances."""
    _flash_against_plain(cuda, shape, launches=2)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_attention_past_dh256_head_groups_above_16(cuda, dt):
    """G 20 at Dh 512: two head groups of 10, each in two column chunks."""
    _flash_against_plain(cuda, (1, 20, 96, 512, dt, True, 0), launches=2)


@pytest.mark.parametrize("dh", [288, 512, 1024])
def test_paged_attention_past_dh256_matches_plain_version(cuda, dh):
    """The paged kernel's column chunks at Dh 288, 512 and 1,024: bf16 q on
    float32 pools (the serving path's), float32 throughout, and bf16 pools;
    lengths of 0 over several splits among them; two calls bit-equal."""
    for shape in [(4, 2, 4, dh, 16, 64, 12, torch.bfloat16, torch.float32),
                  (4, 2, 8, dh, 16, 64, 40, torch.float32, torch.float32,
                   [0, 5, 640, 1]),
                  (2, 2, 16, dh, 16, 24, 5, torch.bfloat16, torch.bfloat16)]:
        args = _pa_inputs(shape, cuda)
        pa_ops.reset_launches()
        got = pa_ops.paged_attention(*args)
        again = pa_ops.paged_attention(*args)
        want = pa_ref.paged_attention_reference(*args)
        torch.cuda.synchronize()
        assert pa_ops.launches["paged_attention"] == 2
        tol = 2e-5 if got.dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        assert torch.equal(got, again), shape


def test_paged_attention_past_dh256_element_copies_and_head_groups(cuda):
    """bf16 pools at Dh 516 (1,032-byte rows: copied element by element) and
    G 20 at Dh 512 (two head groups, two launches)."""
    for shape, n in (((3, 1, 4, 516, 16, 12, 5, torch.bfloat16, torch.bfloat16), 1),
                     ((2, 2, 20, 512, 16, 24, 5, torch.bfloat16, torch.float32), 2)):
        args = _pa_inputs(shape, cuda, seed=2)
        pa_ops.reset_launches()
        got = pa_ops.paged_attention(*args)
        want = pa_ref.paged_attention_reference(*args)
        torch.cuda.synchronize()
        assert pa_ops.launches["paged_attention"] == n
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_paged_attention_refuses_past_its_shared_memory(cuda):
    """One query head at Dh 40,000 needs more shared memory than a CTA may
    take (its q is held whole): a ValueError before any launch."""
    args = _pa_inputs((1, 1, 1, 40000, 16, 2, 2, torch.float32, torch.float32), cuda)
    pa_ops.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        pa_ops.paged_attention(*args)
    assert pa_ops.launches["paged_attention"] == 0


@pytest.mark.parametrize("shape", [(2, 2, 16, 4096, 16, 8, 3, torch.float32, torch.float32),
                                   (2, 1, 16, 4096, 16, 8, 3, torch.bfloat16, torch.float32),
                                   (1, 1, 16, 3000, 16, 8, 4, torch.bfloat16, torch.bfloat16)],
                         ids=["f32_g16_dh4096", "bf16_g16_dh4096", "bf16_g16_dh3000_bf16_pools"])
def test_paged_attention_head_groups_past_shared_memory(cuda, shape):
    """G 16 at Dh 4,096 passes a CTA's shared memory: the wrapper launches
    groups that fit (`group_limit`), within the plain version's tolerances
    and two calls bit-equal."""
    args = _pa_inputs(shape, cuda)
    G, Dh = shape[2], shape[3]
    groups = fa_ops.head_groups(G, pa_ops.group_limit(Dh, args[1].element_size()))
    assert len(groups) > 1
    pa_ops.reset_launches()
    got = pa_ops.paged_attention(*args)
    again = pa_ops.paged_attention(*args)
    want = pa_ref.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert pa_ops.launches["paged_attention"] == 2 * len(groups)
    tol = 2e-5 if got.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)


# (B, H, T, D, lowest decay, initial state): tests/test_kernels.py's shapes
# (D 64 and 128), a decode step from a state, ragged T over a checkpoint
# boundary with decays down to 1e-3, the reduced configs' D 16, D 128 from a
# state over ragged segments, and D 32 at T 1; then the forward's column
# split at its edges: D 48 (run at 64, zero-padded), D 16 (one CTA a head)
# at T 1 from a state, D 128 (eight CTAs a head) over a ragged chunk, and T
# exactly one checkpoint segment
WKV_SHAPES = [(2, 3, 256, 64, 0.8, False), (1, 2, 128, 64, 0.8, False),
              (2, 1, 64, 128, 0.8, True), (4, 8, 1, 64, 0.5, True),
              (1, 2, 197, 32, 1e-3, True), (2, 4, 70, 16, 1e-3, False),
              (1, 2, 197, 128, 1e-3, True), (3, 2, 1, 32, 0.5, True),
              (2, 3, 33, 48, 1e-3, True), (2, 2, 1, 16, 0.5, True),
              (1, 1, 17, 128, 0.8, True), (1, 3, 64, 64, 0.8, True),
              (1, 2, 70, 160, 1e-3, True), (1, 2, 97, 256, 0.8, True),
              (2, 2, 1, 256, 0.5, True), (2, 1, 130, 256, 1e-3, False)]
WKV_IDS = ["kernels_a", "kernels_b", "d128", "decode", "small_w", "d16", "d128_t197",
           "d32_t1", "d48_padded", "d16_t1", "d128_t17", "t64_one_chunk_set",
           "d160_padded", "d256", "d256_decode", "d256_t130"]


def _wkv_inputs(shape, dev, seed=0):
    B, H, T, D, w_lo, state = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v, dy = (torch.randn((B, H, T, D), generator=g) for _ in range(4))
    w = w_lo + (0.999 - w_lo) * torch.rand((B, H, T, D), generator=g)
    u = torch.randn((H, D), generator=g)
    s0 = torch.randn((B, H, D, D), generator=g) if state else None
    ds = torch.randn((B, H, D, D), generator=g)
    return [t.to(dev) if t is not None else None for t in (r, k, v, w, u, s0, dy, ds)]


def _wkv_close(got, want):
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


def _wkv_grad_close(got, want, name=""):
    err = float((got - want).abs().max())
    assert err <= 2e-3 * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=WKV_IDS)
def test_wkv_matches_plain_version(cuda, shape):
    r, k, v, w, u, s0, dy, ds = _wkv_inputs(shape, cuda)
    wkv_ops.reset_launches()
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, s = wkv_ops.wkv_cuda(*ins, s0, need_state=True)
    grads = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ins)
    torch.cuda.synchronize()
    assert wkv_ops.launches == {"wkv_forward": 1, "wkv_backward": 1}
    rin = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    yr, sr = wkv_ref.wkv_reference(*rin, s0)
    _wkv_close(y, yr.detach())
    _wkv_close(s, sr.detach())
    want = torch.autograd.grad((yr * dy).sum() + (sr * ds).sum(), rin)
    for name, a, b in zip("rkvwu", grads, want):
        _wkv_grad_close(a, b, name)
    # the initial state's gradient, and the forward without the final state
    if s0 is not None:
        s0g = s0.clone().requires_grad_(True)
        y2, _ = wkv_ops.wkv_cuda(r, k, v, w, u, s0g)
        (d0,) = torch.autograd.grad((y2 * dy).sum(), [s0g])
        plain = wkv_ref.wkv_backward_reference(r, k, v, w, u, dy, s0)
        _wkv_grad_close(d0, plain[5], "state")
        _wkv_close(y2, yr.detach())


@pytest.mark.parametrize("shape", [WKV_SHAPES[0], WKV_SHAPES[6]], ids=["kernels_a", "d128_t197"])
def test_wkv_gradient_is_deterministic(cuda, shape):
    r, k, v, w, u, s0, dy, ds = _wkv_inputs(shape, cuda)
    _, _, ckpt = wkv_ops.forward_cuda(r, k, v, w, u, s0, True, checkpoints=True)
    a = wkv_ops.backward_cuda(r, k, v, w, u, ckpt, dy, ds, need_dstate0=True)
    b = wkv_ops.backward_cuda(r, k, v, w, u, ckpt, dy, ds, need_dstate0=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [WKV_SHAPES[0], WKV_SHAPES[3], WKV_SHAPES[5],
                                   WKV_SHAPES[6]],
                         ids=["kernels_a", "decode", "d16", "d128_t197"])
def test_wkv_forward_is_deterministic(cuda, shape):
    r, k, v, w, u, s0, _, _ = _wkv_inputs(shape, cuda)
    a = wkv_ops.forward_cuda(r, k, v, w, u, s0, True, checkpoints=True)
    b = wkv_ops.forward_cuda(r, k, v, w, u, s0, True, checkpoints=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wkv_wrapper_refuses(cuda):
    r, k, v, w, u, s0, _, _ = _wkv_inputs(WKV_SHAPES[3], cuda)
    wkv_ops.reset_launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wkv_ops.wkv_cuda(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())
    with pytest.raises(ValueError, match="D="):
        wkv_ops.wkv_cuda(*(torch.cat([t, t, t, t, t[..., :32]], -1)
                           for t in (r, k, v, w, u)))
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv_cuda(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="not contiguous"):
        wkv_ops.wkv_cuda(r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w, u)
    assert wkv_ops.launches == {"wkv_forward": 0, "wkv_backward": 0}


@pytest.mark.parametrize("E,b", [(1 << 12, 2048), (1 << 10, 1024), (1 << 9, 77)])
def test_first_hop_probe_matches_plain_version(cuda, E, b):
    rng = np.random.default_rng(E + b)
    idx = rng.integers(-1, 1000, (E,)).astype(np.int32)
    idx[1::5] = -1
    idx[::7] |= 1 << 30
    keys = torch.as_tensor(rng.integers(0, 1 << 30, (b,)).astype(np.int32), device=cuda)
    index = torch.as_tensor(idx, device=cuda)
    ops.reset_launches()
    got = ops.probe(keys, index)
    want = ref.probe_reference(keys, index)
    torch.cuda.synchronize()
    assert ops.launches["probe"] == 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.probe_cuda(keys.cpu(), index.cpu())


# ---------------------------------------------------------------------------
# the shard axis: one launch for a stacked store's S shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(cuda):
    """A 4-shard store on the card after a routed mixed stream (hot, cold
    and read-cache records, masked compactions)."""
    skv = T.ShardedKV(CFG, 4, device=cuda, compact_batch=128, trigger=0.5)
    for k, o, v in _stream(2, 100, n_keys=6000):
        skv.apply(k, o, v)
    assert skv.compactions.sum() > 0
    return skv


def _first(state, S):
    """The first S shards of a stacked state (contiguous views)."""
    return interop.state_from_numpy(
        [x[:S] for x in interop.state_to_numpy(state)], state.hot.key.device,
        n_shards=S)


def _shard_calls_equal(fn, plain, args, kw, S, launches):
    """fn on the stacked inputs equals the plain version, a second call, and
    S single-shard (no shard axis) calls on the shards' slices; the stacked
    call is `launches` launches of its counter."""
    name = {ops.fused_probe: "fused_probe", ops.fused_write: "fused_write",
            ops.probe: "probe"}[fn]
    ops.reset_launches()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launches[name] == launches
    want = plain(*args, **kw)
    again = fn(*args, **kw)
    per_shard = [fn(*(a[s] for a in args), **{k: (v[s] if torch.is_tensor(v) else v)
                                               for k, v in kw.items()})
                 for s in range(S)]
    torch.cuda.synchronize()
    for n, (x, y, z) in enumerate(zip(got, want, again)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), n
        assert torch.equal(x, z), n
        assert all(torch.equal(x[s], p[n]) for s, p in enumerate(per_shard)), n


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("b", [77, 96, 8191])
def test_shard_axis_fused_probe(cuda, sharded, S, b):
    """fused_probe over S shards: index mode (read and liveness), heads
    mode and target mode, each one launch, equal to the plain version and
    to S single-shard calls (at S = 1, today's call)."""
    st = _first(sharded.state, S)
    hot, rc = st.hot, st.rc
    rng = np.random.default_rng(S * b)
    keys = torch.as_tensor(rng.integers(0, 7000, (S, b)).astype(np.int32), device=cuda)
    cols = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    lower = hot.begin[:, None].expand(S, b).contiguous()
    act = torch.as_tensor(rng.random((S, b)) < 0.9, device=cuda)
    hb = hybrid_log.head_addr(hot, CFG.hot_mem)
    args = (keys, st.hot_index, lower, act, hb, *cols)
    plain = ref.fused_probe_body
    for rc_match in (True, False):
        _shard_calls_equal(ops.fused_probe, plain, args,
                           dict(chain_max=CFG.chain_max, rc_match=rc_match), S, 1)
    heads = plain(*args, chain_max=CFG.chain_max)[2]
    _shard_calls_equal(ops.fused_probe, plain, (keys, heads) + args[2:],
                       dict(chain_max=CFG.chain_max, probe_index=False), S, 1)
    addrs = hot.begin[:, None] + torch.arange(b, dtype=torch.int32, device=cuda)
    k, _, _, _ = hybrid_log.gather(hot, addrs)
    targs = (k, st.hot_index, addrs, addrs < hot.tail[:, None], hb, *cols)
    _shard_calls_equal(ops.fused_probe, plain, targs,
                       dict(chain_max=CFG.chain_max, rc_match=False, target=addrs), S, 1)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", ["b77", "one_hot_key", "zipf_099", "b16384"])
def test_shard_axis_fused_write(cuda, sharded, S, case):
    """fused_write over S shards (its five launches), equal to the plain
    version and to S single-shard calls; with one hot key in every lane of
    every shard, the RMW sums wrap."""
    st = _first(sharded.state, S)
    hot, rc = st.hot, st.rc
    rng = np.random.default_rng(S + WRITE_CASES.index(case))
    batches = [_write_batch(case, rng) for _ in range(S)]
    keys = np.stack([k for k, _ in batches]).astype(np.int32)
    if case == "one_hot_key":
        keys += np.arange(S, dtype=np.int32)[:, None]     # a key of its own a shard
    opsv = np.stack([o for _, o in batches]).astype(np.int32)
    near = rng.integers(0, 97, keys.shape + (CFG.value_width,))
    vals = np.where(near < 12, -2**31 + near, 2**31 - 1 - near).astype(np.int32)
    args = (torch.as_tensor(keys, device=cuda), torch.as_tensor(opsv, device=cuda),
            torch.as_tensor(vals, device=cuda), st.hot_index, hot.begin,
            hybrid_log.head_addr(hot, CFG.hot_mem),
            hybrid_log.read_only_addr(hot, CFG.hot_mem, CFG.hot_mutable_frac),
            hot.tail, hot.key, hot.val, hot.prev, hot.meta,
            rc.key, rc.val, rc.prev, rc.meta)
    _shard_calls_equal(ops.fused_write, ref.fused_write_body, args,
                       dict(chain_max=CFG.chain_max), S, ops.WRITE_KERNELS_PER_CALL)
    if case == "one_hot_key":
        got = ops.fused_write(*args, chain_max=CFG.chain_max)
        assert got[0].sum(1).tolist() == [1] * S          # one representative a shard
        after = np.flatnonzero(opsv[0] != T.OP_RMW).max(initial=-1) + 1
        assert int(vals[0, after:, 0].astype(np.int64).sum()) > 2**31


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("b", [77, 2048])
def test_shard_axis_first_hop_probe(cuda, sharded, S, b):
    st = _first(sharded.state, S)
    rng = np.random.default_rng(S * b + 1)
    keys = torch.as_tensor(rng.integers(0, 1 << 30, (S, b)).astype(np.int32), device=cuda)
    _shard_calls_equal(ops.probe, ref.probe_reference, (keys, st.hot_index), {}, S, 1)


def test_sharded_kernel_store_matches_plain_store(cuda):
    """ShardedKV(S=4) with the kernels and with the plain engine on one op
    stream with deferral (lanes 48), masked compactions and a migration:
    every leaf equal after every batch; a routed round is one launch of
    each probe call, not S."""
    twins = {e: T.ShardedKV(dataclasses.replace(CFG, engine=e), 4, device=cuda,
                            compact_batch=128, lanes=48, trigger=0.4)
             for e in ("fused", "fused_ref")}
    for i, (k, o, v) in enumerate(_stream(4, 60)):
        out = {e: kv.apply(k, o, v) for e, kv in twins.items()}
        for a, b in zip(out["fused"], out["fused_ref"]):
            assert torch.equal(a, b), i
        if i == 30:
            nm = twins["fused"].bucket_map.copy()
            nm[np.flatnonzero(nm == 1)[:3]] = 3
            assert len({kv.migrate(nm) for kv in twins.values()}) == 1
        la = interop.state_leaves(twins["fused"].state)
        lb = interop.state_leaves(twins["fused_ref"].state)
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), i
    assert twins["fused"].compactions.sum() > 0 and twins["fused"].migrations == 1
    kv = twins["fused"]
    kv.trigger = 2.0
    ops.reset_launches()
    k, o, v = next(_stream(5, 1))
    kv.apply_round(k, o, v)
    torch.cuda.synchronize()
    assert ops.launches["fused_probe"] == 3                # hot, cold reads; cold RMW base
    assert ops.launches["fused_write"] == ops.WRITE_KERNELS_PER_CALL
    for kv in twins.values():
        kv.check_invariants()


# ---------------------------------------------------------------------------
# replication: R x S rows in one launch; the session service on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicated(cuda):
    """ReplicatedKV(S=4, R=2) on the card after a mixed fan-in stream."""
    rkv = T.ReplicatedKV(CFG, 4, n_replicas=2, device=cuda, compact_batch=128,
                         trigger=0.5)
    for k, o, v in _stream(6, 100, n_keys=6000):
        rkv.apply(k, o, v)
    assert rkv.compactions.sum() > 0
    return rkv


@pytest.mark.parametrize("kernel", ["fused_probe", "fused_write", "probe"])
def test_replicated_rows_kernels(cuda, replicated, kernel):
    """Each store kernel over the R*S = 8 rows of a replicated state: one
    launch, equal to its plain version, a second call and 8 single-row
    calls, on a fan-out read's slabs (probes) or a fan-in round's (write)."""
    from repro_torch.core import shard_router
    st, R, S = replicated.state, replicated.R, replicated.S
    hot, rc = st.hot, st.rc
    rng = np.random.default_rng(8)
    n = 2048
    keys = torch.as_tensor(rng.integers(0, 7000, n).astype(np.int32), device=cuda)
    opsv = torch.as_tensor(rng.choice([1, 2, 3, 4], n).astype(np.int32), device=cuda)
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, (n, CFG.value_width),
                                        dtype=np.int64).astype(np.int32), device=cuda)
    bmap = replicated._bucket_map_dev
    rep = torch.as_tensor(np.arange(n, dtype=np.int32) % R, device=cuda)
    rk, ro, _, _ = shard_router.route(keys, opsv, vals, S, 512, bucket_map=bmap,
                                      replica=rep, n_replicas=R)
    cols = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    W = rk.shape[1]
    if kernel == "fused_probe":
        args = (rk, st.hot_index, hot.begin[:, None].expand(R * S, W).contiguous(),
                ro != 0, hybrid_log.head_addr(hot, CFG.hot_mem), *cols)
        _shard_calls_equal(ops.fused_probe, ref.fused_probe_body, args,
                           dict(chain_max=CFG.chain_max), R * S, 1)
    elif kernel == "fused_write":
        sk, so, sv, _ = shard_router.route(keys, opsv, vals, S, 512, bucket_map=bmap)
        args = (sk.repeat(R, 1), so.repeat(R, 1), sv.repeat(R, 1, 1), st.hot_index,
                hot.begin, hybrid_log.head_addr(hot, CFG.hot_mem),
                hybrid_log.read_only_addr(hot, CFG.hot_mem, CFG.hot_mutable_frac),
                hot.tail, *cols)
        _shard_calls_equal(ops.fused_write, ref.fused_write_body, args,
                           dict(chain_max=CFG.chain_max), R * S,
                           ops.WRITE_KERNELS_PER_CALL)
    else:
        _shard_calls_equal(ops.probe, ref.probe_reference, (rk, st.hot_index), {},
                           R * S, 1)


def test_replicated_kernel_store_matches_plain_store(cuda):
    """ReplicatedKV(S=4, R=2) with the kernels and with the plain engine on
    one op stream through a migration, a dropped replica and a resync:
    every leaf equal after every step; a fan-in round calls fused_probe 3
    times and fused_write once, a fan-out read round fused_probe twice, as
    a KV batch and a ShardedKV read round do."""
    twins = {e: T.ReplicatedKV(dataclasses.replace(CFG, engine=e), 4, n_replicas=2,
                               device=cuda, compact_batch=128, lanes=48, trigger=0.4)
             for e in ("fused", "fused_ref")}

    def same(ctx):
        la, lb = (interop.state_leaves(kv.state) for kv in twins.values())
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), ctx
    for i, (k, o, v) in enumerate(_stream(7, 60)):
        out = {e: kv.apply(k, o, v) for e, kv in twins.items()}
        for a, b in zip(out["fused"], out["fused_ref"]):
            assert torch.equal(a, b), i
        if i == 20:
            nm = twins["fused"].bucket_map.copy()
            nm[np.flatnonzero(nm == 1)[:3]] = 3
            assert len({kv.migrate(nm) for kv in twins.values()}) == 1
        if i == 30:
            for kv in twins.values():
                kv.drop_replica(0)
        if i == 45:
            assert len({kv.resync(0) for kv in twins.values()}) == 1
        same(i)
        if i % 10 == 0:
            keys = np.arange(0, 3000, 7, dtype=np.int32)
            r1, r2 = (kv.read(keys) for kv in twins.values())
            assert all(torch.equal(a, b) for a, b in zip(r1, r2)), i
    kv = twins["fused"]
    keys = np.arange(3000, dtype=np.int32)
    r0, r1 = kv.read(keys, replica=0), kv.read(keys, replica=1)
    assert kv.resyncs == 1 and all(torch.equal(a, b) for a, b in zip(r0, r1))
    kv.trigger = 2.0
    k, o, v = next(_stream(8, 1))
    ops.reset_launches()
    kv.apply_round(k, o, v)
    torch.cuda.synchronize()
    assert ops.launches["fused_probe"] == 3 and ops.launches["probe"] == 0
    assert ops.launches["fused_write"] == ops.WRITE_KERNELS_PER_CALL
    ops.reset_launches()
    kv.read(k[:40])
    torch.cuda.synchronize()
    assert ops.launches == {"fused_probe": 2, "fused_write": 0, "probe": 0}
    for kv in twins.values():
        kv.check_invariants()


def test_session_service_over_replicated_store(cuda):
    """make_session_service over ReplicatedKV on the card: four sessions
    enqueue mixed ops in waves and drain; every result equals a dict model
    folded round by round (reads see the round's entry snapshot), no shard
    takes more than the pack width, replicas stay byte-identical."""
    from repro_torch.core import replication
    from repro_torch.serve import serve_step
    svc = serve_step.make_session_service(CFG, serve_step.ServiceConfig(
        n_shards=4, n_replicas=2, lanes=64, max_sessions=4, session_depth=128,
        store_kwargs=dict(device=cuda, compact_batch=128, trigger=0.5)))
    svc.trace_schedule = True
    sessions = [svc.open_session() for _ in range(4)]
    rng = np.random.default_rng(9)
    results = {}
    for _ in range(6):
        for s in sessions:
            keys, ops_, vals = next(_stream(int(rng.integers(1 << 20)), 1, n_keys=500))
            s.enqueue(keys, ops_, vals)
        for s in sessions:
            tk, st, v = s.drain()
            results.update({int(t): (int(a), b) for t, a, b in zip(tk, st, v)})
    ref = {}
    for sess, valid, bkeys, bops, bvals, status, rvals, tkt in svc.schedule:
        valid, bkeys, bops, bvals = (x.cpu().numpy() for x in (valid, bkeys, bops, bvals))
        status, rvals, tkt = status.cpu().numpy(), rvals.cpu().numpy(), tkt.cpu().numpy()
        for i in np.flatnonzero(valid):
            k, o = int(bkeys[i]), int(bops[i])
            if o == T.OP_READ:
                want = ref.get(k)
                assert status[i] == (T.ST_OK if want is not None else T.ST_NOT_FOUND)
                if want is not None:
                    assert np.array_equal(rvals[i], want)
            got_st, got_v = results[int(tkt[i])]
            assert got_st == status[i] and np.array_equal(got_v, rvals[i])
        for i in np.flatnonzero(valid):
            k, o, v = int(bkeys[i]), int(bops[i]), bvals[i]
            if o == T.OP_UPSERT:
                ref[k] = v.copy()
            elif o == T.OP_DELETE:
                ref.pop(k, None)
            elif o == T.OP_RMW:
                ref[k] = (ref.get(k, np.zeros_like(v)).astype(np.int64) + v).astype(np.int32)
    assert len(results) == svc.collected == 6 * 4 * B
    assert svc.max_fill <= 64
    assert replication.replicas_byte_identical(svc.kv)
    svc.check_invariants()


SYNC_KEYS = ("cudaStreamSynchronize", "cudaMemcpyAsync", "aten::item",
             "aten::_local_scalar_dense", "aten::nonzero")


def _sync_counts(fn):
    """Host-sync calls (stream syncs, device copies, scalar reads) made by
    fn(), from a profiler window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    return {k: counts.get(k, 0) for k in SYNC_KEYS}


def test_session_rounds_sync_alike_with_obs_on(cuda):
    """The session service over ReplicatedKV on the card, scheduler off:
    each `step()` makes the same host syncs with `repro_torch.obs` on as
    off (the ticket clock queues a round's tickets on the device), and the
    clock's fold reads every queued round in one device-to-host copy."""
    from repro_torch import obs
    from repro_torch.serve import serve_step
    counts = {}
    try:
        for armed in (False, True):
            obs.configure(enabled=armed, reset=True)
            svc = serve_step.make_session_service(CFG, serve_step.ServiceConfig(
                n_shards=4, n_replicas=2, lanes=64, max_sessions=4, session_depth=512,
                store_kwargs=dict(device=cuda, compact_batch=128, trigger=2.0)))
            sessions = [svc.open_session() for _ in range(4)]
            rng = np.random.default_rng(12)
            for s in sessions:
                keys = rng.integers(0, 4000, 512).astype(np.int32)
                s.enqueue(keys, np.full(512, T.OP_UPSERT, np.int32),
                          rng.integers(0, 100, (512, CFG.value_width)).astype(np.int32))
            svc.step()
            counts[armed] = [_sync_counts(svc.step) for _ in range(4)]
            if armed:
                assert len(svc._clock._rounds) == 5     # queued, not read yet
                fold = _sync_counts(svc._clock.fold)
                assert fold["cudaMemcpyAsync"] == 1, fold
                assert not svc._clock._rounds
            for s in sessions:
                s.drain()
            if armed:
                assert obs.latency.summary()["e2e"]["count"] == svc.collected == 2048
    finally:
        obs.configure(enabled=False, reset=True)
    assert counts[True] == counts[False], counts


# ---------------------------------------------------------------------------
# durability: the WAL and recovery over the kernel-backed store
# ---------------------------------------------------------------------------

def test_durable_sharded_store_recovers_on_the_card(cuda, tmp_path):
    """DurableKV over a kernel-backed ShardedKV(S=2) on the card: a
    snapshot, mixed batches (host arrays, and CUDA tensors encoded in one
    device-to-host copy a record), a migration, a kill at a batch boundary;
    recover() into a fresh CUDA store, which then answers every later batch
    and every key bit-equal to an uninterrupted twin.  A durable round calls
    fused_probe 3 times and fused_write once, as a plain round does."""
    def make():
        return T.ShardedKV(CFG, 2, device=cuda, compact_batch=128, lanes=64, trigger=0.5)
    dkv = T.DurableKV(make(), T.DurabilityConfig(dir=str(tmp_path)))
    twin = make()
    stream = list(_stream(10, 50))
    for i, (k, o, v) in enumerate(stream[:40]):
        if i == 10:
            dkv.snapshot(blocking=True)
        if i == 20:
            nm = twin.bucket_map.copy()
            nm[:2] = 1 - nm[:2]
            assert dkv.migrate(nm) == twin.migrate(nm) > 0
        on_card = i % 2 == 0
        args = tuple(torch.as_tensor(x, device=cuda) for x in (k, o, v)) if on_card else (k, o, v)
        c0 = dkv._wal.d2h_copies
        a, b = dkv.apply(*args), twin.apply(k, o, v)
        assert dkv._wal.d2h_copies - c0 == int(on_card)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), i
    assert dkv.kv.compactions.sum() > 0
    calls = []
    for kv in (dkv.kv, twin):
        kv.trigger = 2.0
    k, o, v = (x[:40] for x in stream[40])      # fits one round: nothing defers
    for kv in (dkv, twin):
        ops.reset_launches()
        kv.apply_round(k, o, v)
        torch.cuda.synchronize()
        calls.append(dict(ops.launches))
    for kv in (dkv.kv, twin):
        kv.trigger = 0.5
    assert calls[0] == calls[1] == {"fused_probe": 3, "probe": 0,
                                    "fused_write": ops.WRITE_KERNELS_PER_CALL}
    dkv.kv.wal = None                                # the kill
    rec = T.recover(str(tmp_path), make)
    assert rec.kv.device.type == "cuda" and rec.recovery["snapshot_epoch"] == 1
    for i, (k, o, v) in enumerate(stream[41:]):
        a, b = rec.apply(k, o, v), twin.apply(k, o, v)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), i
    keys = np.arange(3000, dtype=np.int32)
    a, b = rec.read(keys), twin.read(keys)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rec.check_invariants()
    rec.close()


# -- the host tier on the card ------------------------------------------------

# tests/test_host_tier.py::host_cfg: a cold ring of 512 under a 4,096-key
# uniform mix, spilled ~5x within 400 batches of 64; and its all-device twin
HOST_CFG = T.F2Config(hot_index_size=1 << 10, hot_capacity=1 << 12, hot_mem=1 << 9,
                      cold_capacity=1 << 9, cold_mem=1 << 7, n_chunks=1 << 8,
                      chunk_slots=16, chunklog_capacity=1 << 12, chunklog_mem=1 << 8,
                      rc_capacity=1 << 8, host_tier=True, host_chunk_records=16,
                      host_cache_chunks=48, host_resident_frac=0.5, host_prefetch=1,
                      value_width=2, chain_max=24)


def _host_stream(seed, n_steps, n_keys=4096, width=64):
    rng = np.random.default_rng(seed)
    for step in range(n_steps):
        keys = rng.integers(1, n_keys + 1, size=width).astype(np.int64)
        ops_ = rng.choice([T.OP_READ, T.OP_UPSERT, T.OP_RMW, T.OP_DELETE], size=width,
                          p=[.5, .3, .15, .05]).astype(np.int32)
        vals = np.stack([keys * 3 + step, keys * 5 + 1], axis=1).astype(np.int32)
        yield keys.astype(np.int32), ops_, vals


def _host_equal(a, b, ctx=""):
    """Every leaf, the manager's stats and its host store equal."""
    for n, x, y in zip(interop.leaf_names(), interop.state_to_numpy(a.state if
                       isinstance(a, T.ShardedKV) else a._st),
                       interop.state_to_numpy(b.state if isinstance(b, T.ShardedKV) else b._st)):
        assert np.array_equal(x, y), (ctx, n)
    assert a._ht.stats() == b._ht.stats(), ctx
    ea, eb = a._ht.export_snapshot(), b._ht.export_snapshot()
    assert all(np.array_equal(ea[k], eb[k]) for k in ea), ctx


@pytest.mark.parametrize("engine", ["fused", "fused_ref"])
def test_host_tier_kv_on_the_card_matches_the_cpu(cuda, engine):
    """A spilled KV on the card (pinned host store, staged promotions)
    against the same store on the CPU (plain engine), batch by batch, then
    every leaf, the stats and the host store; every key read back; the
    kernels ran (engine "fused")."""
    dev_kv = T.KV(dataclasses.replace(HOST_CFG, engine=engine), device=cuda,
                  compact_batch=128)
    cpu_kv = T.KV(dataclasses.replace(HOST_CFG, engine="fused_ref"), device="cpu",
                  compact_batch=128)
    assert dev_kv._ht._pin and not cpu_kv._ht._pin
    ops.reset_launches()
    for i, (k, o, v) in enumerate(_host_stream(7, 400)):
        a, b = dev_kv.apply(k, o, v), cpu_kv.apply(k, o, v)
        assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]), i
    _host_equal(dev_kv, cpu_kv, "after the drive")
    st = dev_kv._ht.stats()
    assert st["demotions_total"] > 0 and st["promotions_total"] > 0
    assert int(dev_kv.state.cold.floor) > 0 and dev_kv._ht.h2d_bytes > 0
    if engine == "fused":
        assert ops.launches["fused_probe"] > 0 and ops.launches["fused_write"] > 0
    keys = np.arange(1, 4097, dtype=np.int32)
    for off in range(0, 4096, 32):
        a, b = dev_kv.read(keys[off:off + 32]), cpu_kv.read(keys[off:off + 32])
        assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]), off
    _host_equal(dev_kv, cpu_kv, "after the read-back")
    dev_kv.check_invariants()


def test_host_tier_sharded_on_the_card_matches_the_cpu(cuda):
    """ShardedKV(S=2) with the host tier on the card against the CPU: masked
    compactions while driving, a cold->cold pass masked to shard 0 through
    the resumable walk, a wide read that splits; leaves equal."""
    cfg = dataclasses.replace(HOST_CFG, hot_capacity=1 << 11, hot_mem=1 << 8)
    dev_kv = T.ShardedKV(dataclasses.replace(cfg, engine="fused"), 2, device=cuda,
                         compact_batch=128)
    cpu_kv = T.ShardedKV(dataclasses.replace(cfg, engine="fused_ref"), 2, device="cpu",
                         compact_batch=128)
    for i, (k, o, v) in enumerate(_host_stream(11, 300)):
        a, b = dev_kv.apply(k, o, v), cpu_kv.apply(k, o, v)
        assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]), i
    assert (dev_kv.state.cold.floor > 0).all()
    for kv in (dev_kv, cpu_kv):
        kv.compact_cold_cold(shards=np.array([True, False]))
    _host_equal(dev_kv, cpu_kv, "after a masked cold->cold pass")
    keys = np.arange(1, 4097, dtype=np.int32)
    a, b = dev_kv.read(keys), cpu_kv.read(keys)
    assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])
    assert dev_kv._ht.contract_splits == cpu_kv._ht.contract_splits
    _host_equal(dev_kv, cpu_kv, "after a wide read")
    dev_kv.check_invariants()


def test_host_tier_durable_kill_recovers_on_the_card(cuda, tmp_path):
    """DurableKV(fsync="always") over a spilled ShardedKV(S=2) on the card,
    killed at `host.mid_demote`, recovered on the card: later batches and
    every key bit-equal to an uninterrupted twin, and the recovered store
    still spilled."""
    from repro_torch.testing import faults
    cfg = dataclasses.replace(HOST_CFG, hot_capacity=1 << 8, hot_mem=1 << 5,
                              cold_capacity=1 << 8, engine="fused")

    def make():
        return T.ShardedKV(cfg, 2, device=cuda, lanes=32, compact_batch=128,
                           compact_frac=0.25)
    dkv = T.DurableKV(make(), T.DurabilityConfig(dir=str(tmp_path),
                                                 snapshot_every_rounds=6,
                                                 fsync="always"))
    twin = make()
    stream = list(_host_stream(121, 60, n_keys=400))
    i = 0
    while not bool((dkv.kv.state.cold.floor > 0).any()):
        a, b = dkv.apply(*stream[i]), twin.apply(*stream[i])
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), i
        i += 1
    faults.arm("host.mid_demote")
    try:
        while True:
            try:
                dkv.apply(*stream[i])
            except faults.InjectedCrash:
                break
            twin.apply(*stream[i])
            i += 1
    finally:
        faults.reset()
    twin.apply(*stream[i])
    dkv.ckpt.wait()
    rec = T.recover(str(tmp_path), make)
    for k, o, v in stream[i + 1:]:
        a, b = rec.apply(k, o, v), twin.apply(k, o, v)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    keys = np.arange(1, 401, dtype=np.int32)
    a, b = rec.read(keys), twin.read(keys)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool((rec.kv.state.cold.floor > 0).any())
    rec.check_invariants()
    rec.close()


# ---------------------------------------------------------------------------
# the moe, hybrid, audio and vlm families at their reduced sizes (float32)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("phi35_moe_42b_a6_6b", "kimi_k2_1t_a32b", "hymba_1_5b",
                "whisper_large_v3", "llava_next_34b")


def _family_twins(arch, dev):
    """(config, CPU model, card model): one set of weights from seed 0."""
    import copy
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_config
    cfg = get_config(arch).reduced()
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


def _family_batch(cfg, B=2, T=33, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g)}
    if cfg.frontend == "patches":
        b["frontend"] = torch.randn((B, cfg.num_frontend_tokens, cfg.d_model), generator=g)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g)
    return b


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_kernel_path_matches_plain_path(cuda, arch):
    """Forward logits, the loss and every gradient leaf of the model on the
    card (the flash kernels, forward and gradient) against the same model on
    the CPU (their plain version): logits within 1e-4, the loss within 1e-4
    relative, each gradient leaf within 1e-3 of its largest magnitude."""
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, card = _family_twins(arch, cuda)
    b = _family_batch(cfg)
    fwd = {k: v[:, :-1] if k == "tokens" else v for k, v in b.items()}
    out = {}
    fa_ops.reset_launches()
    for where, model in (("card", card), ("cpu", cpu)):
        dev = model.embed.table.device
        with torch.no_grad():
            lg = transformer.forward(cfg, model, {k: v.to(dev) for k, v in fwd.items()})
        params = ts.trainable(model)
        loss = transformer.loss_fn(cfg, model, {k: v.to(dev) for k, v in b.items()},
                                   loss_chunk=16)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[where] = (lg.cpu(), float(loss.detach()), [g.cpu() for g in grads])
    torch.cuda.synchronize()
    attn_calls = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1) + cfg.n_encoder_layers
    assert fa_ops.launches["flash_attention_fwd"] == 3 * attn_calls   # forward, loss, remat
    assert fa_ops.launches["flash_attention_bwd"] == attn_calls
    (lg_a, l_a, g_a), (lg_b, l_b, g_b) = out["card"], out["cpu"]
    torch.testing.assert_close(lg_a, lg_b, atol=1e-4, rtol=1e-4)
    assert abs(l_a - l_b) <= 1e-4 * abs(l_b)
    for name, a, g in zip(ts.trainable(cpu), g_a, g_b):
        scale = float(g.abs().max()) or 1.0
        assert float((a - g).abs().max()) <= 1e-3 * scale, name


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decodes_are_bit_equal(cuda, arch):
    """Two runs of two decode steps on the card from the same cache (the
    cross cache filled from the encoder for Whisper): logits and every
    cache leaf bit-equal, and the MoE combine adds no atomics."""
    from repro_torch.models import layers, transformer
    _, _, card = _family_twins(arch, cuda)
    cfg = card.cfg
    b = {k: v.to(cuda) for k, v in _family_batch(cfg, B=4, T=2, seed=1).items()}
    runs = []
    with torch.no_grad():
        for _ in range(2):
            cache = transformer.init_cache(cfg, 4, 8, device=cuda)
            if cfg.is_encoder_decoder:
                enc = transformer.encode(cfg, card, b["frames"], remat=False)
                for l, blk in enumerate(card.blocks):
                    cache["xk"][l] = layers._heads(enc, blk.cross.wk)
                    cache["xv"][l] = layers._heads(enc, blk.cross.wv)
            lgs = []
            for t in range(2):
                lg, cache = transformer.decode_step(cfg, card, cache,
                                                    b["tokens"][:, t].int())
                lgs.append(lg)
            runs.append((lgs, cache))
    torch.cuda.synchronize()
    for x, y in zip(runs[0][0], runs[1][0]):
        assert torch.equal(x, y)
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Tq, Tk, Dh, dtype, causal, cross): Kimi-K2's Dh 112 (G 8),
    # Whisper's cross shape (Tq != Tk, no mask; causal asked and dropped),
    # and Dh 112 over a ragged Tk with cross
    (1, 16, 2, 160, 160, 112, torch.bfloat16, True, False),
    (2, 4, 4, 30, 150, 64, torch.bfloat16, True, True),
    (2, 4, 4, 30, 150, 64, torch.float32, False, True),
    (1, 8, 1, 70, 333, 112, torch.bfloat16, False, True),
], ids=["dh112_causal", "whisper_cross_bf16", "whisper_cross_f32", "dh112_cross"])
def test_layers_flash_attention_cross_and_dh112(cuda, case):
    """`layers.flash_attention` in the model layout on the card against the
    plain version on the CPU (2e-5 in float32, 2e-2 in bfloat16)."""
    from repro_torch.models import layers
    B, Hq, Hkv, Tq, Tk, Dh, dt, causal, cross = case
    g = torch.Generator().manual_seed(3)
    q = torch.randn((B, Hq, Tq, Dh), generator=g).to(dt)
    k, v = (torch.randn((B, Hkv, Tk, Dh), generator=g).to(dt) for _ in range(2))
    fa_ops.reset_launches()
    got = layers.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal,
                                 cross=cross)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention_fwd"] == 1
    want = layers.flash_attention(q, k, v, causal=causal, cross=cross)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=tol)
