"""The port's paged attention (its plain version, which the wrapper runs for
CPU tensors) against the JAX package's Pallas kernel in interpret mode and
its pure-jnp oracle, on the same numpy inputs.

Tolerances are tests/test_kernels.py's: 2e-5 in float32 (summation order
differs), 2e-2 where q and the output are bfloat16 (one bf16 rounding of
the output, and the Pallas kernel rounds p to the pools' dtype)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention import ops as jpa
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.kvcache import paged

# (B, Hkv, G, Dh, page, n_pool, max_pages, lengths): tests/test_kernels.py's
# two shapes with random lengths, then the edge cases
CASES = {
    "kernels_a": (3, 2, 4, 64, 64, 16, 4, None),
    "kernels_b": (1, 1, 8, 128, 32, 8, 2, None),
    "len_1": (2, 2, 4, 32, 8, 6, 3, [1, 1]),
    "page_boundary": (3, 2, 4, 32, 8, 6, 3, [8, 16, 24]),
    "full_table": (2, 2, 2, 32, 8, 6, 3, [24, 24]),
    "g1": (2, 3, 1, 64, 16, 5, 2, None),
    "dh256": (2, 2, 2, 256, 8, 4, 2, None),
    "b_odd": (5, 1, 4, 32, 8, 9, 3, None),
    "len_0": (2, 2, 2, 16, 4, 5, 3, [0, 5]),
}


def _inputs(case, seed=0):
    B, Hkv, G, Dh, ps, npool, mp, lens = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((Hkv, npool, ps, Dh)).astype(np.float32)
    vp = rng.standard_normal((Hkv, npool, ps, Dh)).astype(np.float32)
    pt = rng.integers(0, npool, (B, mp)).astype(np.int32)
    ln = (rng.integers(1, ps * mp, (B,)) if lens is None else np.array(lens)).astype(np.int32)
    return q, kp, vp, pt, ln


def _port(q, kp, vp, pt, ln, q_dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, ln)]
    t[0] = t[0].to(q_dtype)
    return ops.paged_attention(*t), ref.paged_attention_reference(*t)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_reference_f32(case):
    q, kp, vp, pt, ln = _inputs(case)
    got, plain = _port(q, kp, vp, pt, ln)
    assert torch.equal(got, plain)           # CPU tensors: the wrapper is ref.py
    jin = [jnp.asarray(a) for a in (q, kp, vp, pt, ln)]
    for want in (jpa.paged_attention(*jin, interpret=True),
                 jpa.paged_attention_ref(*jin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["kernels_a", "kernels_b", "b_odd"])
def test_plain_version_matches_reference_bf16_q_f32_pools(case):
    q, kp, vp, pt, ln = _inputs(case, seed=1)
    got, _ = _port(q, kp, vp, pt, ln, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jin = [jnp.asarray(a) for a in (q, kp, vp, pt, ln)]
    jin[0] = jin[0].astype(jnp.bfloat16)
    for want in (jpa.paged_attention(*jin, interpret=True),
                 jpa.paged_attention_ref(*jin)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)


def test_attend_clamps_table_and_switches_to_plain():
    """attend() reads page 0 for -1 entries under the mask; interpret=True
    and the wrapper give the same result on the CPU."""
    cfg = paged.PagedConfig(n_layers=1, n_kv_heads=2, head_dim=16, page_size=4,
                            n_hot_pages=2, n_cold_pages=4, max_seqs=3,
                            max_pages_per_seq=3)
    st = paged.create(cfg, "cpu")
    rng = np.random.default_rng(2)
    st.k_pool.copy_(torch.from_numpy(rng.standard_normal(st.k_pool.shape).astype(np.float32)))
    st.v_pool.copy_(torch.from_numpy(rng.standard_normal(st.v_pool.shape).astype(np.float32)))
    st.page_table.copy_(torch.tensor([[3, 1, -1], [-1, -1, -1], [0, 5, 2]], dtype=torch.int32))
    st.seq_lens.copy_(torch.tensor([6, 0, 11], dtype=torch.int32))
    q = torch.from_numpy(rng.standard_normal((3, 2, 2, 16)).astype(np.float32))
    ids = torch.arange(3, dtype=torch.int32)
    outs = []
    for interpret in (False, True):
        out, st = paged.attend(cfg, st, st.k_pool[0], st.v_pool[0], q, ids,
                               interpret=interpret)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    want = ref.paged_attention_reference(q, st.k_pool[0], st.v_pool[0],
                                         st.page_table.clamp(min=0),
                                         st.seq_lens + 1)
    assert torch.equal(outs[0], want)
    # touched entries, twice: seq 0 pages 3, 1; seq 2 pages 0, 5, 2 (pages
    # 2-5 are cold)
    assert st.ref_count.tolist() == [2, 2, 2, 2, 0, 2]
    assert int(st.cold_reads) == 6


def test_wrapper_dispatch_and_launch_count():
    """CPU tensors run the plain version and count no launch; the forced
    kernel refuses CPU tensors; other devices are refused."""
    q, kp, vp, pt, ln = (torch.from_numpy(a) for a in _inputs("len_1"))
    ops.reset_launches()
    ops.paged_attention(q, kp, vp, pt, ln)
    assert ops.launches == {"paged_attention": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.paged_attention_cuda(q, kp, vp, pt, ln)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.paged_attention(meta, kp, vp, pt, ln)


@pytest.mark.parametrize("bh,max_pages,sms", [(64, 33, 132), (64, 256, 132), (1, 1, 132),
                                              (2000, 33, 132), (5, 700, 132), (3, 4, 8)])
def test_splits_cover_the_table(bh, max_pages, sms):
    """The split kernel's runs of pages cover the table once, with at most
    MAX_SPLITS per head; the serving shape (B 8 x Hkv 8, 33 pages) gets at
    least two CTAs per SM of an H100's 132."""
    pps, n_split = ops.splits(bh, max_pages, sms)
    assert pps >= 1 and 1 <= n_split <= ops.MAX_SPLITS
    assert (n_split - 1) * pps < max_pages <= n_split * pps
    if (bh, max_pages) == (64, 33):
        assert bh * n_split >= 2 * sms


def _split_merge(q, kp, vp, pt, ln, pps):
    """The split kernel's and the merge kernel's arithmetic in plain torch:
    each run of pps pages gives a partial (m, l, acc) over its keys below
    the length (all of the table's keys, every score -1e30, where the length
    is <= 0), an empty run gives (-1e30, 0, -); the partials are merged in
    split order."""
    B, Hkv, G, Dh = q.shape
    ps, mp = kp.shape[2], pt.shape[1]
    total, n_split = mp * ps, -(-mp // pps)
    idx = pt.long().clamp(0, kp.shape[1] - 1)
    k = kp[:, idx].transpose(0, 1).reshape(B, Hkv, total, Dh).float()
    v = vp[:, idx].transpose(0, 1).reshape(B, Hkv, total, Dh).float()
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k) * (Dh ** -0.5)
    out = torch.empty(B, Hkv, G, Dh)
    for b in range(B):
        n = int(ln[b])
        end = total if n <= 0 else min(n, total)
        parts = []
        for i in range(n_split):
            k0, k1 = i * pps * ps, min(end, (i + 1) * pps * ps)
            if k0 >= k1:
                parts.append(None)
                continue
            sc = s[b, :, :, k0:k1] if n > 0 else torch.full_like(s[b, :, :, k0:k1], -1e30)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("hgk,hkd->hgd", p.to(kp.dtype).float(), v[b, :, k0:k1])
            parts.append((m, p.sum(-1), acc))
        M = torch.stack([pt_[0] for pt_ in parts if pt_]).amax(0)
        L, O = torch.zeros(Hkv, G), torch.zeros(Hkv, G, Dh)
        for pt_ in parts:
            if pt_:
                w = torch.exp(pt_[0] - M)
                L += pt_[1] * w
                O += pt_[2] * w[..., None]
        out[b] = O / torch.clamp(L, min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_and_merge_arithmetic_matches_plain_version(case, pps):
    """Splitting the pages into runs and merging the partials gives the
    plain version's result (2e-5 in float32) at every length, including
    lengths of 0 and lengths that end a run."""
    q, kp, vp, pt, ln = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    want = ref.paged_attention_reference(q, kp, vp, pt, ln)
    got = _split_merge(q, kp, vp, pt, ln, pps)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
