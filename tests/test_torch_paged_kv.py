"""The port's F2-tiered paged KV cache against the JAX package's
`kvcache/paged.py`: the same sequence of new_seq, begin_token,
append_layer, end_token, attend, promote_if_hot and release_seq on both,
with the same numpy rows and queries.

Control-plane state (page table, lengths, reference counts, cold reads,
demotions, promotions, the allocator's free lists) must be equal exactly;
pools and attention outputs within 1e-5 (float32, summation order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kvcache import paged as jp
from repro_torch.kvcache import paged as tp

TOL = dict(atol=1e-5, rtol=1e-5)


class Twin:
    """One JAX PagedKV and one port PagedKV (CPU) driven in lockstep."""

    def __init__(self, **cfg):
        self.j = jp.PagedKV(jp.PagedConfig(**cfg))
        self.t = tp.PagedKV(tp.PagedConfig(**cfg), device="cpu")
        self.cfg = self.t.cfg

    def new_seq(self):
        a, b = self.j.new_seq(), self.t.new_seq()
        assert a == b
        return a

    def release_seq(self, s):
        self.j.release_seq(s)
        self.t.release_seq(s)

    def token(self, ids, active, rng):
        """One decode token: tail pages for the active sequences, one row
        per layer for every lane, attention per layer over every lane."""
        ids = np.asarray(ids, np.int32)
        self.j.begin_token(ids[active])
        self.t.begin_token(ids[active])
        cfg = self.cfg
        shape = (len(ids), cfg.n_kv_heads, cfg.head_dim)
        outs = []
        for layer in range(cfg.n_layers):
            k = rng.standard_normal(shape).astype(np.float32)
            v = rng.standard_normal(shape).astype(np.float32)
            self.j.append_layer(layer, ids, jnp.asarray(k), jnp.asarray(v))
            self.t.append_layer(layer, ids, torch.from_numpy(k), torch.from_numpy(v))
            q = rng.standard_normal((len(ids), cfg.n_kv_heads, 2, cfg.head_dim)
                                    ).astype(np.float32)
            a = self.j.attend(layer, jnp.asarray(q), ids)
            b = self.t.attend(layer, torch.from_numpy(q), ids)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
            outs.append(b)
        self.j.end_token(ids[active])
        self.t.end_token(ids[active])
        self.j.promote_if_hot()
        self.t.promote_if_hot()
        self.check()
        return outs

    def check(self):
        js, ts = self.j.state, self.t.state
        for f in ("page_table", "seq_lens", "ref_count", "cold_reads"):
            assert np.array_equal(np.asarray(getattr(js, f)),
                                  getattr(ts, f).numpy()), f
        for f in ("k_pool", "v_pool"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)), **TOL)
        assert (self.j.demotions, self.j.promotions) == (self.t.demotions,
                                                         self.t.promotions)
        assert self.j.alloc.free_hot == self.t.alloc.free_hot
        assert self.j.alloc.free_cold == self.t.alloc.free_cold
        assert self.j.seq_pages == self.t.seq_pages
        assert self.j.free_seqs == self.t.free_seqs


def test_unit_scenario():
    """tests/test_engine.py::test_paged_kv_unit on both packages: one
    sequence over three pages of a two-page hot ring."""
    tw = Twin(n_layers=1, n_kv_heads=2, head_dim=8, page_size=4,
              n_hot_pages=2, n_cold_pages=8, max_seqs=2, max_pages_per_seq=4)
    s0 = tw.new_seq()
    ids = np.array([s0], np.int32)
    for t in range(10):
        tw.j.begin_token(ids)
        tw.t.begin_token(ids)
        row = np.full((1, 2, 8), float(t), np.float32)
        tw.j.append_layer(0, ids, jnp.asarray(row), jnp.asarray(row))
        tw.t.append_layer(0, ids, torch.from_numpy(row), torch.from_numpy(row))
        tw.j.end_token(ids)
        tw.t.end_token(ids)
        tw.check()
    assert tw.t.demotions >= 1
    q = np.ones((1, 2, 1, 8), np.float32)
    out = tw.t.attend(0, torch.from_numpy(q), ids)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(tw.j.attend(0, jnp.asarray(q), ids)), **TOL)
    assert out.shape == (1, 2, 1, 8)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 9.0
    tw.check()


def test_ragged_sequences_demote_and_promote():
    """Three ragged sequences on a three-page hot ring: demotions under
    pressure, then promotions of re-read cold pages once a release frees
    hot pages; lanes without pages stay in the batch throughout."""
    tw = Twin(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4,
              n_hot_pages=3, n_cold_pages=16, max_seqs=4, max_pages_per_seq=8)
    rng = np.random.default_rng(0)
    ids = np.arange(4, dtype=np.int32)
    seqs = [tw.new_seq() for _ in range(3)]
    stop = {seqs[0]: 9, seqs[1]: 14, seqs[2]: 22}      # tokens per sequence
    done = {s: 0 for s in seqs}
    while any(done[s] < stop[s] for s in seqs):
        active = np.zeros(4, bool)
        for s in seqs:
            active[s] = done[s] < stop[s]
        tw.token(ids, active, rng)
        for s in seqs:
            if active[s]:
                done[s] += 1
                if done[s] == stop[s] and s == seqs[0]:
                    tw.release_seq(s)
                    tw.check()
    for _ in range(3):                  # re-read what is left
        tw.token(ids, np.zeros(4, bool), rng)
    assert tw.t.demotions > 0 and tw.t.promotions > 0
    assert int(tw.t.state.cold_reads) > 0


def test_move_page_and_bump_lens_in_place():
    cfg = tp.PagedConfig(n_layers=2, n_kv_heads=1, head_dim=4, page_size=2,
                         n_hot_pages=2, n_cold_pages=2, max_seqs=2,
                         max_pages_per_seq=2)
    st = tp.create(cfg, "cpu")
    st.k_pool[:, :, 1] = 7.0
    st.ref_count[3] = 5
    pool = st.k_pool
    tp.move_page(st, 1, 3, seq=1, logical=0)
    assert st.k_pool is pool and bool((pool[:, :, 3] == 7.0).all())
    assert st.page_table.tolist() == [[-1, -1], [3, -1]]
    assert st.ref_count.tolist() == [0, 0, 0, 0]
    tp.bump_lens(st, torch.tensor([0, 1, 1], dtype=torch.int32),
                 torch.tensor([True, True, False]))
    assert st.seq_lens.tolist() == [1, 1]


def test_paged_kv_defaults_to_cuda():
    cfg = tp.PagedConfig(n_layers=1, n_kv_heads=1, head_dim=4)
    if torch.cuda.is_available():
        assert tp.PagedKV(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.PagedKV(cfg)
