"""The traffic generator: a pure function of the seed, the same bits from
torch and numpy, the mix's shares, the Zipf skew and YCSB's scramble."""
import numpy as np
import pytest
import torch

from f2bench import gen

MIX_A = {"mix": {"read": 0.5, "upsert": 0.5},
         "keys": {"dist": "zipf", "theta": 0.99}, "batch": 1 << 16}
MIX_C_UNIFORM = {"mix": {"read": 1.0}, "keys": {"dist": "uniform"},
                 "batch": 1 << 16}
BIG_SEED = 2 ** 31 + 977          # past 32 signed bits


def traffic(mix, seed, n=1 << 14):
    return gen.Traffic(mix, n, 25, seed, "cpu")


@pytest.mark.parametrize("mix", [MIX_A, MIX_C_UNIFORM])
def test_same_seed_same_batches(mix):
    a, b = traffic(mix, BIG_SEED), traffic(mix, BIG_SEED)
    for i in (0, 7, 100000):
        for x, y in zip(a.batch(i), b.batch(i)):
            if x is None:
                assert y is None
            else:
                assert torch.equal(x, y)
    other = traffic(mix, BIG_SEED + 1)
    assert not torch.equal(a.batch(0)[0], other.batch(0)[0])
    assert not torch.equal(a.batch(0)[0], a.batch(1)[0])


def test_mix_shares_and_values():
    t = traffic(MIX_A, BIG_SEED)
    keys, ops, vals = t.batch(3)
    assert keys.dtype == ops.dtype == vals.dtype == torch.int32
    assert keys.min() >= 0 and keys.max() < t.n
    read = float((ops == gen.OP_READ).float().mean())
    assert abs(read - 0.5) < 0.01
    assert set(ops.unique().tolist()) == {gen.OP_READ, gen.OP_UPSERT}
    assert vals.shape == (t.B, 25) and vals.min() >= 0
    assert vals.max() > 2 ** 24          # full-range words, not bytes
    c = traffic(MIX_C_UNIFORM, BIG_SEED).batch(0)
    assert c[2] is None and bool((c[1] == gen.OP_READ).all())


def test_zipf_is_skewed_and_uniform_is_not():
    zk = traffic(MIX_A, 5).batch(0)[0]
    assert zk.min() >= 0 and zk.max() < 1 << 14
    uk = traffic(MIX_C_UNIFORM, 5).batch(0)[0]
    top_z = torch.bincount(zk.long()).max().item()
    top_u = torch.bincount(uk.long()).max().item()
    assert top_z > 20 * top_u
    # Zipf 0.99 over 2**14 keys: the hottest key takes ~9.6% of the draws
    assert 0.07 < top_z / zk.numel() < 0.12


def test_loaded_values_are_the_same_bits_in_numpy():
    c = np.arange(0, 5000, dtype=np.int64) * 7919 + (1 << 33)
    h_np = gen.hash32(BIG_SEED, gen.S_LOAD, c)
    h_t = gen.hash32(BIG_SEED, gen.S_LOAD, torch.as_tensor(c))
    assert np.array_equal(h_np, h_t.numpy())
    assert h_np.min() >= 0 and h_np.max() < 2 ** 32
    k = torch.arange(100)
    v = gen.loaded_values(BIG_SEED, k, 25)
    assert v.shape == (100, 25) and v.dtype == torch.int32 and v.min() >= 0
    assert not torch.equal(v, gen.loaded_values(BIG_SEED + 1, k, 25))


def test_batch_seeds_differ():
    seeds = {gen.batch_seed(s, i) for s in (0, 1, BIG_SEED, 2 ** 40)
             for i in range(200)}
    assert len(seeds) == 800
    assert all(0 <= x < 2 ** 63 for x in seeds)


def test_scramble_is_ycsbs():
    rank = np.arange(0, 1 << 20, 37, dtype=np.int64)
    n = (1 << 23) - 5
    want = ((rank.astype(np.uint64) * np.uint64(gen.SCRAMBLE))
            >> np.uint64(33)) % np.uint64(n)
    got = gen.scramble(torch.as_tensor(rank), n).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_fmix32_is_murmur3():
    def ref(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & 0xFFFFFFFF
        return x ^ (x >> 16)
    xs = [0, 1, 0xDEADBEEF, 0xFFFFFFFF, 123456789]
    got = gen.fmix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [ref(x) for x in xs]


def test_sample_slice_in_range_and_seeded():
    t = traffic(MIX_A, BIG_SEED)
    for i in range(50):
        lo, hi = t.sample_slice(i, 8192)
        assert 0 <= lo and hi == lo + 8192 and hi <= t.B
    assert t.sample_slice(3, 100) == traffic(MIX_A, BIG_SEED).sample_slice(3, 100)


def test_load_order_is_a_permutation():
    order = gen.load_order(BIG_SEED, 1 << 12, "cpu")
    assert torch.equal(order.sort().values, torch.arange(1 << 12, dtype=torch.int32))


def test_unknown_kinds_refused():
    with pytest.raises(ValueError):
        traffic({"mix": {"scan": 1.0}, "keys": {"dist": "uniform"},
                 "batch": 8}, 1)
    with pytest.raises(ValueError):
        traffic({"mix": {"read": 0.5}, "keys": {"dist": "uniform"},
                 "batch": 8}, 1)
