"""The plain reference's fold on hand-made batches."""
import torch

from f2bench import gen
from f2bench.reference import DenseStore

V = 4
R, U, M = gen.OP_READ, gen.OP_UPSERT, gen.OP_RMW


def batch(keys, ops, vals=None):
    keys = torch.tensor(keys, dtype=torch.int32)
    ops = torch.tensor(ops, dtype=torch.int32)
    if vals is None:
        vals = torch.zeros((len(keys), V), dtype=torch.int32)
    else:
        vals = torch.tensor([[v] * V for v in vals], dtype=torch.int32)
    return keys, ops, vals


def store():
    return DenseStore(16, V, seed=11, device="cpu")


def test_loaded_values():
    s = store()
    k = torch.arange(16)
    assert torch.equal(s.val, gen.loaded_values(11, k, V))
    st, out = s.apply(*batch([3, 5], [R, R]))
    assert st.tolist() == [gen.ST_OK] * 2
    assert torch.equal(out, gen.loaded_values(11, torch.tensor([3, 5]), V))


def test_reads_see_the_state_before_the_batch():
    s = store()
    before = s.val[2].clone()
    st, out = s.apply(*batch([2, 2, 2], [U, R, U], [7, 0, 9]))
    assert st.tolist() == [gen.ST_OK] * 3
    assert torch.equal(out[1], before)
    _, out = s.apply(*batch([2], [R]))
    assert out[0].tolist() == [9] * V           # the last upsert wins


def test_last_upsert_wins_across_keys_and_lane_order():
    s = store()
    s.apply(*batch([1, 4, 1, 4, 1], [U, U, U, U, U], [10, 40, 11, 41, 12]))
    _, out = s.apply(*batch([1, 4], [R, R]))
    assert out[:, 0].tolist() == [12, 41]


def test_rmw_adds_after_the_last_upsert():
    s = store()
    s.apply(*batch([6, 6, 6, 6], [M, U, M, M], [100, 5, 1, 2]))
    _, out = s.apply(*batch([6], [R]))
    assert out[0].tolist() == [8] * V
    base = s.val[7].clone().to(torch.int64)
    st, _ = s.apply(*batch([7, 7], [M, M], [3, 4]))
    assert st.tolist() == [gen.ST_OK] * 2
    _, out = s.apply(*batch([7], [R]))
    assert out[0].tolist() == (base + 7).tolist()


def test_rmw_on_an_absent_key_creates():
    s = store()
    s.present[9] = False
    st, out = s.apply(*batch([9, 9], [R, M], [0, 5]))
    assert st.tolist() == [gen.ST_NOT_FOUND, gen.ST_CREATED]
    assert out[0].tolist() == [0] * V
    st, out = s.apply(*batch([9], [R]))
    assert st.tolist() == [gen.ST_OK] and out[0].tolist() == [5] * V


def test_int32_wrap():
    s = store()
    s.apply(*batch([0], [U], [2 ** 31 - 1]))
    s.apply(*batch([0], [M], [1]))
    _, out = s.apply(*batch([0], [R]))
    assert out[0].tolist() == [-2 ** 31] * V


def test_narrow_store_loses_the_high_bits():
    s = DenseStore(16, V, seed=11, device="cpu", narrow=True)
    _, out = s.apply(*batch(list(range(16)), [R] * 16))
    assert not torch.equal(out, gen.loaded_values(11, torch.arange(16), V))
