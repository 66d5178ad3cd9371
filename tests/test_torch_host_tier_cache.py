"""The reference's chunk-cache properties (tests/test_host_tier.py) on both
packages with the same outcomes and leaves: a spilled reference KV (its
`spilled` fixture's drive) carried into the port, state and host store and
the manager's soft state, then the same operations on both: victim order,
a pinned chunk surviving promotion pressure, promotion idempotence,
demote -> promote byte identity, `KeyError` for a chunk never demoted, the
contract split of a wide read (on KV and on ShardedKV) and the one-lane
`CacheThrash`.  After each, every leaf, the stats and the host stores are
compared bit for bit."""
import numpy as np
import pytest
import torch

from repro.core.host_tier import CacheThrash as JCacheThrash
from repro_torch.core.host_tier import CacheThrash
from torch_host_oracle import (assert_host_equal, carry_store, drive,
                               port_cfg, port_store, ref_cfg, ref_store,
                               spill_factor)
from test_host_tier import C, N_KEYS, V
from torch_parity import as_np, assert_same


@pytest.fixture(scope="module")
def pair():
    """(reference KV, port KV): the reference's 400-step seed-7 drive,
    carried into the port."""
    jkv = ref_store(ref_cfg("fused_ref"), compact_batch=128)
    drive([jkv], seed=7, n_steps=400)
    tkv = port_store(port_cfg(jkv.cfg), compact_batch=128)
    carry_store(jkv, tkv)
    assert_host_equal(jkv, tkv, "carried")
    assert spill_factor(tkv) >= 4.0
    return jkv, tkv


def chunks_of(kv):
    return as_np(kv.state.host.chunk).reshape(-1)


def test_victim_order_empty_then_coldest(pair):
    """Empty rows first, then coldest by (tick, hits, row); protected
    chunks never; a full demand beyond the evictable rows raises, a partial
    one shrinks (but must make progress)."""
    chunks = np.array([3, -1, 7, 9, 11], np.int32)
    ticks = np.array([5, 0, 2, 2, 9], np.int32)
    hits = np.array([1, 0, 4, 2, 0], np.int32)
    cases = [(3, 0, set(), False), (3, 0, {7, 9}, False), (1, 2, set(), False),
             (5, 0, {3, 7, 9, 11}, True)]
    for jkv_or_t in pair:
        pick = jkv_or_t._ht._pick_victims
        got = [pick(0, chunks, ticks, hits, *c) for c in cases]
        assert got == [[1, 3, 2], [1, 0, 4], [1, 3, 2], [1]], got
    for exc, kv in zip((JCacheThrash, CacheThrash), pair):
        pick = kv._ht._pick_victims
        with pytest.raises(exc, match="thrash"):
            pick(0, chunks, ticks, hits, 5, 0, {3, 7, 9, 11}, False)
        with pytest.raises(exc, match="thrash"):
            pick(0, np.array([3, 7], np.int32), ticks[:2], hits[:2], 1, 0, {3, 7}, True)


def test_pinned_chunk_survives_promotion_pressure(pair):
    jkv, tkv = pair
    for kv in pair:
        kv._ht.end_batch()
    demoted = sorted(jkv._ht.store[0])
    assert demoted == sorted(tkv._ht.store[0])
    r_rows = jkv.cfg.host_cache_chunks
    assert len(demoted) > r_rows
    target = demoted[0]
    jkv.state = jkv._ht.promote(jkv.state, [{target}])
    tkv._st = tkv._ht.promote(tkv._st, [{target}])
    group = (r_rows - 1) // 2
    for off in range(0, len(demoted[1:]), group):
        need = set(demoted[1:][off:off + group])
        jkv.state = jkv._ht.promote(jkv.state, [need], pin=False)
        tkv._st = tkv._ht.promote(tkv._st, [need], pin=False)
        assert_same(np.asarray(jkv.state.host.chunk), chunks_of(tkv), f"@ {off}")
        resident = set(chunks_of(tkv).tolist())
        assert target in resident and need <= resident, off
    assert_host_equal(jkv, tkv, "after the pressure")
    for kv in pair:
        kv._ht.end_batch()


def test_promotion_idempotent(pair):
    jkv, tkv = pair
    demoted = sorted(tkv._ht.store[0])
    need = {demoted[1], demoted[3]}
    jkv.state = jkv._ht.promote(jkv.state, [need])
    tkv._st = tkv._ht.promote(tkv._st, [need])
    before = [t.clone() for t in tkv._st.host]
    p0 = tkv._ht.promotions
    jkv.state = jkv._ht.promote(jkv.state, [need])
    tkv._st = tkv._ht.promote(tkv._st, [need])
    assert tkv._ht.promotions == p0
    for a, b in zip(before, tkv._st.host):
        assert torch.equal(a, b)
    assert_host_equal(jkv, tkv, "idempotent")
    for kv in pair:
        kv._ht.end_batch()


def test_demote_promote_byte_identical(pair):
    """A chunk read back through the device cache equals its host copy,
    in both packages."""
    jkv, tkv = pair
    demoted = sorted(tkv._ht.store[0])
    host = tkv._st.host
    for cid in demoted[:4] + demoted[-4:]:
        jkv.state = jkv._ht.promote(jkv.state, [{cid}])
        tkv._st = tkv._ht.promote(tkv._st, [{cid}])
        host = tkv._st.host
        r = int(np.flatnonzero(chunks_of(tkv) == cid)[0])
        hk, hv, hp, hm = tkv._ht.store[0][cid]
        jk, jv, jp, jm = jkv._ht.store[0][cid]
        for a, b in ((hk, jk), (hv, jv), (hp, jp), (hm, jm)):
            assert_same(np.asarray(b), a)
        assert_same(hk, host.key[0].reshape(-1, C)[r].numpy())
        assert_same(hv, host.val[0].reshape(-1, C, V)[r].numpy())
        assert_same(hp, host.prev[0].reshape(-1, C)[r].numpy())
        assert_same(hm, host.meta[0].reshape(-1, C)[r].numpy())
    assert_host_equal(jkv, tkv, "round trips")
    for kv in pair:
        kv._ht.end_batch()


def test_promote_never_demoted_chunk_raises(pair):
    for kv in pair:
        with pytest.raises(KeyError):
            kv._ht.promote(kv.state if kv is pair[0] else kv._st, [{10 ** 6}])
        kv._ht.end_batch()


def test_contract_split_wide_read(pair):
    """One read of the whole keyspace, far more walk paths than cache
    rows: both packages split it into cache-sized slices alike."""
    jkv, tkv = pair
    before = tkv._ht.contract_splits
    all_keys = np.arange(1, N_KEYS + 1, dtype=np.int32)
    ja, ta = jkv.read(all_keys), tkv.read(all_keys)
    assert_same(np.asarray(ja[0]).astype(np.int32), ta[0])
    assert_same(np.asarray(ja[1]), ta[1])
    assert tkv._ht.contract_splits > before
    assert tkv.stats()["host"]["contract_splits_total"] == tkv._ht.contract_splits
    assert_host_equal(jkv, tkv, "wide read")
    tkv.check_invariants()


def test_single_lane_thrash_still_hard_errors(pair):
    """With the whole cache full and pinned, a one-lane read that must
    promote raises `CacheThrash` (no split counted), at the same key in
    both packages."""
    jkv, tkv = pair
    for kv in pair:
        kv._ht.end_batch()
    resident = {int(x) for x in chunks_of(tkv) if x >= 0}
    absent = [c for c in sorted(tkv._ht.store[0]) if c not in resident]
    room = tkv.cfg.host_cache_chunks - len(resident)
    if room > 0:
        jkv.state = jkv._ht.promote(jkv.state, [set(absent[:room])], pin=False)
        tkv._st = tkv._ht.promote(tkv._st, [set(absent[:room])], pin=False)
    splits = tkv._ht.contract_splits
    rng = np.random.default_rng(3)
    raised = None
    for k in rng.permutation(np.arange(1, N_KEYS + 1, dtype=np.int32)):
        outs = []
        for kv, exc in zip(pair, (JCacheThrash, CacheThrash)):
            kv._ht.pin_chunks([{int(x) for x in chunks_of(kv) if x >= 0}])
            try:
                outs.append(tuple(as_np(x) for x in kv.read(np.asarray([k], np.int32))))
            except exc:
                outs.append("thrash")
        if outs[0] == "thrash" or outs[1] == "thrash":
            assert outs == ["thrash", "thrash"], (k, outs)
            raised = int(k)
            break
        assert_same(outs[0][0].astype(np.int32), outs[1][0], f"key {k}")
        assert_same(outs[0][1], outs[1][1], f"key {k}")
    assert raised is not None
    assert tkv._ht.contract_splits == splits
    for kv in pair:
        kv._ht.end_batch()
    assert_host_equal(jkv, tkv, "after the thrash")


def test_contract_split_sharded_wide_read():
    """The routed read loop splits a wide read alike: a spilled reference
    ShardedKV(S=2) (upserts only, no prefetch, a quarter hot ring so that
    it spills in 120 batches) carried into the port, then one read of every
    key on both."""
    n_keys = 2 * N_KEYS
    cfg_kw = dict(host_prefetch=0, hot_capacity=1 << 10, hot_mem=1 << 7)
    jkv = ref_store(ref_cfg("fused_ref", **cfg_kw), 2, compact_batch=128)
    rng = np.random.default_rng(23)
    ref = {}
    for step in range(120):
        keys = rng.integers(1, n_keys + 1, size=64).astype(np.int32)
        vals = np.stack([keys * 3 + step, keys * 5 + 1], axis=1).astype(np.int32)
        jkv.upsert(keys, vals)
        ref.update({int(k): vals[i] for i, k in enumerate(keys)})
    tkv = port_store(port_cfg(jkv.cfg), 2, compact_batch=128)
    carry_store(jkv, tkv)
    assert spill_factor(tkv) > 1.0
    all_keys = np.arange(1, n_keys + 1, dtype=np.int32)
    ja, ta = jkv.read(all_keys), tkv.read(all_keys)
    assert_same(np.asarray(ja[0]).astype(np.int32), ta[0])
    assert_same(np.asarray(ja[1]), ta[1])
    st, v = as_np(ta[0]), as_np(ta[1])
    for j, k in enumerate(all_keys):
        if int(k) in ref:
            assert st[j] == 1 and np.array_equal(v[j], ref[int(k)]), k
        else:
            assert st[j] == 2, k
    assert tkv._ht.contract_splits > 0
    assert_host_equal(jkv, tkv, "sharded wide read")
    tkv.check_invariants()
