"""The port's live rebalancing (core/rebalance.py, ShardedKV.migrate and
maybe_rebalance) against the JAX package's, bit for bit: the planner, and
migrations inside a running op stream — planner-driven, overlapping a masked
compaction on the source shard, and a bucket returning home — with every
stacked leaf, status, value, bucket map, migration count and IoStats equal
to the reference ShardedKV's, statuses and values equal to a flat port KV
replaying the stream (tests/test_rebalance.py's oracle), and shards no
migration involves byte-identical through it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import (OP_DELETE, OP_READ, OP_RMW, OP_UPSERT,  # noqa: E402
                        ST_NOT_FOUND, ST_OK)
from repro.core.sharded import ShardedKV as JShardedKV  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import rebalance as trb, shard_router as tsr  # noqa: E402
from torch_parity import as_np, assert_same, assert_states_equal, configs  # noqa: E402

V = 2
# tests/test_rebalance.py::tiny_cfg
TINY = dict(hot_index_size=1 << 8, hot_capacity=1 << 9, hot_mem=1 << 6,
            cold_capacity=1 << 11, cold_mem=1 << 6, n_chunks=1 << 6,
            chunklog_capacity=1 << 9, chunklog_mem=1 << 5,
            rc_capacity=1 << 6, value_width=V, chain_max=48)


def twins(rb: dict, cfg_kw=None, **kw):
    """(reference ShardedKV, port ShardedKV) over 4 shards with the same
    RebalanceConfig fields."""
    jcfg, tcfg = configs(**dict(TINY, **(cfg_kw or {})))
    return (JShardedKV(jcfg, 4, donate=False, rebalance_cfg=J.RebalanceConfig(**rb),
                       **kw),
            T.ShardedKV(tcfg, 4, device="cpu", rebalance_cfg=T.RebalanceConfig(**rb),
                        **kw))


def assert_twins_equal(jkv, tkv, ctx):
    assert_states_equal(jkv.state, tkv.state, ctx)
    assert np.array_equal(jkv.bucket_map, tkv.bucket_map), ctx
    assert np.array_equal(jkv.compactions, tkv.compactions), ctx
    assert (jkv.rounds, jkv.migrations, jkv.migrated_buckets,
            jkv.migrated_records, jkv.map_version) == (
        tkv.rounds, tkv.migrations, tkv.migrated_buckets,
        tkv.migrated_records, tkv.map_version), ctx
    assert jkv.io_stats() == tkv.io_stats(), ctx
    assert np.array_equal(jkv.traffic_ewma, tkv.traffic_ewma), ctx
    assert np.array_equal(jkv.routed_lanes, tkv.routed_lanes), ctx


def fold(ref, keys, ops, vals):
    for k, o, v in zip(keys, ops, vals):
        k, o = int(k), int(o)
        if o == OP_UPSERT:
            ref[k] = v.copy()
        elif o == OP_DELETE:
            ref.pop(k, None)
        elif o == OP_RMW:
            ref[k] = (ref.get(k, np.zeros(V, np.int32)) + v).astype(np.int32)


def step(jkv, tkv, flat, ref, keys, ops, vals, ctx):
    """One batch on the reference and port ShardedKVs and the flat port KV:
    statuses and values bit-exact, reads against the dict oracle."""
    js, jv = jkv.apply(keys, ops, vals)
    ts, tv = tkv.apply(keys, ops, vals)
    fs, fv = flat.apply(keys, ops, vals)
    assert_same(js, ts, f"{ctx}/status")
    assert_same(jv, tv, f"{ctx}/values")
    assert_same(fs, ts, f"{ctx}/flat status")
    assert_same(fv, tv, f"{ctx}/flat values")
    assert_twins_equal(jkv, tkv, ctx)
    ts, tv = as_np(ts), as_np(tv)
    for i in np.flatnonzero(ops == OP_READ):
        k = int(keys[i])
        if k in ref:
            assert ts[i] == ST_OK and np.array_equal(tv[i], ref[k]), (ctx, k)
        else:
            assert ts[i] == ST_NOT_FOUND, (ctx, k)
    fold(ref, keys, ops, vals)


def keys_on_shard(kv, shard, n=4096):
    cand = np.arange(n, dtype=np.int32)
    b = as_np(tsr.bucket_of(torch.as_tensor(cand), kv.n_buckets))
    return cand[kv.bucket_map[b] == shard]


def test_migration_oracle_flat_replay():
    """tests/test_rebalance.py::test_migration_oracle_flat_replay on both
    packages: three migrations inside a mixed stream (planned from the
    traffic EWMA; overlapping a masked hot->cold pass on the source shard;
    a bucket returning to its first shard), bit-exact with the reference
    ShardedKV after every batch and migration, and with a flat KV."""
    rb = dict(enabled=False, buckets_per_shard=8, migrate_batch=64)
    kw = dict(mode="f2", trigger=0.6, compact_frac=0.3, compact_batch=64)
    jkv, tkv = twins(rb, **kw)
    flat = T.KV(tkv.cfg, device="cpu", **kw)
    rng = np.random.default_rng(19)
    N, B = 500, 128
    ref = {}

    def mixed():
        keys = rng.integers(0, N, B).astype(np.int32)
        ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.3, .4, .15, .15]).astype(np.int32)
        return keys, ops, rng.integers(0, 100, (B, V)).astype(np.int32)

    for i in range(8):
        step(jkv, tkv, flat, ref, *mixed(), f"warm{i}")
    stats = tkv.shard_stats()
    new_map = trb.plan_moves(stats.traffic_ewma, stats.bucket_map, 4,
                             threshold=1.0)
    assert new_map is not None
    moved_b = int(np.flatnonzero(new_map != tkv.bucket_map)[0])
    home = int(tkv.bucket_map[moved_b])
    moved = (jkv.migrate(new_map), tkv.migrate(new_map))
    assert moved[0] == moved[1] > 0
    assert_twins_equal(jkv, tkv, "migrate1")
    for i in range(6):
        step(jkv, tkv, flat, ref, *mixed(), f"mid{i}")

    # pressure on one source shard with the scheduler disarmed, then re-armed
    # so that the pass inside migrate() compacts it between drain and purge
    for kv in (jkv, tkv, flat):
        kv.trigger = 2.0
    src = int(np.argmax(tkv.hot_fills()))
    hot_keys = keys_on_shard(tkv, src)
    for i in range(8):
        if tkv.hot_fills()[src] > 0.55:
            break
        ks = hot_keys[rng.integers(0, len(hot_keys), B)].astype(np.int32)
        step(jkv, tkv, flat, ref, ks, np.full(B, OP_UPSERT, np.int32),
             rng.integers(0, 100, (B, V)).astype(np.int32), f"flood{i}")
    assert tkv.hot_fills()[src] > 0.5
    for kv in (jkv, tkv, flat):
        kv.trigger = 0.5
    pre = tkv.compactions.copy()
    nm2 = tkv.bucket_map.copy()
    nm2[np.flatnonzero(nm2 == src)[:3]] = (src + 1) % 4
    moved = (jkv.migrate(nm2), tkv.migrate(nm2))
    assert moved[0] == moved[1] > 0 and tkv.migrations == 2
    assert tkv.compactions[src] > pre[src], "no masked compaction in migrate"
    assert_twins_equal(jkv, tkv, "migrate2")
    tkv.check_invariants()
    for i in range(6):
        step(jkv, tkv, flat, ref, *mixed(), f"post{i}")

    nm3 = tkv.bucket_map.copy()
    assert nm3[moved_b] != home
    nm3[moved_b] = home
    jkv.migrate(nm3)
    tkv.migrate(nm3)
    assert_twins_equal(jkv, tkv, "migrate3")
    for i in range(4):
        step(jkv, tkv, flat, ref, *mixed(), f"return{i}")
    ks = np.arange(N + 12, dtype=np.int32)
    (js, jv), (ts, tv), (fs, fv) = jkv.read(ks), tkv.read(ks), flat.read(ks)
    assert_same(js, ts)
    assert_same(jv, tv)
    assert_same(fs, ts)
    assert_same(fv, tv)
    ts, tv = as_np(ts), as_np(tv)
    for k in range(N + 12):
        if k in ref:
            assert ts[k] == ST_OK and np.array_equal(tv[k], ref[k]), k
        else:
            assert ts[k] == ST_NOT_FOUND, k
    tkv.check_invariants()
    assert tkv.migrations == 3 and tkv.compactions.sum() > 0


def test_untouched_shards_byte_identical_through_migration():
    """Shards neither source nor destination of a moving bucket pass
    through `migrate` byte-identical; the migration equals the reference's,
    and a balanced store's rebalance is a byte-identical no-op."""
    jkv, tkv = twins(dict(enabled=True, threshold=1e9, migrate_batch=64),
                     trigger=2.0)
    rng = np.random.default_rng(7)
    for _ in range(5):
        keys = rng.integers(0, 600, 128).astype(np.int32)
        vals = rng.integers(0, 100, (128, V)).astype(np.int32)
        jkv.upsert(keys, vals)
        tkv.upsert(keys, vals)
    assert_twins_equal(jkv, tkv, "load")
    before = interop.state_to_numpy(tkv.state)
    counters = (tkv.migrations, tkv.rounds, tkv.io_stats())
    assert tkv.maybe_rebalance() is False
    assert tkv.rebalance(threshold=1e9) == 0
    assert tkv.migrate(tkv.bucket_map) == 0
    for n, a, b in zip(interop.leaf_names(), before,
                       interop.state_to_numpy(tkv.state)):
        assert np.array_equal(a, b), n
    assert (tkv.migrations, tkv.rounds, tkv.io_stats()) == counters
    src, dst = 1, 2
    nm = tkv.bucket_map.copy()
    nm[np.flatnonzero(nm == src)[:2]] = dst
    moved = (jkv.migrate(nm), tkv.migrate(nm))
    assert moved[0] == moved[1] > 0
    assert_twins_equal(jkv, tkv, "migrate")
    for n, a, b in zip(interop.leaf_names(), before,
                       interop.state_to_numpy(tkv.state)):
        for s in (0, 3):
            assert np.array_equal(a[s], b[s]), (n, s)
    ks = keys_on_shard(tkv, dst, 600)[:64]
    (js, jv), (ts, tv) = jkv.read(ks), tkv.read(ks)
    assert_same(js, ts)
    assert_same(jv, tv)
    tkv.check_invariants()


def test_occupancy_driven_rebalance_fires():
    """Concentrated traffic on one shard's buckets trips the automatic
    rebalancer inside `apply` at the same round in both packages; the map,
    the EWMA and the state stay equal and the imbalance falls."""
    rb = dict(enabled=True, buckets_per_shard=8, threshold=1.3, check_every=2,
              decay=0.8, min_traffic=32.0, migrate_batch=64)
    jkv, tkv = twins(rb, dict(hot_capacity=1 << 10, hot_mem=1 << 7),
                     trigger=2.0)
    rng = np.random.default_rng(5)
    hot = keys_on_shard(tkv, 0)[:64]
    pool = np.arange(4096, 4096 + 256, dtype=np.int32)
    for i in range(14):
        keys = np.concatenate([hot[rng.integers(0, len(hot), 48)],
                               pool[rng.integers(0, len(pool), 16)]]).astype(np.int32)
        vals = rng.integers(0, 100, (64, V)).astype(np.int32)
        (js, _), (ts, _) = jkv.upsert(keys, vals), tkv.upsert(keys, vals)
        assert_same(js, ts, i)
        assert_twins_equal(jkv, tkv, f"auto{i}")
    assert tkv.migrations >= 1
    stats, jstats = tkv.shard_stats(), jkv.shard_stats()
    assert stats.to_dict() == jstats.to_dict()
    assert stats.imbalance < 4.0 * 0.999
    assert tkv.stats()["shards"]["migrations"] == tkv.migrations


@pytest.mark.parametrize("seed", range(4))
def test_plan_moves_matches_reference(seed):
    """plan_moves (traffic-only and fill-aware), blend_fill_signal,
    shard_loads and imbalance_of equal the reference's; plans are
    deterministic and strictly reduce the imbalance."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        S = int(rng.choice([2, 4, 8]))
        nb = S * int(rng.choice([2, 4, 8]))
        traffic = rng.random(nb) * rng.choice([0, 1, 10], nb)
        m0 = tsr.default_bucket_map(S, nb)
        fill = rng.random(S) * 100
        for kw in (dict(threshold=1.2), dict(threshold=1.1, max_moves=2),
                   dict(threshold=1.2, min_traffic=5.0),
                   dict(threshold=1.2, fill=fill, fill_weight=0.5)):
            p1 = trb.plan_moves(traffic, m0, S, **kw)
            want = J.rebalance.plan_moves(traffic, m0, S, **kw)
            assert (p1 is None) == (want is None), kw
            if p1 is None:
                continue
            assert np.array_equal(p1, want), kw
            assert np.array_equal(p1, trb.plan_moves(traffic, m0, S, **kw))
            if "fill" not in kw:
                assert trb.imbalance_of(trb.shard_loads(traffic, p1, S)) < \
                    trb.imbalance_of(trb.shard_loads(traffic, m0, S))
        assert np.array_equal(trb.blend_fill_signal(traffic, m0, fill, 0.3),
                              J.rebalance.blend_fill_signal(traffic, m0, fill, 0.3))
        assert trb.imbalance_of(trb.shard_loads(traffic, m0, S)) == \
            J.rebalance.imbalance_of(J.rebalance.shard_loads(traffic, m0, S))
    nb = 32
    m0 = tsr.default_bucket_map(4, nb)
    assert trb.plan_moves(np.ones(nb), m0, 4) is None
    assert trb.plan_moves(np.zeros(nb), m0, 4) is None
