"""The port's replication (ReplicatedKV, assign_replicas) against the JAX
package's, bit for bit: the reference's ReplicatedKV(R=2, S=4) and the
port's driven with one op stream through mixed fan-in batches, a masked
pressure compaction, a forced migration, a dropped replica and a live
resync — statuses, values, every leaf of every replica, compaction counts,
I/O and the nested stats after every batch; fan-out reads (round robin and
least loaded, with deferral rounds) leave every leaf unchanged and equal
the reference's results and accounting.  Port-only contracts: R = 1 fan-in
is ShardedKV, healthy replicas stay byte-identical through a drop and
resync at R = 3, a dropped replica's leaves are frozen through fan-in,
masked compactions and a migration, and shards a migration does not touch
stay byte-identical on every replica.  A resync's replay, which runs every
shard's slabs side by side, equals the reference's batch-at-a-time replay
with the scheduler firing mid-replay."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

import repro.core as J  # noqa: E402
from repro.core import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT  # noqa: E402
from repro.core.replication import ReplicatedKV as JReplicatedKV  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import replication, shard_router as tsr  # noqa: E402
from repro_torch.core.types import ST_NOT_FOUND, ST_OK  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from torch_parity import as_np, assert_same, configs, leaves_np  # noqa: E402

V = 2
# tests/test_replication.py::tiny_cfg, as a field dict both packages take
TINY = dict(hot_index_size=1 << 8, hot_capacity=1 << 9, hot_mem=1 << 6,
            cold_capacity=1 << 11, cold_mem=1 << 6, n_chunks=1 << 6,
            chunklog_capacity=1 << 9, chunklog_mem=1 << 5,
            rc_capacity=1 << 6, value_width=V, chain_max=48)
COMMON = dict(mode="f2", compact_frac=0.3, compact_batch=64)


def tiny_configs(**kw):
    return configs(**dict(TINY, **kw))


def port_rkv(S=4, R=2, **kw):
    return T.ReplicatedKV(tiny_configs()[1], S, n_replicas=R, device="cpu",
                          **dict(COMMON, **kw))


def mixed(rng, n_keys=500, B=128):
    keys = rng.integers(0, n_keys, B).astype(np.int32)
    ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                     p=[.25, .45, .15, .15]).astype(np.int32)
    return keys, ops, rng.integers(0, 100, (B, V)).astype(np.int32)


def fold(ref, keys, ops, vals):
    for k, o, v in zip(keys, ops, vals):
        k = int(k)
        if o == OP_UPSERT:
            ref[k] = v.copy()
        elif o == OP_DELETE:
            ref.pop(k, None)
        elif o == OP_RMW:
            ref[k] = (ref.get(k, np.zeros(V, np.int32)) + v).astype(np.int32)


def check_reads(keys, ops, st, rv, ref, ctx):
    for i in np.flatnonzero(ops == OP_READ):
        k = int(keys[i])
        if k in ref:
            assert st[i] == ST_OK and np.array_equal(rv[i], ref[k]), (ctx, k)
        else:
            assert st[i] == ST_NOT_FOUND, (ctx, k)


def readback(kv, ref, n_keys, ctx, replica=None):
    keys = np.arange(n_keys, dtype=np.int32)
    st, rv = kv.read(keys, replica=replica)
    check_reads(keys, np.full(n_keys, OP_READ), as_np(st), as_np(rv), ref, ctx)


def port_leaves(tkv):
    """[R, S, ...] numpy copies of every leaf."""
    return interop.state_to_numpy(tkv.state, n_replicas=tkv.R)


def assert_twins_equal(jkv, tkv, ctx):
    for n, a, b in zip(interop.leaf_names(), leaves_np(jkv.state), port_leaves(tkv)):
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, n)
        assert np.array_equal(a, b), (ctx, n)
    assert np.array_equal(jkv.compactions, tkv.compactions), ctx
    assert jkv.rounds == tkv.rounds and jkv.io_stats() == tkv.io_stats(), ctx
    assert np.array_equal(jkv.alive, tkv.alive), ctx


def twin_apply(jkv, tkv, batch, ref, ctx):
    js, jv = jkv.apply(*batch)
    ts, tv = tkv.apply(*batch)
    assert_same(js, ts, f"{ctx}/status")
    assert_same(jv, tv, f"{ctx}/values")
    check_reads(batch[0], batch[1], as_np(ts), as_np(tv), ref, ctx)
    fold(ref, *batch)
    assert_twins_equal(jkv, tkv, ctx)


def twin_read(jkv, tkv, keys, ref, ctx, replica=None):
    """A fan-out read on both: results equal, every port leaf unchanged."""
    before = port_leaves(tkv)
    js, jv = jkv.read(keys, replica=replica)
    ts, tv = tkv.read(keys, replica=replica)
    assert_same(js, ts, f"{ctx}/status")
    assert_same(jv, tv, f"{ctx}/values")
    for n, a, b in zip(interop.leaf_names(), before, port_leaves(tkv)):
        assert np.array_equal(a, b), (ctx, "fan-out read wrote", n)
    check_reads(keys, np.full(len(keys), OP_READ), as_np(ts), as_np(tv), ref, ctx)
    assert_twins_equal(jkv, tkv, ctx)
    assert jkv.replica_stats() == tkv.replica_stats(), ctx


# ---------------------------------------------------------------------------
# the replication oracle against the reference
# ---------------------------------------------------------------------------

def test_replication_oracle_matches_reference():
    """tests/test_replication.py::test_replication_oracle_differential on
    both packages: mixed fan-in until the masked pressure compaction fires,
    fan-out reads, a forced migration, a dropped replica (frozen while the
    other serves), a live resync (the healthy replica untouched), pinned
    read-back of both replicas: bit-exact after every step."""
    jcfg, tcfg = tiny_configs()
    kw = dict(COMMON, trigger=0.5)
    jkv = JReplicatedKV(jcfg, 4, n_replicas=2, donate=False,
                        rebalance_cfg=J.RebalanceConfig(
                            enabled=False, buckets_per_shard=8, migrate_batch=64),
                        **kw)
    tkv = T.ReplicatedKV(tcfg, 4, n_replicas=2, device="cpu",
                         rebalance_cfg=T.RebalanceConfig(
                             enabled=False, buckets_per_shard=8, migrate_batch=64),
                         **kw)
    rng = np.random.default_rng(41)
    ref = {}
    for i in range(26):
        twin_apply(jkv, tkv, mixed(rng), ref, ("warm", i))
    assert tkv.compactions.sum() > 0
    assert np.array_equal(tkv.compactions[0], tkv.compactions[1])
    assert replication.replicas_byte_identical(tkv)
    twin_read(jkv, tkv, rng.integers(0, 520, 200).astype(np.int32), ref, "fan-out")

    # the reference's replicated state loads into the port and back
    port = interop.state_from_numpy(leaves_np(jkv.state), "cpu", n_shards=4,
                                    n_replicas=2)
    for n, a, b in zip(interop.leaf_names(), leaves_np(jkv.state),
                       interop.state_to_numpy(port, n_replicas=2)):
        assert np.array_equal(a, b), n
    view = replication.replicated_view(tkv.state, 2)
    assert view.hot.key.shape[:2] == (2, 4)
    assert view.hot.key[1, 2].data_ptr() == tkv.state.hot.key[6].data_ptr()

    nm = tkv.bucket_map.copy()
    src = int(np.argmax(T.core.rebalance.shard_loads(tkv.traffic_ewma, nm, 4)))
    nm[np.flatnonzero(nm == src)[:3]] = (src + 1) % 4
    moved = (jkv.migrate(nm.copy()), tkv.migrate(nm.copy()))
    assert moved[0] == moved[1] > 0
    assert_twins_equal(jkv, tkv, "migrate")
    for i in range(4):
        twin_apply(jkv, tkv, mixed(rng), ref, ("migrated", i))

    jkv.drop_replica(1)
    tkv.drop_replica(1)
    frozen = [a[1].copy() for a in port_leaves(tkv)]
    for i in range(6):
        twin_apply(jkv, tkv, mixed(rng), ref, ("dropped", i))
        for n, a, b in zip(interop.leaf_names(), frozen, port_leaves(tkv)):
            assert np.array_equal(a, b[1]), ("dropped replica changed", i, n)
    assert not replication.replicas_byte_identical(tkv, replicas=[0, 1])
    twin_read(jkv, tkv, np.arange(300, dtype=np.int32), ref, "one alive")

    healthy = [a[0].copy() for a in port_leaves(tkv)]
    moved = (jkv.resync(1), tkv.resync(1))
    assert moved[0] == moved[1] > 0 and tkv.resyncs == 1
    for n, a, b in zip(interop.leaf_names(), healthy, port_leaves(tkv)):
        assert np.array_equal(a, b[0]), ("resync touched the healthy replica", n)
    assert_twins_equal(jkv, tkv, "resync")
    tkv.check_invariants()
    for r in (1, 0):
        twin_read(jkv, tkv, np.arange(512, dtype=np.int32), ref, ("pinned", r),
                  replica=r)
    for i in range(4):
        twin_apply(jkv, tkv, mixed(rng), ref, ("post", i))
    twin_read(jkv, tkv, np.arange(512, dtype=np.int32), ref, "final")
    assert jkv.stats() == tkv.stats()
    assert jkv.memory_model_bytes() == tkv.memory_model_bytes()
    tkv.check_invariants()


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_fanout_reads_match_reference(policy):
    """tests/test_replication.py::test_fanout_reads_are_pure on both
    packages, with slabs of 16 lanes so reads take deferral rounds: every
    port leaf unchanged by each read, statuses, values, I/O, read loads and
    per-replica accounting equal to the reference's under either selector."""
    jcfg, tcfg = tiny_configs()
    kw = dict(COMMON, trigger=2.0, lanes=16)
    jkv = JReplicatedKV(jcfg, 4, n_replicas=2, read_selector=policy,
                        donate=False, **kw)
    tkv = T.ReplicatedKV(tcfg, 4, n_replicas=2, read_selector=policy,
                         device="cpu", **kw)
    rng = np.random.default_rng(9)
    ref = {}
    for i in range(3):
        keys = rng.integers(0, 300, 128).astype(np.int32)
        batch = (keys, np.full(128, OP_UPSERT, np.int32),
                 rng.integers(0, 100, (128, V)).astype(np.int32))
        twin_apply(jkv, tkv, batch, ref, ("load", i))
    io0 = tkv.io_stats()
    for i in range(5):
        n = (128, 77, 200, 33, 128)[i]
        twin_read(jkv, tkv, rng.integers(0, 320, n).astype(np.int32), ref,
                  (policy, i))
    io1 = tkv.io_stats()
    assert io1["mem_hits"] + io1["read_ops"] > io0["mem_hits"] + io0["read_ops"]
    assert np.array_equal(jkv.replica_load, tkv.replica_load)
    assert tkv.rounds > 8                # the reads deferred
    tkv.check_invariants()


def test_resync_replay_matches_reference():
    """A resync whose replay fires the pressure scheduler (hot->cold passes
    that leave the hot log over the trigger, so the next pass fires again,
    also in rounds where the reference gives the shard no slab) and, with
    slabs of 24, takes several rounds a replay batch of 128: the port
    replays every shard's slabs side by side, the reference a batch at a
    time; leaves, compaction counts, `rounds` and `last_occupancy` equal
    the reference's, in fewer rounds.  (The oracle above resyncs with one
    round a batch and no pass firing.)"""
    jcfg, tcfg = tiny_configs()
    # passes move a tenth of the hot log: one that fires leaves it over
    kw = dict(COMMON, trigger=0.3, lanes=24, compact_frac=0.1,
              compact_batch=16)
    rb = dict(enabled=False, buckets_per_shard=8, migrate_batch=128)
    jkv = JReplicatedKV(jcfg, 4, n_replicas=2, donate=False,
                        rebalance_cfg=J.RebalanceConfig(**rb), **kw)
    tkv = T.ReplicatedKV(tcfg, 4, n_replicas=2, device="cpu",
                         rebalance_cfg=T.RebalanceConfig(**rb), **kw)
    rng = np.random.default_rng(6)
    ref = {}
    for i in range(10):
        keys = rng.permutation(1200)[:128].astype(np.int32)
        batch = (keys, np.full(128, OP_UPSERT, np.int32),
                 rng.integers(0, 100, (128, V)).astype(np.int32))
        jkv.apply(*batch)
        tkv.apply(*batch)
        fold(ref, *batch)
    assert_twins_equal(jkv, tkv, "load")
    jkv.drop_replica(1)
    tkv.drop_replica(1)
    batch = mixed(rng, 1200)
    jkv.apply(*batch)
    tkv.apply(*batch)
    fold(ref, *batch)
    passes = []
    maybe_compact = tkv.maybe_compact

    def counted():
        before = tkv.compactions[1].copy()
        maybe_compact()
        passes.append(tkv.compactions[1] - before)
    tkv.maybe_compact = counted
    rounds = tkv.rounds
    moved = (jkv.resync(1), tkv.resync(1))
    del tkv.maybe_compact
    assert moved[0] == moved[1] > 0
    assert_twins_equal(jkv, tkv, "resync")
    assert_same(jkv.last_occupancy, tkv.last_occupancy, "last_occupancy")
    fired = np.array(passes) > 0
    assert fired.any(axis=0).all()       # every shard compacted mid-replay
    assert (fired[1:] & fired[:-1]).any()   # and fired again right after
    assert len(passes) < tkv.rounds - rounds
    readback(tkv, ref, 1200, "pinned", replica=1)
    tkv.check_invariants()


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_assign_replicas_matches_reference(policy):
    """The replica selector equals the reference's over seeded alive masks,
    batch sizes, counters and loads, under either policy."""
    rng = np.random.default_rng(2)
    for _ in range(60):
        R = int(rng.choice([1, 2, 3, 4, 8]))
        alive = np.zeros(R, bool)
        alive[rng.choice(R, rng.integers(1, R + 1), replace=False)] = True
        B = int(rng.integers(0, 200))
        counter = int(rng.integers(0, 1000))
        loads = rng.random(R) * 100
        want = J.shard_router.assign_replicas(B, alive, counter, policy, loads)
        got = tsr.assign_replicas(B, alive, counter, policy, loads)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.isin(got, np.flatnonzero(alive)).all()
    assert tsr.assign_replicas(4, np.ones(3, bool), 1, "round_robin").tolist() == [1, 2, 0, 1]
    with pytest.raises(ValueError):
        tsr.assign_replicas(4, np.zeros(2, bool), 0, policy)


@pytest.mark.parametrize("R,S,W", [(2, 4, 6), (3, 2, 64)])
def test_replica_route_matches_per_replica_routes(R, S, W):
    """`route(..., replica=, n_replicas=R)`'s row r*S + s equals shard s of
    the reference's route of replica r's lanes alone (the others NOOP):
    slabs, placement and deferral lane for lane, as the reference's
    fan-out read builds them."""
    rng = np.random.default_rng(R * S + W)
    B = 96
    keys = rng.integers(0, 300, B).astype(np.int32)
    ops = rng.choice([0, OP_READ, OP_READ, OP_READ], B).astype(np.int32)
    vals = rng.integers(0, 100, (B, V)).astype(np.int32)
    rep = rng.integers(0, R, B).astype(np.int32)
    bmap = rng.integers(0, S, 8 * S).astype(np.int32)
    sk, so, sv, rt = tsr.route(torch.as_tensor(keys), torch.as_tensor(ops),
                               torch.as_tensor(vals), S, W,
                               bucket_map=torch.as_tensor(bmap),
                               replica=torch.as_tensor(rep), n_replicas=R)
    placed = np.zeros(B, bool)
    for r in range(R):
        ops_r = np.where(rep == r, ops, 0).astype(np.int32)
        jk, jo, jv, jrt = J.shard_router.route(
            jax.numpy.asarray(keys), jax.numpy.asarray(ops_r),
            jax.numpy.asarray(vals), S, W, bucket_map=jax.numpy.asarray(bmap))
        rows = slice(r * S, (r + 1) * S)
        assert_same((jk, jo, jv), (sk[rows], so[rows], sv[rows]), f"slabs/{r}")
        mine = rep == r
        assert np.array_equal(np.asarray(jrt.placed)[mine], as_np(rt.placed)[mine])
        assert np.array_equal(np.asarray(jrt.deferred)[mine], as_np(rt.deferred)[mine])
        assert np.array_equal(np.asarray(jrt.occupancy), as_np(rt.occupancy)[rows])
        placed |= np.asarray(jrt.placed)
    assert np.array_equal(placed, as_np(rt.placed))
    assert bool(rt.deferred.any()) == (W == 6)     # the narrow slabs defer


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_r1_fan_in_matches_sharded():
    """ReplicatedKV(R=1)'s fan-in is the port's ShardedKV leaf for leaf:
    statuses, values, state, I/O and compaction counts."""
    rkv = port_rkv(R=1, trigger=0.3)
    skv = T.ShardedKV(rkv.cfg, 4, device="cpu", trigger=0.3, **COMMON)
    rng = np.random.default_rng(13)
    for i in range(20):
        batch = mixed(rng, 400, 96)
        for a, b in zip(rkv.apply(*batch), skv.apply(*batch)):
            assert_same(a, b, i)
    for n, a, b in zip(interop.leaf_names(), interop.state_to_numpy(rkv.state),
                       interop.state_to_numpy(skv.state)):
        assert np.array_equal(a, b), n
    assert rkv.io_stats() == skv.io_stats() and rkv.compactions.sum() > 0
    assert np.array_equal(rkv.compactions[0], skv.compactions)


def test_healthy_replicas_byte_identical_through_drop_resync():
    """R = 3: dropping and resyncing replica 2 keeps replicas 0 and 1
    byte-identical at every step; every replica then serves the oracle."""
    rkv = port_rkv(S=2, R=3, trigger=0.6)
    rng = np.random.default_rng(17)
    ref = {}
    for _ in range(6):
        batch = mixed(rng, 300, 96)
        rkv.apply(*batch)
        fold(ref, *batch)
    rkv.drop_replica(2)
    for _ in range(4):
        batch = mixed(rng, 300, 96)
        rkv.apply(*batch)
        fold(ref, *batch)
        assert replication.replicas_byte_identical(rkv, replicas=[0, 1])
    assert rkv.resync(2) > 0
    assert replication.replicas_byte_identical(rkv, replicas=[0, 1])
    for r in range(3):
        readback(rkv, ref, 312, ("post-resync", r), replica=r)
    for _ in range(3):
        batch = mixed(rng, 300, 96)
        rkv.apply(*batch)
        fold(ref, *batch)
        assert replication.replicas_byte_identical(rkv, replicas=[0, 1])
    readback(rkv, ref, 312, "final")
    rkv.check_invariants()


def test_dropped_replica_frozen():
    """Every leaf of a dropped replica (its scalars and arrays) stays
    byte-identical through fan-in rounds with deferral, scheduler passes
    (hot->cold and cold->cold), explicit masked compactions, a chunk-log GC
    and a migration, while the alive replica advances."""
    rkv = port_rkv(trigger=0.4, lanes=24,
                   rebalance_cfg=T.RebalanceConfig(enabled=False, migrate_batch=64))
    rng = np.random.default_rng(19)
    for _ in range(4):
        rkv.apply(*mixed(rng, 600, 96))
    rkv.drop_replica(0)
    frozen = [a[0].copy() for a in port_leaves(rkv)]
    counts = rkv.compactions[0].copy()

    def same(ctx):
        for n, a, b in zip(interop.leaf_names(), frozen, port_leaves(rkv)):
            assert np.array_equal(a, b[0]), (ctx, n)
        assert np.array_equal(rkv.compactions[0], counts), ctx
    c0 = rkv.compactions[1].sum()
    for i in range(14):
        rkv.apply(*mixed(rng, 900, 96))
        same(i)
    assert rkv.compactions[1].sum() > c0
    rkv.compact_hot_cold()
    rkv.compact_cold_cold()
    rkv.compact_chunklog()
    same("explicit compactions")
    nm = rkv.bucket_map.copy()
    nm[np.flatnonzero(nm == 2)[:2]] = 0
    assert rkv.migrate(nm) > 0
    same("migrate")
    rkv.read(np.arange(300, dtype=np.int32))
    same("fan-out read")
    assert as_np(replication.replicated_view(rkv.state, 2).cold.tail)[1].sum() > 0
    rkv.check_invariants()


def test_untouched_shards_byte_identical_through_replicated_migration():
    """Shards that are neither source nor destination of a moving bucket
    pass through `migrate` byte-identical on every replica."""
    rkv = port_rkv(trigger=2.0,
                   rebalance_cfg=T.RebalanceConfig(enabled=False, migrate_batch=64))
    rng = np.random.default_rng(23)
    for _ in range(5):
        keys = rng.integers(0, 600, 128).astype(np.int32)
        rkv.upsert(keys, rng.integers(0, 100, (128, V)).astype(np.int32))
    src, dst = 1, 2
    before = port_leaves(rkv)
    nm = rkv.bucket_map.copy()
    nm[np.flatnonzero(nm == src)[:2]] = dst
    assert rkv.migrate(nm) > 0
    for n, a, b in zip(interop.leaf_names(), before, port_leaves(rkv)):
        for r in range(2):
            for s in (0, 3):
                assert np.array_equal(a[r, s], b[r, s]), (n, r, s)
    assert replication.replicas_byte_identical(rkv)
    rkv.check_invariants()


def test_replicated_refusals_and_resync_crash_point():
    """What is not ported or not allowed raises; an armed crash point stops
    a resync mid-replay (the durability tests of item 11 use it)."""
    cfg = tiny_configs()[1]
    with pytest.raises(ValueError):
        T.ReplicatedKV(cfg, 4, n_replicas=0, device="cpu")
    with pytest.raises(ValueError):
        T.ReplicatedKV(cfg, 4, read_selector="nearest", device="cpu")
    rkv = port_rkv(trigger=2.0)
    rkv.upsert(np.arange(200, dtype=np.int32), np.ones((200, V), np.int32))
    with pytest.raises(ValueError, match="alive"):
        rkv.resync(1)
    rkv.drop_replica(1)
    with pytest.raises(ValueError, match="last alive"):
        rkv.drop_replica(0)
    with pytest.raises(ValueError, match="not alive"):
        rkv.read(np.arange(4, dtype=np.int32), replica=1)
    faults.arm("resync.mid_replay")
    try:
        with pytest.raises(faults.InjectedCrash):
            rkv.resync(1)
    finally:
        faults.reset()
    assert not rkv._migrating and rkv._sched_rows is None
