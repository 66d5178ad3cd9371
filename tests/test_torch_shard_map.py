"""The port's partitioned store dispatch (`dispatch="shard_map"`): the
shard axis (ShardedKV) or the (replica, shard) rows (ReplicatedKV) split
over a device list, one store step per partition.  A CPU device named P
times stands in for P devices (the reference's forced host device count).
Statuses, values and every state leaf equal the port's vmap dispatch and
the JAX package's shard_map dispatch (a one-device mesh on the CPU), batch
by batch, through compactions, a migration and a drop -> resync; a durable
partitioned store recovers from a vmap store's log; the host tier and the
session service run partitioned."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT  # noqa: E402
from repro.core.replication import ReplicatedKV as JReplicatedKV  # noqa: E402
from repro.core.sharded import ShardedKV as JShardedKV  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import sharded as tsharded  # noqa: E402
from repro_torch.core.replication import (replicas_byte_identical,  # noqa: E402
                                          resolve_mesh_2d)
from repro_torch.core.types import tree_map  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from torch_parity import (as_np, assert_same, assert_states_equal,  # noqa: E402
                          configs, leaves_np)

V = 2
# tests/test_sharded.py::tiny_cfg(hot_capacity=1 << 10, hot_mem=1 << 7)
TINY = dict(hot_index_size=1 << 8, hot_capacity=1 << 10, hot_mem=1 << 7,
            cold_capacity=1 << 12, cold_mem=1 << 6, n_chunks=1 << 6,
            chunklog_capacity=1 << 9, chunklog_mem=1 << 5,
            rc_capacity=1 << 6, value_width=V, chain_max=48)
N_BATCHES = 10


def _leaves(state):
    out = []
    tree_map(lambda x: out.append(x.clone()), state)
    return out


def _batches(seed=3, n=N_BATCHES, n_keys=300, B=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.integers(0, n_keys, B).astype(np.int32)
        ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.3, .45, .15, .1]).astype(np.int32)
        out.append((keys, ops, rng.integers(0, 50, (B, V)).astype(np.int32)))
    return out


def _moved(bucket_map, S):
    m = np.array(bucket_map, copy=True)
    m[0], m[1] = (m[0] + 1) % S, (m[1] + 2) % S
    return m


def _script(kv, replicated: bool):
    """Mixed batches with a migration after batch 3, a dropped replica
    taking writes after batch 5 and its resync after batch 7, then a
    read-back and forced passes of each compaction; yields after every
    step (the caller compares)."""
    for i, (keys, ops, vals) in enumerate(_batches()):
        st, rv = kv.apply(keys, ops, vals)
        yield f"batch {i}", (st, rv)
        if i == 3:
            kv.migrate(_moved(kv.bucket_map, kv.S))
            yield "migrate", None
        if replicated and i == 5:
            kv.drop_replica(1)
        if replicated and i == 7:
            kv.resync(1)
            yield "resync", None
    yield "read", kv.read(np.arange(128, dtype=np.int32))
    kv.compact_hot_cold()
    kv.compact_cold_cold()
    yield "compactions", None


def _run(kv, replicated, ref=None):
    """Drive `_script`; with `ref` (a reference store driven in step),
    every result and leaf equals the reference's."""
    outs = []
    steps = _script(kv, replicated)
    rsteps = _script(ref, replicated) if ref is not None else None
    for ctx, res in steps:
        res = None if res is None else tuple(as_np(x) for x in res)
        outs.append(res)
        if rsteps is not None:
            rctx, rres = next(rsteps)
            assert rctx == ctx
            if res is not None:
                assert_same(rres[0], res[0], f"{ctx}/status")
                assert_same(rres[1], res[1], f"{ctx}/values")
            _assert_ref_state(ref, kv, ctx)
    kv.check_invariants()
    return outs, _leaves(kv.state)


def _assert_ref_state(ref, kv, ctx):
    """Every leaf of the port's state equals the reference's ([R, S, ...]
    leaves under replication)."""
    R = getattr(kv, "R", None)
    if R is None:
        assert_states_equal(ref.state, kv.state, ctx)
        return
    for n, a, b in zip(interop.leaf_names(), leaves_np(ref.state),
                       interop.state_to_numpy(kv.state, n_replicas=R)):
        assert a.shape == b.shape and np.array_equal(a, b), (ctx, n)


def _assert_runs_equal(a, b, ctx):
    for x, y in zip(a[0], b[0]):
        assert (x is None) == (y is None), ctx
        if x is not None:
            assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]), ctx
    assert len(a[1]) == len(b[1])
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        assert torch.equal(x, y), (ctx, i)


_VMAP = {}


def _vmap_run(replicated, R, S):
    key = (replicated, R, S)
    if key not in _VMAP:
        _VMAP[key] = _run(_store(replicated, R, S, "vmap"), replicated)
    return _VMAP[key]


def _store(replicated, R, S, dispatch, devices=None, **kw):
    tcfg = configs(**TINY)[1]
    common = dict(trigger=0.7, compact_batch=64, dispatch=dispatch,
                  device="cpu", devices=devices, **kw)
    if replicated:
        return T.ReplicatedKV(tcfg, S, n_replicas=R, **common)
    return T.ShardedKV(tcfg, S, **common)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_shard_map_dispatch_matches_vmap(P):
    """ShardedKV(S=4) over P listed devices: the P partitions' program is
    bit-exact with the vmap dispatch and, at P = 1, with the reference's
    shard_map dispatch (its one-device mesh) step by step."""
    kv = _store(False, 1, 4, "shard_map", ["cpu"] * P)
    assert kv.dispatch == "shard_map" and kv.mesh.shape == (P,)
    ref = None
    if P == 1:
        ref = JShardedKV(configs(**TINY)[0], 4, trigger=0.7, compact_batch=64,
                         donate=False, dispatch="shard_map")
        assert ref.dispatch == "shard_map"
    got = _run(kv, False, ref)
    _assert_runs_equal(_vmap_run(False, 1, 4), got, f"P={P}")
    assert len(kv._st) == P if P > 1 else kv._pp is None


def test_multi_device_shard_map():
    """tests/test_sharded.py's multi-device case: with two devices listed,
    dispatch='auto' resolves to a two-device mesh over the shard axis and
    serves reads; each partition's rows live in a state of their own."""
    cfg = T.F2Config(hot_index_size=1 << 8, hot_capacity=1 << 10,
                     hot_mem=1 << 7, cold_capacity=1 << 12, cold_mem=1 << 6,
                     n_chunks=1 << 6, chunklog_capacity=1 << 9,
                     chunklog_mem=1 << 5, rc_capacity=1 << 6, value_width=2,
                     chain_max=48)
    kv = T.ShardedKV(cfg, 4, dispatch="auto", devices=["cpu", "cpu"])
    assert kv.dispatch == "shard_map", kv.dispatch
    assert kv.mesh.shape == (2,) and kv.device == torch.device("cpu")
    keys = np.arange(256, dtype=np.int32)
    vals = np.stack([keys, keys + 1], 1).astype(np.int32)
    kv.upsert(keys, vals)
    st, rv = kv.read(keys)
    assert np.all(as_np(st) == 1)
    assert np.array_equal(as_np(rv), vals)
    kv.check_invariants()
    assert [p.hot.tail.shape[0] for p in kv._st] == [2, 2]
    tails = as_np(kv.state.hot.tail)
    assert np.array_equal(tails, np.concatenate([as_np(p.hot.tail) for p in kv._st]))
    # one device: auto stays on vmap; an unknown dispatch is refused
    assert T.ShardedKV(cfg, 4, dispatch="auto", device="cpu").dispatch == "vmap"
    with pytest.raises(ValueError, match="dispatch"):
        T.ShardedKV(cfg, 4, dispatch="pmap", device="cpu")


@pytest.mark.parametrize("R,S,n_dev,shape", [(2, 4, 1, (1, 1)), (2, 4, 2, (1, 2)),
                                             (2, 2, 4, (2, 2))])
def test_replicated_shard_map_dispatch_matches_vmap(R, S, n_dev, shape):
    """ReplicatedKV over a (replica, shard) device mesh chosen by the
    reference's rule: (1, 1), (1, 2) (each device holding both replicas'
    rows of its shards: rows not consecutive) and (2, 2); bit-exact with
    the vmap dispatch through fan-in, a migration, a drop and resync and a
    fan-out read, and at (1, 1) with the reference's shard_map dispatch."""
    kv = _store(True, R, S, "shard_map", ["cpu"] * n_dev)
    assert kv.dispatch == "shard_map" and kv.mesh.shape == shape
    ref = None
    if shape == (1, 1):
        ref = JReplicatedKV(configs(**TINY)[0], S, n_replicas=R, trigger=0.7,
                            compact_batch=64, donate=False, dispatch="shard_map")
        assert ref.dispatch == "shard_map"
    got = _run(kv, True, ref)
    _assert_runs_equal(_vmap_run(True, R, S), got, f"{shape}")
    assert replicas_byte_identical(kv, [0])


def test_resolve_mesh_rules():
    """The reference's device-count rules (`resolve_mesh`,
    `resolve_mesh_2d`) over device lists."""
    cpu = ["cpu"] * 8
    assert tsharded.resolve_mesh("vmap", 4, cpu) is None
    assert tsharded.resolve_mesh("auto", 4, cpu[:1]) is None
    assert tsharded.resolve_mesh("shard_map", 4, cpu[:1]).shape == (1,)
    assert tsharded.resolve_mesh("auto", 4, cpu[:3]).shape == (2,)
    assert tsharded.resolve_mesh("auto", 8, cpu[:6]).shape == (4,)
    assert resolve_mesh_2d("shard_map", 2, 4, cpu[:4]).shape == (1, 4)
    assert resolve_mesh_2d("shard_map", 2, 4, cpu).shape == (2, 4)
    assert resolve_mesh_2d("shard_map", 3, 4, cpu[:6]).shape == (3, 2)
    assert resolve_mesh_2d("auto", 2, 4, cpu[:1]) is None


def test_durable_shard_map_recovers_from_vmap_wal(tmp_path):
    """A durable vmap store logs batches, a snapshot and a migration, and
    is abandoned (a kill); `recover` into a shard_map store over two
    devices restores the snapshot into its partitions and replays the log
    to the state a vmap recovery reaches, and both go on with an
    uninterrupted vmap twin's results."""
    batches = _batches(seed=5, n=8)
    d = tmp_path / "wal"
    dkv = T.DurableKV(_store(False, 1, 4, "vmap"), T.DurabilityConfig(dir=str(d)))
    twin = _store(False, 1, 4, "vmap")
    for i, (k, o, v) in enumerate(batches[:6]):
        dkv.apply(k, o, v)
        twin.apply(k, o, v)
        if i == 2:
            dkv.snapshot(blocking=True)
        if i == 3:
            m = _moved(twin.bucket_map, 4)
            dkv.migrate(m)
            twin.migrate(m)
    dkv.ckpt.wait()
    dkv.kv.wal = None
    shutil.copytree(d, tmp_path / "copy")
    rv = T.recover(str(tmp_path / "copy"), lambda: _store(False, 1, 4, "vmap"))
    rs = T.recover(str(d), lambda: _store(False, 1, 4, "shard_map", ["cpu"] * 2))
    assert rs.kv.dispatch == "shard_map" and rs.kv.mesh.shape == (2,)
    assert rs.recovery["snapshot_epoch"] == rv.recovery["snapshot_epoch"] == 1
    assert rs.recovery["records"] == rv.recovery["records"] > 0
    for a, b in zip(_leaves(rv.kv.state), _leaves(rs.kv.state)):
        assert torch.equal(a, b)
    for k, o, v in batches[6:]:
        a, b, c = twin.apply(k, o, v), rv.apply(k, o, v), rs.apply(k, o, v)
        for x, y in ((a, b), (a, c)):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    for a, b in zip(_leaves(rv.kv.state), _leaves(rs.kv.state)):
        assert torch.equal(a, b)


def test_host_tier_shard_map_matches_vmap():
    """The host tier over two partitions: ShardedKV(S=2) spills past its
    cold ring, the shards' demotions, promotions and masked compactions
    run with the manager over the gathered rows and every store step per
    partition; statuses, values, every leaf and the manager's stats and
    host store equal the vmap dispatch's."""
    from test_host_tier import host_cfg
    from torch_host_oracle import drive, port_cfg, readback
    tcfg = port_cfg(host_cfg(engine="fused_ref", hot_capacity=1 << 11,
                             hot_mem=1 << 8), "fused_ref")
    a = T.ShardedKV(tcfg, 2, compact_batch=128, device="cpu")
    b = T.ShardedKV(tcfg, 2, compact_batch=128, device="cpu",
                    dispatch="shard_map", devices=["cpu", "cpu"])
    assert b.mesh.shape == (2,)
    ref = drive([a, b], seed=11, n_steps=160, ctx="partitioned host tier")
    assert (as_np(b.state.cold.floor) > 0).any()        # a shard spilled
    a.compact_cold_cold(shards=np.array([True, False]))
    b.compact_cold_cold(shards=np.array([True, False]))
    readback([a, b], ref, slice_=256, ctx="partitioned host tier")
    for x, y in zip(_leaves(a.state), _leaves(b.state)):
        assert torch.equal(x, y)
    assert a._ht.stats() == b._ht.stats()
    assert a._ht.promotions > 0 and a._ht.demotions > 0


def test_session_service_shard_map():
    """The session service over a partitioned replicated store (the
    ServiceConfig's dispatch and device list): the sessions' results equal
    a vmap service's on the same requests."""
    tcfg = configs(**TINY)[1]
    outs = []
    for disp, devs in (("vmap", None), ("shard_map", ["cpu"] * 2)):
        svc = serve_step.make_session_service(tcfg, serve_step.ServiceConfig(
            n_shards=2, n_replicas=2, lanes=32, max_sessions=2, session_depth=32,
            dispatch=disp, store_kwargs=dict(device="cpu", devices=devs,
                                             compact_batch=64)))
        assert svc.kv.dispatch == disp
        s = svc.open_session()
        res = []
        for keys, ops, vals in _batches(seed=9, n=8, B=16):
            assert (s.enqueue(keys, ops, vals) >= 0).all()
            res += [as_np(x) for x in s.drain()]
        outs.append((res, _leaves(svc.kv.state)))
    (ra, la), (rb, lb) = outs
    for x, y in zip(ra, rb):
        assert np.array_equal(x, y)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
