"""Shared oracle of the durability tests that hold the PyTorch port
(repro_torch.core.durability) against the JAX package's: one history of
batches and lifecycle events driven into a reference DurableKV, a port
DurableKV and an uninterrupted port twin, a kill, `recover()` in both
packages, then the rest of the history.  Compared bit for bit: statuses and
values of every batch (port against reference and against the twin), the
WAL directories byte for byte, and the recovered stores' state leaves,
bucket maps, map versions, alive masks and round counts.

The reference stores come from `ref_store`, which reuses one constructed
store's jitted steps for every store of the same shape in a process, so a
test pays the reference's compiles once (they take seconds a store; the
steps then run in milliseconds)."""
import copy
import dataclasses
import os

import numpy as np

import repro.core as J
from repro.core import durability as jdur
from repro.core.replication import ReplicatedKV as JReplicatedKV
from repro.core.sharded import ShardedKV as JShardedKV
from repro.testing import faults as jfaults
import repro_torch as T
from repro_torch import interop
from repro_torch.core import durability as tdur
from repro_torch.core.replication import replicas_byte_identical
from repro_torch.testing import faults as tfaults
from test_durability import B, N_KEYS, S, V, gen_batches, shifted_map, tiny_cfg  # noqa: F401
from torch_parity import assert_same, leaves_np

WRITES = [J.OP_UPSERT, J.OP_RMW, J.OP_DELETE]
LANES = 32

_TEMPLATES = {}


def _rb(rebalance, mod):
    return mod.RebalanceConfig(threshold=1.3, check_every=4) if rebalance else None


def ref_store(replicated=True, rebalance=False, lanes=LANES, **store_kw):
    """tests/test_durability.py::make_store (with `store_kw`, e.g. a lower
    `trigger`), as a fresh store that shares the jitted steps of the first
    one built with these arguments: its host attributes are copies of that
    store's just after construction; its device state (immutable, never
    donated) and its jitted functions are shared."""
    key = (replicated, rebalance, lanes, tuple(sorted(store_kw.items())))
    if key not in _TEMPLATES:
        rb = _rb(rebalance, J)
        kv = (JReplicatedKV(tiny_cfg(), S, n_replicas=2, lanes=lanes,
                            rebalance_cfg=rb, donate=False, **store_kw) if replicated
              else JShardedKV(tiny_cfg(), S, lanes=lanes, rebalance_cfg=rb,
                              donate=False, **store_kw))
        _TEMPLATES[key] = (type(kv), dict(vars(kv)))
    cls, fields = _TEMPLATES[key]
    kv = object.__new__(cls)
    for k, v in fields.items():
        mutable = isinstance(v, (np.ndarray, list, dict, set))
        kv.__dict__[k] = copy.deepcopy(v) if mutable else v
    return kv


def port_cfg():
    """The reference's tiny config as the port's."""
    return interop.config_from_dict(dataclasses.asdict(tiny_cfg()))


def port_store(replicated=True, rebalance=False, lanes=LANES, **store_kw):
    """The same store in the port, on the CPU."""
    cfg = port_cfg()
    rb = _rb(rebalance, T)
    if replicated:
        return T.ReplicatedKV(cfg, S, n_replicas=2, lanes=lanes,
                              rebalance_cfg=rb, device="cpu", **store_kw)
    return T.ShardedKV(cfg, S, lanes=lanes, rebalance_cfg=rb, device="cpu",
                       **store_kw)


def assert_results(a, b, ctx):
    assert_same(a[0], b[0], f"{ctx}/status")
    assert_same(a[1], b[1], f"{ctx}/values")


def assert_stores_equal(jkv, tkv, ctx):
    """Every state leaf (every replica's), the bucket map, its version, the
    alive mask and the round count."""
    R = getattr(tkv, "R", None)
    names = interop.leaf_names()
    for n, a, b in zip(names, leaves_np(jkv.state),
                       interop.state_to_numpy(tkv.state, n_replicas=R)):
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, n)
        assert np.array_equal(a, b), (ctx, n, np.flatnonzero(a.ravel() != b.ravel())[:8])
    assert np.array_equal(jkv.bucket_map, tkv.bucket_map), ctx
    assert jkv.map_version == tkv.map_version, ctx
    assert jkv.rounds == tkv.rounds, (ctx, jkv.rounds, tkv.rounds)
    if R is not None:
        assert np.array_equal(jkv.alive, tkv.alive), ctx


def assert_wal_dirs_equal(jdir, tdir, ctx=""):
    """The same WAL segments, byte for byte."""
    jw = sorted(f for f in os.listdir(jdir) if f.startswith("wal_"))
    tw = sorted(f for f in os.listdir(tdir) if f.startswith("wal_"))
    assert jw == tw, (ctx, jw, tw)
    for f in jw:
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), (ctx, f)


def probe_all(stores, ctx):
    """Every key read back on each store: results equal to the first's."""
    probe = np.arange(1, N_KEYS + 1, dtype=np.int32)
    outs = [s.read(probe) for s in stores]
    for i, o in enumerate(outs[1:], 1):
        assert_results(outs[0], o, f"{ctx}/probe{i}")


def settle(d):
    """Let a snapshot still being written by an abandoned DurableKV finish
    (or fail), so that both packages recover from the same snapshot."""
    if d.ckpt._thread is not None:
        d.ckpt._thread.join()


def _crash(point, fn, mod):
    """Run fn with `point` armed in faults module `mod`; it must fire."""
    mod.arm(point)
    try:
        fn()
    except mod.InjectedCrash:
        return
    finally:
        mod.reset()
    raise AssertionError(f"{point} did not fire")


def check_kill_restore_replay(tmp, seed, crash_after, *, migrate_at=None,
                              crash_point=None, drop_at=None, resync_at=None,
                              replicated=True, rebalance=False,
                              snapshot_every=5, n_batches=8, distinct=False,
                              store_kw=None):
    """tests/test_durability.py::check_kill_restore_replay on both packages
    at once (the reference's twin is left out: the port's results are held
    to the reference's batch by batch, and the port's twin is held to
    them).  Returns the port's recovered DurableKV."""
    jdir, tdir = str(tmp / "ref"), str(tmp / "port")
    store_kw = store_kw or {}
    jmk = lambda: ref_store(replicated, rebalance, **store_kw)  # noqa: E731
    tmk = lambda: port_store(replicated, rebalance, **store_kw)  # noqa: E731
    jd = jdur.DurableKV(jmk(), jdur.DurabilityConfig(
        dir=jdir, snapshot_every_rounds=snapshot_every))
    td = tdur.DurableKV(tmk(), tdur.DurabilityConfig(
        dir=tdir, snapshot_every_rounds=snapshot_every))
    twin = tmk()
    batches = gen_batches(seed, n_batches, distinct=distinct)
    crashed = False

    def event(kv, i):
        if migrate_at == i:
            kv.migrate(shifted_map(kv))
        if drop_at == i and hasattr(kv, "drop_replica"):
            kv.drop_replica(1)
        if resync_at == i and hasattr(kv, "resync"):
            kv.resync(1)

    for i, (ks, ops, vs) in enumerate(batches):
        if i == crash_after:
            if crash_point is None:
                crashed = True          # kill -9 at the batch boundary
                break
            if crash_point == "wal.mid_append" and not np.isin(ops, WRITES).any():
                crashed = True          # nothing to append: a boundary kill
                break
            for d, mod in ((jd, jfaults), (td, tfaults)):
                def run(d=d):
                    event(d.kv, i)
                    d.apply(ks, ops, vs)
                _crash(crash_point, run, mod)
            crashed = True
            event(twin, i)
            break
        event(jd.kv, i)
        event(td.kv, i)
        event(twin, i)
        jr, tr, wr = jd.apply(ks, ops, vs), td.apply(ks, ops, vs), twin.apply(ks, ops, vs)
        assert_results(jr, tr, f"batch {i}")
        assert_results(tr, wr, f"batch {i}/twin")
    assert crashed or crash_after >= n_batches
    settle(jd)
    settle(td)
    assert_wal_dirs_equal(jdir, tdir, "at the kill")
    assert sorted(jd.ckpt.available_steps()) == sorted(td.ckpt.available_steps())

    # the dead process: both wrappers are abandoned; recovery reads disk only
    jrec = jdur.recover(jdir, jmk)
    trec = tdur.recover(tdir, tmk)
    assert_stores_equal(jrec.kv, trec.kv, "recovered")
    trec.check_invariants()
    if replicated:
        assert replicas_byte_identical(trec.kv)
    assert trec.recovery["snapshot_epoch"] == jd.ckpt.latest_step()

    start = crash_after + (1 if crash_point == "wal.mid_append" else 0)
    for i, (ks, ops, vs) in enumerate(batches[start:], start):
        jr, tr, wr = jrec.apply(ks, ops, vs), trec.apply(ks, ops, vs), twin.apply(ks, ops, vs)
        assert_results(jr, tr, f"after recovery, batch {i}")
        assert_results(tr, wr, f"after recovery, batch {i}/twin")
    probe_all([jrec, trec, twin], "after recovery")
    assert_stores_equal(jrec.kv, trec.kv, "after recovery")
    trec.check_invariants()
    assert_wal_dirs_equal(jdir, tdir, "after recovery")
    jrec.close()
    trec.close()
    return trec


def history(tmp_path, seed, n, drop_after, migrate_after=None, store_kw=None,
            snapshot_after=None, **cfg):
    """Both packages' DurableKV and a port twin through one history: n
    batches, replica 1 dropped after `drop_after` of them, a migration after
    `migrate_after`, a snapshot after `snapshot_after`."""
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    store_kw = store_kw or {}
    jd = jdur.DurableKV(ref_store(**store_kw), jdur.DurabilityConfig(dir=jdir, **cfg))
    td = tdur.DurableKV(port_store(**store_kw), tdur.DurabilityConfig(dir=tdir, **cfg))
    twin = port_store(**store_kw)
    for i, (ks, ops, vs) in enumerate(gen_batches(seed, n)):
        if i == snapshot_after:
            jd.snapshot(blocking=True)
            td.snapshot(blocking=True)
        if i == drop_after:
            for kv in (jd.kv, td.kv, twin):
                kv.drop_replica(1)
        if i == migrate_after:
            for kv in (jd, td, twin):
                new_map = shifted_map(kv)
                kv.migrate(new_map)
        tr = td.apply(ks, ops, vs)
        assert_results(jd.apply(ks, ops, vs), tr, f"batch {i}")
        assert_results(tr, twin.apply(ks, ops, vs), f"batch {i}/twin")
    assert_wal_dirs_equal(jdir, tdir)
    return jd, td, twin
