"""The port's durability (repro_torch.core.durability: the slab WAL,
snapshots, DurableKV, recover) against the JAX package's, on the sharded
store (tests/test_durability.py's tiny config: V 2, S 2, B 64, 400 keys,
32 lanes): the batch-boundary kill, the torn WAL tail, the fresh epoch
after recovery, WAL GC after snapshots, and the session service's cadence
snapshots, each driven into both packages with the same seeded batches;
the WAL segments byte for byte, the recovered state leaf for leaf, and
statuses and values bit for bit, after recovery too.  Cross-package: the
port's segments equal the reference's byte for byte through a migration's
MAP record, and the port recovers bit-exact from a WAL directory the
reference wrote."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import durability as jdur  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import durability as tdur  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from torch_durability_oracle import (B, S, V, assert_results,  # noqa: E402
                                     assert_stores_equal, assert_wal_dirs_equal,
                                     check_kill_restore_replay, gen_batches,
                                     port_store, probe_all, ref_store, settle,
                                     shifted_map)


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def test_kill_at_batch_boundary_sharded(tmp_path):
    check_kill_restore_replay(tmp_path, 11, 3, replicated=False)


def test_migrate_after_flip_fires_in_the_port():
    """The port's migrate reaches `migrate.after_flip` right after the map
    flip: the purge and the flip happened, the drained replay did not."""
    kv = port_store(replicated=False)
    for ks, ops, vs in gen_batches(5, 3):
        kv.apply(ks, ops, vs)
    new_map = shifted_map(kv)
    tfaults.arm("migrate.after_flip")
    with pytest.raises(tfaults.InjectedCrash):
        kv.migrate(new_map)
    assert kv.map_version == 1 and np.array_equal(kv.bucket_map, new_map)
    assert kv.migrations == 0


def _pair(tmp_path, replicated=False, **cfg):
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jd = jdur.DurableKV(ref_store(replicated), jdur.DurabilityConfig(dir=jdir, **cfg))
    td = tdur.DurableKV(port_store(replicated), tdur.DurabilityConfig(dir=tdir, **cfg))
    return jd, td, jdir, tdir


def _assert_records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rtype, x.epoch, x.seq, x.map_version) == (y.rtype, y.epoch, y.seq, y.map_version)
        for f in ("keys", "ops", "vals"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        assert (x.new_map is None) == (y.new_map is None)
        if x.new_map is not None:
            assert np.array_equal(x.new_map, y.new_map)


def test_torn_wal_tail_is_dropped(tmp_path):
    """tests/test_durability.py::test_torn_wal_tail_is_dropped: the same
    segment (byte-identical in both packages), cut inside the last record's
    header, inside its payload and at byte 20, and with a corrupted CRC,
    reads back the same valid prefix through either package's reader."""
    jd, td, jdir, tdir = _pair(tmp_path)
    for ks, ops, vs in gen_batches(7, 3):
        assert_results(jd.apply(ks, ops, vs), td.apply(ks, ops, vs), "apply")
    jd.close()
    td.close()
    assert_wal_dirs_equal(jdir, tdir)
    seg = os.path.join(tdir, sorted(f for f in os.listdir(tdir) if f.startswith("wal_"))[0])
    full = tdur.read_wal(tdir)
    _assert_records_equal(jdur.read_wal(jdir), full)
    assert len(full) >= 2
    raw = open(seg, "rb").read()
    for cut in (len(raw) - 1, len(raw) - 8, 20):
        open(seg, "wb").write(raw[:cut])
        got = tdur.read_wal(tdir)
        assert len(got) < len(full)
        _assert_records_equal(got, full[:len(got)])
        _assert_records_equal(jdur.read_wal(tdir), got)
    open(seg, "wb").write(raw[:-3] + bytes([raw[-3] ^ 0xFF]) + raw[-2:])
    got = tdur.read_wal(tdir)
    assert len(got) == len(full) - 1
    _assert_records_equal(jdur.read_wal(tdir), got)


def test_recovered_store_reuses_fresh_epoch(tmp_path):
    """Post-recovery writes land in a new segment (the epoch the reference
    picks) and survive a second recovery; both packages' recovered stores
    equal leaf for leaf after each recovery."""
    jd, td, jdir, tdir = _pair(tmp_path)
    ks = np.arange(1, B + 1, dtype=np.int32)
    assert_results(jd.upsert(ks, np.full((B, V), 7, np.int32)),
                   td.upsert(ks, np.full((B, V), 7, np.int32)), "upsert")
    before = tdur.wal_epochs(tdir)
    jrec = jdur.recover(jdir, lambda: ref_store(False))
    trec = tdur.recover(tdir, lambda: port_store(False))
    assert trec._wal.epoch not in before and trec._wal.epoch == jrec._wal.epoch
    assert_stores_equal(jrec.kv, trec.kv, "first recovery")
    for d in (jrec, trec):
        d.upsert(ks, np.full((B, V), 9, np.int32))
        d.close()
    assert_wal_dirs_equal(jdir, tdir)
    jrec2 = jdur.recover(jdir, lambda: ref_store(False))
    trec2 = tdur.recover(tdir, lambda: port_store(False))
    assert_stores_equal(jrec2.kv, trec2.kv, "second recovery")
    st, rv = trec2.read(ks)
    assert (st.numpy() == 1).all()
    assert np.array_equal(rv.numpy(), np.full((B, V), 9, np.int32))
    assert_results(jrec2.read(ks), (st, rv), "read-back")


def test_wal_gc_after_snapshot(tmp_path):
    """Segments older than the newest complete snapshot are removed (by
    the checkpointer's commit hook); the suffix recovers the whole store,
    equal to the reference's recovered store and to an uninterrupted twin
    on every key."""
    jd, td, jdir, tdir = _pair(tmp_path, blocking_snapshots=True)
    batches = gen_batches(13, 6)
    for i, (ks, ops, vs) in enumerate(batches):
        assert_results(jd.apply(ks, ops, vs), td.apply(ks, ops, vs), f"batch {i}")
        if i in (1, 3):
            jd.snapshot()
            td.snapshot()
    jd.snapshot()
    td.snapshot()
    assert min(tdur.wal_epochs(tdir)) >= td.ckpt.latest_step()
    assert tdur.wal_epochs(tdir) == jdur.wal_epochs(jdir)
    assert_wal_dirs_equal(jdir, tdir)
    twin = port_store(False)
    for ks, ops, vs in batches:
        twin.apply(ks, ops, vs)
    jrec = jdur.recover(jdir, lambda: ref_store(False))
    trec = tdur.recover(tdir, lambda: port_store(False))
    assert_stores_equal(jrec.kv, trec.kv, "recovered")
    probe_all([jrec, trec, twin], "read-back")


def test_wal_segments_byte_identical_through_a_migration(tmp_path):
    """The same history (mixed batches as numpy arrays and as CPU tensors,
    a snapshot's rotation, a migration's MAP record, a delete, a batch with
    no values given) writes byte-identical segments in both packages, which
    decode to equal records."""
    jd, td, jdir, tdir = _pair(tmp_path)
    batches = gen_batches(31, 6)
    for i, (ks, ops, vs) in enumerate(batches[:3]):
        targs = (ks, ops, vs) if i != 1 else tuple(torch.from_numpy(x) for x in (ks, ops, vs))
        assert_results(jd.apply(ks, ops, vs), td.apply(*targs), f"batch {i}")
    jd.snapshot(blocking=True)
    td.snapshot(blocking=True)
    new_map = shifted_map(jd.kv)
    assert jd.migrate(new_map) == td.migrate(new_map) > 0
    for i, (ks, ops, vs) in enumerate(batches[3:], 3):
        assert_results(jd.apply(ks, ops, vs), td.apply(ks, ops, vs), f"batch {i}")
    assert_results(jd.delete(batches[0][0][:8]), td.delete(batches[0][0][:8]), "delete")
    assert_results(jd.apply(batches[0][0], batches[0][1]),
                   td.apply(batches[0][0], batches[0][1]), "no values")
    jd.close()
    td.close()
    assert_wal_dirs_equal(jdir, tdir)
    recs = tdur.read_wal(tdir)
    assert [r.rtype for r in recs].count(tdur.REC_MAP) == 1
    _assert_records_equal(jdur.read_wal(jdir), recs)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_recover_from_the_other_packages_wal(tmp_path, writer):
    """A WAL directory with no snapshot, written by one package through a
    migration, recovers in the other bit-exact: the recovered store equals
    the writer's own recovery leaf for leaf, and the remaining batches give
    equal statuses and values."""
    import shutil
    jd, td, jdir, tdir = _pair(tmp_path)
    batches = gen_batches(37, 8)
    d = jd if writer == "reference" else td
    for i, (ks, ops, vs) in enumerate(batches[:5]):
        if i == 3:
            d.migrate(shifted_map(d.kv))
        d.apply(ks, ops, vs)
    src = jdir if writer == "reference" else tdir
    settle(d)
    other = str(tmp_path / "copy")
    shutil.copytree(src, other)
    jrec = jdur.recover(src if writer == "reference" else other, lambda: ref_store(False))
    trec = tdur.recover(other if writer == "reference" else src, lambda: port_store(False))
    assert trec.recovery["snapshot_epoch"] is None and trec.recovery["records"] > 0
    assert_stores_equal(jrec.kv, trec.kv, "recovered")
    for i, (ks, ops, vs) in enumerate(batches[5:], 5):
        assert_results(jrec.apply(ks, ops, vs), trec.apply(ks, ops, vs), f"batch {i}")
    probe_all([jrec, trec], "read-back")


def test_session_service_snapshots_and_recovers(tmp_path):
    """tests/test_durability.py::test_session_service_snapshots_and_recovers
    on both packages: the session layer over a DurableKV built by
    `make_session_service(..., ServiceConfig(durability=...))`; packed
    rounds hit the WAL, the cadence hook snapshots at packed-round
    boundaries (as often as the reference's), the segments are
    byte-identical, and both packages' recovered stores equal leaf for leaf
    and read back every served write."""
    from repro.core.types import ST_NOT_FOUND, ST_OK
    from repro.serve.sessions import KVSessionService as JSessionService
    from repro_torch.serve import serve_step
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jsvc = JSessionService(jdur.DurableKV(ref_store(False), jdur.DurabilityConfig(
        dir=jdir, snapshot_every_rounds=4)), max_sessions=2, session_depth=32)
    tsvc = serve_step.make_session_service(
        port_store(False).cfg, serve_step.ServiceConfig(
            n_shards=S, lanes=32, max_sessions=2, session_depth=32,
            durability=tdur.DurabilityConfig(dir=tdir, snapshot_every_rounds=4),
            store_kwargs=dict(device="cpu")))
    assert isinstance(tsvc.kv, tdur.DurableKV)
    rng = np.random.default_rng(23)
    ref = {}
    jsess, tsess = jsvc.open_session(), tsvc.open_session()
    for _ in range(6):
        ks = rng.integers(1, 200, 24).astype(np.int32)
        vs = rng.integers(0, 100, (24, V)).astype(np.int32)
        ops = np.full(24, 2, np.int32)
        jsess.enqueue(ks, ops, vs)
        tsess.enqueue(ks, ops, vs)
        jsess.drain()
        tsess.drain()
        for k, v in zip(ks, vs):
            ref[int(k)] = v.copy()
    assert tsvc.kv.snapshots == jsvc.kv.snapshots >= 1
    jsvc.kv.wait()
    tsvc.kv.wait()
    assert_wal_dirs_equal(jdir, tdir)
    jrec = jdur.recover(jdir, lambda: ref_store(False))
    trec = tdur.recover(tdir, lambda: port_store(False))
    assert_stores_equal(jrec.kv, trec.kv, "recovered")
    probe = np.arange(1, 200, dtype=np.int32)
    st, rv = trec.read(probe)
    st, rv = st.numpy(), rv.numpy()
    for i, k in enumerate(probe):
        if int(k) in ref:
            assert st[i] == ST_OK and np.array_equal(rv[i], ref[int(k)]), k
        else:
            assert st[i] == ST_NOT_FOUND, k
    trec.check_invariants()
