"""The port's kill-restore-replay oracles against the JAX package's on the
replicated store (tests/test_durability.py's seeded instances, R 2, S 2):
kills at batch boundaries (after a snapshot, with no snapshot yet, after a
migration), between a migration's map flip and its replay
(`migrate.after_flip`), mid-resync, mid-WAL-append (a torn tail),
mid-snapshot (no manifest), and with the rebalancer armed.  Each drives one
history into a reference DurableKV, a port DurableKV and a port twin and
recovers both packages: the WAL segments byte for byte, the recovered
stores leaf for leaf (every replica), and every later status and value bit
for bit (tests/torch_durability_oracle.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import durability as jdur  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core import durability as tdur  # noqa: E402
from repro_torch.core.replication import replicas_byte_identical  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from torch_durability_oracle import (assert_results, assert_stores_equal,  # noqa: E402
                                     assert_wal_dirs_equal,
                                     check_kill_restore_replay, gen_batches,
                                     port_store, ref_store, settle)


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


# tests/test_durability.py's seeded instances: (seed, crash_after, options)
KILLS = {
    "batch_boundary_replicated": (22, 5, {}),
    "right_after_snapshot": (33, 4, dict(snapshot_every=4)),
    "no_snapshot_yet": (44, 2, dict(snapshot_every=100)),
    "after_migration": (55, 5, dict(migrate_at=3)),
    "mid_migration": (66, 4, dict(migrate_at=4, crash_point="migrate.after_flip")),
    "mid_resync": (77, 5, dict(drop_at=2, resync_at=5,
                               crash_point="resync.mid_replay")),
    "mid_wal_append": (88, 4, dict(crash_point="wal.mid_append")),
    "with_rebalancer_armed": (111, 5, dict(rebalance=True, snapshot_every=4,
                                           n_batches=10, distinct=True)),
}


@pytest.mark.parametrize("case", list(KILLS))
def test_kill_restore_replay(tmp_path, case):
    seed, crash_after, kw = KILLS[case]
    check_kill_restore_replay(tmp_path, seed, crash_after, **kw)


def test_kill_mid_snapshot(tmp_path):
    """The snapshot dies before its manifest in both packages: recovery
    falls back to the previous complete snapshot and a longer WAL suffix."""
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jd = jdur.DurableKV(ref_store(), jdur.DurabilityConfig(dir=jdir))
    td = tdur.DurableKV(port_store(), tdur.DurabilityConfig(dir=tdir))
    twin = port_store()
    batches = gen_batches(99, 6)
    for i, (ks, ops, vs) in enumerate(batches[:4]):
        tr = td.apply(ks, ops, vs)
        assert_results(jd.apply(ks, ops, vs), tr, f"batch {i}")
        assert_results(tr, twin.apply(ks, ops, vs), f"batch {i}/twin")
        if i == 1:
            jd.snapshot(blocking=True)
            td.snapshot(blocking=True)
    for d, mod in ((jd, jfaults), (td, tfaults)):
        mod.arm("checkpoint.before_manifest")
        with pytest.raises(mod.InjectedCrash):
            d.snapshot(blocking=True)
        mod.reset()
        settle(d)
    assert_wal_dirs_equal(jdir, tdir)
    jrec = jdur.recover(jdir, ref_store)
    trec = tdur.recover(tdir, port_store)
    assert trec.recovery["snapshot_epoch"] == 1
    assert_stores_equal(jrec.kv, trec.kv, "recovered")
    assert replicas_byte_identical(trec.kv)
    trec.check_invariants()
    for i, (ks, ops, vs) in enumerate(batches[4:], 4):
        tr = trec.apply(ks, ops, vs)
        assert_results(jrec.apply(ks, ops, vs), tr, f"after recovery, batch {i}")
        assert_results(tr, twin.apply(ks, ops, vs), f"after recovery, batch {i}/twin")
    assert np.array_equal(jrec.kv.alive, trec.kv.alive)
