"""The port's `DurableKV.rebuild_replica` against the JAX package's
(tests/test_durability.py's two rebuild tests, R 2, S 2): a dropped replica
rebuilt from the snapshot and the WAL suffix, through a migration that ran
while it was down, and with no snapshot at all.  The rebuilt store equals
the reference's leaf for leaf (both replicas), the healthy replica's rows
stay byte-untouched and serve no drained record, the replicas read back
equal, and the store keeps serving like a twin that resynced live."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.testing import faults as jfaults  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.replication import replicas_byte_identical  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from torch_durability_oracle import (N_KEYS, assert_results,  # noqa: E402
                                     assert_stores_equal, history, probe_all)


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def test_rebuild_replica_drains_nothing_from_healthy(tmp_path):
    """Snapshots every 6 rounds; replica 1 dropped after 3 batches, a map
    flip while it is down: `rebuild_replica(1)` replays the same records as
    the reference's, reads no drained record from replica 0, leaves replica
    0's rows byte-untouched, and ends leaf-equal to the reference's store;
    the replicas then read back equal, and every key reads as on a twin
    that ran a live resync."""
    jd, td, twin = history(tmp_path, 17, 8, drop_after=3, migrate_after=6,
                            snapshot_every_rounds=6, blocking_snapshots=True)
    assert td.snapshots == jd.snapshots >= 1
    drained = td.kv.resynced_records
    healthy = [a[0].copy() for a in interop.state_to_numpy(td.kv.state, n_replicas=2)]
    jn, tn = jd.rebuild_replica(1), td.rebuild_replica(1)
    assert tn == jn > 0
    assert td.kv.resynced_records == drained
    assert td.kv.alive.all()
    for before, leaf in zip(healthy, interop.state_to_numpy(td.kv.state, n_replicas=2)):
        assert np.array_equal(before, leaf[0])
    assert_stores_equal(jd.kv, td.kv, "rebuilt")
    probe = np.arange(1, N_KEYS + 1, dtype=np.int32)
    assert_results(td.kv.read(probe, replica=0), td.kv.read(probe, replica=1), "pinned")
    td.check_invariants()
    twin.resync(1)
    probe_all([jd, td, twin], "after the rebuild")


def test_rebuild_replica_without_snapshot(tmp_path):
    """No snapshot: replica 1 is reset and the whole WAL replays into it;
    the replicas end byte-identical and leaf-equal to the reference's."""
    jd, td, twin = history(tmp_path, 19, 4, drop_after=2)
    assert td.ckpt.latest_step() is None
    assert td.rebuild_replica(1) == jd.rebuild_replica(1) > 0
    assert td.kv.alive.all()
    assert replicas_byte_identical(td.kv)
    assert_stores_equal(jd.kv, td.kv, "rebuilt")
    td.check_invariants()
    twin.resync(1)
    probe_all([jd, td, twin], "after the rebuild")

