"""The port's recovery and replica rebuild against the JAX package's with
scheduler passes firing during the replay (not the reference's seeded
instances: its tiny histories never fill a hot log past the 0.8 trigger, so
here the stores run at trigger 0.1).  A WAL-only recovery through a
migration, and `rebuild_replica` with passes on the rebuilt replica's rows
alone: the recovered and rebuilt stores equal the reference's leaf for
leaf, the healthy replica's rows are byte-untouched, and every later status
and value is bit-exact (tests/torch_durability_oracle.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.testing import faults as jfaults  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from torch_durability_oracle import (assert_stores_equal,  # noqa: E402
                                     check_kill_restore_replay, history, probe_all)


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def test_kill_restore_replay_with_compactions(tmp_path):
    """A kill after 20 of 24 batches with no snapshot: the WAL-only replay
    runs through a migration with scheduler passes firing."""
    rec = check_kill_restore_replay(tmp_path, 123, 20, snapshot_every=1000,
                                    migrate_at=10, n_batches=24,
                                    store_kw=dict(trigger=0.1))
    assert rec.kv.compactions.sum() > 0 and rec.recovery["snapshot_epoch"] is None


def test_rebuild_replica_with_compactions_mid_replay(tmp_path):
    """24 batches, a snapshot after 3, replica 1 down after 5, a migration
    while it is down: scheduler passes fire mid-replay, on replica 1's rows
    alone; the rebuilt store equals the reference's leaf for leaf, replica
    0's rows are byte-untouched and its pass counts unchanged."""
    jd, td, twin = history(tmp_path, 29, 24, drop_after=5, migrate_after=16,
                            snapshot_after=3, store_kw=dict(trigger=0.1))
    healthy = [a[0].copy() for a in interop.state_to_numpy(td.kv.state, n_replicas=2)]
    passes = td.kv.compactions.copy()
    assert td.rebuild_replica(1) == jd.rebuild_replica(1) > 0
    assert td.kv.compactions[1].sum() > 0 and (td.kv.compactions[0] == passes[0]).all()
    for before, leaf in zip(healthy, interop.state_to_numpy(td.kv.state, n_replicas=2)):
        assert np.array_equal(before, leaf[0])
    assert np.array_equal(jd.kv.compactions, td.kv.compactions)
    assert_stores_equal(jd.kv, td.kv, "rebuilt")
    td.check_invariants()
    twin.resync(1)
    probe_all([jd, td, twin], "after the rebuild")
