"""The journal pins of tests/test_durability.py on the PyTorch port: beyond
end-state equality, a crash-and-recover run must leave the expected
lifecycle event sequence in `repro_torch.obs`'s journal (the snapshot, the
armed crash point firing inside the migration or the demotion, recovery
completing), with the crash point and the epoch threaded through the
events' fields."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as T  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from test_durability import S, gen_batches, shifted_map, tiny_cfg  # noqa: E402
from torch_durability_oracle import port_store  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    obs.configure(enabled=True, reset=True)
    yield
    faults.reset()
    obs.configure(enabled=False, reset=True)


def _in_order(expected, kinds):
    it = iter(kinds)
    return all(k in it for k in expected)


def test_journal_pins_crash_recover_event_sequence(tmp_path):
    """tests/test_durability.py::test_journal_pins_crash_recover_event_
    sequence: a blocking snapshot commits (in line) then reports taken, the
    armed point fires inside the migration, recovery completes from disk."""
    d = str(tmp_path)
    mk = lambda: port_store(replicated=False)  # noqa: E731
    dkv = T.DurableKV(mk(), T.DurabilityConfig(dir=d, snapshot_every_rounds=0))
    batches = gen_batches(13, 5)
    for ks, ops, vs in batches[:3]:
        dkv.apply(ks, ops, vs)
    dkv.snapshot(blocking=True)
    for ks, ops, vs in batches[3:]:
        dkv.apply(ks, ops, vs)
    faults.arm("migrate.after_flip")
    with pytest.raises(faults.InjectedCrash):
        dkv.kv.migrate(shifted_map(dkv.kv))
    faults.reset()
    rec = T.recover(d, mk)
    rec.check_invariants()
    kinds = obs.journal.kinds()
    expected = ["snapshot.committed", "snapshot.taken", "crashpoint.armed",
                "crashpoint.hit", "recovery.completed"]
    assert _in_order(expected, kinds), (expected, kinds)
    hit = obs.journal.events("crashpoint.hit")
    assert [e["point"] for e in hit] == ["migrate.after_flip"]
    armed = obs.journal.events("crashpoint.armed")
    assert armed[-1]["point"] == "migrate.after_flip"
    assert armed[-1]["seq"] < hit[-1]["seq"]
    done = obs.journal.events("recovery.completed")
    assert len(done) == 1 and done[0]["records"] > 0
    assert done[0]["snapshot_epoch"] == obs.journal.events("snapshot.committed")[-1]["epoch"]
    assert obs.journal.JOURNAL.dropped == 0
    rec.close()


def _host_store():
    """tests/test_durability.py::make_host_store in the port, on the CPU."""
    cfg = interop.config_from_dict(dataclasses.asdict(tiny_cfg(
        hot_capacity=1 << 8, hot_mem=1 << 5, cold_capacity=1 << 8,
        host_tier=True, host_chunk_records=16, host_cache_chunks=48,
        host_resident_frac=0.5, host_prefetch=1)))
    return T.ShardedKV(cfg, S, lanes=32, compact_batch=128, compact_frac=0.25,
                       device="cpu")


def _spilled(kv):
    return bool((kv.state.cold.floor > 0).any())


def test_journal_pins_demote_crash_recover_sequence(tmp_path):
    """tests/test_durability.py::test_journal_pins_demote_crash_recover_
    sequence: chunks demoted, a snapshot capturing them, the armed point
    firing mid-demotion, recovery completing; the interrupted demotion runs
    again during the replay (a `host.demoted` between the hit and the
    recovery's end)."""
    d = str(tmp_path)
    dkv = T.DurableKV(_host_store(), T.DurabilityConfig(
        dir=d, snapshot_every_rounds=0, fsync="always"))
    batches = gen_batches(151, 40, skew=False)
    i = 0
    while i < len(batches) and not _spilled(dkv.kv):
        dkv.apply(*batches[i])
        i += 1
    assert _spilled(dkv.kv), "workload never spilled to host"
    dkv.snapshot(blocking=True)
    faults.arm("host.mid_demote")
    fired = False
    while i < len(batches):
        try:
            dkv.apply(*batches[i])
            i += 1
        except faults.InjectedCrash:
            fired = True
            break
    faults.reset()
    assert fired, "host.mid_demote never fired after spill"
    rec = T.recover(d, _host_store)
    rec.check_invariants()
    kinds = obs.journal.kinds()
    expected = ["host.demoted", "snapshot.taken", "crashpoint.armed",
                "crashpoint.hit", "recovery.completed"]
    assert _in_order(expected, kinds), (expected, kinds)
    hit = obs.journal.events("crashpoint.hit")
    assert hit[-1]["point"] == "host.mid_demote"
    done = obs.journal.events("recovery.completed")
    assert len(done) == 1
    demos = [e["seq"] for e in obs.journal.events("host.demoted")]
    assert any(hit[-1]["seq"] < s < done[0]["seq"] for s in demos), \
        (hit[-1]["seq"], done[0]["seq"], demos)
    rec.close()
