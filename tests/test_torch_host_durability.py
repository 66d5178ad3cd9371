"""The reference's host-tier kills (tests/test_durability.py:567-650) on
both packages at once: a durable ShardedKV(S=2) with the host tier on,
driven until its cold log spills, a crash at `host.mid_demote` (seeds 121
and, with no snapshot, 141) or `host.mid_promote` (seed 131) inside a
batch whose WAL record is already durable, `recover()` in each package,
then the rest of the batches.  Compared bit for bit: every batch's
statuses and values (the port also against an uninterrupted twin), the WAL
directories, the recovered stores' leaves, manager stats and host stores,
and a read-back of every key.  With the tier on each package also recovers
from the other's WAL."""
import os
import shutil

import numpy as np
import pytest

from repro.core import durability as jdur
from repro.testing import faults as jfaults
from repro_torch.core import durability as tdur
from repro_torch.testing import faults as tfaults
from test_durability import N_KEYS, S, gen_batches, tiny_cfg
from torch_durability_oracle import assert_results, assert_wal_dirs_equal, settle
from torch_host_oracle import assert_host_equal, port_cfg, port_store, ref_store

STORE_KW = dict(lanes=32, compact_batch=128, compact_frac=0.25)


def host_tiny():
    """tests/test_durability.py::make_host_store's config."""
    return tiny_cfg(hot_capacity=1 << 8, hot_mem=1 << 5, cold_capacity=1 << 8,
                    host_tier=True, host_chunk_records=16, host_cache_chunks=48,
                    host_resident_frac=0.5, host_prefetch=1)


def jmk():
    return ref_store(host_tiny(), S, **STORE_KW)


def tmk():
    return port_store(port_cfg(host_tiny()), S, **STORE_KW)


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _spilled(kv):
    return bool(np.asarray(kv.state.cold.floor).any())


def _apply_crashing(d, batch, mod):
    """d.apply(batch) with a crash point armed: True if it fired."""
    try:
        d.apply(*batch)
    except mod.InjectedCrash:
        return True
    return False


def check_host_kill(tmp, seed, crash_point, *, snapshot_every=6, n_batches=40):
    jdir, tdir = str(tmp / "ref"), str(tmp / "port")
    cfg = dict(snapshot_every_rounds=snapshot_every, fsync="always")
    jd = jdur.DurableKV(jmk(), jdur.DurabilityConfig(dir=jdir, **cfg))
    td = tdur.DurableKV(tmk(), tdur.DurabilityConfig(dir=tdir, **cfg))
    twin = tmk()
    batches = gen_batches(seed, n_batches, skew=False)
    i = 0
    while i < n_batches - 8 and not _spilled(td.kv):
        jr, tr, wr = (s.apply(*batches[i]) for s in (jd, td, twin))
        assert_results(jr, tr, f"batch {i}")
        assert_results(tr, wr, f"batch {i}/twin")
        i += 1
    assert _spilled(td.kv) and _spilled(jd.kv), "the workload never spilled"

    jfaults.arm(crash_point)
    tfaults.arm(crash_point)
    fired = False
    while i < n_batches:
        fj = _apply_crashing(jd, batches[i], jfaults)
        ft = _apply_crashing(td, batches[i], tfaults)
        assert fj == ft, (i, fj, ft)
        if fj:
            fired = True
            break
        twin.apply(*batches[i])
        i += 1
    jfaults.reset()
    tfaults.reset()
    assert fired, f"{crash_point} never fired after the spill"
    # write-ahead: the crashed batch is durable and replays in recovery
    twin.apply(*batches[i])
    i += 1
    settle(jd)
    settle(td)
    assert_wal_dirs_equal(jdir, tdir, "at the kill")

    wal_only = {}
    if snapshot_every >= n_batches:
        # each package recovers from the other's WAL too (copies: recovery
        # opens a new segment in the directory it reads)
        for name, src in (("port_from_ref", jdir), ("ref_from_port", tdir)):
            dst = str(tmp / name)
            shutil.copytree(src, dst)
            wal_only[name] = dst
    jrec = jdur.recover(jdir, jmk)
    trec = tdur.recover(tdir, tmk)
    assert_host_equal(jrec.kv, trec.kv, "recovered")
    trec.check_invariants()
    assert trec.recovery["snapshot_epoch"] == jd.ckpt.latest_step()
    if wal_only:
        assert not any(f.startswith("snap") and os.listdir(os.path.join(tdir, f))
                       for f in os.listdir(tdir))
        x = tdur.recover(wal_only["port_from_ref"], tmk)
        y = jdur.recover(wal_only["ref_from_port"], jmk)
        assert_host_equal(jrec.kv, x.kv, "port recovered from the reference's WAL")
        assert_host_equal(y.kv, trec.kv, "reference recovered from the port's WAL")
        x.close()
        y.close()

    for k, b in enumerate(batches[i:], i):
        jr, tr, wr = (s.apply(*b) for s in (jrec, trec, twin))
        assert_results(jr, tr, f"after recovery, batch {k}")
        assert_results(tr, wr, f"after recovery, batch {k}/twin")
    probe = np.arange(1, N_KEYS + 1, dtype=np.int32)
    jr, tr, wr = (s.read(probe) for s in (jrec, trec, twin))
    assert_results(jr, tr, "read-back")
    assert_results(tr, wr, "read-back/twin")
    assert_host_equal(jrec.kv, trec.kv, "after recovery")
    trec.check_invariants()
    assert _spilled(trec.kv)
    jrec.close()
    trec.close()


def test_kill_mid_demotion(tmp_path):
    # between the host-side chunk copy and the floor commit: the demotion
    # is invisible, recovery runs it again
    check_host_kill(tmp_path, 121, "host.mid_demote")


def test_kill_mid_promotion(tmp_path):
    # after victim selection, before the device install: the cache is a
    # replica, recovery refills it on demand
    check_host_kill(tmp_path, 131, "host.mid_promote")


def test_kill_mid_demotion_wal_only(tmp_path):
    # no snapshot lands: the host store is rebuilt by replaying the log
    # through live demotions, in either package from either's WAL
    check_host_kill(tmp_path, 141, "host.mid_demote", snapshot_every=1000)
