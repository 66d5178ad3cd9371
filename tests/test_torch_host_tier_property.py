"""The seeded counterpart of the reference's spill property
(tests/test_host_tier.py::test_spill_differential_property) on both
packages.

At the property's own size (cold ring 256, 32 cache rows, batches of 64 lanes
over 1,024 keys, 100 steps) the store never spills: the hot log never
reaches its compaction trigger, so nothing reaches the cold log, and the
property's `spill_factor > 1` fails although every comparison before it
holds.  The first test replays the reference's falsifying example, seed 0,
through both packages and shows exactly that.  The second runs the same
drive with a hot ring a quarter the size (1,024 records, 128 in memory),
where every example spills (> 3x), and holds it bit for bit."""
import numpy as np
import pytest

from torch_host_oracle import (assert_host_equal, drive, port_cfg, port_store,
                               readback, ref_cfg, ref_store, spill_factor)
from test_host_tier import twin_cfg

N_KEYS = 1024
SPILLING = dict(hot_capacity=1 << 10, hot_mem=1 << 7)


def stores(**kw):
    engine = "fused_ref"
    jcfg = ref_cfg(engine, cold_capacity=1 << 8, host_cache_chunks=32, **kw)
    jtcfg = ref_cfg(engine, twin_cfg, **kw)
    return [ref_store(jcfg, compact_batch=64), port_store(port_cfg(jcfg), compact_batch=64),
            ref_store(jtcfg, compact_batch=64), port_store(port_cfg(jtcfg), compact_batch=64)]


def test_reference_property_size_never_spills():
    """Seed 0 at the property's size: both packages agree batch by batch
    and on the read-back, and neither spills (span 0, floor 0)."""
    jkv, tkv, jtw, ttw = all_ = stores()
    ref = drive(all_, seed=0, n_steps=100, n_keys=N_KEYS, check_every=25, ctx="seed 0")
    for kv in (jkv, tkv):
        assert spill_factor(kv) == 0.0
        assert int(np.asarray(kv.state.cold.floor)) == 0
    assert tkv._ht.stats()["demotions_total"] == 0
    readback(all_, ref, n_keys=N_KEYS, ctx="seed 0")
    assert_host_equal(jkv, tkv, "seed 0")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_spill_property(seed):
    """The property's drive with a quarter hot ring: every example spills
    (> 1, ~3.8 for these seeds), the spilled store equals the reference's
    leaf for leaf and both equal their all-device twins."""
    jkv, tkv, jtw, ttw = all_ = stores(**SPILLING)
    ref = drive(all_, seed=seed, n_steps=100, n_keys=N_KEYS, check_every=25,
                ctx=f"seed {seed}")
    assert spill_factor(tkv) > 1.0, spill_factor(tkv)
    assert int(tkv.state.cold.floor) > 0
    assert_host_equal(jkv, tkv, f"seed {seed}")
    readback(all_, ref, n_keys=N_KEYS, ctx=f"seed {seed}")
    assert_host_equal(jkv, tkv, f"seed {seed}, after the read-back")
