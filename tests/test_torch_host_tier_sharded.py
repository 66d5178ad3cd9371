"""The reference's ShardedKV differential spill oracle
(tests/test_host_tier.py::test_spill_oracle_sharded_masked_compactions) on
both packages at once, beside each package's all-device sharded twin:
statuses and values equal batch by batch, then every state leaf, the
manager's stats and host store bit for bit; a cold->cold pass masked to
one shard; every key read back on all four stores."""
import numpy as np
import torch

from torch_host_oracle import (assert_host_equal, drive, port_cfg, port_store,
                               readback, ref_cfg, ref_store, spill_factor)
from test_host_tier import twin_cfg


def test_spill_oracle_sharded_masked_compactions():
    """ShardedKV(S=2), seed 11, 300 steps, halved hot ring: the shards'
    pressure triggers fire on different rounds, so compactions and
    demotions run masked; then a cold->cold pass masked to shard 0 through
    the resumable walk, its idle shard's leaves byte-frozen."""
    engine = "fused_ref"
    kw = dict(hot_capacity=1 << 11, hot_mem=1 << 8)
    jcfg, jtcfg = ref_cfg(engine, **kw), ref_cfg(engine, twin_cfg, **kw)
    jkv = ref_store(jcfg, 2, compact_batch=128)
    jtw = ref_store(jtcfg, 2, compact_batch=128)
    tkv = port_store(port_cfg(jcfg, engine), 2, compact_batch=128)
    ttw = port_store(port_cfg(jtcfg, engine), 2, compact_batch=128)
    ref = drive([jkv, tkv, jtw, ttw], seed=11, n_steps=300, ctx="sharded")
    assert_host_equal(jkv, tkv, "sharded after the drive")
    floors = tkv.state.cold.floor.numpy()
    assert (floors > 0).all(), floors           # every shard spilled
    assert spill_factor(tkv) >= 2.0, spill_factor(tkv)
    # a cold->cold pass masked to shard 0: shard 1's cache traffic, clock
    # and begin stay still (its floor moves only if the pass's demotion
    # check, which looks at every shard as the reference's does, needs it)
    host, cold = tkv.state.host, tkv.state.cold
    before = [t[1].clone() for t in (host.clock, host.tick, host.hits, cold.begin)]
    begin0 = int(cold.begin[0])
    mask = np.array([True, False])
    jkv.compact_cold_cold(shards=mask)
    tkv.compact_cold_cold(shards=mask)
    assert_host_equal(jkv, tkv, "sharded after a masked cold->cold pass")
    host, cold = tkv.state.host, tkv.state.cold
    for b, a in zip(before, (host.clock, host.tick, host.hits, cold.begin)):
        assert torch.equal(b, a[1])
    assert int(cold.begin[0]) > begin0                  # shard 0 truncated
    readback([jkv, tkv, jtw, ttw], ref, ctx="sharded")
    assert_host_equal(jkv, tkv, "sharded after the read-back")
    tkv.check_invariants()
    assert tkv.memory_model_bytes() == jkv.memory_model_bytes()
    assert tkv.stats()["host"] == jkv.stats()["host"]
