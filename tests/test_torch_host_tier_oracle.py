"""The reference's KV differential spill oracle (tests/test_host_tier.py)
on both packages at once (its ShardedKV oracle is in
test_torch_host_tier_sharded.py): a store whose cold ring is several times
smaller than the live log it serves, driven beside the same store in the
JAX package and beside each package's all-device twin (a cold ring large
enough that nothing demotes).  Statuses and values must be equal batch by
batch; at the end every state leaf (the chunk cache's and `cold.floor`
among them), `HostTier.stats()` and the exported host store must be equal
bit for bit; then every key is read back on all four stores against the
dict reference, and the spilled stores compared again (reads promote)."""
import pytest

from torch_host_oracle import (assert_host_equal, drive, port_cfg, port_store,
                               readback, ref_cfg, ref_store, spill_factor)
from test_host_tier import host_cfg, twin_cfg


def test_spill_oracle_kv_bit_exact():
    """KV, seed 7, 400 steps of 64 lanes over 4,096 keys (the reference's
    `spilled` fixture): >= 4x spill, demotions and promotions both ran."""
    engine = "fused_ref"
    jcfg, jtcfg = ref_cfg(engine), ref_cfg(engine, twin_cfg)
    jkv = ref_store(jcfg, compact_batch=128)
    jtw = ref_store(jtcfg, compact_batch=128)
    tkv = port_store(port_cfg(jcfg), compact_batch=128)
    ttw = port_store(port_cfg(jtcfg), compact_batch=128)
    ref = drive([jkv, tkv, jtw, ttw], seed=7, n_steps=400, ctx="kv")
    assert_host_equal(jkv, tkv, "kv after the drive")
    assert spill_factor(tkv) >= 4.0, spill_factor(tkv)
    st = tkv._ht.stats()
    assert st["chunks"] > 0 and st["demotions_total"] > 0 and st["promotions_total"] > 0
    assert tkv.compaction_counts["cold_cold"] > 0       # the resumable walk ran
    readback([jkv, tkv, jtw, ttw], ref, ctx="kv")
    assert_host_equal(jkv, tkv, "kv after the read-back")
    tkv.check_invariants()
    mem = tkv.memory_model_bytes()
    assert mem == jkv.memory_model_bytes()
    assert mem["host_store_bytes"] == tkv._ht.host_bytes() > 0


def test_host_config_validation_matches_the_reference():
    """The reference's host-tier asserts are the port's ValueErrors."""
    import repro_torch as T
    from repro_torch import interop
    import dataclasses
    for bad in (dict(host_chunk_records=24), dict(host_cache_chunks=0),
                dict(host_resident_frac=1.0), dict(host_prefetch=-1),
                dict(host_log_factor=0.5), dict(host_resident_frac=0.99)):
        with pytest.raises(AssertionError):
            host_cfg(**bad)
        d = dataclasses.asdict(host_cfg())
        d.update(bad)
        with pytest.raises(ValueError):
            interop.config_from_dict(d)
    with pytest.raises(ValueError, match="compact_batch"):
        T.KV(port_cfg(host_cfg()), compact_batch=4096, device="cpu")
    with pytest.raises(ValueError, match="mode='f2'"):
        T.KV(port_cfg(host_cfg()), mode="faster", compact_batch=128, device="cpu")
