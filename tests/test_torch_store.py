"""The port's store, compactions and KV facade against the JAX package's,
bit for bit: YCSB op streams through both KVs with every F2State leaf,
status, value, IoStats and compaction count compared after every batch
(with hot->cold, cold->cold and chunk-log GC firing mid stream), the
read-cache/compaction record-loss scenario, the FASTER mode with both
compaction kinds, two-phase reads across a cold truncation, and the
interop round trip."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import OP_DELETE, OP_RMW, OP_UPSERT, ST_OK  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import compaction as tcomp, store as tstore  # noqa: E402
from repro_torch.workload import Zipf, make_ops  # noqa: E402
from torch_parity import (as_np, assert_same, assert_states_equal,  # noqa: E402
                          configs, leaves_np, reference_kv, t, to_port,
                          twin_kvs)

# small rings so that every compaction kind fires within a short stream
STREAM_CFG = dict(cold_capacity=1 << 12, chunklog_capacity=1 << 9,
                  chunklog_mem=1 << 5)
B = 96


def _step(jkv, tkv, keys, ops, vals, ctx):
    js, jv = jkv.apply(keys, ops, vals)
    ts, tv = tkv.apply(keys, ops, vals)
    assert_same(js, ts, f"{ctx}/status")
    assert_same(jv, tv, f"{ctx}/values")
    assert_states_equal(jkv.state, tkv.state, ctx)
    assert jkv.compactions == tkv.compactions, ctx
    assert jkv.io_stats() == tkv.io_stats(), ctx
    return as_np(ts), as_np(tv)


@pytest.mark.parametrize("workload", ["A", "B", "F"])
def test_ycsb_stream_parity(workload):
    jkv, tkv = twin_kvs(**STREAM_CFG)
    V = tkv.cfg.value_width
    rng = np.random.default_rng(ord(workload))
    # load: every key once, then the mix at Zipf 0.99 over the same keys;
    # the key count fills the cold ring past its trigger without overflow
    n_keys = 4300
    perm = rng.permutation(n_keys).astype(np.int32)
    for i in range(0, n_keys, B):
        k = perm[i:i + B]
        st, _ = _step(jkv, tkv, k, np.full(len(k), OP_UPSERT, np.int32),
                      np.stack([k] * V, 1), f"load{i}")
        assert np.all(st == ST_OK)
    zipf = Zipf(n_keys, 0.99)
    for i in range(30):
        keys, ops, vals, _ = make_ops(rng, workload, zipf, B, V)
        if i % 10 == 9:
            ops[::13] = OP_DELETE
        _step(jkv, tkv, keys, ops, vals, f"{workload}{i}")
        if workload == "B" and i == 15:
            # YCSB-B writes too little to trip cold->cold; run it mid stream
            jkv.compact_cold_cold()
            tkv.compact_cold_cold()
    counts = tkv.compaction_counts
    assert counts["hot_cold"] > 0 and counts["cold_cold"] > 0 \
        and counts["chunk_gc"] > 0, counts
    tkv.check_invariants()
    jkv.check_invariants()
    assert tkv.stats() == {"io": jkv.io_stats()}


def test_unfused_engine_stream_parity():
    """The port's "unfused" oracle against the reference's "jnp"."""
    jkv, tkv = twin_kvs(engine="unfused", **STREAM_CFG)
    rng = np.random.default_rng(5)
    for i in range(30):
        keys = rng.integers(0, 2500, B).astype(np.int32)
        ops = rng.choice([1, OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.3, .45, .15, .1]).astype(np.int32)
        _step(jkv, tkv, keys, ops, rng.integers(0, 100, (B, 2)).astype(np.int32),
              f"unfused{i}")
    assert tkv.compactions > 0


@pytest.mark.parametrize("rc_capacity", [1, 1 << 9])
def test_rc_compaction_loss_scenario(rc_capacity):
    """tests/test_rc_compaction_loss.py: upsert -> read (RC admits) ->
    full hot->cold compaction -> read loses nothing, in both packages."""
    jcfg, tcfg = configs(hot_index_size=1 << 12, hot_capacity=1 << 13,
                         hot_mem=1 << 10, cold_capacity=1 << 15, cold_mem=1 << 8,
                         n_chunks=1 << 9, chunklog_capacity=1 << 12,
                         chunklog_mem=1 << 7, rc_capacity=rc_capacity,
                         value_width=4, chain_max=24)
    jkv, tkv = reference_kv(jcfg), T.KV(tcfg, device="cpu")
    keys = np.arange(4096, dtype=np.int32)
    vals = np.stack([keys, keys * 2, keys * 3, keys * 4], 1).astype(np.int32)
    _step(jkv, tkv, keys, np.full(4096, OP_UPSERT, np.int32), vals, "load")
    for ctx in ("read", "compact", "reread"):
        if ctx == "compact":
            jkv.compact_hot_cold(int(jkv.state.hot.tail))
            tkv.compact_hot_cold(int(tkv.state.hot.tail))
            assert_states_equal(jkv.state, tkv.state, ctx)
            continue
        (js, jv), (ts, tv) = jkv.read(keys), tkv.read(keys)
        assert_same(js, ts, ctx)
        assert_same(jv, tv, ctx)
        assert_states_equal(jkv.state, tkv.state, ctx)
        assert np.all(as_np(ts) == ST_OK) and np.array_equal(as_np(tv), vals)
    tkv.check_invariants()


@pytest.mark.parametrize("faster_compaction", ["scan", "lookup"])
def test_faster_mode_parity(faster_compaction):
    jkv, tkv = twin_kvs(mode="faster", faster_compaction=faster_compaction,
                        **STREAM_CFG)
    rng = np.random.default_rng(11)
    for i in range(40):
        keys = rng.integers(0, 1200, B).astype(np.int32)
        ops = rng.choice([1, OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.2, .5, .2, .1]).astype(np.int32)
        _step(jkv, tkv, keys, ops, rng.integers(0, 100, (B, 2)).astype(np.int32),
              f"faster{i}")
    assert tkv.compaction_counts["single_log"] > 0
    assert jkv.temp_table_peak_bytes == tkv.temp_table_peak_bytes
    assert jkv.memory_model_bytes() == tkv.memory_model_bytes()


@pytest.fixture(scope="module")
def loaded():
    """The reference state (and its leaves) after a stream that leaves hot,
    cold and RC records plus tombstones, checked against the port's."""
    jkv, tkv = twin_kvs(**STREAM_CFG)
    rng = np.random.default_rng(3)
    for i in range(24):
        if i == 16:
            half = int(tkv.state.hot.tail) // 2
            jkv.compact_hot_cold(half)
            tkv.compact_hot_cold(half)
        keys = rng.integers(0, 1500, B).astype(np.int32)
        ops = rng.choice([1, OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.3, .5, .1, .1]).astype(np.int32)
        _step(jkv, tkv, keys, ops, rng.integers(0, 100, (B, 2)).astype(np.int32),
              f"prep{i}")
    assert int(tkv.state.cold.tail) > 128 and int(tkv.state.rc.tail) > 0
    return jkv.state


def _twins_at(jstate):
    """Twin KVs whose state is `jstate` (the port's a copy of it)."""
    jkv, tkv = twin_kvs(**STREAM_CFG)
    jkv.state, tkv.state = jstate, to_port(jstate)
    return jkv, tkv


def test_two_phase_read_across_cold_truncation(loaded):
    jkv, tkv = _twins_at(loaded)
    jcfg, tcfg = jkv.cfg, tkv.cfg
    keys = np.arange(0, 1500, 16, dtype=np.int32)
    act = np.ones(len(keys), bool)
    jst, jsnap = jax.jit(functools.partial(J.store.read_begin, jcfg))(
        jkv.state, jnp.asarray(keys), jnp.asarray(act))
    tst, tsnap = tstore.read_begin(tcfg, tkv.state, t(keys), t(act))
    assert_same(jsnap, tsnap, "snapshot")
    jkv.state, tkv.state = jst, tst
    jkv.compact_cold_cold()
    tkv.compact_cold_cold()
    assert_states_equal(jkv.state, tkv.state, "truncated")
    assert int(tkv.state.cold_truncs) > int(tsnap.num_truncs)
    jout = jax.jit(functools.partial(J.store.read_finish, jcfg))(jkv.state, jsnap)
    tout = tstore.read_finish(tcfg, tkv.state, tsnap)
    assert_same(jout[1:], tout[1:], "finish")
    assert_states_equal(jout[0], tout[0], "finish")
    assert np.any(as_np(tout[1]) == ST_OK)


def test_compaction_steps_and_conditional_insert_parity(loaded):
    jcfg, tcfg = configs(**STREAM_CFG)
    jst = loaded
    # frontiers: the oldest hot records, the newest cold ones (older cold
    # records of this stream are all superseded)
    steps = {
        "hot_cold": (J.compaction.hot_cold_step, tcomp.hot_cold_step,
                     jst.hot.begin, jst.hot.tail),
        "cold_cold": (J.compaction.cold_cold_step, tcomp.cold_cold_step,
                      jst.cold.tail - 128, jst.cold.tail),
        "single_log": (J.compaction.single_log_lookup_step,
                       tcomp.single_log_lookup_step, jst.hot.begin, jst.hot.tail),
    }
    for name, (jf, tf, start, until) in steps.items():
        jout = jax.jit(jf, static_argnums=(0, 4))(jcfg, jst, start, until, 128)
        tout = tf(tcfg, to_port(jst), t(start), t(until), 128)
        assert_same(jout[1], tout[1], name)
        assert_states_equal(jout[0], tout[0], name)
        assert int(tout[1]) > 0, name
    keys = np.arange(0, 64, dtype=np.int32)
    starts = np.asarray(jst.hot.tail - 40 + np.arange(64) % 50, np.int32)
    mask = np.arange(64) % 5 != 0
    vals = np.full((64, 2), 7, np.int32)
    jout = jax.jit(J.compaction.conditional_insert_hot, static_argnums=0)(
        jcfg, jst, jnp.asarray(mask), jnp.asarray(keys), jnp.asarray(vals),
        jnp.asarray(starts))
    tout = tcomp.conditional_insert_hot(tcfg, to_port(jst), t(mask), t(keys),
                                        t(vals), t(starts))
    assert_same(jout[1], tout[1], "ok")
    assert_states_equal(jout[0], tout[0], "conditional_insert")
    assert 0 < int(as_np(tout[1]).sum()) < int(mask.sum())


def test_interop_round_trip_and_reporting(loaded):
    jkv, tkv = _twins_at(loaded)
    # reference leaves -> port -> numpy is the identity, and port -> port too
    back = interop.state_to_numpy(interop.state_from_numpy(leaves_np(jkv.state), "cpu"))
    for n, a, b in zip(interop.leaf_names(), leaves_np(jkv.state), back):
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    again = interop.state_from_numpy(interop.state_to_numpy(tkv.state), "cpu")
    assert_states_equal(jkv.state, again, "round trip")
    assert len(interop.leaf_names()) == len(jax.tree_util.tree_leaves(jkv.state))
    # reporting: pure probes and the memory model agree too
    keys = np.arange(0, 1600, 7, dtype=np.int32)
    assert np.array_equal(jkv.chain_hops(keys), tkv.chain_hops(keys))
    assert_states_equal(jkv.state, tkv.state, "chain_hops is pure")
    assert jkv.memory_model_bytes() == tkv.memory_model_bytes()
    with pytest.raises(ValueError):
        interop.state_from_numpy(leaves_np(jkv.state)[:-1], "cpu")


def test_long_compaction_wraps_chunk_log_in_both_packages():
    """Chunk-log GC runs only between batches, so one compaction call that
    appends more chunk versions than the chunk log holds overwrites live
    chunks.  The port keeps the reference's policy exactly: both latch
    `cold_idx.overflowed` on the same step, with equal states."""
    jkv, tkv = twin_kvs(n_chunks=1 << 9, chunklog_capacity=1 << 10,
                        chunklog_mem=1 << 5)
    keys = np.arange(1600, dtype=np.int32)
    for i in range(0, 1600, B):
        _step(jkv, tkv, keys[i:i + B], np.full(len(keys[i:i + B]), OP_UPSERT,
                                               np.int32),
              np.stack([keys[i:i + B]] * 2, 1), f"load{i}")
    assert not bool(tkv.state.cold_idx.overflowed)
    jkv.compact_hot_cold(int(jkv.state.hot.tail))
    tkv.compact_hot_cold(int(tkv.state.hot.tail))
    assert_states_equal(jkv.state, tkv.state, "long compaction")
    assert bool(tkv.state.cold_idx.overflowed)
