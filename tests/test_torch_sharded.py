"""The port's sharded store (shard_router, ShardedKV) against the JAX
package's, bit for bit: the router's slabs and inverse gather, its
round-trip and deferral contracts, and ShardedKV(S=4) driven with the
reference's ShardedKV on one op stream — statuses, values, every stacked
state leaf, IoStats, compaction counts and routed rounds after every batch
— through masked compactions (the hot->cold => cold->cold cascade in one
scheduler pass), multi-round deferral, the engine knob and a stacked-state
interop round trip; plus ShardedKV against S independent port KVs fed the
routed slabs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import OP_DELETE, OP_NOOP, OP_READ, OP_RMW, OP_UPSERT  # noqa: E402
from repro.core.sharded import ShardedKV as JShardedKV  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import shard_router as tsr, store as tstore  # noqa: E402
from repro_torch.core.types import ST_NONE, ST_OK  # noqa: E402
from torch_parity import (as_np, assert_same, assert_states_equal,  # noqa: E402
                          configs, leaves_np, t)

V = 2
# tests/test_sharded.py::tiny_cfg, as a field dict both packages take
TINY = dict(hot_index_size=1 << 8, hot_capacity=1 << 9, hot_mem=1 << 6,
            cold_capacity=1 << 12, cold_mem=1 << 6, n_chunks=1 << 6,
            chunklog_capacity=1 << 9, chunklog_mem=1 << 5,
            rc_capacity=1 << 6, value_width=V, chain_max=48)
ALL_OPS = [OP_NOOP, OP_READ, OP_UPSERT, OP_RMW, OP_DELETE]


def tiny_configs(**kw):
    return configs(**dict(TINY, **kw))


def twin_skvs(S=4, cfg_kw=None, **kw):
    """A reference ShardedKV (no donation) and a CPU port ShardedKV."""
    jcfg, tcfg = tiny_configs(**(cfg_kw or {}))
    return (JShardedKV(jcfg, S, donate=False, **kw),
            T.ShardedKV(tcfg, S, device="cpu", **kw))


def assert_twins_equal(jkv, tkv, ctx):
    assert_states_equal(jkv.state, tkv.state, ctx)
    assert np.array_equal(jkv.compactions, tkv.compactions), ctx
    assert jkv.rounds == tkv.rounds, ctx
    assert jkv.io_stats() == tkv.io_stats(), ctx
    assert jkv.io_stats_per_shard() == tkv.io_stats_per_shard(), ctx


def twin_step(jkv, tkv, keys, ops, vals, ctx):
    js, jv = jkv.apply(keys, ops, vals)
    ts, tv = tkv.apply(keys, ops, vals)
    assert_same(js, ts, f"{ctx}/status")
    assert_same(jv, tv, f"{ctx}/values")
    assert_twins_equal(jkv, tkv, ctx)
    return as_np(ts), as_np(tv)


def mixed(rng, n_keys, B, p=(.35, .45, .1, .1)):
    keys = rng.integers(0, n_keys, B).astype(np.int32)
    ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                     p=list(p)).astype(np.int32)
    return keys, ops, rng.integers(0, 100, (B, V)).astype(np.int32)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def check_route_roundtrip(keys, ops, vals, S, W):
    """tests/test_sharded.py's router contract, on the port's router."""
    B = len(keys)
    sk, so, sv, rt = tsr.route(t(keys), t(ops), t(vals), S, W)
    sk, so, sv = as_np(sk), as_np(so), as_np(sv)
    r = {f: as_np(getattr(rt, f)) for f in rt._fields}
    active = np.asarray(ops) != OP_NOOP
    assert np.array_equal(active, r["placed"] | r["deferred"])
    assert not np.any(r["placed"] & r["deferred"])
    dests = r["dest"][r["placed"]]
    assert len(set(dests.tolist())) == len(dests)
    for i in np.flatnonzero(r["placed"]):
        s, w = divmod(int(r["dest"][i]), W)
        assert s == r["shard"][i] < S and w < W
        assert sk[s, w] == keys[i] and so[s, w] == ops[i]
        assert np.array_equal(sv[s, w], vals[i]) and r["mask"][s, w]
    assert np.array_equal(r["occupancy"], np.minimum(r["counts"], W))
    assert np.array_equal(r["mask"].sum(1), r["occupancy"])
    assert r["mask"].sum() == r["placed"].sum()
    assert r["counts"].sum() == active.sum()
    if W >= B:
        assert not r["deferred"].any()
    for s in range(S):
        lanes = [i for i in np.flatnonzero(r["placed"]) if r["shard"][i] == s]
        pos = [int(r["dest"][i]) - s * W for i in lanes]
        assert pos == sorted(pos) == list(range(len(pos)))
    tags = torch.arange(S * W, dtype=torch.int32).reshape(S, W)
    ost, ov = tsr.unroute(rt, tags, torch.stack([tags, tags + 1], -1))
    ost, ov = as_np(ost), as_np(ov)
    assert np.array_equal(ost[r["placed"]], r["dest"][r["placed"]])
    assert np.array_equal(ov[r["placed"], 0], r["dest"][r["placed"]])
    assert np.all(ost[~r["placed"]] == ST_NONE) and np.all(ov[~r["placed"]] == 0)


def check_deferral_rounds(keys, ops, S, W):
    """tests/test_sharded.py's deferral contract on the port's router:
    re-routing deferred lanes places every active lane once, in exactly
    ceil(max shard demand / W) rounds, in batch order within a shard."""
    B = len(keys)
    vals = torch.zeros((B, V), dtype=torch.int32)
    active = ops != OP_NOOP
    placed_round = np.full(B, -1)
    placed_pos = np.full(B, -1)
    shard = np.full(B, -1)
    cur_ops = ops.copy()
    rounds = 0
    for rnd in range(B + 1):
        _, _, _, rt = tsr.route(t(keys), t(cur_ops), vals, S, W)
        placed, deferred = as_np(rt.placed), as_np(rt.deferred)
        rounds += 1
        assert not np.any(placed & (placed_round >= 0))
        assert np.array_equal(cur_ops != OP_NOOP, placed | deferred)
        placed_round[placed] = rnd
        placed_pos[placed] = as_np(rt.dest)[placed] % W
        shard[placed] = as_np(rt.shard)[placed]
        if not deferred.any():
            break
        cur_ops = np.where(deferred, ops, OP_NOOP).astype(np.int32)
    assert (placed_round[active] >= 0).all() and (placed_round[~active] == -1).all()
    per_shard = (np.bincount(shard[active], minlength=S) if active.any()
                 else np.zeros(S, np.int64))
    assert rounds == (int(max(1, -(-per_shard.max() // W))) if active.any() else 1)
    for s in range(S):
        lanes = np.flatnonzero(active & (shard == s))
        order = lanes[np.lexsort((placed_pos[lanes], placed_round[lanes]))]
        assert np.array_equal(order, np.sort(order))


@pytest.mark.parametrize("S,W", [(1, 64), (2, 16), (4, 64), (4, 8), (8, 4),
                                 (4, 2)])
def test_router_matches_reference(S, W):
    """Slabs, Route fields and the inverse gather equal the reference's lane
    for lane, under the default map and an edited one; the round-trip and
    deferral contracts hold on the port's router."""
    rng = np.random.default_rng(100 * S + W)
    keys = rng.integers(-50, 200, 64).astype(np.int32)
    ops = rng.choice(ALL_OPS, 64).astype(np.int32)
    vals = rng.integers(0, 100, (64, V)).astype(np.int32)
    nb = 8 * S
    edited = rng.integers(0, S, nb).astype(np.int32)
    for bmap in (None, edited):
        jout = J.shard_router.route(
            jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(vals), S, W,
            bucket_map=None if bmap is None else jnp.asarray(bmap))
        tout = tsr.route(t(keys), t(ops), t(vals), S, W,
                         bucket_map=None if bmap is None else t(bmap))
        assert_same(tuple(jout[:3]), tuple(tout[:3]), "slabs")
        assert_same(jout[3], tout[3], "route")
        st = rng.integers(0, 4, (S, W)).astype(np.int32)
        sv = rng.integers(-9, 9, (S, W, V)).astype(np.int32)
        assert_same(J.shard_router.unroute(jout[3], jnp.asarray(st), jnp.asarray(sv)),
                    tsr.unroute(tout[3], t(st), t(sv)), "unroute")
    assert_same(J.shard_router.bucket_of(jnp.asarray(keys), nb),
                tsr.bucket_of(t(keys), nb))
    assert np.array_equal(J.shard_router.default_bucket_map(S, nb),
                          tsr.default_bucket_map(S, nb))
    base = tsr.default_bucket_map(S, nb)
    assert np.array_equal(J.shard_router.bucket_moves(base, edited, S),
                          tsr.bucket_moves(base, edited, S))
    check_route_roundtrip(keys, ops, vals, S, W)
    check_deferral_rounds(keys, ops, S, W)


def test_router_key_affinity_and_determinism():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 30, 48).astype(np.int32)       # many duplicates
    ops = np.full(48, OP_UPSERT, np.int32)
    vals = rng.integers(0, 9, (48, V)).astype(np.int32)
    r1 = tsr.route(t(keys), t(ops), t(vals), 4, 48)[3]
    r2 = tsr.route(t(keys), t(ops), t(vals), 4, 48)[3]
    assert_same(r1.dest, r2.dest)
    sid = as_np(tsr.shard_of(t(keys), 4))
    for k in np.unique(keys):
        assert len(np.unique(sid[keys == k])) == 1


# ---------------------------------------------------------------------------
# ShardedKV against the reference's
# ---------------------------------------------------------------------------

def test_sharded_matches_reference_and_independent_stores():
    """tests/test_sharded.py::test_sharded_matches_independent_stores on
    both packages: a mixed stream, then fresh keys until the cold log's
    trigger fires inside the same scheduler pass as a hot->cold pass, a
    routed read, and forced compactions.  The port also equals four
    independent port KVs fed the routed slabs."""
    S, B = 4, 128
    kw = dict(mode="f2", trigger=0.6, compact_frac=0.3, compact_batch=64)
    jkv, tkv = twin_skvs(S, dict(cold_capacity=1 << 9), **kw)
    refs = [T.KV(tkv.cfg, device="cpu", **kw) for _ in range(S)]
    rng = np.random.default_rng(7)
    cascades = 0

    def step(keys, ops, vals, ctx):
        nonlocal cascades
        before = {k: v.copy() for k, v in tkv.compaction_counts.items()}
        ts, tv = twin_step(jkv, tkv, keys, ops, vals, ctx)
        if (tkv.compaction_counts["hot_cold"] > before["hot_cold"]).any() and \
                (tkv.compaction_counts["cold_cold"] > before["cold_cold"]).any():
            cascades += 1
        sk, so, sv, rt = tsr.route(t(keys), t(ops), t(vals), S, B)
        outs = [r.apply(sk[s], so[s], sv[s]) for s, r in enumerate(refs)]
        us, uv = tsr.unroute(rt, torch.stack([o[0] for o in outs]),
                             torch.stack([o[1] for o in outs]))
        assert np.array_equal(ts, as_np(us)) and np.array_equal(tv, as_np(uv)), ctx

    for i in range(40):
        step(*mixed(rng, 500, B), f"mixed{i}")
    nxt = 1000
    for i in range(40):
        keys = np.arange(nxt, nxt + B, dtype=np.int32)
        nxt += B
        step(keys, np.full(B, OP_UPSERT, np.int32),
             rng.integers(0, 100, (B, V)).astype(np.int32), f"flood{i}")
        if as_np(tkv.state.cold_truncs).sum() > 0:
            break
    assert cascades > 0, "no scheduler pass ran hot->cold and cold->cold"
    rkeys = rng.integers(0, 1500, B).astype(np.int32)
    (js, jv), (ts, tv) = jkv.read(rkeys), tkv.read(rkeys)
    assert_same(js, ts, "read")
    assert_same(jv, tv, "read")
    assert_twins_equal(jkv, tkv, "read")
    sk, so, _, rt = tsr.route(t(rkeys), torch.full((B,), OP_READ, dtype=torch.int32),
                              torch.zeros((B, V), dtype=torch.int32), S, B)
    outs = []
    for s, r in enumerate(refs):
        r._st, st_r, rv_r = tstore.read_batch(r.cfg, r._st, sk[s][None],
                                              (so[s] == OP_READ)[None])
        outs.append((st_r[0], rv_r[0]))
    us, uv = tsr.unroute(rt, torch.stack([o[0] for o in outs]),
                         torch.stack([o[1] for o in outs]))
    assert_same(us, ts, "read/independent")
    assert_same(uv, tv, "read/independent")
    for kv in (jkv, tkv):
        kv.compact_hot_cold()
        kv.compact_cold_cold()
    assert_twins_equal(jkv, tkv, "forced")
    for r in refs:
        r.compact_hot_cold()
        r.compact_cold_cold()
    for s, r in enumerate(refs):
        tstore_s = interop.state_to_numpy(interop.shard_state(tkv.state, s))
        for n, a, b in zip(interop.leaf_names(), tstore_s,
                           interop.state_to_numpy(r.state)):
            assert np.array_equal(a, b), (s, n)
    assert np.array_equal(tkv.compactions, [r.compactions for r in refs])
    assert tkv.compactions.sum() > 0 and as_np(tkv.state.cold_truncs).sum() > 0
    tkv.check_invariants()
    assert tkv.stats()["io"] == jkv.io_stats()
    assert tkv.memory_model_bytes() == jkv.memory_model_bytes()


def test_masked_compaction_single_hot_shard():
    """Pressure on one shard compacts only that shard, in both packages;
    the other shards stay byte-identical to fresh ones, and reads after the
    masked pass return what was written."""
    S = 4
    jkv, tkv = twin_skvs(S, trigger=0.6, compact_frac=0.5, compact_batch=64)
    sid = as_np(tsr.shard_of(torch.arange(20000, dtype=torch.int32), S))
    hot_shard = int(sid[0])
    hot_keys = np.flatnonzero(sid == hot_shard)[:400].astype(np.int32)
    rng = np.random.default_rng(13)
    ref = {}
    for off in range(0, 400, 100):
        ks = hot_keys[off:off + 100]
        vs = rng.integers(0, 100, (100, V)).astype(np.int32)
        twin_step(jkv, tkv, ks, np.full(100, OP_UPSERT, np.int32), vs, off)
        ref.update({int(k): v for k, v in zip(ks, vs)})
    others = [s for s in range(S) if s != hot_shard]
    assert tkv.compactions[hot_shard] > 0
    assert all(tkv.compactions[s] == 0 for s in others)
    fresh = interop.state_to_numpy(tstore.create(tkv.cfg, "cpu", n_shards=S))
    for n, a, b in zip(interop.leaf_names(), interop.state_to_numpy(tkv.state),
                       fresh):
        for s in others:
            assert np.array_equal(a[s], b[s]), (n, s)
    tkv.check_invariants()
    (js, jv), (ts, tv) = jkv.read(hot_keys[:128]), tkv.read(hot_keys[:128])
    assert_same(js, ts)
    assert_same(jv, tv)
    assert np.all(as_np(ts) == ST_OK)
    assert np.array_equal(as_np(tv), np.stack([ref[int(k)] for k in hot_keys[:128]]))


def test_multi_round_deferral():
    """lanes < B: both packages take the same number of rounds and end in
    the same state, and the reads match a dict oracle (per-key order holds
    across rounds)."""
    jcfg, tcfg = configs()                       # tests/conftest.py::small_cfg
    jkv = JShardedKV(jcfg, 4, trigger=2.0, donate=False, lanes=16)
    tkv = T.ShardedKV(tcfg, 4, trigger=2.0, lanes=16, device="cpu")
    rng = np.random.default_rng(23)
    ref = {}
    B = 96
    for i in range(5):
        keys = rng.integers(0, 120, B).astype(np.int32)
        ops = rng.choice([OP_UPSERT, OP_RMW, OP_DELETE], B,
                         p=[.6, .3, .1]).astype(np.int32)
        vals = rng.integers(0, 100, (B, V)).astype(np.int32)
        twin_step(jkv, tkv, keys, ops, vals, f"defer{i}")
        for k, o, v in zip(keys, ops, vals):
            if o == OP_UPSERT:
                ref[int(k)] = v.copy()
            elif o == OP_DELETE:
                ref.pop(int(k), None)
            else:
                ref[int(k)] = (ref.get(int(k), np.zeros(V, np.int32)) + v).astype(np.int32)
    assert tkv.rounds > 5
    ks = np.asarray(sorted(ref), np.int32)
    (js, jv), (ts, tv) = jkv.read(ks), tkv.read(ks)
    assert_same(js, ts)
    assert_same(jv, tv)
    assert np.all(as_np(ts) == ST_OK)
    assert np.array_equal(as_np(tv), np.stack([ref[int(k)] for k in ks]))
    assert_twins_equal(jkv, tkv, "read")
    tkv.check_invariants()


@pytest.mark.parametrize("mode,faster_compaction",
                         [("f2", "scan"), ("faster", "scan"),
                          ("faster", "lookup")])
def test_sharded_engines_and_modes(mode, faster_compaction):
    """tests/test_sharded.py::test_sharded_cross_engine_parity: the port's
    "unfused" and "fused_ref" engines against the reference's "fused_ref",
    through masked compactions and (in f2 mode) a live migration; and the
    FASTER mode with both compaction kinds."""
    cfg_kw = dict(hot_capacity=1 << 8, hot_mem=1 << 5, cold_capacity=1 << 11)
    kw = dict(mode=mode, trigger=0.5, compact_batch=64,
              faster_compaction=faster_compaction)
    jcfg, _ = tiny_configs(engine="fused_ref", **cfg_kw)
    jrb = J.RebalanceConfig(enabled=False, migrate_batch=64)
    jkv = JShardedKV(jcfg, 4, donate=False, rebalance_cfg=jrb, **kw)
    engines = ("unfused", "fused_ref") if mode == "f2" else ("fused",)
    tkvs = [T.ShardedKV(tiny_configs(engine=e, **cfg_kw)[1], 4, device="cpu",
                        rebalance_cfg=T.RebalanceConfig(enabled=False,
                                                        migrate_batch=64),
                        **kw) for e in engines]
    rng = np.random.default_rng(29)
    for i in range(10):
        batch = mixed(rng, 400, 96)
        js, jv = jkv.apply(*batch)
        for tkv in tkvs:
            ts, tv = tkv.apply(*batch)
            assert_same(js, ts, f"{tkv.cfg.engine}{i}/status")
            assert_same(jv, tv, f"{tkv.cfg.engine}{i}/values")
            assert_twins_equal(jkv, tkv, f"{tkv.cfg.engine}{i}")
        if i == 5 and mode == "f2":
            nm = tkvs[0].bucket_map.copy()
            nm[np.flatnonzero(nm == 0)[:3]] = 2
            moved = [kv.migrate(nm) for kv in (jkv, *tkvs)]
            assert moved[0] > 0 and len(set(moved)) == 1
            for tkv in tkvs:
                assert_twins_equal(jkv, tkv, f"migrate/{tkv.cfg.engine}")
    assert tkvs[-1].compactions.sum() > 0
    if mode == "faster":
        assert np.array_equal(jkv.temp_table_peak_bytes,
                              tkvs[-1].temp_table_peak_bytes)
    for tkv in tkvs:
        tkv.check_invariants()
        assert tkv.migrated_records == jkv.migrated_records


def test_stacked_state_interop_round_trip():
    """A reference ShardedKV state loads into the port and back bit for
    bit; the port's stacked state round-trips; a shard's slice is a view of
    the stacked tensors."""
    jkv, tkv = twin_skvs(4, trigger=0.6, compact_batch=64)
    rng = np.random.default_rng(3)
    for i in range(6):
        twin_step(jkv, tkv, *mixed(rng, 600, 96), i)
    jl = leaves_np(jkv.state)
    port = interop.state_from_numpy(jl, "cpu", n_shards=4)
    for n, a, b in zip(interop.leaf_names(), jl, interop.state_to_numpy(port)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), n
    assert_states_equal(jkv.state, interop.state_from_numpy(
        interop.state_to_numpy(tkv.state), "cpu", n_shards=4), "port round trip")
    with pytest.raises(ValueError, match="shard"):
        interop.state_from_numpy(jl, "cpu", n_shards=2)
    one = interop.shard_state(port, 2)
    assert one.hot.tail.ndim == 0 and one.hot.key.data_ptr() == \
        port.hot.key[2].data_ptr()
    # a shard's slice runs as a single-shard store (api.KV's leaf shapes)
    kv = T.KV(tkv.cfg, device="cpu")
    kv.state = interop.state_from_numpy(interop.state_to_numpy(one), "cpu")
    st, _ = kv.read(np.arange(600, dtype=np.int32))
    assert (as_np(st) == ST_OK).any()


@pytest.mark.parametrize("S", [1, 2, 4])
def test_plain_kernels_over_the_shard_axis(S):
    """The three store kernels' plain versions (what the wrappers run for
    CPU tensors) over a stacked store's [S, 77] lanes equal S one-store
    calls on the shards' slices, in index, heads and target mode."""
    from repro_torch.core import hybrid_log
    from repro_torch.kernels.f2_probe import ops, ref
    _, tcfg = tiny_configs()
    skv = T.ShardedKV(tcfg, S, device="cpu", trigger=0.5, compact_batch=64)
    rng = np.random.default_rng(S)
    for _ in range(12):
        skv.apply(*mixed(rng, 900, 96))
    st, b = skv.state, 77
    hot, rc = st.hot, st.rc
    cols = (hot.key, hot.val, hot.prev, hot.meta, rc.key, rc.val, rc.prev, rc.meta)
    keys = torch.as_tensor(rng.integers(0, 1000, (S, b)).astype(np.int32))
    hb = hybrid_log.head_addr(hot, tcfg.hot_mem)
    lower = hot.begin[:, None].expand(S, b).contiguous()
    act = torch.as_tensor(rng.random((S, b)) < 0.9)
    addrs = hot.begin[:, None] + torch.arange(b, dtype=torch.int32)
    opsv = torch.as_tensor(rng.choice([0, 1, 2, 3, 4], (S, b)).astype(np.int32))
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, (S, b, V),
                                        dtype=np.int64).astype(np.int32))
    calls = [(ops.fused_probe, (keys, st.hot_index, lower, act, hb, *cols),
              dict(chain_max=48, rc_match=False)),
             (ops.fused_probe, (keys, lower, lower, act, hb, *cols),
              dict(chain_max=48, probe_index=False)),
             (ops.fused_probe, (hybrid_log.gather(hot, addrs)[0], st.hot_index, addrs,
                                act, hb, *cols),
              dict(chain_max=48, rc_match=False, target=addrs)),
             (ops.fused_write, (keys, opsv, vals, st.hot_index, hot.begin, hb,
                                hybrid_log.read_only_addr(hot, tcfg.hot_mem, 0.9),
                                hot.tail, *cols), dict(chain_max=48)),
             (ops.probe, (keys, st.hot_index), {})]
    for fn, args, kw in calls:
        got = fn(*args, **kw)
        for s in range(S):
            one = fn(*(a[s] for a in args),
                     **{k: (v[s] if torch.is_tensor(v) else v) for k, v in kw.items()})
            assert_same(tuple(x[s] for x in got), tuple(one), f"{fn.__name__}/{s}")
    assert ops.launches == {"fused_probe": 0, "fused_write": 0, "probe": 0}
