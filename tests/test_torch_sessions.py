"""The port's session layer (pack_from_pool, KVSessionService), the KV
half of serve_step and KVProtocol against the JAX package's, bit for bit:
the packer's seven outputs on seeded pools and an empty one; one scripted
enqueue/step/poll/drain interleaving with a migration mid-stream fed to
both packages' KVSessionService over ShardedKV and over ReplicatedKV —
tickets, statuses, values, every pool leaf and every store leaf after each
event, the nested stats at the end, and (replicated) the recorded schedule
replayed on a port ShardedKV twin.  Port-only contracts, after
tests/test_sessions.py and tests/test_protocol.py: ring capacity and
rejection, out-of-order collection, the NOOP refusal, the session
lifecycle, no starvation under a hot-shard flood, structural and
behavioural KVProtocol conformance of every facade (the durable one
included), make_kv_service refusing what is not ported, and its durable
deployments recovering what they acked."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import OP_DELETE, OP_NOOP, OP_READ, OP_RMW, OP_UPSERT  # noqa: E402
from repro.core.replication import ReplicatedKV as JReplicatedKV  # noqa: E402
from repro.core.sharded import ShardedKV as JShardedKV  # noqa: E402
from repro.serve.sessions import KVSessionService as JSessionService  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import shard_router as tsr  # noqa: E402
from repro_torch.core.types import ST_NOT_FOUND, ST_OK  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.serve.sessions import SLOT_DONE, KVSessionService  # noqa: E402
from torch_parity import as_np, assert_same, configs, leaves_np, t  # noqa: E402

V = 2
# tests/test_sessions.py::tiny_cfg, as a field dict both packages take
TINY = dict(hot_index_size=1 << 8, hot_capacity=1 << 9, hot_mem=1 << 6,
            cold_capacity=1 << 11, cold_mem=1 << 6, n_chunks=1 << 6,
            chunklog_capacity=1 << 9, chunklog_mem=1 << 5,
            rc_capacity=1 << 6, value_width=V, chain_max=48)
MIX = [OP_READ, OP_UPSERT, OP_RMW, OP_DELETE]
# the reference's packer, compiled once per shape
J_PACK = jax.jit(J.shard_router.pack_from_pool, static_argnums=(5, 6))


def tiny_configs(**kw):
    return configs(**dict(TINY, **kw))


def mixed_enqueue(rng, n_keys, B):
    keys = rng.integers(0, n_keys, B).astype(np.int32)
    ops = rng.choice(MIX, B, p=[.25, .45, .15, .15]).astype(np.int32)
    return keys, ops, rng.integers(0, 100, (B, V)).astype(np.int32)


def make_service(S=2, W=4, N=2, C=8, trigger=0.9):
    """A port session service over a CPU ShardedKV of the tiny config."""
    kv = T.ShardedKV(tiny_configs()[1], S, device="cpu", trigger=trigger,
                     compact_frac=0.3, compact_batch=64, lanes=W)
    return KVSessionService(kv, max_sessions=N, session_depth=C)


def shard_keyset(S, shard, n):
    cand = np.arange(1 << 14, dtype=np.int32)
    sid = as_np(tsr.shard_of(torch.as_tensor(cand), S))
    return cand[sid == shard][:n]


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

# tests/test_sessions.py::test_packer_seeded's cases: (seed, N, C, S, W)
PACK_CASES = [(3, 4, 6, 2, 3), (33, 4, 6, 2, 3), (333, 4, 6, 2, 3),
              (3333, 4, 6, 2, 3), (33333, 4, 6, 2, 3), (1, 4, 6, 4, 1),
              (2, 1, 12, 2, 8), (4, 8, 2, 2, 3), (5, 8, 64, 4, 16)]


@pytest.mark.parametrize("case", PACK_CASES, ids=[str(c[0]) for c in PACK_CASES])
def test_pack_from_pool_matches_reference(case):
    """The seven outputs equal the reference's lane for lane (dtypes too),
    with distinct tickets in random slots; the oldest pending op is packed
    and no shard takes more than W lanes."""
    seed, N, C, S, W = case
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, (N, C)).astype(np.int32)
    ops = rng.choice([OP_READ, OP_UPSERT], (N, C)).astype(np.int32)
    vals = rng.integers(0, 9, (N, C, V)).astype(np.int32)
    pending = rng.random((N, C)) < 0.6
    tkt = rng.permutation(N * C).reshape(N, C).astype(np.int32)
    bmap = tsr.default_bucket_map(S, 4 * S)
    want = J_PACK(jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(vals),
                  jnp.asarray(tkt), jnp.asarray(pending), S, W, jnp.asarray(bmap))
    got = tsr.pack_from_pool(t(keys), t(ops), t(vals), t(tkt), t(pending), S, W,
                             t(bmap))
    assert_same(tuple(jax.device_get(want)), tuple(got), f"pack/{seed}")
    valid, fill = as_np(got[5]), as_np(got[6])
    assert fill.max(initial=0) <= W and fill.sum() == valid.sum()
    if pending.any():
        n, c = np.unravel_index(np.argmin(np.where(pending, tkt, 1 << 30)), tkt.shape)
        packed = set(zip(as_np(got[3])[valid], as_np(got[4])[valid]))
        assert (n, c) in packed


def test_pack_from_pool_empty_pool():
    bmap = tsr.default_bucket_map(2, 8)
    z = np.zeros((3, 4), np.int32)
    want = J_PACK(jnp.asarray(z), jnp.asarray(z), jnp.zeros((3, 4, V), jnp.int32),
                  jnp.asarray(z), jnp.zeros((3, 4), bool), 2, 4, jnp.asarray(bmap))
    got = tsr.pack_from_pool(t(z), t(z), torch.zeros((3, 4, V), dtype=torch.int32),
                             t(z), torch.zeros((3, 4), dtype=torch.bool), 2, 4, t(bmap))
    assert_same(tuple(jax.device_get(want)), tuple(got), "empty")
    assert not as_np(got[5]).any() and (as_np(got[1]) == OP_NOOP).all()


@pytest.mark.parametrize("valid_lanes", [(), (0,), (2, 5, 6), (1, 3, 4, 7)])
def test_commit_writes_valid_lanes_only(valid_lanes):
    """`commit` writes status, values and DONE at (session, slot) of the
    valid lanes and nothing else (padding lanes carry slot -1; a valid lane
    may target row 0 of the flattened pool, or no lane may be valid)."""
    from repro_torch.serve import sessions
    rng = np.random.default_rng(len(valid_lanes))
    pool = sessions.create_pool(3, 4, V, "cpu")
    for f in ("status", "slot_state", "rvals"):
        getattr(pool, f).copy_(t(rng.integers(0, 9, getattr(pool, f).shape)))
    before = {f: as_np(getattr(pool, f)).copy() for f in ("status", "slot_state", "rvals")}
    B = 8
    cells = rng.permutation(12)[:B]
    cells[0] = 0                         # lane 0 aims at row 0
    sess, slot = cells // 4, cells % 4
    valid = np.isin(np.arange(B), valid_lanes)
    slot = np.where(valid, slot, -1)
    status = rng.integers(10, 20, B)
    rvals = rng.integers(10, 20, (B, V))
    sessions.commit(pool, t(sess), t(slot), torch.as_tensor(valid), t(status), t(rvals))
    want = {f: a.copy() for f, a in before.items()}
    for i in np.flatnonzero(valid):
        want["status"][sess[i], slot[i]] = status[i]
        want["rvals"][sess[i], slot[i]] = rvals[i]
        want["slot_state"][sess[i], slot[i]] = SLOT_DONE
    for f, a in want.items():
        assert np.array_equal(as_np(getattr(pool, f)), a), f


# ---------------------------------------------------------------------------
# one interleaving through both packages' services
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["sharded", "replicated"])
def test_session_interleaving_matches_reference(store):
    """A scripted interleaving of enqueues (with ring rejections), steps,
    polls and drains on three sessions, with masked compactions inside the
    packed rounds and a forced migration while ops sit pending, through
    both packages' KVSessionService: tickets, poll and drain results, every
    pool leaf and every store leaf equal after each event; the nested stats
    equal at the end."""
    jcfg, tcfg = tiny_configs(hot_capacity=1 << 6, hot_mem=1 << 5)
    kw = dict(mode="f2", trigger=0.5, compact_frac=0.3, compact_batch=64, lanes=8)
    if store == "replicated":
        jkv = JReplicatedKV(jcfg, 4, n_replicas=2, donate=False, **kw)
        tkv = T.ReplicatedKV(tcfg, 4, n_replicas=2, device="cpu", **kw)
    else:
        jkv = JShardedKV(jcfg, 4, donate=False, **kw)
        tkv = T.ShardedKV(tcfg, 4, device="cpu", **kw)
    R = getattr(tkv, "R", None)
    jsvc = JSessionService(jkv, max_sessions=3, session_depth=8)
    tsvc = KVSessionService(tkv, max_sessions=3, session_depth=8)
    tsvc.trace_schedule = True
    pairs = [(jsvc.open_session(), tsvc.open_session()) for _ in range(3)]
    rng = np.random.default_rng(61)

    def same(ctx):
        for n, a, b in zip(tsvc.pool._fields, jax.device_get(jsvc.pool),
                           interop.pool_to_numpy(tsvc.pool)):
            assert np.array_equal(np.asarray(a), b), (ctx, "pool", n)
        for n, a, b in zip(interop.leaf_names(), leaves_np(jkv.state),
                           interop.state_to_numpy(tkv.state, n_replicas=R)):
            assert np.array_equal(a, b), (ctx, n)

    def same_results(a, b, ctx):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), ctx

    migrated = None
    for ev in range(300):
        if ev == 150:
            nm = tkv.bucket_map.copy()
            src = int(np.argmax(np.bincount(nm, minlength=4)))
            nm[np.flatnonzero(nm == src)[:3]] = (src + 1) % 4
            assert any(b.outstanding for _, b in pairs)
            migrated = len(tsvc.schedule)
            assert jkv.migrate(nm.copy()) == tkv.migrate(nm.copy()) > 0
        act = rng.choice(["enq", "enq", "enq", "step", "poll", "drain"])
        js, ts = pairs[int(rng.integers(0, 3))]
        if act == "enq":
            batch = mixed_enqueue(rng, 400, int(rng.integers(1, 9)))
            assert np.array_equal(js.enqueue(*batch), ts.enqueue(*batch)), ev
        elif act == "step":
            jsvc.step()
            tsvc.step()
        elif act == "poll" and ts._fifo:
            pick = rng.choice(ts._fifo, size=min(len(ts._fifo), 4), replace=False)
            same_results(js.poll(pick), ts.poll(pick), ev)
        elif act == "drain":
            same_results(js.drain(), ts.drain(), ev)
        same(ev)
    for js, ts in pairs:
        same_results(js.drain(), ts.drain(), "finish")
    same("finish")
    assert tkv.compactions.sum() > 0 and tkv.migrations == 1
    assert tsvc.tickets_rejected > 0 and tsvc.max_fill <= 8
    assert jsvc.stats() == tsvc.stats()
    assert jsvc.stats() == serve_step.kv_service_stats(tsvc)
    tsvc.check_invariants()
    pool = interop.pool_from_numpy(jax.device_get(jsvc.pool), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool, tsvc.pool))

    # the recorded schedule replayed on a flat port ShardedKV twin: every
    # round's statuses and values (the replicated primary's), no deferral
    twin = T.ShardedKV(tcfg, 4, device="cpu", **kw)
    for r, (sess, valid, bkeys, bops, bvals, status, rvals,
            tkt) in enumerate(tsvc.schedule):
        if r == migrated:
            twin.migrate(tkv.bucket_map.copy())
        assert np.all(np.diff(as_np(tkt)[as_np(valid)]) > 0), r
        st, rv, _, deferred = twin.apply_round(bkeys, bops, bvals)
        twin.maybe_rebalance()
        assert not bool(deferred.any()), r
        assert_same(st, status, r)
        assert_same(rv, rvals, r)
    for n, a, b in zip(interop.leaf_names(),
                       interop.state_to_numpy(tkv.state, n_replicas=R or 1),
                       interop.state_to_numpy(twin.state)):
        assert all(np.array_equal(x, b) for x in a), n


# ---------------------------------------------------------------------------
# rings, handles and fairness (the port's own contracts)
# ---------------------------------------------------------------------------

def test_ring_capacity_rejection_and_reuse():
    svc = make_service(S=2, W=8, N=2, C=4)
    s = svc.open_session()
    t1 = s.enqueue(np.arange(6, dtype=np.int32), np.full(6, OP_UPSERT, np.int32),
                   np.ones((6, V), np.int32))
    assert list(t1[4:]) == [-1, -1] and s.in_use == 4
    done, st, _ = s.poll(t1)
    assert not done.any() and (st == 0).all()
    svc.step()
    done, st, _ = s.poll(t1)
    assert list(done) == [True] * 4 + [False, False] and s.in_use == 0
    t2 = s.enqueue(np.arange(4, dtype=np.int32), np.full(4, OP_READ, np.int32))
    assert (t2 >= 0).all()
    _, st, rv = s.drain()
    assert (st == ST_OK).all() and (rv == 1).all()
    svc.check_invariants()


def test_out_of_order_free_holds_capacity():
    """Collecting a newer ticket before an older one frees no room; the
    older one then releases both."""
    svc = make_service(S=2, W=1, N=1, C=4)
    s = svc.open_session()
    tk = s.enqueue(shard_keyset(2, 0, 4), np.full(4, OP_RMW, np.int32),
                   np.ones((4, V), np.int32))
    svc.step()
    svc.step()
    assert not s.poll(tk[2:])[0].any()
    done, _, _ = s.poll(tk[1:2])
    assert done.all() and s.in_use == 4
    done, _, _ = s.poll(tk[:1])
    assert done.all() and s.in_use == 2
    s.drain()
    assert s.in_use == 0
    svc.check_invariants()


def test_noop_enqueue_rejected():
    svc = make_service(N=1, C=4)
    s = svc.open_session()
    with pytest.raises(ValueError, match="OP_NOOP"):
        s.enqueue(np.zeros(2, np.int32), np.full(2, OP_NOOP, np.int32))
    assert s.in_use == 0 and svc.tickets_issued == 0


def test_session_lifecycle():
    """close_session frees the slot for reuse (its cursors carry over); a
    closed handle refuses work; the pool caps the open sessions."""
    svc = make_service(N=2, C=4)
    a, b = svc.open_session(), svc.open_session()
    with pytest.raises(RuntimeError, match="open"):
        svc.open_session()
    a.enqueue(np.arange(2, dtype=np.int32), np.full(2, OP_UPSERT, np.int32),
              np.ones((2, V), np.int32))
    with pytest.raises(RuntimeError, match="outstanding"):
        a.close()
    a.drain()
    a.close()
    with pytest.raises(RuntimeError, match="closed"):
        a.enqueue(np.zeros(1, np.int32), np.full(1, OP_READ, np.int32))
    c = svc.open_session()
    assert c.sid == a.sid and c._head == c._tail == 2
    c.enqueue(np.arange(2, dtype=np.int32), np.full(2, OP_READ, np.int32))
    _, st, _ = c.drain()
    assert (st == ST_OK).all()
    b.close()
    svc.check_invariants()


def test_no_starvation_under_hot_shard_flood():
    """Session B's ops complete within the FIFO bound while session A
    refloods the same shard with newer tickets every round; the oldest
    pending op is packed by every round."""
    S, W, C = 2, 4, 16
    svc = make_service(S=S, W=W, N=2, C=C)
    a, b = svc.open_session(), svc.open_session()
    hot = shard_keyset(S, 0, 64)

    def flood(n):
        n = min(n, C - a.in_use)
        if n > 0:
            a.enqueue(hot[:n], np.full(n, OP_RMW, np.int32), np.ones((n, V), np.int32))
    flood(C)
    tb = b.enqueue(hot[:4], np.full(4, OP_RMW, np.int32), np.ones((4, V), np.int32))
    bound = -(-(C + len(tb)) // W) + 1
    for r in range(bound):
        oldest = min(a._fifo + b._fifo)
        svc.step()
        cur = (a if oldest in a._slot_of else b)._slot_of[oldest]
        sid = a.sid if oldest in a._slot_of else b.sid
        assert int(svc.pool.slot_state[sid, cur % C]) == SLOT_DONE, r
        done, _, _ = b.poll(tb)
        a.poll(list(a._fifo))
        flood(C)
        if done.all():
            break
        tb = tb[~done]
    else:
        raise AssertionError("the hot-shard flood starved session B")
    a.drain()
    b.drain()
    svc.check_invariants()


# ---------------------------------------------------------------------------
# KVProtocol conformance and the service factory
# ---------------------------------------------------------------------------

def _store_kw():
    return dict(trigger=0.6, compact_batch=64, device="cpu")


FACADES = {
    "kv": lambda cfg, tmp: T.KV(cfg, trigger=0.6, compact_batch=64, device="cpu"),
    "sharded": lambda cfg, tmp: T.ShardedKV(cfg, 4, **_store_kw()),
    "replicated": lambda cfg, tmp: T.ReplicatedKV(cfg, 2, n_replicas=2, **_store_kw()),
    "sessions": lambda cfg, tmp: serve_step.make_session_service(cfg, serve_step.ServiceConfig(
        n_shards=2, lanes=32, max_sessions=2, session_depth=32,
        store_kwargs=_store_kw())),
    "durable": lambda cfg, tmp: T.DurableKV(T.ReplicatedKV(cfg, 2, n_replicas=2, **_store_kw()),
                                            T.DurabilityConfig(dir=str(tmp),
                                                               snapshot_every_rounds=4)),
}
SUBDICTS = {"kv": {"io"}, "sharded": {"io", "shards"},
            "replicated": {"io", "shards", "replicas"},
            "sessions": {"io", "shards", "sessions"},
            "durable": {"io", "shards", "replicas", "durability"}}


@pytest.mark.parametrize("name", list(FACADES))
def test_kv_protocol_conformance(name, tmp_path):
    """tests/test_protocol.py's suite on the port's facades: isinstance of
    KVProtocol; upsert/delete/rmw/read and conflict-free mixed batches
    through protocol calls only, against a dict oracle; the nested stats
    shape; invariants."""
    store = FACADES[name](tiny_configs()[1], tmp_path)
    assert isinstance(store, T.KVProtocol)
    rng = np.random.default_rng(71)
    ref = {}

    def fold(keys, ops, vals):
        for k, o, v in zip(keys, ops, vals):
            if o == OP_UPSERT:
                ref[int(k)] = v.copy()
            elif o == OP_DELETE:
                ref.pop(int(k), None)
            elif o == OP_RMW:
                ref[int(k)] = (ref.get(int(k), np.zeros(V, np.int32)) + v).astype(np.int32)

    def check(keys, st, rv, mask=None):
        st, rv = as_np(st), as_np(rv)
        for i, k in enumerate(keys):
            if mask is not None and not mask[i]:
                continue
            if int(k) in ref:
                assert st[i] == ST_OK and np.array_equal(rv[i], ref[int(k)]), (name, k)
            else:
                assert st[i] == ST_NOT_FOUND, (name, k)

    for _ in range(3):
        keys = rng.integers(0, 300, 64).astype(np.int32)
        vals = rng.integers(0, 100, (64, V)).astype(np.int32)
        store.upsert(keys, vals)
        fold(keys, np.full(64, OP_UPSERT), vals)
        dk = rng.integers(0, 300, 16).astype(np.int32)
        store.delete(dk)
        fold(dk, np.full(16, OP_DELETE), vals[:16])
        mk = rng.integers(0, 300, 32).astype(np.int32)
        deltas = rng.integers(0, 10, (32, V)).astype(np.int32)
        store.rmw(mk, deltas)
        fold(mk, np.full(32, OP_RMW), deltas)
        probe = rng.integers(0, 300, 64).astype(np.int32)
        check(probe, *store.read(probe))
    for _ in range(3):
        keys = rng.permutation(300)[:96].astype(np.int32)
        ops = rng.choice(MIX, 96, p=[.25, .45, .15, .15]).astype(np.int32)
        vals = rng.integers(0, 100, (96, V)).astype(np.int32)
        st, rv = store.apply(keys, ops, vals)
        check(keys, st, rv, ops == OP_READ)
        fold(keys, ops, vals)
    probe = np.arange(300, dtype=np.int32)
    check(probe, *store.read(probe))
    store.check_invariants()
    out = serve_step.kv_service_stats(store)
    assert SUBDICTS[name] <= set(out), out.keys()
    assert set(out["io"]) == {"read_bytes", "write_bytes", "read_ops", "mem_hits"}
    if "replicas" in out:
        assert out["replicas"]["n_replicas"] == 2
    if "sessions" in out:
        assert out["sessions"]["outstanding"] == 0
        assert 0.0 < out["sessions"]["slab_occupancy"] <= 1.0


def test_make_kv_service_builds_the_deployment():
    """ServiceConfig picks the facade; the keyword-splat call still works,
    with a DeprecationWarning; kv_service_step and kv_service_read are the
    store's apply and read."""
    cfg = tiny_configs()[1]
    kv = serve_step.make_kv_service(cfg, serve_step.ServiceConfig(
        n_shards=2, n_replicas=2, lanes=16, read_selector="least_loaded",
        store_kwargs=_store_kw()))
    assert isinstance(kv, T.ReplicatedKV) and kv.R == 2 and kv.lanes == 16
    with pytest.warns(DeprecationWarning):
        skv = serve_step.make_kv_service(cfg, n_shards=4, lanes=8, **_store_kw())
    assert type(skv) is T.ShardedKV and skv.S == 4 and skv.trigger == 0.6
    keys = np.arange(40, dtype=np.int32)
    for kv_ in (kv, skv):
        serve_step.kv_service_step(kv_, keys, np.full(40, OP_UPSERT, np.int32),
                                   np.ones((40, V), np.int32))
        st, rv = serve_step.kv_service_read(kv_, keys)
        assert (as_np(st) == ST_OK).all() and (as_np(rv) == 1).all()
    with pytest.raises(TypeError, match="store_kwargs"):
        serve_step.make_kv_service(cfg, serve_step.ServiceConfig(), mode="f2")


@pytest.mark.parametrize("field,value", [("obs_enabled", True), ("obs_port", 0)],
                         ids=["obs_enabled-True-item 13", "obs_port-0-item 13"])
def test_make_kv_service_refuses_what_is_not_ported(field, value):
    """ROADMAP item 13's two settings, which raised until observability was
    ported, now work in both factories: `obs_enabled` arms
    `repro_torch.obs` (a write reaches the registry and the trace), and
    `obs_port=0` serves `/healthz` 200 on the loopback at a free port."""
    import json
    import urllib.request
    from repro_torch import obs
    sc = dataclasses.replace(serve_step.ServiceConfig(n_shards=2, store_kwargs=_store_kw()),
                             **{field: value})
    obs.configure(enabled=False, reset=True)
    try:
        for make in (serve_step.make_kv_service, serve_step.make_session_service):
            n_srv = len(serve_step.OBS_SERVERS)
            kv = make(tiny_configs()[1], sc)
            keys = np.arange(1, 33, dtype=np.int32)
            kv.upsert(keys, np.ones((32, V), np.int32))
            if field == "obs_enabled":
                assert obs.enabled() and obs.get_registry().names()
                kv.stats()
                assert "f2_stats_io_read_ops" in obs.get_registry().names()
                assert len(obs.trace.TRACER) > 0
                obs.configure(enabled=False, reset=True)
                continue
            assert not obs.enabled()
            srv, thread = serve_step.OBS_SERVERS[n_srv]
            try:
                host, port = srv.server_address[:2]
                assert host == "127.0.0.1" and port > 0
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=10) as r:
                    assert r.status == 200
                    assert json.loads(r.read())["status"] == "ok"
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=10)
    finally:
        obs.configure(enabled=False, reset=True)


@pytest.mark.parametrize("replicas", [1, 2])
def test_make_kv_service_with_durability_recovers(tmp_path, replicas):
    """ServiceConfig.durability wraps the store in DurableKV, in both
    factories; what the service acked comes back from `recover`."""
    cfg = tiny_configs()[1]
    sc = serve_step.ServiceConfig(
        n_shards=2, n_replicas=replicas, lanes=16, store_kwargs=_store_kw(),
        durability=T.DurabilityConfig(dir=str(tmp_path / "kv"), snapshot_every_rounds=3))
    kv = serve_step.make_kv_service(cfg, sc)
    svc = serve_step.make_session_service(cfg, dataclasses.replace(
        sc, durability=T.DurabilityConfig(dir=str(tmp_path / "svc"))))
    assert isinstance(kv, T.DurableKV) and isinstance(svc.kv, T.DurableKV)
    assert isinstance(kv.kv, T.ReplicatedKV if replicas > 1 else T.ShardedKV)
    rng = np.random.default_rng(5)
    for store in (kv, svc):
        keys = rng.permutation(200)[:48].astype(np.int32)
        vals = rng.integers(0, 100, (48, V)).astype(np.int32)
        for _ in range(3):
            serve_step.kv_service_step(store, keys, np.full(48, OP_UPSERT, np.int32), vals)
            vals = vals + 1
        d = store.kv if store is svc else store
        d.wait()
        rec = T.recover(d.dcfg.dir, lambda: serve_step.make_kv_service(
            cfg, dataclasses.replace(sc, durability=None)))
        st, rv = rec.read(keys)
        assert (as_np(st) == ST_OK).all() and np.array_equal(as_np(rv), vals - 1)
        rec.check_invariants()
