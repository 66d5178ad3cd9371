"""Observability in the PyTorch port (`repro_torch.obs`): the registry,
tracer, journal and exporters against the reference's unit contract, and
the fold points of the port's facades held against the reference's
(`repro.obs`) on the same seeded op stream.

For each facade (flat, sharded, replicated, the session service, durable
and a spilled KV) one stream goes through the reference with `repro.obs`
on and through the port with `repro_torch.obs` on.  Equal by name and
labels: every counter, every gauge (the `f2_stats_*` mirrors included),
every count histogram, and the observation count of every timing
histogram; equal too the journal's kind sequence, the multiset of span
names and the `stats()` tree with its leaf types.  A bench envelope from
each package diffs with no delta (`repro_torch.obs.report.diff`).  With
obs off, the port's outputs and `stats()` equal its obs-on run bit for
bit.

The one named exception is inside a resync (`test_resync_parity_names_
its_exceptions`): the port replays a slab per shard a round where the
reference replays batch by batch (`core.replication._replay`), so the
replay's scheduler passes are grouped otherwise (their `compaction.*`
events, `compact.*` spans and `f2_compactions_total` increments); nothing
else differs."""
import collections
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core.durability import DurabilityConfig as JDurabilityConfig  # noqa: E402
from repro.core.durability import DurableKV as JDurableKV  # noqa: E402
from repro.core.replication import ReplicatedKV as JReplicatedKV  # noqa: E402
from repro.core.sharded import ShardedKV as JShardedKV  # noqa: E402
from repro.serve import serve_step as jss  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.obs import export, report, rules, serve  # noqa: E402
from repro_torch.obs.journal import Journal  # noqa: E402
from repro_torch.obs.metrics import (COUNT_BUCKETS, MetricError,  # noqa: E402
                                     MetricsRegistry, fold_stats)
from repro_torch.obs.report import summarize  # noqa: E402
from repro_torch.obs.trace import NOOP_SPAN, Tracer  # noqa: E402
from repro_torch.serve import serve_step as tss  # noqa: E402
from test_obs import B, V, _assert_same_leaf_types, _drive, tiny_cfg  # noqa: E402
from torch_host_oracle import gen_batch  # noqa: E402
from torch_parity import as_np  # noqa: E402

TIMING = ("f2_latency_seconds", "f2_wal_fsync_seconds",
          "f2_checkpoint_save_seconds")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Both packages' observability is process-global: every test starts
    and ends with both disabled and empty."""
    for o in (obs, jobs):
        o.configure(enabled=False, reset=True)
    yield
    for o in (obs, jobs):
        o.configure(enabled=False, reset=True)


def tcfg(**kw):
    """tests/test_obs.py::tiny_cfg as the port's config."""
    return interop.config_from_dict(dataclasses.asdict(tiny_cfg(**kw)))


# ---------------------------------------------------------------------------
# the registry, the tracer, the journal, the exporters (the reference's
# unit contract, tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_counter_monotone_and_negative_raises():
    reg = MetricsRegistry()
    c = reg.counter("c_total", labels=("facade",)).labels(facade="kv")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(MetricError):
        c.inc(-1)
    c.set_total(100)
    assert c.value == 100


@pytest.mark.parametrize("case", ["kind", "labels", "child_labels"])
def test_metric_redeclaration_raises(case):
    reg = MetricsRegistry()
    reg.counter("m", labels=("a",))
    with pytest.raises(MetricError):
        if case == "kind":
            reg.gauge("m", labels=("a",))
        elif case == "labels":
            reg.counter("m", labels=("b",))
        else:
            reg.counter("m", labels=("a",)).labels(wrong=1)
    assert reg.counter("m", labels=("a",)) is reg.counter("m", labels=("a",))


@pytest.mark.parametrize("edges", [(1.0, 1.0, 2.0), (2.0, 1.0), "redeclared"])
def test_histogram_bucket_edges_validated(edges):
    reg = MetricsRegistry()
    with pytest.raises(MetricError):
        if edges == "redeclared":
            reg.histogram("h", buckets=(1.0, 2.0, 4.0))
            reg.histogram("h", buckets=(1.0, 2.0))
        else:
            reg.histogram("h_bad", buckets=edges)


def test_histogram_binning_at_edges():
    h = MetricsRegistry().histogram("h", buckets=(1.0, 2.0, 4.0)).labels()
    h.observe_many([0.5, 1.0, 1.5, 2.0, 3.0, 5.0])
    assert h.counts == [2, 2, 1, 1]
    assert h.count == 6
    assert h.sum == pytest.approx(13.0)


@pytest.mark.parametrize("raw", [3, 2.5, True, "least_loaded", [1, 2, 3], [0.5, 1.5]],
                         ids=["int", "float", "bool", "str", "int_list", "float_list"])
def test_gauge_stores_raw_python_values(raw):
    g = MetricsRegistry().gauge("g", labels=("k",))
    g.labels(k="x").set(raw)
    got = g.labels(k="x").value
    assert got is raw and type(got) is type(raw)


def test_disabled_helpers_are_noops():
    assert not obs.enabled()
    obs.count("f2_x_total", 3, facade="kv")
    obs.count_total("f2_y_total", 10, facade="kv")
    obs.gauge_set("f2_z", 1.5, facade="kv")
    obs.observe("f2_h", 2.0, buckets=COUNT_BUCKETS, facade="kv")
    assert obs.get_registry().names() == []
    assert obs.journal.emit("compaction.hot_cold", facade="kv") is None
    assert len(obs.journal.JOURNAL) == 0


def test_disabled_span_is_shared_noop_singleton():
    s1 = obs.span("a", cat="serve", n=1)
    s2 = obs.span("b")
    assert s1 is s2 is NOOP_SPAN
    with s1:
        pass
    obs.instant("marker")
    assert len(obs.trace.TRACER) == 0


def test_fold_stats_disabled_identity_enabled_rebuilt():
    tree = {"io": {"read_ops": 7, "frac": 0.25},
            "shards": {"fill": [0.1, 0.2], "selector": "round_robin",
                       "alive": [True, False]}}
    assert obs.fold_stats("kv", tree) is tree
    assert obs.get_registry().names() == []
    obs.configure(enabled=True)
    out = fold_stats("sharded", tree)
    assert out == tree and out is not tree
    assert type(out["io"]["read_ops"]) is int and type(out["io"]["frac"]) is float
    assert out["shards"]["fill"] is tree["shards"]["fill"]
    g = obs.get_registry().get("f2_stats_shards_selector")
    assert g.labels(facade="sharded").value == "round_robin"


CHROME_COMPLETE_KEYS = {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"}


def _validate_chrome_trace(doc: dict):
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "i"), ev
        if ev["ph"] == "X":
            assert CHROME_COMPLETE_KEYS <= set(ev), ev
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        json.dumps(ev)


def test_span_emits_chrome_complete_event(tmp_path):
    obs.configure(enabled=True)
    with obs.span("unit.work", cat="test", n=3):
        pass
    obs.instant("unit.marker", cat="test")
    doc = obs.trace.TRACER.snapshot()
    _validate_chrome_trace(doc)
    ev = doc["traceEvents"][0]
    assert (ev["name"], ev["cat"], ev["args"]) == ("unit.work", "test", {"n": 3})
    with open(obs.trace.TRACER.save(str(tmp_path / "trace.json"))) as f:
        _validate_chrome_trace(json.load(f))


def test_traced_decorator_and_capacity_bound():
    obs.configure(enabled=True)

    @obs.traced("unit.fn", cat="test")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    assert obs.trace.TRACER.snapshot()["traceEvents"][-1]["name"] == "unit.fn"
    tr = Tracer(capacity=4)
    for i in range(6):
        with tr.span(f"s{i}"):
            pass
    assert len(tr) == 4 and tr.dropped == 2
    assert tr.snapshot()["otherData"]["dropped"] == 2


def test_journal_bounded_eviction_and_filters():
    j = Journal(capacity=8)
    for i in range(20):
        j.emit("unit.tick", i=i)
    assert len(j) == 8 and j.total == 20 and j.dropped == 12
    assert [e["seq"] for e in j.events()] == list(range(12, 20))
    snap = j.snapshot()
    assert (snap["capacity"], snap["total"], snap["dropped"]) == (8, 20, 12)
    j = Journal()
    j.emit("compaction.hot_cold", facade="kv")
    j.emit("compaction.chunk_gc", facade="kv")
    j.emit("rebalance.migrated", buckets=2)
    assert [e["kind"] for e in j.events("compaction.")] == [
        "compaction.hot_cold", "compaction.chunk_gc"]
    assert len(j.events("rebalance.migrated")) == 1
    assert j.kinds() == ["compaction.hot_cold", "compaction.chunk_gc",
                         "rebalance.migrated"]


def test_compaction_emits_journal_and_counter():
    obs.configure(enabled=True)
    kv = T.KV(tcfg(), trigger=0.6, compact_batch=64, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(8):
        keys = rng.integers(1, 400, B).astype(np.int32)
        kv.upsert(keys, rng.integers(0, 100, (B, V)).astype(np.int32))
    kinds = obs.journal.events("compaction.")
    assert kinds, "no compaction fired under trigger=0.6"
    total = sum(c.value for _, c in
                obs.get_registry().get("f2_compactions_total").samples())
    assert total == len(kinds)


def test_store_run_produces_valid_trace():
    obs.configure(enabled=True)
    kv = T.ShardedKV(tcfg(), 2, trigger=0.6, compact_batch=64, device="cpu")
    _drive(kv)
    doc = obs.trace.TRACER.snapshot()
    assert "sharded.apply_round" in {ev["name"] for ev in doc["traceEvents"]}
    _validate_chrome_trace(doc)


def test_chain_hops_histogram():
    kv = T.KV(tcfg(), trigger=2.0, device="cpu")
    keys = np.arange(1, 129, dtype=np.int32)
    kv.upsert(keys, np.stack([keys] * V, 1).astype(np.int32))
    hops_off = kv.chain_hops(keys)
    assert obs.get_registry().get("f2_chain_hops") is None
    obs.configure(enabled=True)
    np.testing.assert_array_equal(hops_off, kv.chain_hops(keys))
    assert obs.get_registry().get("f2_chain_hops").labels(facade="kv").count == len(keys)


def test_prometheus_text_format():
    obs.configure(enabled=True)
    obs.count("f2_unit_total", 3, facade="kv")
    obs.gauge_set("f2_unit_fill", [0.5, 1.5], facade="kv")
    obs.gauge_set("f2_unit_mode", "round_robin", facade="kv")
    obs.observe("f2_unit_rounds", [1, 3], buckets=(1.0, 2.0, 4.0), facade="kv")
    text = export.prometheus_text()
    assert '# TYPE f2_unit_total counter' in text
    assert 'f2_unit_total{facade="kv"} 3' in text
    assert 'f2_unit_fill{facade="kv",idx="0"} 0.5' in text
    assert "f2_unit_mode{" not in text
    assert 'f2_unit_rounds_bucket{facade="kv",le="1"} 1' in text
    assert 'f2_unit_rounds_bucket{facade="kv",le="+Inf"} 2' in text
    assert 'f2_unit_rounds_count{facade="kv"} 2' in text
    assert text.endswith("\n")


def test_bench_envelope_snapshot_and_summarize(tmp_path):
    obs.configure(enabled=True)
    obs.count("f2_unit_total", 2, facade="kv")
    obs.observe("f2_unit_rounds", [1, 1, 9], buckets=(1.0, 2.0, 4.0), facade="kv")
    obs.journal.emit("compaction.hot_cold", facade="kv", records=8)
    path = str(tmp_path / "BENCH_unit.json")
    export.write_bench_json(path, bench="unit", config={"tiny": True},
                            results={"ops_per_s": 1e4})
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == {"schema_version", "bench", "config", "git_sha",
                       "results", "metrics_snapshot"}
    assert doc["schema_version"] == export.SCHEMA_VERSION and doc["bench"] == "unit"
    with open(export.save_snapshot(str(tmp_path / "obs.json"))) as f:
        snap = json.load(f)
    assert snap["journal"]["total"] == 1
    out = summarize(snap)
    assert "f2_unit_total{facade=kv} = 2" in out
    assert "compaction.hot_cold x1" in out
    assert "p99<=inf" in out
    assert "f2_unit_total" in summarize(snap["metrics"])
    assert "bench: unit" in summarize(doc)
    assert summarize({}) == "(empty snapshot)"


# ---------------------------------------------------------------------------
# cross-package parity of the fold points
# ---------------------------------------------------------------------------

def _spilled_cfg_kw():
    """tests/test_durability.py::make_host_store's rings (a uniform mixed
    stream spills within ~20 batches of 64), the plain single-pass engine."""
    return dict(hot_capacity=1 << 8, hot_mem=1 << 5, cold_capacity=1 << 8,
                host_tier=True, host_chunk_records=16, host_cache_chunks=48,
                host_resident_frac=0.5, host_prefetch=1, engine="fused_ref")


def _build(pkg, name, tmp):
    """One facade of the reference (`pkg` "jax") or the port ("torch")."""
    ref = pkg == "jax"
    cfg = tiny_cfg() if ref else tcfg()
    kw = dict(trigger=0.6, compact_batch=64)
    if ref:
        kw["donate"] = False
    else:
        kw["device"] = "cpu"
    if name == "kv":
        return (J.KV if ref else T.KV)(cfg, **kw)
    if name == "sharded":
        return (JShardedKV if ref else T.ShardedKV)(cfg, 4, **kw)
    if name == "replicated":
        return (JReplicatedKV if ref else T.ReplicatedKV)(cfg, 2, n_replicas=2, **kw)
    if name == "sessions":
        ss = jss if ref else tss
        return ss.make_session_service(cfg, ss.ServiceConfig(
            n_shards=2, lanes=32, max_sessions=2, session_depth=32,
            store_kwargs=kw))
    if name == "durable":
        d = tmp / pkg
        d.mkdir()
        # blocking snapshots: a non-blocking one's `snapshot.committed`
        # comes from the checkpointer's thread, its place in the journal a
        # race in either package
        dc = (JDurabilityConfig if ref else T.DurabilityConfig)(
            dir=str(d), snapshot_every_rounds=4, blocking_snapshots=True)
        return (JDurableKV if ref else T.DurableKV)(
            (JShardedKV if ref else T.ShardedKV)(cfg, 4, **kw), dc)
    assert name == "spilled"
    hk = _spilled_cfg_kw()
    if ref:
        hk["engine"] = interop.ENGINE_TO_REFERENCE[hk["engine"]]
        return J.KV(tiny_cfg(**hk), compact_batch=128, compact_frac=0.25,
                    donate=False)
    return T.KV(tcfg(**_spilled_cfg_kw()), compact_batch=128, compact_frac=0.25,
                device="cpu")


def _drive_spilled(store):
    """Uniform mixed batches until the cold log spills and then some, a
    cold->cold pass, and a read-back of every key in slices."""
    rng = np.random.default_rng(11)
    outs = []
    for step in range(30):
        keys, ops, vals = gen_batch(rng, step, n_keys=400)
        outs.append(tuple(as_np(x) for x in store.apply(keys, ops, vals)))
    store.compact_cold_cold()
    for off in range(0, 400, 50):
        outs.append(tuple(as_np(x) for x in store.read(np.arange(off + 1, off + 51,
                                                                 dtype=np.int32))))
    return outs


def _run(pkg, name, tmp):
    """One facade of one package driven with its obs on: (outputs, stats,
    the registry snapshot, journal kinds, span names, the journal)."""
    o = jobs if pkg == "jax" else obs
    o.configure(enabled=True, reset=True)
    store = _build(pkg, name, tmp)
    outs = (_drive_spilled if name == "spilled" else _drive)(store)
    if name == "durable":
        store.snapshot()
    st = store.stats()
    snap = o.export.metrics_snapshot()
    kinds = o.journal.kinds()
    spans = collections.Counter(e["name"] for e in o.trace.TRACER.snapshot()["traceEvents"])
    events = o.journal.events()
    if name == "spilled":
        assert store._ht.stats()["demotions_total"] > 0
        assert store._ht.stats()["promotions_total"] > 0
    if name == "durable":
        store.close() if pkg == "torch" else store.ckpt.wait()
    o.configure(enabled=False, reset=True)
    return dict(outs=[tuple(as_np(x) for x in out) for out in outs], stats=st,
                snap=snap, kinds=kinds, spans=spans, events=events)


def metric_view(snap) -> dict:
    """{(name, labels): value}: counters and gauges by value, count
    histograms by count, sum and buckets, timing histograms by count."""
    out = {}
    for name, m in snap.items():
        for s in m["samples"]:
            key = (name, tuple(sorted(s["labels"].items())))
            if m["type"] != "histogram":
                out[key] = s["value"]
            elif name in TIMING:
                out[key] = s["count"]
            else:
                out[key] = (s["count"], s["sum"], s["bucket_counts"])
    return out


FACADES = ["kv", "sharded", "replicated", "sessions", "durable", "spilled"]
_RUNS = {}


def _runs(name, tmp_path_factory):
    """Both packages' runs of one facade, once per test process."""
    if name not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"obs_{name}")
        _RUNS[name] = {pkg: _run(pkg, name, tmp) for pkg in ("jax", "torch")}
    return _RUNS[name]


@pytest.mark.parametrize("name", FACADES)
def test_fold_points_match_the_reference(name, tmp_path_factory):
    r = _runs(name, tmp_path_factory)
    j, t = r["jax"], r["torch"]
    for (sa, va), (sb, vb) in zip(j["outs"], t["outs"]):
        np.testing.assert_array_equal(sa.astype(np.int32), sb)
        np.testing.assert_array_equal(va.astype(np.int32), vb)
    mj, mt = metric_view(j["snap"]), metric_view(t["snap"])
    assert sorted(mj) == sorted(mt), set(mj) ^ set(mt)
    bad = {k: (mj[k], mt[k]) for k in mj if mj[k] != mt[k]}
    assert not bad, bad
    assert j["kinds"] == t["kinds"]
    assert j["spans"] == t["spans"]
    assert j["stats"] == t["stats"]
    _assert_same_leaf_types(j["stats"], t["stats"])
    # the events' fields too, but for the wall-clock ones
    drop = ("ts", "seconds")
    assert ([{k: v for k, v in e.items() if k not in drop} for e in j["events"]]
            == [{k: v for k, v in e.items() if k not in drop} for e in t["events"]])


@pytest.mark.parametrize("name", FACADES)
def test_bench_envelopes_diff_with_no_counter_delta(name, tmp_path_factory):
    """An envelope from each package, its results every counter, gauge
    and count histogram of the run by name and labels: `report.diff` finds
    no delta between them."""
    r = _runs(name, tmp_path_factory)

    def results(snap):
        return {f"{n}{{{','.join(f'{k}={v}' for k, v in labels)}}}": val
                for (n, labels), val in metric_view(snap).items()
                if n not in TIMING}
    a = jobs.export.bench_envelope("obs_parity", {"facade": name},
                                   results(r["jax"]["snap"]))
    b = export.bench_envelope("obs_parity", {"facade": name},
                              results(r["torch"]["snap"]))
    assert any(k.startswith("f2_stats_io_") for k in a["results"])
    out = report.diff(a, b)
    assert "results: identical" in out and "config drift: none" in out, out


@pytest.mark.parametrize("name", FACADES)
def test_port_obs_on_and_off_bit_exact(name, tmp_path):
    """The port with obs off against its obs-on run: outputs and `stats()`
    bit for bit, leaf types too; off, nothing reaches the registry."""
    (tmp_path / "on").mkdir()
    (tmp_path / "off").mkdir()
    on = _run("torch", name, tmp_path / "on")
    obs.configure(enabled=False, reset=True)
    store = _build("torch", name, tmp_path / "off")
    outs = (_drive_spilled if name == "spilled" else _drive)(store)
    if name == "durable":
        store.snapshot()
    st = store.stats()
    if name == "durable":
        store.close()
    for (sa, va), (sb, vb) in zip(on["outs"], outs):
        np.testing.assert_array_equal(sa, as_np(sb))
        np.testing.assert_array_equal(va, as_np(vb))
    assert st == on["stats"]
    _assert_same_leaf_types(on["stats"], st)
    assert obs.get_registry().names() == [] and len(obs.journal.JOURNAL) == 0
    assert len(obs.trace.TRACER) == 0


def test_resync_parity_names_its_exceptions():
    """A load, a drop, writes and a resync whose replay fires the pressure
    scheduler (tests/test_torch_replication.py::test_resync_replay_matches_
    reference's store) on both packages with obs on.  Equal: the reads of
    the resynced replica, `stats()` (per-row compaction counts included),
    and everything observed before the resync.  The one named exception:
    inside the resync the port replays a slab per shard a round
    (`replication._replay`) where the reference replays batch by batch, so
    its replay's scheduler passes are grouped otherwise: the
    `compaction.*` events, `compact.*` spans and `f2_compactions_total`
    increments of the resync differ in number, while the row-passes they
    cover (the events' `shards` summed) are the same.  All else observed
    in the resync is equal: its span, its `replica.resynced` event and
    counter, the fan-out gauges."""
    res = {}
    kw = dict(mode="f2", trigger=0.3, lanes=24, compact_frac=0.1,
              compact_batch=16)
    for pkg, o in (("jax", jobs), ("torch", obs)):
        o.configure(enabled=True, reset=True)
        if pkg == "jax":
            kv = JReplicatedKV(tiny_cfg(), 4, n_replicas=2, donate=False,
                               rebalance_cfg=J.RebalanceConfig(
                                   enabled=False, migrate_batch=128), **kw)
        else:
            kv = T.ReplicatedKV(tcfg(), 4, n_replicas=2, device="cpu",
                                rebalance_cfg=T.RebalanceConfig(
                                    enabled=False, migrate_batch=128), **kw)
        rng = np.random.default_rng(6)
        for _ in range(10):
            keys = rng.permutation(1200)[:128].astype(np.int32)
            kv.apply(keys, np.full(128, J.OP_UPSERT, np.int32),
                     rng.integers(0, 100, (128, V)).astype(np.int32))
        kv.drop_replica(1)
        keys = rng.integers(0, 1200, 128).astype(np.int32)
        kv.apply(keys, rng.choice([J.OP_READ, J.OP_UPSERT, J.OP_RMW, J.OP_DELETE], 128,
                                  p=[.25, .45, .15, .15]).astype(np.int32),
                 rng.integers(0, 100, (128, V)).astype(np.int32))
        before = dict(snap=metric_view(o.export.metrics_snapshot()),
                      events=o.journal.events(),
                      spans=collections.Counter(
                          e["name"] for e in o.trace.TRACER.snapshot()["traceEvents"]))
        n = kv.resync(1)
        st, v = kv.read(np.arange(1200, dtype=np.int32), replica=1)
        res[pkg] = dict(
            n=n, out=(as_np(st), as_np(v)), stats=kv.stats(), before=before,
            snap=metric_view(o.export.metrics_snapshot()),
            events=o.journal.events()[len(before["events"]):],
            spans=collections.Counter(
                e["name"] for e in o.trace.TRACER.snapshot()["traceEvents"]))
        o.configure(enabled=False, reset=True)
    j, t = res["jax"], res["torch"]
    assert j["n"] == t["n"] > 0
    np.testing.assert_array_equal(j["out"][0].astype(np.int32), t["out"][0])
    np.testing.assert_array_equal(j["out"][1].astype(np.int32), t["out"][1])
    assert j["stats"] == t["stats"]
    _assert_same_leaf_types(j["stats"], t["stats"])
    # before the resync: everything equal
    assert j["before"]["snap"] == t["before"]["snap"]
    assert j["before"]["spans"] == t["before"]["spans"]
    assert ([e["kind"] for e in j["before"]["events"]]
            == [e["kind"] for e in t["before"]["events"]])

    # the resync: passes fired inside it, grouped otherwise, the same
    # row-passes in all
    def passes(events):
        return [e for e in events if e["kind"].startswith("compaction.")]
    assert passes(j["events"]) and passes(t["events"])
    assert (sum(e["shards"] for e in passes(j["events"]))
            == sum(e["shards"] for e in passes(t["events"])))
    assert ([e["kind"] for e in j["events"] if e not in passes(j["events"])]
            == [e["kind"] for e in t["events"] if e not in passes(t["events"])]
            == ["replica.resynced"])
    assert ({k: c for k, c in j["spans"].items() if not k.startswith("compact.")}
            == {k: c for k, c in t["spans"].items() if not k.startswith("compact.")})
    assert sorted(j["snap"]) == sorted(t["snap"])
    bad = {k: (j["snap"][k], t["snap"][k]) for k in j["snap"]
           if k[0] != "f2_compactions_total" and j["snap"][k] != t["snap"][k]}
    assert not bad, bad


# ---------------------------------------------------------------------------
# alerts and endpoints on the port's fold points
# ---------------------------------------------------------------------------

def test_alert_fires_through_store_fold_points():
    obs.configure(enabled=True, reset=True)
    rules.add_rule("deferral",
                   "count(f2_deferral_rounds{facade=sharded,path=apply}) >= 1")
    kv = T.ShardedKV(tcfg(), 2, trigger=0.6, compact_batch=64, device="cpu")
    keys = np.arange(1, 65, dtype=np.int32)
    kv.upsert(keys, np.stack([keys, keys], 1).astype(np.int32))
    assert not rules.ENGINE.any_firing()
    kv.stats()                              # the fold point runs the engine
    assert rules.ENGINE.any_firing()
    ev = obs.journal.events("alert.fired")
    assert len(ev) == 1 and ev[0]["rule"] == "deferral"
    code, _, body = serve.render("/healthz")
    assert code == 503 and json.loads(body)["firing"] == ["deferral"]


def test_session_fold_runs_the_alert_engine():
    """The session service's fill fold is a fold point too: a rule on its
    packed-lane counter fires there, and `/healthz` reports it."""
    obs.configure(enabled=True, reset=True)
    rules.add_rule("packed", "value(f2_packed_lanes_total{facade=sessions}) >= 1")
    svc = _build("torch", "sessions", None)
    keys = np.arange(1, 33, dtype=np.int32)
    svc.upsert(keys, np.stack([keys, keys], 1).astype(np.int32))
    assert not rules.ENGINE.any_firing()
    svc.stats()
    assert [e["rule"] for e in obs.journal.events("alert.fired")] == ["packed"]
    assert serve.render("/healthz")[0] == 503
