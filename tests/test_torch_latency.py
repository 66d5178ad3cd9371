"""Request latency in the PyTorch port (`repro_torch.obs.latency`, `rules`,
`serve`): the reference's contract (tests/test_latency.py) against the
port's copy, the ticket clock fed torch tensors through the session
service's one-copy fetch, and the ticket lifecycle oracle of
tests/test_sessions.py on the port's session service.

The estimator contract: `quantile()` over log-bucketed counts is within
one bucket ratio (10^(1/per_decade)) of `numpy.percentile` on the raw
samples, for any sample set inside the bucket range."""
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop, obs  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.obs import latency, rules, serve  # noqa: E402
from repro_torch.obs.latency import (LATENCY_LOG_BUCKETS, DecayingQuantile,  # noqa: E402
                                     TicketClock, log_buckets, quantile,
                                     quantiles)
from repro_torch.obs.rules import AlertEngine, Rule, RuleError  # noqa: E402
from repro_torch.serve.sessions import KVSessionService, fetch_tickets  # noqa: E402
from test_sessions import _drive_for_clock, tiny_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.configure(enabled=False, reset=True)
    yield
    obs.configure(enabled=False, reset=True)


def _bin_counts(values, edges):
    """Bucket raw samples the way the histogram would."""
    counts = [0] * (len(edges) + 1)
    for v in values:
        i = 0
        for e in edges:
            if v <= e:
                break
            i += 1
        counts[i] += 1
    return counts


# ---------------------------------------------------------------------------
# the quantile estimator against numpy.percentile
# ---------------------------------------------------------------------------

def _check_estimator(values, per_decade=5, qs=(0.5, 0.95, 0.99, 0.999)):
    edges = log_buckets(1e-6, 10.0, per_decade)
    counts = _bin_counts(values, edges)
    ratio = 10.0 ** (1.0 / per_decade)
    for q in qs:
        est = quantile(edges, counts, q)
        true = float(np.percentile(values, q * 100.0, method="inverted_cdf"))
        assert est is not None
        assert true / ratio * (1 - 1e-9) <= est <= true * ratio * (1 + 1e-9), \
            (q, est, true, ratio)


def _lognormal(rng):
    return np.clip(np.exp(rng.normal(-6.0, 1.5, size=500)), 2e-6, 9.0)


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "pareto"])
def test_quantile_matches_numpy_seeded(dist):
    rng = np.random.default_rng({"lognormal": 11, "uniform": 12, "pareto": 13}[dist])
    for _ in range(5 if dist == "lognormal" else 1):
        vals = {"lognormal": lambda: _lognormal(rng),
                "uniform": lambda: rng.uniform(1e-4, 1e-1, 300),
                "pareto": lambda: np.clip(rng.pareto(1.2, 300) * 1e-4, 2e-6, 9.0)}[dist]()
        _check_estimator(vals)


def test_quantile_empty_degenerate_and_overflow():
    edges = LATENCY_LOG_BUCKETS
    assert quantile(edges, [0] * (len(edges) + 1), 0.5) is None
    counts = _bin_counts([1e-3] * 10, edges)
    est = quantile(edges, counts, 0.5)
    assert est == pytest.approx(1e-3, rel=0.6)
    qs = quantiles(edges, counts)
    assert set(qs) == {"p50", "p95", "p99", "p999"}
    assert all(v == est for v in qs.values())
    assert quantile((1e-3, 1e-2), [0, 0, 7], 0.5) == 1e-2


@pytest.mark.parametrize("per_decade", [1, 3, 5, 9])
def test_log_buckets_strictly_increasing(per_decade):
    e = log_buckets(1e-6, 10.0, per_decade)
    assert all(b > a for a, b in zip(e, e[1:]))
    assert e[0] == pytest.approx(1e-6) and e[-1] == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# decaying live windows (injected clocks)
# ---------------------------------------------------------------------------

def test_decaying_quantile_half_life():
    w = DecayingQuantile(half_life_s=30.0)
    for _ in range(8):
        w.observe(1e-3, now=0.0)
    assert w.total(now=0.0) == pytest.approx(8.0)
    assert w.total(now=30.0) == pytest.approx(4.0)
    assert w.total(now=90.0) == pytest.approx(1.0)
    assert w.quantile(0.5, now=90.0) == pytest.approx(1e-3, rel=0.6)


def test_decaying_quantile_spike_ages_out():
    w = DecayingQuantile(half_life_s=30.0)
    w.observe(1.0, now=0.0)
    for t in range(1, 11):
        w.observe(1e-4, now=300.0 + t)
    assert w.quantile(0.5, now=311.0) == pytest.approx(1e-4, rel=0.6)
    late = w.quantile(0.5, now=4000.0)
    assert late is None or late < 1e-2


def test_observe_phase_feeds_registry_and_live():
    obs.configure(enabled=True, reset=True)
    latency.observe_phase("e2e", 0.01)
    latency.observe_phase("e2e", 0.02)
    s = latency.summary()
    assert s["e2e"]["count"] == 2
    assert s["e2e"]["p50"] == pytest.approx(0.015, rel=0.7)
    assert latency.live_summary()["e2e"]["total"] == pytest.approx(2.0, abs=0.1)
    obs.configure(enabled=False, reset=True)
    latency.observe_phase("e2e", 0.01)
    assert latency.summary() == {} and latency.live_summary() == {}


# ---------------------------------------------------------------------------
# the ticket lifecycle clock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fetch", ["identity", "torch"])
def test_ticket_clock_phases(fetch):
    """The reference's synthetic stamps; with "torch" the rounds are int32
    tensors read through the session service's one-copy fetch."""
    obs.configure(enabled=True, reset=True)
    if fetch == "torch":
        clk = TicketClock(fetch=fetch_tickets)

        def rnd(x):
            return torch.tensor(x, dtype=torch.int32)
    else:
        clk = TicketClock()
        rnd = np.array
    clk.note_enqueue(0, 4, now=10.0)
    clk.note_round(rnd([0, 1, 2, -1]), 10.1, 10.2, 10.5)
    clk.note_enqueue(4, 1, now=10.6)
    clk.note_round(rnd([3, 4, -1, -1]), 10.7, 10.8, 11.0)
    clk.note_collected([0, 1, 2, 3, 4], now=11.5)
    assert clk.outstanding == 0
    s = latency.summary()
    assert s["pack"]["count"] == 2
    assert s["pack"]["mean"] == pytest.approx(0.1, rel=1e-6)
    assert s["queue"]["count"] == s["apply"]["count"] == s["e2e"]["count"] == 5
    e2e_sum = s["e2e"]["mean"] * s["e2e"]["count"]
    part = (s["queue"]["mean"] * s["queue"]["count"]
            + s["apply"]["mean"] * s["apply"]["count"])
    assert e2e_sum >= part * (1 - 1e-9)


def test_ticket_clock_refold_unknown_and_disabled():
    obs.configure(enabled=True, reset=True)
    clk = TicketClock()
    clk.note_enqueue(0, 1, now=0.0)
    clk.note_round(np.array([0]), 0.1, 0.2, 0.3)
    clk.note_round(np.array([0]), 0.4, 0.5, 0.6)    # a re-pack: the first wins
    clk.note_round(np.array([99]), 0.7, 0.8, 0.9)   # never enqueued
    clk.note_collected([0, 77], now=1.0)            # 77 unknown: ignored
    s = latency.summary()
    assert s["queue"]["count"] == 1
    assert s["queue"]["mean"] == pytest.approx(0.2, rel=1e-6)
    assert s["e2e"]["count"] == 1 and clk.outstanding == 0
    obs.configure(enabled=False, reset=True)
    clk = TicketClock()
    clk.note_enqueue(0, 2, now=0.0)
    clk.note_round(np.array([0, 1]), 0.1, 0.2, 0.3)
    clk.note_collected([0, 1], now=0.5)
    assert latency.summary() == {}


def test_fetch_tickets_one_copy_in_round_order():
    """Rounds of any shape come back as flat lists, in round order, from
    one concatenation (on a CUDA device: one device-to-host copy)."""
    rounds = [torch.tensor([[3, -1], [4, 5]], dtype=torch.int32),
              torch.tensor([], dtype=torch.int32),
              torch.tensor([7, -1, -1], dtype=torch.int32)]
    assert fetch_tickets(rounds) == [[3, -1, 4, 5], [], [7, -1, -1]]
    assert all(type(t) is int for t in fetch_tickets(rounds)[0])


def _port_service(S=2, W=8, N=2, C=16):
    """tests/test_sessions.py::make_service in the port, on the CPU."""
    cfg = interop.config_from_dict(dataclasses.asdict(tiny_cfg()))
    store = T.ShardedKV(cfg, S, mode="f2", trigger=0.6, compact_frac=0.3,
                        compact_batch=64, lanes=W, device="cpu")
    svc = KVSessionService(store, max_sessions=N, session_depth=C)
    svc.trace_schedule = True
    return svc


def test_ticket_latency_oracle_and_disabled_bit_exact():
    """tests/test_sessions.py::test_ticket_latency_oracle_and_disabled_bit_
    exact on the port: with obs on, a fully drained run has one queue,
    apply and e2e observation a collected ticket, one pack observation a
    round, every duration positive and the e2e total over queue + apply;
    the obs-off twin gives bit-equal client results and records nothing."""
    svc_off = _port_service()
    outs_off = _drive_for_clock(svc_off, seed=5)
    assert latency.summary() == {}
    obs.configure(enabled=True, reset=True)
    svc_on = _port_service()
    outs_on = _drive_for_clock(svc_on, seed=5)
    for a, b in zip(outs_off, outs_on):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert svc_on._clock.outstanding == 0
    s = latency.summary()
    n = svc_on.collected
    assert n > 0
    assert s["queue"]["count"] == s["apply"]["count"] == s["e2e"]["count"] == n
    assert s["pack"]["count"] == svc_on.pack_rounds
    for phase in ("queue", "apply", "e2e", "pack"):
        assert s[phase]["mean"] > 0.0 and s[phase]["p50"] > 0.0, phase
    assert s["e2e"]["mean"] * n >= (s["queue"]["mean"] + s["apply"]["mean"]) * n * (1 - 1e-9)
    assert obs.journal.kinds().count("session.opened") == 2


# ---------------------------------------------------------------------------
# alert rules
# ---------------------------------------------------------------------------

def test_rule_parse_and_errors():
    r = Rule("t", "p99(f2_latency_seconds{phase=e2e}) > 0.5")
    assert (r.agg, r.metric, r.labels, r.op, r.threshold) == \
        ("p99", "f2_latency_seconds", {"phase": "e2e"}, ">", 0.5)
    Rule("t", "value(f2_host_chunks) >= 1e3")
    for bad in ("p99()", "max(m) > 1", "p99(m) >> 1", "p99(m) > x",
                "p99(m{phase}) > 1", ""):
        with pytest.raises(RuleError):
            Rule("bad", bad)
    with pytest.raises(RuleError):
        Rule("bad", "p99(m) > 1", kind="nope")


def test_threshold_fire_resolve_and_debounce():
    obs.configure(enabled=True, reset=True)
    eng = AlertEngine()
    eng.add("tail", "p99(f2_latency_seconds{phase=e2e}) > 0.1", for_count=2)
    assert eng.evaluate() == []
    latency.observe_phase("e2e", 1.0)
    assert eng.evaluate() == []
    assert [t["event"] for t in eng.evaluate()] == ["fired"]
    assert eng.any_firing()
    ev = obs.journal.events("alert.fired")
    assert len(ev) == 1 and ev[0]["rule"] == "tail"
    for _ in range(500):
        latency.observe_phase("e2e", 1e-4)
    assert [t["event"] for t in eng.evaluate()] == ["resolved"]
    assert not eng.any_firing()
    assert len(obs.journal.events("alert.resolved")) == 1


def test_rate_rule_needs_two_samples():
    obs.configure(enabled=True, reset=True)
    eng = AlertEngine()
    eng.add("r", "rate(f2_test_total) > 10")
    obs.count("f2_test_total", 5)
    assert eng.evaluate(now=0.0) == []
    obs.count("f2_test_total", 100)
    assert [t["event"] for t in eng.evaluate(now=1.0)] == ["fired"]
    assert [t["event"] for t in eng.evaluate(now=2.0)] == ["resolved"]


def test_burn_rate_ewma_smooths():
    obs.configure(enabled=True, reset=True)
    eng = AlertEngine()
    eng.add("b", "value(f2_pressure) > 0.9", kind="burn_rate", alpha=0.5)
    obs.gauge_set("f2_pressure", 1.0)
    assert [t["event"] for t in eng.evaluate()] == ["fired"]
    obs.gauge_set("f2_pressure", 0.0)
    vals = []
    for _ in range(4):
        eng.evaluate()
        vals.append(eng.rules["b"].last_value)
    assert vals == sorted(vals, reverse=True)
    assert vals[-1] < 0.9 and not eng.any_firing()


def test_engine_disabled_is_noop():
    eng = AlertEngine()
    eng.add("t", "value(f2_x) > 0")
    assert eng.evaluate() == [] and eng.evaluations == 0
    rules.maybe_evaluate()
    assert rules.ENGINE.evaluations == 0


# ---------------------------------------------------------------------------
# the endpoints
# ---------------------------------------------------------------------------

def _prom_parseable(text):
    n = 0
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        assert name_part and not name_part.startswith("{"), line
        float(value)
        n += 1
    return n


def test_render_metrics_and_healthz():
    obs.configure(enabled=True, reset=True)
    latency.observe_phase("e2e", 0.01)
    code, ctype, body = serve.render("/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    assert _prom_parseable(body.decode()) > 0
    assert "f2_latency_seconds_bucket" in body.decode()
    code, _, body = serve.render("/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    rules.add_rule("tail", "count(f2_latency_seconds{phase=e2e}) >= 1")
    code, _, body = serve.render("/healthz")
    assert code == 503 and json.loads(body)["firing"] == ["tail"]
    snap = json.loads(serve.render("/snapshot.json")[2])
    assert "live_latency" in snap and snap["alerts"]["rules"][0]["firing"] is True
    assert set(json.loads(serve.render("/trace.json")[2])) >= {"traceEvents"}
    assert serve.render("/nope") is None


def test_serve_real_socket_scrape():
    obs.configure(enabled=True, reset=True)
    latency.observe_phase("fsync", 2e-3)
    srv, thread = serve.start(port=0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.status == 200 and _prom_parseable(r.read().decode()) > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.floats(min_value=2e-6, max_value=9.0,
                              allow_nan=False, allow_infinity=False),
                    min_size=1, max_size=200),
           st.floats(min_value=0.0, max_value=1.0))
    def test_quantile_within_bucket_ratio_property(vals, q):
        counts = _bin_counts(vals, LATENCY_LOG_BUCKETS)
        est = quantile(LATENCY_LOG_BUCKETS, counts, q)
        assert est is not None
        true = float(np.percentile(vals, q * 100.0, method="inverted_cdf"))
        ratio = 10.0 ** (1.0 / 5)
        assert true / ratio * (1 - 1e-9) <= est <= true * ratio * (1 + 1e-9)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_quantile_within_bucket_ratio_property():
        pass
