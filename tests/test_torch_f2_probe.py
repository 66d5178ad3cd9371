"""The port's probe and write engines against the JAX package's three
engines ("jnp", "fused_ref", and "fused_pallas" in interpret mode), bit for
bit, on the acceptance distributions of tests/test_probe_engine.py and
tests/test_write_engine.py at B = 77.

On the CPU the port runs its plain single-pass versions (`ref.py`, also
reached through the `ops.py` wrappers) and its unfused oracle.  The CUDA
kernels run only on a card: tests/test_torch_cuda.py holds them against
the plain versions there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (OP_DELETE, OP_READ, OP_RMW, OP_UPSERT,  # noqa: E402
                        cold_index as jci, hybrid_log as jlog,
                        probe_engine as jpe, write_engine as jwe)
from repro.core.types import IoStats as JIo  # noqa: E402
from repro_torch.core import (hybrid_log as tlog, probe_engine as tpe,  # noqa: E402
                              write_engine as twe)
from repro_torch.kernels.f2_probe import ops as tops, ref as tref  # noqa: E402
from torch_parity import (assert_same, colliding_keys, configs,  # noqa: E402
                          reference_kv, t, to_port)

# jitted once per module, so each (engine, mode) compiles once for all cases
_jprobe = jax.jit(jpe.probe, static_argnames=("cfg", "rc_match", "engine"))
_jplan = jax.jit(jwe.plan, static_argnames=("cfg", "engine"))

B = 77
JAX_ENGINES = ("jnp", "fused_ref", "fused_pallas")
PORT_ENGINES = ("unfused", "fused_ref", "fused")


@pytest.fixture(scope="module")
def cfgs():
    return configs(chain_max=64, hot_mutable_frac=0.5)


@pytest.fixture(scope="module")
def jstate(cfgs):
    """One reference store for every case of this file: the stored keys of
    all distributions, with hot in-memory, stable-tier and cold records,
    read-cache replicas, tombstones, and superseded (dead) records."""
    jcfg, _ = cfgs
    keys = np.unique(np.concatenate([
        np.arange(300), colliding_keys(jcfg.hot_index_size, 32)])).astype(np.int32)
    kv = reference_kv(jcfg, mode="f2", trigger=2.0)
    kv.upsert(keys, np.stack([keys] * jcfg.value_width, 1) + 1)
    kv.compact_hot_cold(int(kv.state.hot.tail) // 2)
    kv.read(keys[: len(keys) // 2])
    kv.delete(keys[::7])
    kv.upsert(keys[::3], np.full((len(keys[::3]), jcfg.value_width), 9, np.int32))
    return kv.state


def _to_b(q):
    """A B-lane query: the head and the tail of the list (stored and absent
    keys), repeated if the list is short."""
    q = np.asarray(q, np.int32)
    if len(q) > B:
        q = np.concatenate([q[:B - 17], q[-17:]])
    return np.resize(q, B).astype(np.int32)


def _probe_queries(jcfg):
    """tests/test_probe_engine.py's query distributions at B lanes."""
    rng = np.random.default_rng(0)
    uniform = rng.permutation(np.arange(300)).astype(np.int32)
    collide = colliding_keys(jcfg.hot_index_size, 24)
    return {"uniform": _to_b(np.concatenate([uniform[:96], np.arange(9000, 9032)])),
            "all_colliding_slot": _to_b(np.concatenate([collide, collide[:8]])),
            "zipf_duplicates": _to_b(np.minimum(rng.zipf(1.3, 128), 300))}


def _port_probe_results(tcfg, keys, log, lower, hb, act, **kw):
    """The port's ProbeResult from every CPU route: each engine, the plain
    body called directly, and the kernel wrapper (plain on the CPU)."""
    out = {e: tpe.probe(tcfg, keys, log, lower, hb, act, engine=e, **kw)
           for e in PORT_ENGINES}
    rc = kw.get("rc") or tpe.dummy_rc(tcfg.value_width, keys.device)
    index = kw.get("index")
    args = (keys, index if index is not None else kw["heads"], lower, act, hb,
            log.key, log.val, log.prev, log.meta, rc.key, rc.val, rc.prev,
            rc.meta)
    flags = dict(chain_max=tcfg.chain_max, rc_match=kw.get("rc_match", True),
                 has_rc=kw.get("rc") is not None, probe_index=index is not None,
                 target=kw.get("target"))
    for name, fn in (("ref_body", tref.fused_probe_body),
                     ("ref_body_early_exit",
                      lambda *a, **k: tref.fused_probe_body(*a, early_exit=True, **k)),
                     ("ops_wrapper", tops.fused_probe)):
        f, addr, heads, value, meta, hops, ios, exh = fn(*args, **flags)
        n_io = ios.sum(dtype=torch.int32)
        out[name] = tpe.ProbeResult(f, addr, heads, value, meta, hops, n_io,
                                    n_io, hops.sum(dtype=torch.int32) - n_io, exh)
    return out


def _assert_all_agree(jres, tres, ctx):
    want = jres["jnp"]
    for e, r in jres.items():
        assert_same(want, r, f"{ctx}/jax:{e}")
    for e, r in tres.items():
        assert_same(want, r, f"{ctx}/port:{e}")


@pytest.mark.parametrize("rc_match", [True, False], ids=["read", "liveness"])
@pytest.mark.parametrize("dist", ["uniform", "all_colliding_slot",
                                  "zipf_duplicates"])
def test_probe_index_mode_parity(cfgs, jstate, dist, rc_match):
    jcfg, tcfg = cfgs
    q = _probe_queries(jcfg)[dist]
    jst, tst = jstate, to_port(jstate)
    lower = jnp.broadcast_to(jst.hot.begin, (B,))
    hb = jlog.head_addr(jst.hot, jcfg.hot_mem)
    act = np.ones(B, bool)
    act[::9] = False
    jres = {e: _jprobe(jcfg, jnp.asarray(q), jst.hot, lower, hb,
                         jnp.asarray(act), index=jst.hot_index, rc=jst.rc,
                         rc_match=rc_match, engine=e) for e in JAX_ENGINES}
    tres = _port_probe_results(tcfg, t(q), tst.hot, t(lower), t(hb), t(act),
                               index=tst.hot_index, rc=tst.rc,
                               rc_match=rc_match)
    _assert_all_agree(jres, tres, dist)
    assert int(np.sum(np.asarray(jres["jnp"].found))) > 0


def test_probe_cold_heads_mode_parity(cfgs, jstate):
    """heads= mode over cold-index chains, no read cache."""
    jcfg, tcfg = cfgs
    jst, tst = jstate, to_port(jstate)
    q = _to_b(np.concatenate([np.arange(96), np.arange(8000, 8032)]))
    act = jnp.ones((B,), bool)
    entries, _ = jci.find_entries(jst.cold_idx, jcfg, jnp.asarray(q), act,
                                  JIo.zeros())
    lower = jnp.broadcast_to(jst.cold.begin, (B,))
    hb = jlog.head_addr(jst.cold, jcfg.cold_mem)
    jres = {e: _jprobe(jcfg, jnp.asarray(q), jst.cold, lower, hb, act,
                         heads=entries, rc=None, engine=e) for e in JAX_ENGINES}
    tres = _port_probe_results(tcfg, t(q), tst.cold, t(lower), t(hb), t(act),
                               heads=t(entries))
    _assert_all_agree(jres, tres, "cold_heads")
    assert int(np.sum(np.asarray(jres["jnp"].found))) > 0


@pytest.mark.parametrize("which", ["hot", "cold"])
def test_probe_target_mode_parity(cfgs, jstate, which):
    """The compaction liveness probe: target = the frontier's addresses, on
    frontiers holding live, superseded and tombstone records."""
    jcfg, tcfg = cfgs
    jst, tst = jstate, to_port(jstate)
    log = getattr(jst, which)
    addrs = jnp.asarray(log.begin + np.arange(B, dtype=np.int32))
    k, _, _, meta = jlog.gather(log, addrs)
    m = (addrs < log.tail) & ((meta & 2) == 0)
    if which == "hot":
        hb = jlog.head_addr(log, jcfg.hot_mem)
        jkw = dict(index=jst.hot_index, rc=jst.rc, rc_match=False, target=addrs)
        tkw = dict(index=tst.hot_index, rc=tst.rc, rc_match=False, target=t(addrs))
    else:
        hb = jlog.head_addr(log, jcfg.cold_mem)
        ent, _ = jci.find_entries(jst.cold_idx, jcfg, k, m, JIo.zeros())
        jkw = dict(heads=ent, rc=None, target=addrs)
        tkw = dict(heads=t(ent), target=t(addrs))
    jres = {e: _jprobe(jcfg, k, log, addrs, hb, m, engine=e, **jkw)
            for e in JAX_ENGINES}
    tres = _port_probe_results(tcfg, t(k), getattr(tst, which), t(addrs),
                               t(hb), t(m), **tkw)
    _assert_all_agree(jres, tres, which)
    r = jres["jnp"]
    live = int(np.asarray(r.found & (r.addr == addrs)).sum())
    # superseded and deleted hot records are dead; cold records here are not
    assert 0 < live < int(np.asarray(m).sum()) if which == "hot" else live > 0


def _write_batches(jcfg):
    """tests/test_write_engine.py's distributions at B lanes, then one key
    in every lane (mixed ops, values near +-2^31 so its RMW sums wrap) and
    a Zipf-0.99 batch over the keyspace the store holds (YCSB's skew)."""
    rng = np.random.default_rng(0)

    def mk(keys, ops, vals=None):
        if vals is None:
            vals = rng.integers(0, 100, (B, jcfg.value_width)).astype(np.int32)
        return (np.resize(np.asarray(keys, np.int32), B),
                np.resize(np.asarray(ops, np.int32), B), vals)

    near = rng.integers(0, 97, (B, jcfg.value_width))
    wrap = np.where(near < 12, -2**31 + near, 2**31 - 1 - near).astype(np.int32)
    hot_ops = rng.choice([OP_UPSERT, OP_RMW, OP_RMW, OP_RMW, OP_DELETE], B)
    hot_ops[-9:] = OP_RMW        # RMWs after the last set
    ranks = np.arange(1, 301, dtype=np.float64) ** -0.99
    zipf = rng.choice(300, B, p=ranks / ranks.sum())

    collide = colliding_keys(jcfg.hot_index_size, 32)
    return {
        "uniform_mixed": mk(rng.integers(0, 300, B),
                            rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                                       p=[.2, .3, .3, .2])),
        "duplicate_keys": mk(rng.permutation(np.repeat(rng.integers(0, 24, 10), 8)),
                             rng.choice([OP_UPSERT, OP_RMW, OP_DELETE], 80)),
        "all_colliding_slot": mk(np.concatenate([collide, collide[:16]]),
                                 rng.choice([OP_UPSERT, OP_RMW, OP_DELETE], 48)),
        "rmw_after_delete": mk(np.repeat(np.arange(13), 6),
                               np.tile([OP_DELETE, OP_RMW, OP_RMW, OP_UPSERT,
                                        OP_DELETE, OP_RMW], 13)),
        "pure_rmw_created": mk(np.concatenate([np.arange(0, 39), np.arange(9000, 9038)]),
                               np.full(B, OP_RMW)),
        "one_hot_key": mk(np.full(B, 7), hot_ops, wrap),
        "zipf_099": mk(zipf, rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], B,
                                        p=[.5, .2, .2, .1])),
    }


@pytest.mark.parametrize("dist", ["uniform_mixed", "duplicate_keys",
                                  "all_colliding_slot", "rmw_after_delete",
                                  "pure_rmw_created", "one_hot_key", "zipf_099"])
def test_write_plan_parity(cfgs, jstate, dist):
    jcfg, tcfg = cfgs
    keys, ops, vals = _write_batches(jcfg)[dist]
    jst, tst = jstate, to_port(jstate)
    jres = {e: _jplan(jcfg, jnp.asarray(keys), jnp.asarray(ops),
                        jnp.asarray(vals), jst.hot, jst.hot_index, jst.rc,
                        engine=e) for e in JAX_ENGINES}
    tres = {e: twe.plan(tcfg, t(keys), t(ops), t(vals), tst.hot, tst.hot_index,
                        tst.rc, engine=e) for e in PORT_ENGINES}
    hot = tst.hot
    bounds = (hot.begin, tlog.head_addr(hot, tcfg.hot_mem),
              tlog.read_only_addr(hot, tcfg.hot_mem, tcfg.hot_mutable_frac),
              hot.tail)
    cols = (hot.key, hot.val, hot.prev, hot.meta,
            tst.rc.key, tst.rc.val, tst.rc.prev, tst.rc.meta)
    for name, fn in (("ref_body", tref.fused_write_body),
                     ("ops_wrapper", tops.fused_write)):
        out = fn(t(keys), t(ops), t(vals), tst.hot_index, *bounds, *cols,
                 chain_max=tcfg.chain_max)
        n_io = out[17].sum(dtype=torch.int32)
        tres[name] = twe.WritePlan(*out[:17], n_io, n_io,
                                   out[16].sum(dtype=torch.int32) - n_io, out[18])
    _assert_all_agree(jres, tres, dist)
    rep = np.asarray(jres["jnp"].rep)
    assert rep.sum() > 0
    if dist in ("duplicate_keys", "zipf_099"):
        assert rep.sum() < B
    if dist == "one_hot_key":
        assert rep.sum() == 1
        # the RMWs after the last set sum beyond int32, so the plans must wrap
        last_set = np.flatnonzero(ops != OP_RMW).max()
        assert int(vals[last_set + 1:, 0].astype(np.int64).sum()) > 2**31


# --- the legacy first-hop probe (tests/test_kernels.py::test_f2_probe) -----

@pytest.mark.parametrize("E,nb", [(1 << 12, 2048), (1 << 10, 1024), (1 << 9, 77)])
def test_first_hop_probe_parity(E, nb):
    """Bit-exact against the reference's `probe_ref` and its Pallas kernel in
    interpret mode, on indexes with every seventh entry RC-tagged (NULL
    entries stay NULL under the tag)."""
    from repro.kernels.f2_probe import ops as jfp
    rng = np.random.default_rng(E + nb)
    idx = rng.integers(-1, 1000, (E,)).astype(np.int32)
    idx[1::5] = -1
    idx[::7] |= 1 << 30
    keys = rng.integers(0, 1 << 30, (nb,)).astype(np.int32)
    got = tops.probe(t(keys), t(idx))
    assert_same(got, tref.probe_reference(t(keys), t(idx)))
    assert_same(got, tuple(jfp.probe_ref(jnp.asarray(keys), jnp.asarray(idx))))
    if nb % 1024 == 0:      # the Pallas kernel tiles the batch by 1024
        assert_same(got, tuple(jfp.probe(jnp.asarray(keys), jnp.asarray(idx),
                                         interpret=True)))
    assert int(got[1].sum()) > 0 and int((got[0] == -1).sum()) > 0


def test_index_heads_retag_the_first_hop(cfgs, jstate):
    """The two-phase read's snapshot (`index_heads`) equals a plain gather of
    the index entries, RC tags included, with every engine."""
    jcfg, tcfg = cfgs
    st = to_port(jstate)
    keys = torch.arange(-40, 600, dtype=torch.int32)
    want = st.hot_index[tref._mix(keys) & (st.hot_index.shape[0] - 1)]
    assert bool(((want >= 0) & ((want & (1 << 30)) != 0)).any())
    for engine in PORT_ENGINES:
        cfg = dataclasses.replace(tcfg, engine=engine)
        assert_same(tpe.index_heads(cfg, st.hot_index, keys), want, engine)


def _probe_check_inputs(B=5, C=16, R=8, V=3, E=32):
    i32 = torch.int32
    cols = (torch.zeros(C, dtype=i32), torch.zeros((C, V), dtype=i32),
            torch.zeros(C, dtype=i32), torch.zeros(C, dtype=i32),
            torch.zeros(R, dtype=i32), torch.zeros((R, V), dtype=i32),
            torch.zeros(R, dtype=i32), torch.zeros(R, dtype=i32))
    return dict(keys=torch.zeros(B, dtype=i32), heads_src=torch.zeros(E, dtype=i32),
                lower=torch.zeros(B, dtype=i32), active=torch.ones(B, dtype=torch.bool),
                hb=torch.zeros(1, dtype=i32), cols=cols,
                target=torch.zeros(B, dtype=i32), probe_index=True)


@pytest.mark.parametrize("fault,error,match", [
    ("dtype", TypeError, "dtype"),
    ("shape", ValueError, "shape"),
    ("contiguity", ValueError, "not contiguous"),
    ("pow2", ValueError, "power of two"),
    ("active", TypeError, "dtype"),
])
def test_fused_probe_input_checks_refuse_each_fault(fault, error, match):
    """The kernel wrapper's input checks (`_check_probe_inputs`) pass good
    inputs and refuse a wrong dtype, shape, layout, capacity or mask."""
    kw = _probe_check_inputs()
    assert tops._check_probe_inputs(**kw) == (5, 32, 16, 8, 3)
    cols = list(kw["cols"])
    if fault == "dtype":
        cols[2] = cols[2].to(torch.int64)
    elif fault == "shape":
        cols[5] = torch.zeros((8, 4), dtype=torch.int32)
    elif fault == "contiguity":
        cols[1] = torch.zeros((3, 16), dtype=torch.int32).t()
    elif fault == "pow2":
        cols[0] = torch.zeros(12, dtype=torch.int32)
    else:
        kw["active"] = kw["active"].to(torch.int32)
    kw["cols"] = tuple(cols)
    with pytest.raises(error, match=match):
        tops._check_probe_inputs(**kw)
