"""The port's state primitives (hybrid_log, groups, chain, read_cache,
cold_index) against the JAX package's, bit for bit, on random inputs over a
real store state carried into both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT  # noqa: E402
from repro.core.store import hot_slots  # noqa: E402
from repro.core import (chain as jchain, cold_index as jci,  # noqa: E402
                        groups as jgroups, hybrid_log as jlog,
                        read_cache as jrc)
from repro.core.types import IoStats as JIo  # noqa: E402
from repro_torch.core import (chain as tchain, cold_index as tci,  # noqa: E402
                              groups as tgroups, hybrid_log as tlog,
                              read_cache as trc)
from repro_torch.core.types import IoStats as TIo  # noqa: E402
from torch_parity import (assert_same, configs, t, to_port,  # noqa: E402
                          twin_kvs)

CFG_KW = dict(cold_capacity=1 << 12, chunklog_capacity=1 << 9,
              chunklog_mem=1 << 5)


@pytest.fixture(scope="module")
def jstate():
    """A reference store after mixed traffic: hot and cold records,
    stable-tier records, RC replicas, tombstones, truncated logs."""
    jkv, _ = twin_kvs(**CFG_KW)
    rng = np.random.default_rng(7)
    for _ in range(40):
        keys = rng.integers(0, 1500, 96).astype(np.int32)
        ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], 96,
                         p=[.35, .4, .15, .1]).astype(np.int32)
        jkv.apply(keys, ops, rng.integers(0, 100, (96, 2)).astype(np.int32))
    st = jkv.state
    assert int(st.hot.begin) > 0 and int(st.cold.tail) > 0 and int(st.rc.tail) > 0
    return st


@pytest.fixture(scope="module")
def cfgs():
    return configs(**CFG_KW)


def _io(stats):
    return TIo(*(t(x) for x in stats))


def _log_pair(jstate, which):
    return getattr(jstate, which), getattr(to_port(jstate), which)


# ---------------------------------------------------------------------------
# hybrid_log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["hot", "cold"])
def test_hybrid_log_gather_and_bounds(jstate, which):
    jl, tl = _log_pair(jstate, which)
    rng = np.random.default_rng(1)
    addr = np.concatenate([[-1, 0], rng.integers(0, int(jl.tail) + 64, 200)]).astype(np.int32)
    assert_same(jlog.gather(jl, jnp.asarray(addr)), tlog.gather(tl, t(addr)))
    for mem in (1 << 7, 1 << 8):
        assert_same(jlog.head_addr(jl, mem), tlog.head_addr(tl, mem))
        for frac in (0.9, 0.05):
            assert_same(jlog.read_only_addr(jl, mem, frac),
                        tlog.read_only_addr(tl, mem, frac))
    assert_same(jlog.truncate(jl, jl.tail - 5), tlog.truncate(tl, t(jl.tail - 5)))


@pytest.mark.parametrize("which", ["hot", "cold"])
def test_hybrid_log_append_and_flush(jstate, which):
    jl, tl = _log_pair(jstate, which)
    rng = np.random.default_rng(2)
    B = 150
    mask = rng.random(B) < 0.6
    keys = rng.integers(0, 5000, B).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, (B, 2), dtype=np.int64).astype(np.int32)
    prevs = rng.integers(-1, 900, B).astype(np.int32)
    metas = rng.integers(0, 4, B).astype(np.int32)
    jout = jlog.append(jl, jnp.asarray(mask), jnp.asarray(keys), jnp.asarray(vals),
                       jnp.asarray(prevs), jnp.asarray(metas))
    tout = tlog.append(tl, t(mask), t(keys), t(vals), t(prevs), t(metas))
    assert_same(jout, tout, "append")
    jst = JIo(*(jnp.int32(v) for v in (3, 4, 5, 6)))
    assert_same(jlog.charge_flush(jout[0], jst, 1 << 7, 24),
                tlog.charge_flush(tout[0], _io(jst), 1 << 7, 24), "flush")


@pytest.mark.parametrize("op", ["update_in_place", "invalidate",
                                "set_tombstone_in_place"])
def test_hybrid_log_masked_scatters(jstate, op):
    jl, tl = _log_pair(jstate, "hot")
    rng = np.random.default_rng(3)
    B = 120
    live = np.arange(int(jl.begin), int(jl.tail), dtype=np.int32)
    addrs = rng.permutation(live)[:B].astype(np.int32)
    mask = rng.random(B) < 0.5
    if op == "update_in_place":
        vals = rng.integers(0, 1000, (B, 2)).astype(np.int32)
        metas = rng.integers(0, 2, B).astype(np.int32)
        want = jlog.update_in_place(jl, jnp.asarray(mask), jnp.asarray(addrs),
                                    jnp.asarray(vals), jnp.asarray(metas))
        got = tlog.update_in_place(tl, t(mask), t(addrs), t(vals), t(metas))
    else:
        addrs[::7] = addrs[0]                      # repeated targets
        want = getattr(jlog, op)(jl, jnp.asarray(mask), jnp.asarray(addrs))
        got = getattr(tlog, op)(tl, t(mask), t(addrs))
    assert_same(want, got, op)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def _group_inputs(seed):
    rng = np.random.default_rng(seed)
    B = 97
    mask = rng.random(B) < 0.7
    gid = rng.choice(np.array([3, 5, 9, 2**30, 2**30 + 1, -4, 2**31 - 1],
                              np.int32), B)
    return B, mask, gid, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_groups_bit_exact(seed):
    B, mask, gid, rng = _group_inputs(seed)
    m, g = jnp.asarray(mask), jnp.asarray(gid)
    assert_same(jgroups.group_info(m, g), tgroups.group_info(t(mask), t(gid)))
    is_set = rng.random(B) < 0.4
    jinfo, jls = jgroups.segment_reduce_last_set(m, g, jnp.asarray(is_set), B)
    tinfo, tls = tgroups.segment_reduce_last_set(t(mask), t(gid), t(is_set), B)
    assert_same((jinfo, jls), (tinfo, tls))
    vals2 = rng.integers(-2**31, 2**31, (B, 3), dtype=np.int64).astype(np.int32)
    for vals in (vals2, vals2[:, 0]):
        assert_same(jgroups.segment_sum_where(jnp.asarray(vals), m, jinfo.run_id, B),
                    tgroups.segment_sum_where(t(vals), t(mask), tinfo.run_id, B))
        pos = rng.integers(-1, B, B).astype(np.int32)
        assert_same(jgroups.select_at_pos(jnp.asarray(vals), None, jnp.asarray(pos)),
                    tgroups.select_at_pos(t(vals), t(pos)))
    pos = jnp.arange(B, dtype=jnp.int32)
    seg = jnp.where(jinfo.run_id >= 0, jinfo.run_id, B - 1)
    want = jax.ops.segment_min(jnp.where(m, pos, 2**30), seg, num_segments=B)
    got = tgroups.segment_min(torch.where(t(mask), torch.arange(B, dtype=torch.int32),
                                          2**30), tinfo.run_id, B)
    assert_same(want, got, "segment_min")


# ---------------------------------------------------------------------------
# chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_rc,rc_match", [(True, True), (True, False),
                                              (False, True)])
def test_chain_walk_bit_exact(jstate, cfgs, with_rc, rc_match):
    jcfg, _ = cfgs
    ts = to_port(jstate)
    rng = np.random.default_rng(4)
    B = 90
    keys = rng.integers(0, 1600, B).astype(np.int32)
    heads = np.asarray(jstate.hot_index)[np.asarray(hot_slots(jcfg, jnp.asarray(keys)))]
    lower = np.full(B, int(jstate.hot.begin), np.int32)
    lower[::5] += 40
    active = rng.random(B) < 0.85
    hb = jlog.head_addr(jstate.hot, jcfg.hot_mem)
    want = jchain.walk(jnp.asarray(keys), jnp.asarray(heads), jstate.hot,
                       jnp.asarray(lower), hb, jnp.asarray(active),
                       jcfg.chain_max, rc=jstate.rc if with_rc else None,
                       rc_match=rc_match)
    got = tchain.walk(t(keys), t(heads), ts.hot, t(lower), t(hb), t(active),
                      jcfg.chain_max, rc=ts.rc if with_rc else None,
                      rc_match=rc_match)
    assert_same(want, got)


# ---------------------------------------------------------------------------
# read_cache
# ---------------------------------------------------------------------------

def test_read_cache_insert_on_store_state(jstate):
    ts = to_port(jstate)
    rng = np.random.default_rng(5)
    B = 150                       # > rc capacity: admissions get clamped
    keys = rng.integers(0, 3000, B).astype(np.int32)
    mask = rng.random(B) < 0.9
    vals = rng.integers(0, 100, (B, 2)).astype(np.int32)
    prevs = rng.integers(-1, 2000, B).astype(np.int32)
    want = jrc.insert(jstate.rc, jstate.hot_index, jnp.asarray(mask),
                      jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(prevs))
    got = trc.insert(ts.rc, ts.hot_index, t(mask), t(keys), t(vals), t(prevs))
    assert_same(want, got)


def test_read_cache_invalidate_gather_ro(jstate):
    ts = to_port(jstate)
    rng = np.random.default_rng(6)
    B = 64
    addr = rng.integers(-1, int(jstate.rc.tail) + 10, B).astype(np.int32)
    mask = rng.random(B) < 0.5
    assert_same(jrc.gather(jstate.rc, jnp.asarray(addr)), trc.gather(ts.rc, t(addr)))
    for frac in (0.5, 0.1):
        assert_same(jrc.read_only_addr(jstate.rc, frac), trc.read_only_addr(ts.rc, frac))
    assert_same(jrc.invalidate(jstate.rc, jnp.asarray(mask), jnp.asarray(addr)),
                trc.invalidate(ts.rc, t(mask), t(addr)))


# ---------------------------------------------------------------------------
# cold_index
# ---------------------------------------------------------------------------

def test_cold_index_find_entries(jstate, cfgs):
    jcfg, tcfg = cfgs
    ts = to_port(jstate)
    rng = np.random.default_rng(8)
    keys = rng.integers(-50, 2000, 111).astype(np.int32)
    active = rng.random(111) < 0.8
    st = JIo(*(jnp.int32(v) for v in (1, 2, 3, 4)))
    assert_same(jci.find_entries(jstate.cold_idx, jcfg, jnp.asarray(keys),
                                 jnp.asarray(active), st),
                tci.find_entries(ts.cold_idx, tcfg, t(keys), t(active), _io(st)))


@pytest.mark.parametrize("charge_rmw_read", [True, False])
def test_cold_index_update_entries(jstate, cfgs, charge_rmw_read):
    jcfg, tcfg = cfgs
    ts = to_port(jstate)
    rng = np.random.default_rng(9 + charge_rmw_read)
    B = 150
    keys = rng.integers(0, 4000, B).astype(np.int32)
    live = rng.random(B) < 0.8
    # one writer per global slot, as the compactions publish
    g, _, _ = jci.slot_coords(jcfg, jnp.asarray(keys))
    mask = np.asarray(jnp.asarray(live) & jgroups.group_info(jnp.asarray(live), g).is_last)
    new_addrs = rng.integers(0, 4000, B).astype(np.int32)
    st = JIo(*(jnp.int32(v) for v in (1, 2, 3, 4)))
    want = jci.update_entries(jstate.cold_idx, jcfg, jnp.asarray(mask),
                              jnp.asarray(keys), jnp.asarray(new_addrs), st,
                              charge_rmw_read=charge_rmw_read)
    got = tci.update_entries(ts.cold_idx, tcfg, t(mask), t(keys), t(new_addrs),
                             _io(st), charge_rmw_read=charge_rmw_read)
    assert_same(want, got)


@pytest.mark.parametrize("frac", [0.5, 0.3])
def test_cold_index_compact_chunklog(jstate, cfgs, frac):
    jcfg, tcfg = cfgs
    ts = to_port(jstate)
    st = JIo(*(jnp.int32(v) for v in (1, 2, 3, 4)))
    assert_same(jci.compact_chunklog(jstate.cold_idx, jcfg, st, frac),
                tci.compact_chunklog(ts.cold_idx, tcfg, _io(st), frac))
