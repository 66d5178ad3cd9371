"""The host tier's device side (repro_torch.core.host_tier, and its
functions in store and compaction) against the JAX package's, on one
spilled reference state carried into the port: the reference's KV driven
until cold chunks were demoted and promoted, so the chunk cache is
non-trivially filled.  Outputs and every leaf they write are compared bit
for bit; the three planners (`plan_fetch`, `plan_finish`,
`plan_cc_frontier`) must write nothing.  The port's engines "unfused" and
"fused_ref" run against the reference's "jnp" and "fused_ref"."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import compaction as jcomp
from repro.core import host_tier as jht
from repro.core import store as jstore
import repro_torch as T  # noqa: F401
from repro_torch import interop
from repro_torch.core import compaction as tcomp
from repro_torch.core import host_tier as tht
from repro_torch.core import store as tstore
from torch_host_oracle import REF_ENGINE, drive, port_cfg, ref_store
from test_host_tier import C, host_cfg
from torch_parity import assert_same, leaves_np

ENGINES = ("unfused", "fused_ref")


@pytest.fixture(scope="module")
def spilled():
    """(reference KV, its state carried into the port as a stack of one):
    250 steps of the reference's drive, the cache rows mostly resident."""
    jkv = ref_store(host_cfg(), compact_batch=128)
    drive([jkv], seed=5, n_steps=250)
    st = jkv._ht.stats()
    assert st["demotions_total"] > 0 and st["promotions_total"] > 0
    assert int(jkv.state.cold.floor) > 0
    assert int((np.asarray(jkv.state.host.chunk) >= 0).sum()) > host_cfg().host_cache_chunks // 2
    return jkv


def carried(jkv):
    return interop.state_from_numpy([a[None] for a in leaves_np(jkv.state)], "cpu",
                                    n_shards=1)


def cfgs(engine):
    jcfg = dataclasses.replace(host_cfg(), engine=REF_ENGINE[engine])
    return jcfg, port_cfg(jcfg, engine)


def one(x):
    """A port output of a stack of one without its shard axis."""
    if isinstance(x, tuple):
        return type(x)(*(one(y) for y in x)) if hasattr(x, "_fields") else tuple(one(y) for y in x)
    return x[0] if isinstance(x, torch.Tensor) and x.ndim else x


def assert_leaves(jstate, tstate, ctx=""):
    names = interop.leaf_names()
    for n, a, b in zip(names, leaves_np(jstate), interop.state_to_numpy(tstate)):
        b = b[0]
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, n)
        assert np.array_equal(a, b), (ctx, n, np.flatnonzero(a.ravel() != b.ravel())[:8])


def addresses(jkv, rng, n=512):
    """Cold addresses around and below the floor, in the ring, past the
    tail, and NULL."""
    c = jkv.state.cold
    begin, floor, tail = int(c.begin), int(c.floor), int(c.tail)
    a = np.concatenate([rng.integers(begin, max(floor, begin + 1), n // 2),
                        rng.integers(max(floor - 64, 0), tail + 64, n // 2 - 2),
                        [-1, tail]]).astype(np.int32)
    return a


def test_gather_translated(spilled):
    jkv = spilled
    cfg = jkv.cfg
    tstate = carried(jkv)
    a = addresses(jkv, np.random.default_rng(0))
    ref = jht.gather_translated(cfg, jkv.state.cold, jkv.state.host, jnp.asarray(a))
    out = tht.gather_translated(port_cfg(cfg), tstate.cold, tstate.host,
                                torch.from_numpy(a)[None])
    missing = np.asarray(ref[4])
    assert missing.any() and (~missing & (a < int(jkv.state.cold.floor)) & (a >= 0)).any()
    for i, (x, y) in enumerate(zip(ref, out)):
        assert_same(np.asarray(x), y[0], f"output {i}")


@pytest.mark.parametrize("target", [False, True], ids=["heads", "target"])
def test_probe_cold(spilled, target):
    """`probe_cold` from the cold index's entries (read lanes), and in
    target mode over a compaction frontier below the floor."""
    jkv = spilled
    cfg = jkv.cfg
    st = jkv.state
    tstate = carried(jkv)
    rng = np.random.default_rng(1)
    B = 256
    if target:
        addrs = jnp.asarray(int(st.cold.begin) + np.arange(B, dtype=np.int32))
        keys = jht.gather_translated(cfg, st.cold, st.host, addrs)[0]
        lower, tgt = addrs, addrs
    else:
        keys = jnp.asarray(rng.integers(1, 4097, B).astype(np.int32))
        lower, tgt = jnp.broadcast_to(st.cold.begin, (B,)), None
    active = jnp.asarray(rng.random(B) < 0.9)
    entries, _ = J.cold_index.find_entries(st.cold_idx, cfg, keys, active, st.stats)
    head = J.hybrid_log.head_addr(st.cold, cfg.cold_mem)
    ref = jht.probe_cold(cfg, keys, st.cold, st.host, lower, head, active,
                         entries, target=tgt)
    assert (np.asarray(ref.missed) >= 0).any() and np.asarray(ref.found).any()
    assert np.asarray(ref.touch).any()
    t = lambda x: torch.from_numpy(np.array(x))[None]  # noqa: E731
    out = tht.probe_cold(port_cfg(cfg), t(keys), tstate.cold, tstate.host,
                         t(lower), t(head), t(active), t(entries),
                         target=None if tgt is None else t(tgt))
    for f in ref._fields:
        assert_same(np.asarray(getattr(ref, f)), one(getattr(out, f)), f)


def test_fold_touch(spilled):
    jkv = spilled
    st = jkv.state
    tstate = carried(jkv)
    rng = np.random.default_rng(2)
    touch = (rng.random(st.host.chunk.shape[0]) < 0.3) * rng.integers(1, 9, st.host.chunk.shape[0])
    touch = touch.astype(np.int32)
    for miss in (False, True):
        ref = jht.fold_touch(st.host, jnp.asarray(touch), jnp.bool_(miss))
        out = tht.fold_touch(tstate.host, torch.from_numpy(touch)[None],
                             torch.tensor([miss]))
        for f in ref._fields:
            assert_same(np.asarray(getattr(ref, f)), one(getattr(out, f)), f)
        tstate = carried(jkv)


def test_install_and_extract_chunks(spilled):
    """`install_chunks` of demoted chunks into chosen rows (some slots
    masked out), and `extract_chunks` of the ring's first chunks above the
    floor: equal outputs and leaves."""
    jkv = spilled
    cfg = jkv.cfg
    st = jkv.state
    tstate = carried(jkv)
    R = cfg.host_cache_chunks
    resident = set(np.asarray(st.host.chunk).tolist())
    absent = [c for c in sorted(jkv._ht.store[0]) if c not in resident][:R]
    assert len(absent) >= 8
    rng = np.random.default_rng(3)
    P = len(absent)
    rows = rng.permutation(R)[:P].astype(np.int32)
    mask = rng.random(P) < 0.8
    data = [np.stack([jkv._ht.store[0][c][i] for c in absent]) for i in range(4)]
    args = [np.asarray(absent, np.int32), rows, *data, mask]
    ref = jht.install_chunks(st, *(jnp.asarray(a) for a in args))
    out = tht.install_chunks(tstate, *(torch.from_numpy(np.array(a))[None] for a in args))
    assert_leaves(ref, out, "install")

    first = int(st.cold.floor) // C
    ref = jht.extract_chunks(cfg, 8, st, jnp.int32(first))
    out = tht.extract_chunks(port_cfg(cfg), 8, carried(jkv), torch.tensor([first], dtype=torch.int32))
    for i, (x, y) in enumerate(zip(ref, out)):
        assert_same(np.asarray(x), y[0], f"extract {i}")


def test_demote_commit_and_drop_dead_rows(spilled):
    jkv = spilled
    cfg = jkv.cfg
    st = jkv.state
    nf = int(st.cold.floor) + 4 * C
    assert_leaves(jht.demote_commit(st, jnp.int32(nf)),
                  tht.demote_commit(carried(jkv), torch.tensor([nf], dtype=torch.int32)),
                  "commit")
    # move BEGIN past some resident chunks, then drop their rows
    chunks = np.asarray(st.host.chunk)
    live = np.sort(chunks[chunks >= 0])
    begin = int(live[len(live) // 2]) * C + 3
    jst = st._replace(cold=st.cold._replace(begin=jnp.int32(begin)))
    tstate = carried(jkv)
    tstate = tstate._replace(cold=tstate.cold._replace(
        begin=torch.tensor([begin], dtype=torch.int32)))
    ref = jht.drop_dead_rows(cfg, jst)
    out = tht.drop_dead_rows(port_cfg(cfg), tstate)
    assert (np.asarray(ref.host.chunk) != chunks).any()
    assert_leaves(ref, out, "drop")


@pytest.mark.parametrize("engine", ENGINES)
def test_read_batch_host(spilled, engine):
    """A host-tier read round (misses defer, the tripwire stays clear) and
    a committed read (misses latch it): statuses, values, missed, leaves."""
    jkv = spilled
    jcfg, tcfg = cfgs(engine)
    keys = np.random.default_rng(4).integers(1, 4097, 128).astype(np.int32)
    active = np.ones(128, bool)
    for fn_j, fn_t in ((jstore.read_batch_host, tstore.read_batch_host),
                       (jstore.read_batch, tstore.read_batch)):
        ref = fn_j(jcfg, jkv.state, jnp.asarray(keys), jnp.asarray(active))
        out = fn_t(tcfg, carried(jkv), torch.from_numpy(keys)[None],
                   torch.from_numpy(active)[None])
        assert_leaves(ref[0], out[0], fn_t.__name__)
        for i, (x, y) in enumerate(zip(ref[1:], out[1:])):
            assert_same(np.asarray(x), y[0], f"{fn_t.__name__} {i}")
    assert np.asarray(ref[0].host.missed_in_step)


@pytest.mark.parametrize("engine", ENGINES)
def test_planners_are_pure(spilled, engine):
    """plan_fetch (a mixed batch), plan_finish (a two-phase read's
    snapshot) and plan_cc_frontier (a frontier from cold BEGIN) give the
    reference's missed chunks and leave every leaf as it was."""
    jkv = spilled
    jcfg, tcfg = cfgs(engine)
    rng = np.random.default_rng(6)
    B = 128
    keys = rng.integers(1, 4097, B).astype(np.int32)
    ops = rng.choice([0, 1, 2, 3, 4], B).astype(np.int32)
    tstate = carried(jkv)
    before = [t.clone() for t in interop.state_leaves(tstate)]

    def unchanged(ctx):
        for n, a, b in zip(interop.leaf_names(), before, interop.state_leaves(tstate)):
            assert torch.equal(a, b), (ctx, n)

    t = lambda x: torch.from_numpy(np.array(x))[None]  # noqa: E731
    ref = jstore.plan_fetch(jcfg, jkv.state, jnp.asarray(keys), jnp.asarray(ops))
    out = tstore.plan_fetch(tcfg, tstate, t(keys), t(ops))
    assert (np.asarray(ref) >= 0).any()
    assert_same(np.asarray(ref), out[0], "plan_fetch")
    unchanged("plan_fetch")

    _, jsnap = jstore.read_begin(jcfg, jkv.state, jnp.asarray(keys),
                                 jnp.ones(B, bool))
    tsnap = tstore.ReadSnapshot(*(t(x) for x in jsnap))
    ref = jstore.plan_finish(jcfg, jkv.state, jsnap)
    out = tstore.plan_finish(tcfg, tstate, tsnap)
    assert (np.asarray(ref) >= 0).any()
    assert_same(np.asarray(ref), out[0], "plan_finish")
    unchanged("plan_finish")

    start = jkv.state.cold.begin
    until = start + 128
    ref = jcomp.plan_cc_frontier(jcfg, jkv.state, start, until, 128)
    out = tcomp.plan_cc_frontier(tcfg, tstate, t(start), t(until), 128)
    assert (np.asarray(ref) >= 0).any()
    assert_same(np.asarray(ref), out[0], "plan_cc_frontier")
    carry = tcomp.cc_walk_init(tcfg, tstate, t(start), t(until), 128)
    assert_same(np.asarray(jcomp.cc_walk_init(jcfg, jkv.state, start, until, 128).cur),
                carry.cur[0], "cc_walk_init")
    unchanged("plan_cc_frontier / cc_walk_init")


@pytest.mark.parametrize("engine", ENGINES)
def test_resumable_cold_cold_step(spilled, engine):
    """One resumable cold->cold step from cold BEGIN, driven by the
    reference's manager and by the port's from the same carried store:
    each walk round's carry, the commit's appends and every leaf."""
    jkv = spilled
    jcfg, tcfg = cfgs(engine)
    jm = ref_store(jcfg, compact_batch=128)
    jm.state = jkv.state
    tm = T.KV(tcfg, compact_batch=128, device="cpu")
    from torch_host_oracle import carry_store
    carry_store(jkv, tm)
    jm._ht = jkv._ht.__class__.__new__(jkv._ht.__class__)
    jm._ht.__dict__.update({k: v for k, v in vars(jkv._ht).items()})
    for k in ("store", "pinned", "prefetched", "ewma"):
        setattr(jm._ht, k, [type(x)(x) for x in getattr(jkv._ht, k)])
    start = int(jkv.state.cold.begin)
    until = start + 256
    jm._ccstep_host(jnp.int32(start), jnp.int32(until))
    tm._ccstep_host(torch.tensor([start], dtype=torch.int32),
                    torch.tensor([until], dtype=torch.int32))
    assert_leaves(jm.state, tm._st, "cc step")
    assert jm._ht.stats() == tm._ht.stats()
    assert jm._ht.pinned == tm._ht.pinned
