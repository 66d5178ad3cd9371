"""Shared helpers of the tests that hold the port's host tier
(repro_torch.core.host_tier and its branches in the store, the compactions,
KV, ShardedKV and durability) against the JAX package's: the reference's
host-tier configurations (tests/test_host_tier.py), fresh reference stores
that share one constructed store's jitted steps, the differential drive run
on both packages at once, and the comparisons (statuses and values batch by
batch, every state leaf, the manager's stats and its host store)."""
import copy
import dataclasses

import numpy as np

import repro.core as J
from repro.core.sharded import ShardedKV as JShardedKV
from repro.core.types import OP_DELETE, OP_READ, OP_RMW, OP_UPSERT, ST_NOT_FOUND, ST_OK
import repro_torch as T
from repro_torch import interop
from test_host_tier import B, N_KEYS, host_cfg
from torch_parity import as_np, assert_same, leaves_np

# the port's engine -> the reference's
REF_ENGINE = interop.ENGINE_TO_REFERENCE


def port_cfg(jcfg, engine=None):
    """The reference's config as the port's (`engine` in the port's naming;
    by default the reference's engine translated)."""
    d = dataclasses.asdict(jcfg)
    if engine is not None:
        d["engine"] = REF_ENGINE[engine]
    return interop.config_from_dict(d)


def ref_cfg(engine, make=host_cfg, **kw):
    """`make(**kw)` (host_cfg or twin_cfg) with the reference's engine for
    the port's `engine`."""
    return make(engine=REF_ENGINE[engine], **kw)


def _fresh_copy(obj, fields):
    out = object.__new__(type(obj))
    for k, v in fields.items():
        if isinstance(v, J.host_tier.HostTier):
            v = _fresh_copy(v, dict(vars(v)))
        elif isinstance(v, (np.ndarray, list, dict, set)):
            v = copy.deepcopy(v)
        out.__dict__[k] = v
    return out


_TEMPLATES = {}


def ref_store(jcfg, n_shards=None, **kw):
    """A fresh reference KV (`n_shards` None) or ShardedKV built with
    donate=False, sharing the jitted steps of the first one built with the
    same arguments in this process: its host-side fields (the host tier's
    containers and counters included) are copies of that store's just after
    construction, its device state the same immutable empty state."""
    key = (jcfg, n_shards, tuple(sorted(kw.items())))
    if key not in _TEMPLATES:
        kv = (J.KV(jcfg, donate=False, **kw) if n_shards is None
              else JShardedKV(jcfg, n_shards, donate=False, **kw))
        _TEMPLATES[key] = (kv, dict(vars(kv)))
    kv, fields = _TEMPLATES[key]
    return _fresh_copy(kv, fields)


def port_store(tcfg, n_shards=None, **kw):
    if n_shards is None:
        return T.KV(tcfg, device="cpu", **kw)
    return T.ShardedKV(tcfg, n_shards, device="cpu", **kw)


def gen_batch(rng, step, n_keys=N_KEYS, p=(.5, .3, .15, .05)):
    """tests/test_host_tier.py::drive_differential's batch for `step`."""
    keys = rng.integers(1, n_keys + 1, size=B).astype(np.int64)
    ops = rng.choice([OP_READ, OP_UPSERT, OP_RMW, OP_DELETE], size=B,
                     p=list(p)).astype(np.int32)
    vals = np.stack([keys * 3 + step, keys * 5 + 1], axis=1).astype(np.int32)
    return keys.astype(np.int32), ops, vals


def fold_ref(ref, keys, ops, vals):
    for i in range(len(keys)):
        k, op = int(keys[i]), int(ops[i])
        if op == OP_UPSERT:
            ref[k] = vals[i].copy()
        elif op == OP_RMW:
            ref[k] = ref[k] + vals[i] if k in ref else vals[i].copy()
        elif op == OP_DELETE:
            ref.pop(k, None)


def drive(stores, *, seed, n_steps, n_keys=N_KEYS, check_every=50, ctx=""):
    """Identical mixed batches into every store of `stores` (the first is
    the reference package's spilled store, the second the port's, then any
    twins): every store's statuses and values must equal the first's batch
    by batch.  Returns the dict reference of every write."""
    rng = np.random.default_rng(seed)
    ref = {}
    for step in range(n_steps):
        keys, ops, vals = gen_batch(rng, step, n_keys)
        outs = [s.apply(keys, ops, vals) for s in stores]
        for i, o in enumerate(outs[1:], 1):
            assert_same(as_np(outs[0][0]).astype(np.int32), as_np(o[0]),
                        f"{ctx} status @ {step}, store {i}")
            assert_same(as_np(outs[0][1]).astype(np.int32), as_np(o[1]),
                        f"{ctx} values @ {step}, store {i}")
        fold_ref(ref, keys, ops, vals)
        if step % check_every == 0:
            for s in stores:
                s.check_invariants()
    for s in stores:
        s.check_invariants()
    return ref


def readback(stores, ref, n_keys=N_KEYS, slice_=32, ctx=""):
    """Every key read back in slices of `slice_` on every store: results
    equal to the first store's, and to the dict reference."""
    all_keys = np.arange(1, n_keys + 1, dtype=np.int32)
    for off in range(0, n_keys, slice_):
        ks = all_keys[off:off + slice_]
        outs = [tuple(as_np(x) for x in s.read(ks)) for s in stores]
        for i, o in enumerate(outs[1:], 1):
            assert_same(outs[0][0].astype(np.int32), o[0], f"{ctx} readback @ {off}, {i}")
            assert_same(outs[0][1].astype(np.int32), o[1], f"{ctx} readback @ {off}, {i}")
        st, v = outs[0]
        for j, k in enumerate(ks):
            k = int(k)
            if k in ref:
                assert st[j] == ST_OK, (ctx, k, st[j])
                np.testing.assert_array_equal(v[j], ref[k])
            else:
                assert st[j] == ST_NOT_FOUND, (ctx, k, st[j])


def port_leaves(tkv, flat):
    """The port store's leaves as the reference lays them out: a flat KV's
    without the shard axis."""
    leaves = interop.state_to_numpy(tkv._st if flat else tkv.state)
    return [a[0] for a in leaves] if flat else leaves


def assert_host_equal(jkv, tkv, ctx=""):
    """Every state leaf (host.* and cold.floor among them), the manager's
    stats and its exported host store, bit for bit."""
    flat = isinstance(tkv, T.KV)
    names = interop.leaf_names()
    for n, a, b in zip(names, leaves_np(jkv.state), port_leaves(tkv, flat)):
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, n, a.shape, b.shape)
        assert np.array_equal(a, b), (ctx, n, np.flatnonzero(a.ravel() != b.ravel())[:8])
    assert jkv._ht.stats() == tkv._ht.stats(), (ctx, jkv._ht.stats(), tkv._ht.stats())
    je, te = jkv._ht.export_snapshot(), interop.host_store_to_numpy(tkv._ht)
    assert set(je) == set(te), ctx
    for k in je:
        assert_same(np.asarray(je[k]), te[k], f"{ctx} {k}")


def carry_manager(jht, tht):
    """The reference manager's host store and soft state (pins, prefetch
    marks, miss EWMAs, counters) copied into the port's."""
    interop.host_store_from_numpy(tht, jht.export_snapshot())
    tht.pinned = [set(int(c) for c in s) for s in jht.pinned]
    tht.prefetched = [set(int(c) for c in s) for s in jht.prefetched]
    tht.ewma = [{int(k): float(v) for k, v in e.items()} for e in jht.ewma]
    for k in ("promotions", "demotions", "prefetch_hits", "contract_splits"):
        setattr(tht, k, getattr(jht, k))


def carry_store(jkv, tkv):
    """A reference store (state and host tier) carried into a port store of
    the same config."""
    leaves = leaves_np(jkv.state)
    if isinstance(tkv, T.KV):
        tkv._st = interop.state_from_numpy([a[None] for a in leaves], "cpu",
                                           n_shards=1)
    else:
        tkv.state = interop.state_from_numpy(leaves, "cpu", n_shards=tkv.S)
    carry_manager(jkv._ht, tkv._ht)


def spill_factor(kv):
    """Live log span over the device cold ring (the largest shard's)."""
    c = kv.state.cold
    return float(np.max(as_np(c.tail).astype(np.int64) - as_np(c.begin))
                 / kv.cfg.cold_capacity)
