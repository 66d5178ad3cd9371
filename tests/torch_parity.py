"""Shared helpers of the tests that hold the PyTorch port (repro_torch)
against the JAX package (repro): one config and one state carried into
both, outputs compared bit for bit."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

import repro.core as J
from repro_torch import interop
import repro_torch as T

# the reference's engine name for each port engine
JAX_ENGINE = interop.ENGINE_TO_REFERENCE


def small_dict(**kw) -> dict:
    """tests/conftest.py::small_cfg sizes, as a field dict both packages take."""
    base = dict(hot_index_size=1 << 9, hot_capacity=1 << 11, hot_mem=1 << 8,
                cold_capacity=1 << 13, cold_mem=1 << 7, n_chunks=1 << 7,
                chunklog_capacity=1 << 11, chunklog_mem=1 << 6,
                rc_capacity=1 << 7, value_width=2, chain_max=48)
    base.update(kw)
    return base


def configs(**kw):
    """(reference F2Config, port F2Config) for the same fields; `engine`
    is given in the port's naming."""
    d = small_dict(**kw)
    tcfg = T.F2Config(**d)
    return J.F2Config(**interop.config_to_dict(tcfg)), tcfg


def leaves_np(jstate):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]


def to_port(jstate) -> "T.core.store.F2State":
    """A reference F2State carried into the port (on the CPU)."""
    return interop.state_from_numpy(leaves_np(jstate), "cpu")


def assert_states_equal(jstate, tstate, ctx=""):
    names = interop.leaf_names()
    jl, tl = leaves_np(jstate), interop.state_to_numpy(tstate)
    assert len(jl) == len(tl) == len(names)
    for n, a, b in zip(names, jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, n, a.dtype, b.dtype)
        assert np.array_equal(a, b), (ctx, n, np.flatnonzero(a.ravel() != b.ravel())[:8])


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, ctx=""):
    """Bit-exact equality of two results (arrays, or tuples of them),
    dtype included."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), ctx
        fields = getattr(a, "_fields", range(len(a)))
        for f, x, y in zip(fields, a, b):
            assert_same(x, y, f"{ctx}.{f}")
        return
    x, y = as_np(a), as_np(b)
    assert x.dtype == y.dtype and x.shape == y.shape, (ctx, x.dtype, y.dtype, x.shape, y.shape)
    assert np.array_equal(x, y), (ctx, np.flatnonzero(x.ravel() != y.ravel())[:8])


def t(x, dtype=None):
    """numpy / jax array -> CPU tensor (a copy)."""
    a = np.array(np.asarray(x), copy=True)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def colliding_keys(index_size: int, n: int, slot: int = 7) -> np.ndarray:
    """The first n int32 keys whose hash slot is `slot`."""
    k = np.arange(1 << 20, dtype=np.int32)
    s = np.asarray(J.types.hash32(jnp.asarray(k)) & jnp.uint32(index_size - 1))
    return k[s == slot][:n]


_REFERENCE_KVS = {}


def reference_kv(jcfg, **kw):
    """A fresh-state reference KV (no donation).  Instances are reused per
    (config, options) so that their jitted steps compile once per process;
    the state and counters are reset on every call."""
    key = (jcfg, tuple(sorted(kw.items())))
    kv = _REFERENCE_KVS.get(key)
    if kv is None:
        kv = _REFERENCE_KVS[key] = J.KV(jcfg, donate=False, **kw)
    kv.state = J.store.create(jcfg)
    kv.compactions = 0
    kv.temp_table_peak_bytes = 0
    return kv


def twin_kvs(mode="f2", compact_batch=128, faster_compaction="scan",
             engine="fused", **cfg_kw):
    """A reference KV (no donation) and a CPU port KV on one config."""
    jcfg, tcfg = configs(engine=engine, **cfg_kw)
    extra = dict(mode=mode, compact_batch=compact_batch,
                 faster_compaction=faster_compaction)
    return reference_kv(jcfg, **extra), T.KV(tcfg, device="cpu", **extra)



def model_configs(arch: str, **over):
    """(reference ModelConfig, port ModelConfig): `arch` reduced, fields
    replaced by `over`."""
    import dataclasses
    from repro.models.registry import get_config
    jcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return jcfg, interop.model_config_from_dict(interop.model_config_to_dict(jcfg))


def named_leaves(tree, names) -> dict:
    """{port parameter name: numpy leaf} of a reference tree shaped like the
    parameters (params, grads, mu, nu, err)."""
    return {n: np.asarray(interop.reference_leaf(tree, n)) for n in names}


def assert_trees_close(ttree, jtree, rel: float, ctx=""):
    """Every leaf of two nested dicts of arrays within `rel` of the largest
    magnitude of the reference leaf (absolute where that is 0)."""
    if isinstance(jtree, dict):
        assert set(ttree) == set(jtree), (ctx, set(ttree) ^ set(jtree))
        for k in jtree:
            assert_trees_close(ttree[k], jtree[k], rel, f"{ctx}.{k}")
        return
    a, b = as_np(ttree).astype(np.float32), np.asarray(jtree, np.float32)
    assert a.shape == b.shape, (ctx, a.shape, b.shape)
    if a.size:
        tol = rel * (float(np.abs(b).max()) or 1.0)
        err = float(np.abs(a - b).max())
        assert err <= tol, (ctx, err, tol)
