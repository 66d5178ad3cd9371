"""The port's sharding rules, parameter specs, cache and input specs
(`repro_torch.distributed`, `repro_torch.launch.specs`,
`serve_step.cache_specs`) against the JAX package's, entry by entry, for
every architecture on the 16 x 16 and 2 x 16 x 16 production meshes
(described by their axis names and sizes, as the reference's tests
describe them), and the bytes one device holds of each cell's arguments
against the arithmetic of the reference's own specs."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ALL_SHAPES, shape_applicable
from repro.distributed import param_sharding as jps
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.models.registry import ARCH_IDS, get_config as jget_config
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.serve import serve_step as jss
from repro_torch.distributed import param_sharding as ps
from repro_torch.distributed.sharding import (PartitionSpec as P, constrain,
                                              fit_spec, local_shape, placements,
                                              spec_for, use_mesh)
from repro_torch.launch import specs
from repro_torch.models.registry import get_config
from repro_torch.serve import serve_step


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": FakeMesh(), "2x16x16": FakePodMesh()}
V5E_MEMORY = 16e9           # the reference's serving threshold: 9 of 16 GB


# -- the reference's rule tests (tests/test_sharding.py) ---------------------

def test_spec_for_drops_missing_axes():
    s = spec_for(("batch", None, "heads"), mesh=FakeMesh())
    assert s == P("data", None, "model")     # 'pod' dropped on single pod


def test_spec_for_divisibility():
    # kv_heads=8 can't shard 16 ways -> replicated
    s = spec_for(("batch", "kv_heads", None), mesh=FakeMesh(),
                 shape=(256, 8, 128))
    assert s == P("data", None, None)
    # batch=1 (long_500k) stays unsharded
    s = spec_for(("batch", None), mesh=FakeMesh(), shape=(1, 64))
    assert s == P(None, None)


def test_fit_spec():
    s = fit_spec(P(None, "model"), (4, 1500), mesh=FakeMesh())
    assert s == P(None, None)                # 1500 % 16 != 0
    s = fit_spec(P(None, "model"), (4, 1600), mesh=FakeMesh())
    assert s == P(None, "model")


def test_placements_local_shape_and_constrain_without_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakePodMesh()
    spec = P(("pod", "data"), None, "model")
    assert placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert local_shape((64, 3, 32), spec, mesh) == (2, 3, 2)
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    x = torch.ones(4, 4)
    assert constrain(x, "batch", "embed") is x            # no active mesh
    with use_mesh(mesh):
        assert constrain(x, "batch", "embed") is x        # a plain tensor


# -- parameter, cache and input specs against the reference -----------------

_REF_PARAMS = {}


def _ref_param_shapes(arch):
    if arch not in _REF_PARAMS:
        jcfg = jget_config(arch)
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


_MODELS = {}


def _port_model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = specs.meta_model(get_config(arch))
    return _MODELS[arch]


def _ref_leaf(tree, name):
    node = tree
    for k in ps.reference_path(name).split("/"):
        node = node[k]
    return node


def _same(port_spec, ref_spec):
    return tuple(port_spec) == tuple(ref_spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_cache_input_specs_match_reference(arch):
    """Every parameter's spec (the reference's stacked block spec less its
    layer axis), under the storage and the serving rules, and the cache
    and input specs of every shape, on both production meshes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    model = _port_model(arch)
    jshapes = _ref_param_shapes(arch)
    names = [n for n, _ in model.named_parameters()]
    for mesh_name, mesh in MESHES.items():
        for mode in ("train", "serve"):
            if mode == "serve":
                _, jspec = jspecs.params_specs(jcfg, mesh, mode="serve")
                _, tspec = specs.params_specs(cfg, mesh, mode="serve",
                                              device_memory=V5E_MEMORY, model=model)
            else:
                jspec = jps.param_specs(jshapes, mesh)
                tspec = ps.param_specs(model, mesh)
            assert set(tspec) == set(names)
            for n in names:
                ref = _ref_leaf(jspec, n)
                stacked = n.split(".")[0] in ps.STACKED
                ref = tuple(ref)[1:] if stacked else tuple(ref)
                assert _same(tspec[n], ref), (arch, mesh_name, mode, n, tspec[n], ref)
        assert ({k: tuple(v) for k, v in serve_step.cache_specs(cfg, mesh).items()}
                == {k: tuple(v) for k, v in jss.cache_specs(jcfg, mesh).items()})
        for shape in ALL_SHAPES:
            tb, tsp = specs.input_specs(cfg, shape, mesh)
            jb, jsp = jspecs.input_specs(jcfg, shape, mesh)
            assert set(tb) == set(jb)
            for k in tb:
                assert tuple(tb[k].shape) == tuple(jb[k].shape)
                assert _same(tsp[k], jsp[k]), (arch, shape.name, k)
            if shape.kind == "decode":
                tc, tcs = specs.cache_state_specs(cfg, shape, mesh)
                jc, jcs = jspecs.cache_state_specs(jcfg, shape, mesh)
                assert set(tc) == set(jc)
                for k in tc:
                    assert tuple(tc[k].shape) == tuple(jc[k].shape), (arch, k)
                    assert _same(tcs[k], jcs[k]), (arch, shape.name, k)


def _ref_bytes(leaves, spec_leaves, mesh):
    sizes = dict(mesh.shape)
    total = 0
    for s, sp in zip(leaves, spec_leaves):
        div = 1
        for e in sp:
            if e is not None:
                for a in ((e,) if isinstance(e, str) else e):
                    div *= sizes[a]
        total += int(np.prod(s.shape, dtype=np.int64)) * np.dtype(s.dtype).itemsize // div
    return total


def _ref_argument_bytes(jcfg, shape, mesh):
    """The reference's cell arguments (dryrun.build_cell's) by its specs."""
    is_p = lambda x: isinstance(x, JP)  # noqa: E731
    batch, bspecs = jspecs.input_specs(jcfg, shape, mesh)
    if shape.kind == "train":
        st, sp = jspecs.train_state_specs(jcfg, JAdamWConfig(state_dtype="bfloat16"), mesh)
        trees = [(st, sp), (batch, bspecs)]
    elif shape.kind == "prefill":
        trees = [jspecs.params_specs(jcfg, mesh, mode="serve"), (batch, bspecs)]
    else:
        trees = [jspecs.params_specs(jcfg, mesh, mode="serve"),
                 jspecs.cache_state_specs(jcfg, shape, mesh),
                 (batch["tokens"], bspecs["tokens"])]
    return sum(_ref_bytes(jax.tree.leaves(t), jax.tree.leaves(s, is_leaf=is_p), mesh)
               for t, s in trees)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference_specs(arch):
    """For every applicable cell on both meshes, the bytes one device holds
    of the cell's arguments by the port's specs equal the reference's
    specs' arithmetic (bytes over the product of the sharded axes)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    model = _port_model(arch)
    for mesh in MESHES.values():
        for shape in ALL_SHAPES:
            if not shape_applicable(jcfg, shape)[0]:
                continue
            got = specs.argument_bytes(cfg, specs.SHAPES[shape.name], mesh,
                                       device_memory=V5E_MEMORY, model=model)
            assert got == _ref_argument_bytes(jcfg, shape, mesh), (arch, shape.name)


def test_layout_variants_in_a_subprocess():
    """REPRO_TRAIN_LAYOUT=sp_tp and REPRO_DECODE_KV=heads, read at import
    by both packages: the rule tables and every architecture's cache specs
    agree."""
    prog = textwrap.dedent("""
        import json
        from repro.distributed import sharding as js
        from repro.models.registry import ARCH_IDS, get_config as jg
        from repro.serve import serve_step as jss
        from repro_torch.distributed import sharding as ts
        from repro_torch.models.registry import get_config as tg
        from repro_torch.serve import serve_step as tss
        class M:
            axis_names = ("pod", "data", "model")
            shape = {"pod": 2, "data": 16, "model": 16}
        assert ts.TRAIN_RULES == js.TRAIN_RULES and ts.SERVE_RULES == js.SERVE_RULES
        assert ts.TRAIN_RULES["heads"] == "model" and ts.SERVE_RULES["cache_seq"] is None
        for a in ARCH_IDS:
            t = {k: tuple(v) for k, v in tss.cache_specs(tg(a), M()).items()}
            j = {k: tuple(v) for k, v in jss.cache_specs(jg(a), M()).items()}
            assert t == j, (a, t, j)
        print("LAYOUTS_OK")
    """)
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, REPRO_TRAIN_LAYOUT="sp_tp", REPRO_DECODE_KV="heads",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src")]
                                          + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LAYOUTS_OK" in out.stdout


def test_default_rules_match_reference():
    from repro.distributed import sharding as js
    from repro_torch.distributed import sharding as ts
    assert ts.DEFAULT_RULES == js.DEFAULT_RULES
    assert ts.TRAIN_RULES == js.TRAIN_RULES and ts.SERVE_RULES == js.SERVE_RULES
    assert ps._TABLE == jps._TABLE
