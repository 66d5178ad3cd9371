"""The port stands alone: it imports and runs (the store, single-shard,
sharded with a live migration, sharded with observability on, replicated
with a drop and resync, the session service over it, a durable store through a snapshot, a replica
rebuild and a recovery, reduced serving
engines and reduced training runs of the dense and RWKV-6 families) with
the JAX package, JAX and the benchmarks blocked; its entry points default to the CUDA device and
refuse to quietly run without it; the forced-kernel engine refuses CPU
tensors."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as T  # noqa: E402
from repro_torch.core import probe_engine  # noqa: E402
from repro_torch.kernels.f2_probe import ops  # noqa: E402
from torch_parity import small_dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_nothing_of_the_reference():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_port_runs_with_the_reference_blocked():
    """A subprocess that cannot import jax, repro or benchmarks imports the
    port and runs a CPU KV through writes, reads and compactions."""
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import repro_torch as T
        cfg = T.F2Config(**{small_dict()!r})
        kv = T.KV(cfg, device="cpu", compact_batch=128)
        keys = np.arange(3000, dtype=np.int32)
        for i in range(0, 3000, 100):
            kv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
        st, v = kv.read(keys)
        assert (st.numpy() == T.ST_OK).all()
        assert (v.numpy() == np.stack([keys] * 2, 1)).all()
        assert kv.compactions > 0
        kv.check_invariants()
        skv = T.ShardedKV(cfg, 4, device="cpu", compact_batch=128, lanes=64,
                          trigger=0.3)
        for i in range(0, 3000, 100):
            skv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
        nm = skv.bucket_map.copy()
        nm[:2] = 3
        assert skv.migrate(nm) > 0
        st, v = skv.read(keys)
        assert (st.numpy() == T.ST_OK).all()
        assert (v.numpy() == np.stack([keys] * 2, 1)).all()
        assert skv.compactions.sum() > 0 and skv.rounds > 30
        skv.check_invariants()
        from repro_torch import obs
        from repro_torch.obs import serve as obs_serve
        obs.configure(enabled=True, reset=True)
        okv = T.ShardedKV(cfg, 4, device="cpu", compact_batch=128, lanes=64,
                          trigger=0.3)
        for i in range(0, 3000, 100):
            okv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
        st, v = okv.read(keys[:500])
        assert (st.numpy() == T.ST_OK).all()
        assert sum(okv.stats()["shards"]["compactions"]) > 0
        names = obs.get_registry().names()
        assert "f2_deferral_rounds" in names and "f2_stats_io_read_ops" in names
        assert "compaction.hot_cold" in obs.journal.kinds()
        assert obs.latency.summary()["deferral"]["count"] > 0
        assert obs_serve.render("/healthz")[0] == 200
        obs.configure(enabled=False, reset=True)
        rkv = T.ReplicatedKV(cfg, 2, n_replicas=2, device="cpu",
                             compact_batch=128, lanes=64, trigger=0.3)
        for i in range(0, 3000, 100):
            rkv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
        rkv.drop_replica(1)
        rkv.upsert(keys[:100], np.stack([keys[:100] + 1] * 2, 1))
        assert rkv.resync(1) > 0
        st, v = rkv.read(keys, replica=1)
        assert (st.numpy() == T.ST_OK).all()
        assert (v.numpy()[:100] == np.stack([keys[:100] + 1] * 2, 1)).all()
        rkv.check_invariants()
        from repro_torch.serve import serve_step
        svc = serve_step.make_session_service(cfg, serve_step.ServiceConfig(
            n_shards=2, n_replicas=2, lanes=32, max_sessions=2, session_depth=64,
            store_kwargs=dict(device="cpu", compact_batch=128)))
        s = svc.open_session()
        s.enqueue(keys[:50], np.full(50, T.OP_UPSERT, np.int32),
                  np.stack([keys[:50] + 7] * 2, 1))
        s.drain()
        s.enqueue(keys[:50], np.full(50, T.OP_READ, np.int32))
        _, st, v = s.drain()
        assert (st == T.ST_OK).all() and (v == np.stack([keys[:50] + 7] * 2, 1)).all()
        svc.check_invariants()
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            mk = lambda: T.ReplicatedKV(cfg, 2, n_replicas=2, device="cpu",
                                        compact_batch=128, lanes=32)
            dkv = T.DurableKV(mk(), T.DurabilityConfig(dir=d))
            dkv.upsert(keys[:64], np.stack([keys[:64]] * 2, 1))
            dkv.snapshot(blocking=True)
            dkv.kv.drop_replica(1)
            dkv.upsert(keys[64:128], np.stack([keys[64:128]] * 2, 1))
            assert dkv.rebuild_replica(1) > 0
            rec = T.recover(d, mk)
            st, v = rec.read(keys[:128])
            assert (st.numpy() == T.ST_OK).all()
            assert (v.numpy() == np.stack([keys[:128]] * 2, 1)).all()
        import torch
        from repro_torch.models import transformer
        from repro_torch.models.registry import get_config
        from repro_torch.serve.engine import Engine, Request
        mcfg = get_config("granite-3-8b").reduced()
        model = transformer.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
        eng = Engine(mcfg, model, max_batch=2, max_len=32, backend="paged",
                     page_size=4, device="cpu")
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(1, 4 + i, dtype=np.int32),
                               max_new_tokens=3))
        fin = eng.run()
        assert sorted(len(r.out_tokens) for r in fin) == [3, 3, 3]
        import tempfile
        from repro_torch.launch import train
        with tempfile.TemporaryDirectory() as d:
            train.main(["--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--ckpt-dir", d])
            from repro_torch.checkpoint.checkpointer import Checkpointer
            assert Checkpointer(d).latest_step() == 2
        rcfg = get_config("rwkv6-7b").reduced()
        rmodel = transformer.init_params(rcfg, torch.Generator().manual_seed(0), "cpu")
        eng = Engine(rcfg, rmodel, max_batch=2, max_len=32, backend="contiguous",
                     device="cpu")
        for i in range(2):
            eng.submit(Request(rid=i, prompt=np.arange(1, 5, dtype=np.int32) + i,
                               max_new_tokens=3))
        assert sorted(len(r.out_tokens) for r in eng.run()) == [3, 3]
        with tempfile.TemporaryDirectory() as d:
            train.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                        "--steps", "1", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", d])
            assert Checkpointer(d).latest_step() == 1
        bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
        assert not bad, bad
        print("isolated-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated-ok" in out.stdout


def _service(cfg, session):
    from repro_torch.serve import serve_step
    make = serve_step.make_session_service if session else serve_step.make_kv_service
    return make(cfg, serve_step.ServiceConfig(n_shards=2, n_replicas=2, lanes=16))


@pytest.mark.parametrize("make", [lambda cfg: T.KV(cfg),
                                  lambda cfg: T.ShardedKV(cfg, 4),
                                  lambda cfg: T.ReplicatedKV(cfg, 4),
                                  lambda cfg: _service(cfg, False),
                                  lambda cfg: _service(cfg, True),
                                  lambda cfg: T.recover("unused", lambda: T.ShardedKV(cfg, 2))],
                         ids=["KV", "ShardedKV", "ReplicatedKV", "make_kv_service",
                              "make_session_service", "recover"])
def test_kv_defaults_to_the_cuda_device(make):
    cfg = T.F2Config(**small_dict())
    if torch.cuda.is_available():
        assert make(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(cfg)


def test_sharded_kv_refuses_what_is_not_ported():
    cfg = T.F2Config(**small_dict())
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        T.ShardedKV(cfg, 4, dispatch="shard_map", device="cpu")
    host = T.F2Config(**small_dict(host_tier=True, host_chunk_records=16,
                                   host_cache_chunks=64))
    with pytest.raises(ValueError, match="live rebalancing"):
        T.ShardedKV(host, 4, device="cpu", compact_batch=128,
                    rebalance_cfg=T.RebalanceConfig())
    with pytest.raises(ValueError, match="replication"):
        T.ReplicatedKV(host, 4, device="cpu", compact_batch=128)
    skv = T.ShardedKV(host, 4, device="cpu", compact_batch=128)
    with pytest.raises(ValueError, match="migration"):
        skv.migrate(skv.bucket_map)
    with pytest.raises(ValueError, match="power of 2"):
        T.ShardedKV(cfg, 3, device="cpu")


def test_serving_entry_points_default_to_the_cuda_device():
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import Engine
    cfg = get_config("granite-3-8b").reduced()
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert Engine(cfg, model.cuda(), backend="paged").device.type == "cuda"
        return
    for make in (lambda: Engine(cfg, model, backend="paged"),
                 lambda: Engine(cfg, model, backend="contiguous"),
                 lambda: serve.main(["--reduced", "--requests", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_training_entry_points_default_to_the_cuda_device(tmp_path):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("granite-3-8b").reduced()
    make = lambda: Trainer(cfg, AdamWConfig(), TrainerConfig(ckpt_dir=str(tmp_path)),  # noqa: E731
                           TokenPipeline(cfg.vocab_size, batch=2, seq_len=8))
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        return
    for run in (make, lambda: train.main(["--reduced", "--steps", "1",
                                          "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_rwkv6_entry_points_default_to_the_cuda_device(tmp_path):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import Engine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("rwkv6-7b").reduced()
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    trainer = lambda: Trainer(cfg, AdamWConfig(), TrainerConfig(ckpt_dir=str(tmp_path)),  # noqa: E731
                              TokenPipeline(cfg.vocab_size, batch=2, seq_len=8))
    if torch.cuda.is_available():
        assert Engine(cfg, model.cuda()).device.type == "cuda"
        assert trainer().device.type == "cuda"
        return
    for make in (lambda: Engine(cfg, model), trainer,
                 lambda: serve.main(["--arch", "rwkv6-7b", "--reduced",
                                     "--backend", "contiguous", "--requests", "1"]),
                 lambda: train.main(["--arch", "rwkv6-7b", "--reduced", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def _port_module_names():
    return {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
            for p in _port_sources() if "repro_torch" in p.parts}


def test_port_sources_include_the_serving_slice():
    """The AST scan above walks every module of the serving slice."""
    names = _port_module_names()
    for mod in ("configs/base.py", "configs/granite_3_8b.py",
                "models/registry.py", "models/layers.py",
                "models/transformer.py", "kvcache/paged.py",
                "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py", "serve/engine.py",
                "launch/serve.py", "interop.py"):
        assert mod in names, mod


def test_port_sources_include_the_training_slice():
    """The AST scan above walks every module of the training slice."""
    names = _port_module_names()
    for mod in ("kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
                "optim/adamw.py", "train/train_step.py", "train/trainer.py",
                "checkpoint/checkpointer.py", "data/pipeline.py",
                "testing/faults.py", "launch/train.py"):
        assert mod in names, mod


def test_port_sources_include_the_sharded_slice():
    """The AST scan above walks every module of the sharded slice."""
    names = _port_module_names()
    for mod in ("core/shard_router.py", "core/rebalance.py", "core/sharded.py",
                "core/store.py", "kernels/f2_probe/ops.py",
                "kernels/f2_probe/ref.py"):
        assert mod in names, mod


def test_port_sources_include_the_replication_and_service_slice():
    """The AST scan above walks every module of the replication and
    session-service slice."""
    names = _port_module_names()
    for mod in ("core/replication.py", "core/protocol.py", "serve/sessions.py",
                "serve/serve_step.py", "core/shard_router.py", "interop.py"):
        assert mod in names, mod


def test_port_sources_include_the_durability_slice():
    """The AST scan above walks every module of the durability slice."""
    names = _port_module_names()
    for mod in ("core/durability.py", "checkpoint/checkpointer.py",
                "testing/faults.py", "core/sharded.py", "core/replication.py",
                "serve/sessions.py", "serve/serve_step.py"):
        assert mod in names, mod


def test_port_sources_include_the_host_tier_slice():
    """The AST scan above walks every module of the host-tier slice."""
    names = _port_module_names()
    for mod in ("core/host_tier.py", "core/store.py", "core/compaction.py",
                "core/api.py", "core/sharded.py", "core/durability.py",
                "core/hybrid_log.py", "interop.py", "checkpoint/checkpointer.py"):
        assert mod in names, mod


def test_host_tier_runs_with_the_reference_blocked(tmp_path):
    """A subprocess that cannot import jax, repro or benchmarks imports
    `repro_torch.core.host_tier` and runs a KV and a durable ShardedKV whose
    cold logs spill to host, through demotions, promotions, a cold->cold
    pass, a snapshot and a recovery; every read is right."""
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import repro_torch as T
        from repro_torch.core import host_tier
        cfg = T.F2Config(**{small_dict()!r} | dict(
            hot_capacity=1 << 10, hot_mem=1 << 7, cold_capacity=1 << 9,
            host_tier=True, host_chunk_records=16, host_cache_chunks=48))
        keys = np.arange(1, 3001, dtype=np.int32)
        kv = T.KV(cfg, device="cpu", compact_batch=128)
        for i in range(0, 3000, 100):
            kv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
        assert int(kv.state.cold.floor) > 0 and kv._ht.stats()["demotions_total"] > 0
        kv.compact_cold_cold()
        for i in range(0, 3000, 20):
            st, v = kv.read(keys[i:i + 20])
            assert (st.numpy() == T.ST_OK).all()
            assert (v.numpy() == np.stack([keys[i:i + 20]] * 2, 1)).all()
        assert kv._ht.stats()["promotions_total"] > 0
        kv.check_invariants()
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            mk = lambda: T.ShardedKV(cfg, 2, device="cpu", compact_batch=128)
            dkv = T.DurableKV(mk(), T.DurabilityConfig(dir=d))
            for i in range(0, 3000, 100):
                dkv.upsert(keys[i:i + 100], np.stack([keys[i:i + 100]] * 2, 1))
            dkv.snapshot(blocking=True)
            assert dkv.kv._ht.host_chunks() > 0
            rec = T.recover(d, mk)
            assert rec.kv._ht.host_chunks() == dkv.kv._ht.host_chunks()
            for i in range(0, 3000, 50):
                st, v = rec.read(keys[i:i + 50])
                assert (st.numpy() == T.ST_OK).all()
                assert (v.numpy() == np.stack([keys[i:i + 50]] * 2, 1)).all()
        bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
        assert not bad, bad
        assert "repro_torch.core.host_tier" in sys.modules
        print("isolated-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated-ok" in out.stdout


def test_port_sources_include_the_obs_slice():
    """The AST scan above walks every module of the observability slice."""
    names = _port_module_names()
    for mod in ("obs/__init__.py", "obs/_flags.py", "obs/metrics.py",
                "obs/trace.py", "obs/journal.py", "obs/latency.py",
                "obs/rules.py", "obs/export.py", "obs/serve.py",
                "obs/report.py", "testing/faults.py", "interop.py"):
        assert mod in names, mod


def test_port_sources_include_the_ssm_slice():
    """The AST scan above walks every module of the RWKV-6 slice."""
    names = _port_module_names()
    for mod in ("models/rwkv6.py", "kernels/rwkv6_wkv/ops.py",
                "kernels/rwkv6_wkv/ref.py", "serve/serve_step.py",
                "configs/rwkv6_7b.py"):
        assert mod in names, mod


def test_forced_kernel_engine_refuses_cpu_tensors():
    kv = T.KV(T.F2Config(**small_dict(engine="fused_cuda")), device="cpu")
    keys = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="fused_cuda"):
        kv.upsert(keys, np.zeros((8, 2), np.int32))
    with pytest.raises(ValueError, match="fused_cuda"):
        probe_engine.resolve("fused_cuda", torch.device("cpu"))
    assert probe_engine.resolve("fused", torch.device("cpu")) == "fused_ref"
    assert probe_engine.resolve("fused", torch.device("cuda")) == "fused_cuda"


def test_kernel_wrappers_count_only_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; tensors on other devices are refused."""
    ops.reset_launches()
    kv = T.KV(T.F2Config(**small_dict()), device="cpu")
    kv.upsert(np.arange(64, dtype=np.int32), np.ones((64, 2), np.int32))
    st = kv.state
    cols = (st.hot.key, st.hot.val, st.hot.prev, st.hot.meta,
            st.rc.key, st.rc.val, st.rc.prev, st.rc.meta)
    keys = torch.arange(16, dtype=torch.int32)
    found = ops.fused_probe(keys, st.hot_index, st.hot.begin.repeat(16),
                            torch.ones(16, dtype=torch.bool), st.hot.tail,
                            *cols, chain_max=8)[0]
    assert bool(found.all())
    ops.fused_write(keys, torch.full((16,), T.OP_RMW, dtype=torch.int32),
                    torch.ones((16, 2), dtype=torch.int32), st.hot_index,
                    st.hot.begin, st.hot.begin, st.hot.begin, st.hot.tail,
                    *cols, chain_max=8)
    addr, _ = ops.probe(keys, st.hot_index)
    assert addr.dtype == torch.int32 and addr.shape == (16,)
    # a stacked store's [S, B] lanes run the plain versions on the CPU too
    skv = T.ShardedKV(T.F2Config(**small_dict()), 2, device="cpu")
    skv.upsert(np.arange(64, dtype=np.int32), np.ones((64, 2), np.int32))
    addr, _ = ops.probe(torch.stack([keys, keys]), skv.state.hot_index)
    assert addr.shape == (2, 16)
    assert ops.launches == {"fused_probe": 0, "fused_write": 0, "probe": 0}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.probe_cuda(keys, st.hot_index)
    meta = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.fused_probe(meta, st.hot_index, meta, meta.bool(), st.hot.tail,
                        *cols, chain_max=4)
