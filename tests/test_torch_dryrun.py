"""The port's dry-run (`repro_torch.launch.{comm_analysis, step_trace,
dryrun}`): the ring formulas against the JAX package's HLO analyzer on its
own test case, a traced L-layer loop counting every layer, and reduced
cells laid out on a fake group of 16 ranks (a 4 x 4 mesh): a dense
training cell (its FLOPs per device, a ZeRO-3 weight all-gather, its
argument bytes equal to the specs' arithmetic, its temporaries), GLM-4's
and Whisper's decode under both cache layouts (the cache written without
DTensor's `index_copy_`), RWKV-6's and Hymba's recurrences counted by trip
count equal to the full per-token loop, the temporaries' peak of a
hand-built step, and the plain-tensor decode of every family unchanged by
the sharded cache write."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import hlo_tree
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, placements
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch import comm_analysis, dryrun, specs, step_trace
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.registry import get_config


def test_collective_formulas():
    """tests/test_hlo_tree.py's case: an f32[64, 64] all-reduce in groups of
    4 of 8 devices is 2 * 3/4 * 16,384 link bytes, as the reference's HLO
    analyzer reads it; the other kinds follow the ring formulas."""
    text = """
ENTRY %main (p: f32[64,64]) -> f32[64,64] {
  %p = f32[64,64]{1,0} parameter(0)
  %ar = f32[64,64]{1,0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%add
  ROOT %r = f32[64,64]{1,0} add(%ar, %ar)
}
"""
    b = 64 * 64 * 4
    ref = hlo_tree.analyze(text, 8)["collectives"]["ici_bytes"]
    op = comm_analysis.make_op("all-reduce", b, [0, 1, 2, 3])
    assert op.link_bytes == pytest.approx(2 * 3 / 4 * b) == pytest.approx(ref)
    s = comm_analysis.collective_summary([op])
    assert s["intra_node_bytes"] == pytest.approx(ref) and s["inter_node_bytes"] == 0
    assert comm_analysis.link_bytes("all-gather", b, 4) == 3 / 4 * b
    assert comm_analysis.link_bytes("reduce-scatter", b, 4) == 3 * b
    assert comm_analysis.link_bytes("all-to-all", b, 4) == 3 / 4 * b
    assert comm_analysis.link_bytes("collective-permute", b, 4) == b
    # a group across the 8-GPU node boundary goes at the inter-node rate
    far = comm_analysis.make_op("all-reduce", b, list(range(4, 12)))
    s = comm_analysis.collective_summary([far])
    assert far.cross_node and s["inter_node_bytes"] == far.link_bytes
    roof = comm_analysis.roofline_terms(989e12, 3.35e12, s, 16)
    assert roof["compute_s"] == pytest.approx(1.0) and roof["memory_s"] == pytest.approx(1.0)
    assert roof["collective_s"] == pytest.approx(far.link_bytes / 50e9)
    assert comm_analysis.roofline_terms(0.0, 0.0, s, 16)["dominant"] == "collective"


@pytest.fixture(scope="module")
def fake16():
    """This process as rank 0 of a fake group of 16 ranks, and a 4 x 4 mesh."""
    import torch.distributed as dist
    dryrun.fake_world(16)
    yield make_mesh((4, 4), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


def _loop(mesh, L):
    """L layers of x @ w_l, each weight stored ZeRO-3 (rows over data) and
    used replicated: every layer gathers its weight once."""
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          placements(P("data", None), mesh))
    ws = [distribute_tensor(torch.empty(32, 32, device="meta"), mesh,
                            placements(P("data", None), mesh)) for _ in range(L)]
    trace = step_trace.StepTrace(mesh)
    with trace:
        for w in ws:
            w = w.redistribute(mesh, placements(P(None, None), mesh))
            x = x @ w
    return trace


def test_loop_counts_every_layer(fake16):
    """An eager L-layer loop runs every layer: its FLOPs, collectives and
    link bytes are L times one layer's (the reference multiplies a scanned
    body by its trip count)."""
    one, three = _loop(fake16, 1), _loop(fake16, 3)
    assert one.flops == 2 * 16 * 32 * 32            # a device's 16 rows
    assert three.flops == 3 * one.flops
    assert len(one.collectives) == 1 and len(three.collectives) == 3
    op = one.collectives[0]
    assert op.kind == "all-gather" and op.group_size == 4 and op.mesh_dims == (0,)
    assert op.bytes_result == 32 * 32 * 4
    s1, s3 = one.summary(), three.summary()
    assert s3["intra_node_bytes"] + s3["inter_node_bytes"] == pytest.approx(
        3 * (s1["intra_node_bytes"] + s1["inter_node_bytes"]))


def test_all_to_all_recorded_as_asked(fake16):
    """A Shard(0) -> Shard(1) redistribution asks for an all-to-all, which a
    CPU group runs as an all-gather and a chunk: the trace records the
    all-to-all, with the input's bytes."""
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.empty(64, 64, device="meta"), fake16,
                          placements(P(None, "model"), fake16))
    trace = step_trace.StepTrace(fake16)
    with trace:
        x.redistribute(fake16, placements(P("model", None), fake16))
    assert [op.kind for op in trace.collectives] == ["all-to-all"]
    assert trace.collectives[0].bytes_result == 64 * 16 * 4
    assert trace.collectives[0].mesh_dims == (1,)


def test_reduced_dense_train_cell(fake16):
    """Granite-3-8B reduced, a training step of 8 x 64 tokens on the 4 x 4
    fake group: `run_cell` returns ok in-process with the FLOPs one device
    does, a ZeRO-3 all-gather over `data`, its argument bytes equal to the
    specs' arithmetic, and the model FLOPs of 6ND."""
    cfg = dataclasses.replace(get_config("granite_3_8b").reduced(), dtype="bfloat16")
    shape = ShapeSpec("train_tiny", 64, 8, "train")
    rec = dryrun.run_cell("granite_3_8b", "train_tiny", False, verbose=False,
                          cfg=cfg, shape=shape, mesh_shape=(4, 4))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == [4, 4] and rec["n_devices"] == 16
    assert "meta" in rec["device"]
    assert rec["cost"]["flops_per_device"] > 0
    kinds = rec["collectives"]["by_kind"]
    assert kinds.get("all-gather", 0) > 0 and rec["collectives"]["count"] > 0
    assert sum(rec["comm_debug_counts"].values()) > 0
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 4}
    assert rec["memory"]["argument_bytes_per_device"] == specs.argument_bytes(
        cfg, shape, Mesh())
    mem = rec["memory"]
    assert mem["temp_bytes_per_device"] > 0 and mem["temp_bytes_method"]
    assert mem["total_bytes_per_device"] == (mem["argument_bytes_per_device"]
                                             + mem["temp_bytes_per_device"])
    n = cfg.active_param_count()
    assert rec["model_flops"] == 6.0 * n * 8 * 64
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}


def test_skipped_and_failed_cells_are_recorded(fake16):
    """A shape the assignment rules exclude is `skipped`; a cell whose step
    raises is `failed` with its error (never dropped)."""
    rec = dryrun.run_cell("granite_3_8b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped" and rec["reason"]
    bad = dataclasses.replace(get_config("granite_3_8b").reduced(), family="nope")
    rec = dryrun.run_cell("granite_3_8b", "train_tiny", False, verbose=False,
                          cfg=bad, shape=ShapeSpec("train_tiny", 64, 8, "train"),
                          mesh_shape=(4, 4))
    assert rec["status"] == "failed" and "nope" in rec["error"]


def _reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")


def _cell(arch, kind, T=8, B=8, **kw):
    shape = ShapeSpec(f"{kind}_tiny", T, B, kind)
    rec = dryrun.run_cell(arch, shape.name, False, verbose=False, cfg=_reduced(arch),
                          shape=shape, mesh_shape=(4, 4), **kw)
    assert rec["status"] == "ok", rec.get("error")
    return rec


@pytest.mark.parametrize("layout", ["seq", "heads"])
@pytest.mark.parametrize("arch", ["glm4_9b", "whisper_large_v3"])
def test_decode_cell_runs_under_both_cache_layouts(fake16, monkeypatch, arch, layout):
    """GLM-4's and Whisper's decode (the two cells that failed at
    decode_32k) run with the cache's sequence (`seq`) or its KV heads
    (`heads`) over `model`, with temporaries and total = arguments +
    temporaries."""
    monkeypatch.setattr(sharding, "_DECODE_KV", layout)
    rec = _cell(arch, "decode", T=64)
    mem = rec["memory"]
    assert rec["cost"]["flops_per_device"] > 0 and mem["temp_bytes_per_device"] > 0
    assert mem["total_bytes_per_device"] == (mem["argument_bytes_per_device"]
                                             + mem["temp_bytes_per_device"])


class _Ops(TorchDispatchMode):
    """The aten operations run under it: applied to a DTensor (which it
    hands on to DTensor) or to plain tensors."""

    def __init__(self):
        super().__init__()
        self.on_dtensor, self.plain = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.on_dtensor.add(func)
            return NotImplemented
        self.plain.add(func)
        return func(*args, **(kwargs or {}))


def test_sharded_cache_write_skips_dtensor_index_copy(fake16):
    """A decode cell writes its cache without `aten.index_copy_` on a
    DTensor (PyTorch 2.11 has no sharding strategy for it; 2.13 has one
    that relabels the cache's placements): each shard writes its own rows.
    A decode on plain tensors still calls `index_copy_`."""
    from torch.distributed.tensor.experimental import implicit_replication
    copy = torch.ops.aten.index_copy_.default
    cfg = _reduced("granite_3_8b")
    shape = ShapeSpec("decode_tiny", 64, 8, "decode")
    with sharding.use_mesh(fake16), implicit_replication():
        fn, args = dryrun.build_cell("granite_3_8b", shape.name, fake16, cfg=cfg,
                                     shape=shape)
        cache = args[1]
        before = (tuple(cache["k"].placements), tuple(cache["v"].placements))
        ops = _Ops()
        with ops:
            fn(*args)
    assert copy not in ops.on_dtensor and copy in ops.plain
    assert (tuple(cache["k"].placements), tuple(cache["v"].placements)) == before
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    plain = transformer.init_cache(cfg, 2, 16)
    ops = _Ops()
    with ops:
        transformer.decode_step(cfg, model, plain, torch.tensor([3, 5], dtype=torch.int32))
    assert copy in ops.plain and not ops.on_dtensor


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["rwkv6_7b", "hymba_1_5b"])
def test_recurrence_by_trip_count_equals_full_loop(fake16, arch, kind):
    """At T = 8, the WKV (RWKV-6) and the selective scan (Hymba) run one
    step counted 8 times, forward and gradient: the FLOPs, operand bytes
    and collectives equal the full per-token loop's (the reference counts a
    scanned body by its trip count)."""
    by_trips = _cell(arch, kind)
    with step_trace.unrolled():
        full = _cell(arch, kind)
    assert by_trips["cost"] == full["cost"]
    assert by_trips["collectives"] == full["collectives"]
    assert by_trips["cost"]["flops_per_device"] > 0


@pytest.mark.parametrize("grad", [False, True])
def test_wkv_step_counts_its_trip_count(grad):
    """The WKV on meta tensors: at T = 8 one step under `repeat(8)` counts 8
    times a T = 1 call's FLOPs and operand bytes, as does the unrolled loop,
    forward and (with `grad`) gradient; the outputs have their shapes."""
    def counted(T, unrolled=False):
        r, k, v, w = (torch.empty(2, 3, T, 16, device="meta", requires_grad=grad)
                      for _ in range(4))
        u = torch.empty(3, 16, device="meta", requires_grad=grad)
        trace = step_trace.StepTrace()
        with trace:
            if unrolled:
                with step_trace.unrolled():
                    y, s = wkv_ops.wkv(r, k, v, w, u, None, need_state=True)
            else:
                y, s = wkv_ops.wkv(r, k, v, w, u, None, need_state=True)
            assert y.shape == (2, 3, T, 16) and s.shape == (2, 3, 16, 16)
            if grad:
                torch.autograd.grad((y.sum(), s.sum()), (r, k, v, w, u))
        return trace.flops, trace.op_bytes
    one = counted(1)
    assert one[0] > 0
    assert counted(8) == counted(8, unrolled=True) == (8 * one[0], 8 * one[1])


def test_temporaries_of_a_hand_built_step(fake16):
    """The temporaries are the peak of the live local shards the step makes:
    x * 2 (16 x 32 float32 = 2,048 bytes a device), then its product with a
    replicated [32, 48] (16 x 48 = 3,072 more), a peak of 5,120 before the
    first is freed; the total is arguments + temporaries."""
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.empty(64, 32, device="meta"), fake16,
                          placements(P("data", None), fake16))
    w = distribute_tensor(torch.empty(32, 48, device="meta"), fake16,
                          placements(P(None, None), fake16))

    def step(x, w):
        a = x * 2.0
        b = a @ w
        del a
        return b.sum(0)

    trace = step_trace.StepTrace(fake16)
    with trace:
        out = step(x, w)
    assert trace.temp_peak == 2048 + 3072
    assert trace.temp_live == 48 * 4             # the output alone
    mem = dryrun.memory_record(step_trace.local_bytes([x, w]), (x, w), out, trace)
    assert mem["argument_bytes_per_device"] == 2048 + 32 * 48 * 4
    assert mem["output_bytes_per_device"] == 48 * 4
    assert mem["temp_bytes_per_device"] == 5120
    assert mem["total_bytes_per_device"] == 2048 + 32 * 48 * 4 + 5120


@pytest.mark.parametrize("arch", ["granite_3_8b", "phi35_moe_42b_a6_6b", "rwkv6_7b",
                                  "hymba_1_5b", "whisper_large_v3", "llava_next_34b"])
def test_plain_decode_unchanged_by_the_sharded_write(monkeypatch, arch):
    """Every family's decode on plain tensors (reduced, float32, no mesh)
    gives the same logits and caches, bit for bit, through
    `sharding.index_write_` as through `index_copy_` itself."""
    cfg = get_config(arch).reduced()
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 2)).astype(np.int32)

    def run():
        cache = transformer.init_cache(cfg, 2, 16)
        if cfg.is_encoder_decoder:
            g = torch.Generator().manual_seed(1)
            for n in ("xk", "xv"):
                cache[n] = torch.randn(cache[n].shape, generator=g)
        out = []
        for t in toks:
            lg, cache = transformer.decode_step(cfg, model, cache, torch.from_numpy(t))
            out.append(lg)
        return out, cache

    got, got_cache = run()
    monkeypatch.setattr(transformer, "index_write_",
                        lambda x, dim, index, src: x.index_copy_(dim, index, src))
    want, want_cache = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(got_cache) == set(want_cache)
    for n in got_cache:
        assert torch.equal(got_cache[n], want_cache[n]), n
