"""The port's dry-run (`repro_torch.launch.{comm_analysis, step_trace,
dryrun}`): the ring formulas against the JAX package's HLO analyzer on its
own test case, a traced L-layer loop counting every layer, and one reduced
dense training cell laid out on a fake group of 16 ranks (a 4 x 4 mesh):
its FLOPs per device, a ZeRO-3 weight all-gather, and its argument bytes
equal to the specs' arithmetic."""
import dataclasses

import pytest
import torch

from repro.launch import hlo_tree
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import P, placements
from repro_torch.launch import comm_analysis, dryrun, specs, step_trace
from repro_torch.launch.mesh import make_mesh
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
    assert rec["memory"]["temp_bytes_per_device"] is None
    assert rec["memory"]["temp_bytes_reason"]
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
