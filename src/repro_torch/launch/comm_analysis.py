"""Collective inventory and roofline terms of a traced step (the JAX
package's `launch/hlo_analysis.py`; there the collectives are parsed from
the partitioned HLO text, which has no counterpart here: `step_trace`
records them as the step asks for them).

Per-device link bytes follow the standard ring formulas, in terms of the
bytes of the collective's result:

    all-reduce       2 (G-1)/G * bytes
    all-gather         (G-1)/G * bytes_out
    reduce-scatter     (G-1)   * bytes_out        (= (G-1)/G * bytes_in)
    all-to-all         (G-1)/G * bytes
    collective-permute  bytes

The hardware model is the H100 SXM's datasheet, not a measurement: 989
TFLOP/s dense bf16, 3.35 TB/s of HBM3, NVLink 4 at 450 GB/s a direction
within a node of 8 GPUs, and 50 GB/s a GPU between nodes (400 Gb/s NDR).
A group whose ranks span two nodes is charged at the inter-node rate (the
reference's pod boundary becomes the node boundary).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence

PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s of HBM3
NVLINK_BW = 450e9            # bytes/s a direction, within a node
INTERNODE_BW = 50e9          # bytes/s a GPU between nodes (400 Gb/s NDR)
NODE_SIZE = 8                # GPUs a node

@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_result: int
    group_size: int
    cross_node: bool
    link_bytes: float        # per-device bytes over the wire
    mesh_dims: tuple = ()    # the mesh dimensions the group spans
    count: int = 1           # times it runs (a loop body's trip count)


def link_bytes(kind: str, bytes_result: int, group_size: int) -> float:
    """Per-device bytes over the wire of one collective (ring formulas)."""
    g = max(group_size, 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * bytes_result
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * bytes_result
    if kind == "reduce-scatter":
        return float((g - 1) * bytes_result)
    if kind == "collective-permute":
        return float(bytes_result)
    raise ValueError(f"unknown collective {kind!r}")


def crosses_node(ranks: Sequence[int], node_size: int = NODE_SIZE) -> bool:
    return min(ranks) // node_size != max(ranks) // node_size


def make_op(kind: str, bytes_result: int, ranks: Sequence[int],
            mesh_dims: tuple = (), count: int = 1) -> CollectiveOp:
    g = len(ranks)
    return CollectiveOp(kind=kind, bytes_result=int(bytes_result), group_size=g,
                        cross_node=crosses_node(ranks),
                        link_bytes=link_bytes(kind, bytes_result, g),
                        mesh_dims=tuple(mesh_dims), count=int(count))


def collective_summary(ops: List[CollectiveOp]) -> Dict[str, object]:
    """Link bytes by kind and by link class (within a node, between nodes),
    and the count of collectives, each op counted `count` times (the
    reference's `hlo_tree` weighs a loop body's collectives by its trip
    count)."""
    by_kind: Dict[str, float] = defaultdict(float)
    intra = inter = 0.0
    count = 0
    for op in ops:
        b = op.link_bytes * op.count
        by_kind[op.kind] += b
        count += op.count
        if op.cross_node:
            inter += b
        else:
            intra += b
    return {"by_kind": dict(by_kind), "intra_node_bytes": intra,
            "inter_node_bytes": inter, "count": count}


def roofline_terms(flops: float, hbm_bytes: float, coll: Dict[str, object],
                   n_devices: int) -> Dict[str, object]:
    """Three roofline terms in seconds (per step, per device): the FLOPs
    and HBM bytes one device does and moves, and its collectives' link
    bytes over NVLink or the inter-node rate."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    t_coll = (coll["intra_node_bytes"] / NVLINK_BW
              + coll["inter_node_bytes"] / INTERNODE_BW)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dominant}
