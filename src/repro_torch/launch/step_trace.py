"""One step traced on a device mesh (the JAX package's `launch/hlo_tree.py`,
which walks the partitioned HLO with loop trip counts).  Here the step runs
eagerly, on DTensors, so every layer runs and is counted as it runs: there
is no loop body to multiply by a trip count.

`StepTrace` is a dispatch mode that sees the aten operations a step runs:

  * on a DTensor it steps aside (`NotImplemented`), so DTensor dispatches
    the operation and the mode sees what each device runs: the operation on
    the local shards, and the collectives of every redistribution;
  * on the global-shape fake tensors of DTensor's sharding propagation it
    counts nothing (they describe the whole tensor, not a device's work);
  * on plain tensors (local shards) it adds the operation's FLOPs
    (`torch.utils.flop_counter`'s formulas), and for those operations the
    bytes of their operands and results (the HBM-traffic proxy, as the
    reference counts dot operand and result bytes);
  * a view of a non-contiguous local shard views a contiguous copy
    (DTensor views a shard by the global tensor's layout; a meta tensor
    holds no data, so the traced step is the same);
  * on a functional collective it records a `comm_analysis.CollectiveOp`:
    its kind as the step asked for it, its result bytes, its group and the
    mesh dimensions the group spans.  On a CPU group DTensor runs an
    all-to-all as an all-gather and a chunk; the trace records the
    all-to-all that was asked for.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import comm_analysis

# functional collective -> (kind, result bytes from the input's)
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _asked_all_to_all() -> bool:
    """Whether the current collective runs inside DTensor's all-to-all (its
    CPU fallback gathers and chunks)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class StepTrace(TorchDispatchMode):
    """Per-device FLOPs, operand bytes and collectives of what runs under
    it (see the module docstring).  `mesh` (a DeviceMesh) names the mesh
    dimensions a group spans."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.collectives: List[comm_analysis.CollectiveOp] = []
        self._groups: Dict[str, tuple] = {}
        if mesh is not None:
            for d in range(mesh.ndim):
                name = mesh.get_group(d).group_name
                self._groups[name] = self._groups.get(name, ()) + (d,)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, FakeTensor) for a in leaves):
            return func(*args, **kwargs)
        if func is torch.ops.aten.view.default and not args[0].is_contiguous():
            # DTensor views a local shard by its global layout, which a
            # sliced shard may not have; a meta tensor holds no data, so
            # viewing a contiguous copy traces the same step
            args = (args[0].contiguous(),) + tuple(args[1:])
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            self._record(func, args)
            return out
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += int(flop_registry[pk](*args, **kwargs, out_val=out))
            self.op_bytes += sum(t.numel() * t.element_size()
                                 for t in tree_leaves((args, out))
                                 if isinstance(t, torch.Tensor))
        return out

    def _record(self, func, args):
        name = func._overloadpacket.__name__
        kind = _FUNCTIONAL.get(name)
        if kind is None:                    # wait_tensor and the like
            return
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        x = args[0]
        group_name = args[-1]
        pg = _resolve_process_group(group_name)
        ranks = dist.get_process_group_ranks(pg)
        g = len(ranks)
        b = x.numel() * x.element_size()
        if kind == "all-gather":
            if _asked_all_to_all():
                kind = "all-to-all"         # asked: an all-to-all of x
            else:
                b *= g
        elif kind == "reduce-scatter":
            b //= g
        self.collectives.append(comm_analysis.make_op(
            kind, b, ranks, self._groups.get(group_name, ())))

    def summary(self) -> Dict[str, object]:
        return comm_analysis.collective_summary(self.collectives)


def local_bytes(tensors) -> int:
    """Bytes one device holds of these tensors (a DTensor's local shard,
    a plain tensor whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
