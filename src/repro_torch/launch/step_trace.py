"""One step traced on a device mesh (the JAX package's `launch/hlo_tree.py`,
which walks the partitioned HLO with loop trip counts).  Here the step runs
eagerly, on DTensors, so every layer runs and is counted as it runs.  A
recurrence over the sequence (the WKV and the selective scan, a `lax.scan`
in the reference) runs one step's body under `repeat(T)` on `meta` tensors
(`scan_by_trip_count`), and what the body does counts T times, as the
reference counts a scanned body by its trip count; `unrolled()` runs every
step instead, to check the two against each other.

`StepTrace` is a dispatch mode that sees the aten operations a step runs:

  * on a DTensor it steps aside (`NotImplemented`), so DTensor dispatches
    the operation and the mode sees what each device runs: the operation on
    the local shards, and the collectives of every redistribution;
  * on the global-shape fake tensors of DTensor's sharding propagation,
    and on the factories that make them under its fake mode, it counts
    nothing (they describe the whole tensor, not a device's work);
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
    all-to-all that was asked for;
  * it keeps the live bytes of the local tensors the step creates, keyed by
    storage (a view counts with its base, once) and dropped when the last
    tensor on a storage is freed (weak references), and their peak
    (`temp_peak`): the eager step's temporaries per device.  A loop body
    under `repeat` holds one step's live set, which is not multiplied.
"""
from __future__ import annotations

import sys
import weakref
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


_TRIPS = [1]            # what runs now counts this many times
_UNROLLED = [False]


class repeat:
    """Context manager: what runs inside counts `n` times in every
    `StepTrace` (FLOPs, operand bytes, collectives), as one step of a loop
    stands for its trip count.  Nested, the counts multiply; `repeat(0)`
    counts nothing."""

    def __init__(self, n: int):
        self.n = int(n)

    def __enter__(self):
        _TRIPS.append(_TRIPS[-1] * self.n)
        return self

    def __exit__(self, *exc):
        _TRIPS.pop()
        return False


class unrolled:
    """Context manager: `by_trip_count()` is False inside, so the
    recurrences run every step of their loops on `meta` tensors too."""

    def __enter__(self):
        _UNROLLED.append(True)
        return self

    def __exit__(self, *exc):
        _UNROLLED.pop()
        return False


def by_trip_count() -> bool:
    """Whether a recurrence on `meta` tensors runs one step under `repeat`
    (the default) rather than every step."""
    return not _UNROLLED[-1]


def scan_by_trip_count(step, n: int, *xs):
    """`step(*xs)` (a tuple of tensors: one step of a recurrence over n),
    counted as n runs of it.  Where a gradient will be taken, the backward
    pass runs the step's gradient counted n times too: an autograd Function
    whose backward recomputes the step uncounted (`repeat(0)`) and takes
    its gradient under `repeat(n)`."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in xs):
        return _Repeated.apply(n, step, *xs)
    with repeat(n):
        return tuple(step(*xs))


class _Repeated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, step, *xs):
        ctx.set_materialize_grads(False)
        ctx.n, ctx.step = n, step
        ctx.save_for_backward(*xs)
        with repeat(n):
            return tuple(step(*xs))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(q) if x is not None else None
                   for x, q in zip(xs, need)]
            with repeat(0):
                outs = ctx.step(*ins)
            # a step inside the loop gets a gradient for every output (the
            # carried state's from the next step): an unused one is zeros
            pairs = [(o, torch.zeros_like(o) if g is None else g)
                     for o, g in zip(outs, gs) if o.requires_grad]
            wrt = [i for i in ins if i is not None and i.requires_grad]
            with repeat(ctx.n):
                got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                          [g for _, g in pairs], allow_unused=True)
        # an input the step does not reach gets zeros, laid out as it is
        got = iter(torch.zeros_like(i) if g is None else g for i, g in zip(wrt, got))
        return (None, None) + tuple(next(got) if i is not None and i.requires_grad
                                    else None for i in ins)


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
        self.temp_live = 0          # bytes of the step's tensors alive now
        self.temp_peak = 0
        self._live: Dict[int, list] = {}   # storage -> [bytes, weakrefs]
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
        if (any(isinstance(a, FakeTensor) for a in leaves)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)):
            return func(*args, **kwargs)     # sharding propagation's stand-ins
        if func is torch.ops.aten.view.default and not args[0].is_contiguous():
            # DTensor views a local shard by its global layout, which a
            # sliced shard may not have; a meta tensor holds no data, so
            # viewing a contiguous copy traces the same step
            args = (args[0].contiguous(),) + tuple(args[1:])
        out = func(*args, **kwargs)
        # the functional collectives' autograd wrapper is its input on a
        # device (on `meta` its fake kernel makes a new tensor)
        wrap = (func.namespace == "_c10d_functional"
                and func._overloadpacket.__name__ == "_wrap_tensor_autograd")
        self._hold(out, leaves, alias=args[0] if wrap else None)
        n = _TRIPS[-1]
        if func.namespace == "_c10d_functional":
            if n:
                self._record(func, args, n)
            return out
        pk = func._overloadpacket
        if pk in flop_registry and n:
            self.flops += n * int(flop_registry[pk](*args, **kwargs, out_val=out))
            self.op_bytes += n * sum(t.numel() * t.element_size()
                                     for t in tree_leaves((args, out))
                                     if isinstance(t, torch.Tensor))
        return out

    def _hold(self, out, inputs, alias=None):
        """Count the new storages among an operation's results as live until
        their last tensor is freed (a result on an input's storage, a view or
        an in-place result, adds a reference to a storage already counted, or
        belongs to a tensor the step did not create; `alias`: the results
        stand for this tensor, whatever storage `meta` gave them)."""
        seen = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = (t if alias is None else alias).untyped_storage()._cdata
            entry = self._live.get(key)
            if entry is None and alias is not None:
                continue
            if entry is None:
                if seen is None:
                    seen = {a.untyped_storage()._cdata for a in inputs
                            if isinstance(a, torch.Tensor)}
                if key in seen:
                    continue
                entry = self._live[key] = [t.untyped_storage().nbytes(), {}]
                self.temp_live += entry[0]
                self.temp_peak = max(self.temp_peak, self.temp_live)
            ref = weakref.ref(t, lambda r, k=key: self._drop(k, r))
            entry[1][id(ref)] = ref

    def _drop(self, key, ref):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1].pop(id(ref), None)
        if not entry[1]:
            del self._live[key]
            self.temp_live -= entry[0]

    def _record(self, func, args, n: int):
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
            kind, b, ranks, self._groups.get(group_name, ()), count=n))

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
