"""Logical-axis sharding rules -> partition specs and DTensor placements
(the JAX package's `distributed/sharding.py`).

Models annotate activations and parameters with *logical* axis names; a
rules table maps them onto mesh axes.  The single-pod mesh is ("data",
"model"); the multi-pod one prepends "pod".  The same model code runs under
either mesh or none: `constrain` leaves a plain tensor alone, and with no
active mesh it leaves every tensor alone.

A mesh is a `torch.distributed.device_mesh.DeviceMesh`, or any object with
`axis_names` and `shape` (a mapping from axis name to size), the way the
reference's tests describe one.  `use_mesh(mesh)` makes a mesh the active
one, as `jax.set_mesh` does.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of mesh axis names (the dimension split over their product,
    the first axis outermost)."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# logical axis -> mesh axis (or tuple of mesh axes).
# DEFAULT_RULES = storage layout (params, optimizer moments, caches) and the
# serving activation layout (tensor parallel over `model`).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),      # data parallel over pod x data
    "fsdp": ("pod", "data"),       # ZeRO-3 parameter shards
    "seq": None,                   # activations sequence dim
    "cache_seq": "model",          # decode KV cache sequence dim
    "embed": None,                 # d_model of activations
    "heads": "model",              # attention heads (tensor parallel)
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",                # ffn hidden
    "expert": "model",             # expert parallelism
    "vocab": "model",              # embedding/logits vocab shard
    "stage": "pod",                # pipeline stages (optional)
    "ssm_state": None,
}

# Training activation layout: FSDP + sequence parallelism.  The residual
# stream stays sharded (batch x seq) across all devices between layers;
# weights are ZeRO-3-gathered per layer instead.
#
# REPRO_TRAIN_LAYOUT selects the training layout:
#   sp_zero3 (default) -- residual seq-sharded, weights ZeRO-3 gathered
#   sp_tp              -- Megatron TP+SP: attn heads / mlp hidden over model
# REPRO_DECODE_KV selects the decode cache layout:
#   seq (default)      -- cache sequence over model (flash-decode combine)
#   heads              -- KV heads over model (`fit_spec` replicates the
#                         cache for archs whose kv_heads don't divide it)
_TRAIN_LAYOUT = os.environ.get("REPRO_TRAIN_LAYOUT", "sp_zero3")
_DECODE_KV = os.environ.get("REPRO_DECODE_KV", "seq")

if _TRAIN_LAYOUT == "sp_tp":
    TRAIN_RULES: Dict[str, Axis] = dict(DEFAULT_RULES, seq="model")
else:
    TRAIN_RULES = dict(DEFAULT_RULES, seq="model",
                       heads=None, kv_heads=None, mlp=None)
SERVE_RULES: Dict[str, Axis] = dict(DEFAULT_RULES)
if _DECODE_KV == "heads":
    SERVE_RULES["cache_seq"] = None

_ACTIVE_RULES: list = []
_ACTIVE_MESH: list = []


class use_rules:
    """Context manager selecting the activation rule set (parameters keep
    DEFAULT_RULES for storage)."""

    def __init__(self, rules: Dict[str, Axis]):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()
        return False


def active_rules() -> Dict[str, Axis]:
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else DEFAULT_RULES


class use_mesh:
    """Context manager making `mesh` the active mesh (`jax.set_mesh`)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def active_mesh():
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def _mesh_obj(mesh):
    return mesh if mesh is not None else active_mesh()


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names")
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a mesh-like object."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def mesh_axes(mesh=None) -> Tuple[str, ...]:
    m = _mesh_obj(mesh)
    return axis_names(m) if m is not None else ()


def _entry(axs: Tuple[str, ...]) -> Axis:
    if not axs:
        return None
    return axs[0] if len(axs) == 1 else axs


def spec_for(logical: Sequence[Optional[str]],
             rules: Optional[Dict[str, Axis]] = None, mesh=None,
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """A PartitionSpec from logical axis names.

    Mesh axes missing from the mesh are dropped ('pod' on a single-pod
    mesh), and, when `shape` is given, so are axes whose size does not
    divide the dimension (GQA kv_heads=8 on a 16-way model axis replicates;
    batch=1 stays unsharded on data).  A mesh axis is used at most once."""
    rules = rules or DEFAULT_RULES
    m = _mesh_obj(mesh)
    avail = set(axis_names(m)) if m is not None else set()
    sizes = axis_sizes(m) if m is not None else {}
    out = []
    used = set()
    for i, name in enumerate(logical):
        ax = rules.get(name) if name else None
        if ax is None:
            out.append(None)
            continue
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        axs = tuple(a for a in axs if a in avail and a not in used)
        if shape is not None and axs:
            kept, prod = [], 1
            for a in axs:
                if shape[i] % (prod * sizes.get(a, 1)) == 0:
                    kept.append(a)
                    prod *= sizes.get(a, 1)
            axs = tuple(kept)
        used.update(axs)
        out.append(_entry(axs))
    return PartitionSpec(*out)


def fit_spec(spec: Sequence[Axis], shape: Sequence[int], mesh=None
             ) -> PartitionSpec:
    """Drop mesh axes from a spec where they don't divide the dimension;
    with no mesh, the empty spec."""
    m = _mesh_obj(mesh)
    if m is None:
        return PartitionSpec()
    sizes = axis_sizes(m)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axs = (entry,) if isinstance(entry, str) else tuple(entry)
        kept, prod = [], 1
        for a in axs:
            if shape[i] % (prod * sizes.get(a, 1)) == 0:
                kept.append(a)
                prod *= sizes.get(a, 1)
        out.append(_entry(tuple(kept)))
    while len(out) < len(shape):
        out.append(None)
    return PartitionSpec(*out)


def placements(spec: Sequence[Axis], mesh) -> tuple:
    """DTensor placements of a spec on a DeviceMesh, one per mesh dimension:
    `Shard(d)` where the spec puts that mesh axis on tensor dimension d,
    `Replicate()` elsewhere.  A dimension split over several mesh axes is
    sharded by each of them, outermost first, as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    dim_of = {}
    for d, e in enumerate(spec):
        if e is None:
            continue
        axs = (e,) if isinstance(e, str) else tuple(e)
        if [names.index(a) for a in axs] != sorted(names.index(a) for a in axs):
            raise ValueError(f"spec {spec}: axes {axs} out of the mesh's "
                             f"order {names}")
        for a in axs:
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


def local_shape(shape: Sequence[int], spec: Sequence[Axis], mesh
                ) -> Tuple[int, ...]:
    """The shape one device holds of a tensor laid out by `spec` (every
    sharded dimension divides evenly: `spec_for` and `fit_spec` see to it)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        for a in ((e,) if isinstance(e, str) else e):
            out[d] //= sizes[a]
    return tuple(out)


def constrain(x, *logical: Optional[str],
              rules: Optional[Dict[str, Axis]] = None):
    """The layout constraint by logical names (`with_sharding_constraint`):
    a DTensor under an active DeviceMesh is redistributed to the spec's
    placements; a plain tensor, or any tensor with no active mesh, comes
    back unchanged."""
    m = active_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(logical, rules or active_rules(), mesh=m, shape=x.shape)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_dim(x, dim: int, sizes: Sequence[int]):
    """`x` with dimension `dim` split into `sizes` (a reshape).  A DTensor
    sharded on `dim` over mesh dimensions whose product does not divide
    `sizes[0]` is replicated on `dim` first, as GSPMD would reshard it (a
    DTensor refuses an uneven split); its gradient merges back through
    `merge_dims`."""
    if not is_distributed(x):
        shape = tuple(x.shape)
        return x.reshape(shape[:dim] + tuple(sizes) + shape[dim + 1:])
    return _SplitDim.apply(x, dim, tuple(sizes))


def _split(x, dim: int, sizes: tuple):
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    if n > 1 and sizes[0] % n:
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                  and p.dim == dim else p
                                  for p in x.placements])
    x = x.contiguous()          # DTensor reshapes its local shard as a view
    shape = tuple(x.shape)
    return x.reshape(shape[:dim] + sizes + shape[dim + 1:])


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, sizes: tuple):
        ctx.dim, ctx.n = dim, len(sizes)
        return _split(x, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return merge_dims(g, ctx.dim, ctx.n), None, None


def is_distributed(x) -> bool:
    """Whether `x` is a DTensor (laid out over a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def index_write_(x, dim: int, index, src):
    """`x.index_copy_(dim, index, src)` for a one-element `index`: the row
    `src` (size 1 on `dim`) written into x at position index[0], in place.

    A plain tensor takes `index_copy_` itself.  A DTensor is written through
    `local_map`: `src` and `index` are laid out as x is, replicated over the
    mesh dimensions that shard `dim`, and each shard writes the row only
    where it holds the position (elsewhere it writes back what it holds, so
    no shard reads the index on the host).  x keeps its placements; DTensor
    has no sharding strategy for `index_copy_` in every PyTorch version, and
    where it has one it may relabel x's placements without moving its
    shards."""
    if not is_distributed(x):
        return x.index_copy_(dim, index, src)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    x_pl = tuple(x.placements)
    split = [i for i, p in enumerate(x_pl) if isinstance(p, Shard) and p.dim == dim]
    n_shards = 1
    for i in split:
        n_shards *= mesh.size(i)
    if x.shape[dim] % n_shards:
        raise ValueError(f"index_write_: dimension {dim} of {tuple(x.shape)} "
                         f"splits unevenly over {n_shards} shards")
    src_pl = tuple(Replicate() if i in split else p for i, p in enumerate(x_pl))
    rep = (Replicate(),) * mesh.ndim
    args = [t if isinstance(t, DTensor) else
            DTensor.from_local(t, mesh, rep, run_check=False) for t in (index, src)]

    def body(xl, il, sl):
        n = xl.shape[dim]
        chunk = 0                       # this shard's place along `dim`
        for i in split:
            chunk = chunk * mesh.size(i) + mesh.get_local_rank(i)
        at = il - chunk * n
        held = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        xl.index_copy_(dim, at, torch.where(held, sl, xl.index_select(dim, at)))
        return xl

    local_map(body, out_placements=(x_pl,), in_placements=(x_pl, rep, src_pl),
              device_mesh=mesh, redistribute_inputs=True)(x, *args)
    return x



def _merged(x, dim: int, n: int):
    shape = tuple(x.shape)
    m = 1
    for s in shape[dim:dim + n]:
        m *= s
    return x.reshape(shape[:dim] + (m,) + shape[dim + n:])


class _MergeDims(torch.autograd.Function):
    """`merge_dims` of a DTensor: the gradient splits back through
    `split_dim`, which reshards where its layout (the backward pass's
    choice) would split unevenly."""

    @staticmethod
    def forward(ctx, x, dim: int, n: int):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return _merged(x, dim, n)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def merge_dims(x, dim: int, n: int):
    """`x` with dimensions dim .. dim+n-1 merged into one (a reshape).  A
    DTensor sharded on one of the inner merged dimensions is replicated on
    it first (a DTensor may merge only its outermost sharded dimension)."""
    if not is_distributed(x):
        return _merged(x, dim, n)
    from torch.distributed.tensor import Replicate, Shard
    inner = range(dim + 1, dim + n)
    pl = [Replicate() if isinstance(q, Shard) and q.dim in inner else q
          for q in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return _MergeDims.apply(x.contiguous(), dim, n)


def matmul(x, w):
    """`x @ w` for x [..., K], w [K, N].  A DTensor x of three or more
    dimensions has its leading dimensions merged (`merge_dims`) before the
    product and split back after, where matmul's own flattening may be
    refused."""
    if not is_distributed(x) or x.dim() <= 2:
        return x @ w
    lead = tuple(x.shape[:-1])
    return split_dim(merge_dims(x, 0, len(lead)) @ w, 0, lead)
