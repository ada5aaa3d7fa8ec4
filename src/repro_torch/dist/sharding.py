"""Named-axis sharding rules on a torch `DeviceMesh` (the port of
`repro/dist/sharding.py`).

The two rule tables are the reference's, copied as they are:

1.  Activations and batches by *logical* axis names: `LOGICAL_AXIS_RULES`
    says which mesh axes a meaning ("batch", "heads", ...) may shard over,
    and `spec()` resolves names to a per-dim tuple of mesh-axis names (the
    entries of the reference's `PartitionSpec`), with its two
    degradations: a dim that does not divide the mesh-axis product
    replicates, and a mesh axis consumed by an earlier dim is skipped.

2.  Parameters by *name pattern* (`_auto_spec`, matched on the '/'-joined
    key path, first match wins):

    | pattern             | rule                                        |
    |---------------------|---------------------------------------------|
    | ndim <= 1           | replicate (norms, biases, scalars)          |
    | last part == embed  | vocab dim (dim 0) on 'model' iff divisible; |
    |                     | the gathered feature dim is NEVER sharded   |
    | stack/...           | leading stacked-layer axis NEVER sharded;   |
    |                     | remaining dims fall through, shifted by one |
    | .../experts/...     | expert dim on 'model'; the d_model dim on   |
    |                     | 'data' (wi/wg dim 1 / wo last dim)          |
    | any other matmul    | last dim on 'model', second-to-last on      |
    |                     | 'data'                                      |

    Optimizer moments (opt/mu/..., opt/nu/..., opt/master/...) hold their
    parameter's key path as a suffix and so take its spec.

The torch side: `placements(spec, mesh)` turns such a tuple into one
DTensor placement per mesh dim (`Shard(d)` where that mesh axis shards
tensor dim d, else `Replicate()`); a dim over ("pod", "data") is sharded
on both mesh dims in mesh order, pod major, as JAX lays it out.
`NamedSharding` pairs a mesh with a spec, as JAX's does.

Mesh axes (launch/mesh.py): 'data', 'model', optional 'pod'.  A missing
or size-1 axis means "do not shard", so on a (1, 1) mesh every placement
is `Replicate()`.  The port's model computes on plain local tensors: the
train step gathers the params before its forward (train_lib/train.py),
and the only collective inside the model is `batch_mean`, the MoE
load-balance loss's means over the data-parallel ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..quant.quantize import QuantizedTensor
from ..sparse.nm import SparseTensor
from ..tree import flatten_with_path

# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` (a `DeviceMesh`) the active mesh within the block."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def active_mesh():
    return _MESH_STACK[-1] if _MESH_STACK else None


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or of anything with
    `mesh_dim_names` and a `shape` tuple)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape), strict=True))


# ---------------------------------------------------------------------------
# Activation specs: logical axis names -> mesh axes
# ---------------------------------------------------------------------------

LOGICAL_AXIS_RULES: dict[str, tuple[str, ...]] = {
    "batch":    ("pod", "data"),
    "seq":      ("data",),
    "seq_kv":   ("data",),    # long-context: kv sequence over 'data' (SP)
    "embed":    ("model",),
    "residual": ("model",),   # remat carry / context parallelism
    "vocab":    ("model",),
    "heads":    ("model",),
    "kv_heads": ("model",),
    "mlp":      ("model",),
    "experts":  ("model",),
}


def spec(shape, names, mesh) -> tuple:
    """Resolve logical axis `names` (str | None per dim) to a per-dim
    tuple of mesh-axis entries (None, a name, or a tuple of names) for a
    tensor of `shape` on `mesh`.

    Divisibility-safe: a name resolves to the longest suffix of its rule
    tuple whose axis-size product divides the dim (so 'batch' drops
    'pod' before 'data'); anything that still does not fit, or whose
    mesh axes were consumed by an earlier dim, replicates."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, names, strict=False):
        if name is None:
            entries.append(None)
            continue
        if name not in LOGICAL_AXIS_RULES:
            raise ValueError(
                f"unknown logical axis {name!r}; add it to "
                f"LOGICAL_AXIS_RULES")
        axes = tuple(a for a in LOGICAL_AXIS_RULES[name]
                     if sizes.get(a, 1) > 1 and a not in used)
        picked: tuple[str, ...] | None = None
        for i in range(len(axes)):
            cand = axes[i:]
            if dim % math.prod(sizes[a] for a in cand) == 0:
                picked = cand
                break
        if picked:
            used.update(picked)
            entries.append(picked[0] if len(picked) == 1 else picked)
        else:
            entries.append(None)
    return tuple(entries)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec_: tuple, mesh) -> tuple:
    """One DTensor placement per mesh dim for a tensor of spec `spec_`:
    `Shard(d)` on each mesh axis that shards tensor dim d, `Replicate()`
    on the rest."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axis names (JAX's `NamedSharding`)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def constrain(x, *names):
    """The same object when no mesh is active.  Under a mesh a DTensor is
    redistributed to `spec(x.shape, names)`'s placements; a plain tensor
    is refused: the port's model computes on local tensors and makes no
    `constrain` call of its own."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{names} under a mesh needs a DTensor, got a plain "
            f"{type(x).__name__}: the port's model computes on local "
            f"tensors, so a constraint on one would place nothing")
    return x.redistribute(mesh, placements(spec(x.shape, names, mesh), mesh))


# ---------------------------------------------------------------------------
# Parameter specs: name patterns -> mesh axes
# ---------------------------------------------------------------------------


def _auto_spec(name: str, shape, sizes: dict[str, int]) -> tuple:
    """Param-name pattern -> per-dim mesh-axis tuple (the module
    docstring's rule table; trailing None entries may be omitted).
    A QuantizedTensor's or SparseTensor's children arrive as integer path
    segments (".../w/0", ".../w/1"), as the reference's pytree children
    do, and the shape-driven rules place them together."""
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)
    ndim = len(shape)
    if ndim <= 1:
        return ()
    off = 1 if (name.startswith("stack/") or "/stack/" in name) else 0
    if off == 0 and name.rsplit("/", 1)[-1] == "embed":
        if model > 1 and shape[0] % model == 0:
            return ("model",)
        return ()
    specs = [None] * ndim
    if "experts/" in name and ndim - off >= 3:
        if model > 1 and shape[off] % model == 0:
            specs[off] = "model"
        # FSDP the d_model dim: last for wo (E, d_ff, d_model), first
        # non-expert dim for wi/wg (E, d_model, d_ff).
        d_model_dim = ndim - 1 if name.rsplit("/", 1)[-1] == "wo" else off + 1
        if data > 1 and shape[d_model_dim] % data == 0:
            specs[d_model_dim] = "data"
        return tuple(specs)
    if ndim - off >= 2:
        if model > 1 and shape[-1] % model == 0:
            specs[-1] = "model"
        if data > 1 and shape[-2] % data == 0:
            specs[-2] = "data"
    return tuple(specs)


def map_with_path(fn, tree, path: tuple = ()):
    """`fn(path, leaf)` over a tree of dicts and lists, `path` the tuple of
    keys (str for a dict key, int for a list index).  A QuantizedTensor or
    SparseTensor is a node whose children are its reference pytree
    children (q, scale; values, indices, scale) under the keys 0, 1, 2; a
    None child stays None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(path + (0,), tree.q),
                               fn(path + (1,), tree.scale))
    if isinstance(tree, SparseTensor):
        return SparseTensor(
            fn(path + (0,), tree.values), fn(path + (1,), tree.indices),
            None if tree.scale is None else fn(path + (2,), tree.scale),
            n=tree.n, m=tree.m, k_dense=tree.k_dense)
    return fn(path, tree)


def _path_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def params_pspecs(tree, mesh):
    """Same-layout tree of spec tuples for a params / optimizer-state tree
    (leaves: tensors, meta tensors included).  The specs are its leaves:
    do not walk the result as a tree of lists."""
    sizes = mesh_sizes(mesh)
    return map_with_path(
        lambda path, leaf: _auto_spec(_path_name(path), tuple(leaf.shape),
                                      sizes), tree)


def params_shardings(tree, mesh):
    """Same-layout tree of `NamedSharding` (for `reshard.reshard`)."""
    sizes = mesh_sizes(mesh)
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, _auto_spec(
            _path_name(path), tuple(leaf.shape), sizes)), tree)


# ---------------------------------------------------------------------------
# Cache specs (serving): slot-name -> logical axes
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    "k": (None, "batch", "seq_kv", "kv_heads", None),
    "v": (None, "batch", "seq_kv", "kv_heads", None),
    # int8 KV codec: per-row scales shard with the rows they describe
    # (same layout minus the head_dim axis).
    "k_scale": (None, "batch", "seq_kv", "kv_heads"),
    "v_scale": (None, "batch", "seq_kv", "kv_heads"),
    "conv": (None, "batch", None, None),
    "state": (None, "batch", "heads", None, None),
    "h": (None, "batch", "mlp"),
    # paged KV pools: the pool's page axis takes the "seq_kv" role (pages
    # ARE the sequence, shuffled).  There is no batch axis; block tables
    # stay host-side/replicated.
    "k_pages": (None, "seq_kv", None, "kv_heads", None),
    "v_pages": (None, "seq_kv", None, "kv_heads", None),
    "k_scale_pages": (None, "seq_kv", None, "kv_heads"),
    "v_scale_pages": (None, "seq_kv", None, "kv_heads"),
}


def block_table_pspec(mesh, shape=None) -> tuple:
    """Spec of a (B, n_bt) block table: slots over 'batch', table entries
    replicated (every shard of a paged pool needs the whole row)."""
    return spec(shape, ("batch", None), mesh) if shape else ("batch", None)


def cache_shardings(cache_tree, mesh):
    """Shardings for a `models.transformer.init_cache` tree (either
    layout).  Slots under 'tail' lack the leading stack dim."""
    def visit(path, leaf):
        name = str(path[-1])
        axes = _CACHE_AXES.get(name)
        if axes is None or leaf.dim() == 0:
            return NamedSharding(mesh, ())
        axes = axes[1:] if "tail" in path else axes
        return NamedSharding(mesh, spec(leaf.shape, axes[:leaf.dim()], mesh))
    return map_with_path(visit, cache_tree)


# ---------------------------------------------------------------------------
# Local and full views, and the data-parallel means
# ---------------------------------------------------------------------------


def full_tree(tree):
    """Every DTensor leaf gathered to its full plain tensor (a collective:
    every rank of its mesh calls it); other leaves as they are."""
    return map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def local_tree(tree):
    """Every DTensor leaf as its local shard."""
    return map_with_path(
        lambda _, x: x.to_local() if isinstance(x, DTensor) else x, tree)


def tree_mesh(tree):
    """The mesh of the first DTensor leaf of `tree`, else None."""
    for _, x in flatten_with_path(tree):
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


_BATCH_GROUPS: list[tuple] = []


@contextlib.contextmanager
def batch_parallel(groups: tuple):
    """Within the block `batch_mean` averages over the process groups
    `groups` (one per mesh axis of the batch split): the ranks that each
    hold an equal share of the batch."""
    _BATCH_GROUPS.append(tuple(groups))
    try:
        yield
    finally:
        _BATCH_GROUPS.pop()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks of the active `batch_parallel`
    groups, with autograd through the reduction; the same object outside
    one.  A mean over this rank's share of the batch becomes the mean
    over the whole batch."""
    groups = _BATCH_GROUPS[-1] if _BATCH_GROUPS else ()
    if not groups:
        return x
    n = 1
    for g in groups:
        x = _AllReduceSum.apply(x, g)
        n *= torch.distributed.get_world_size(g)
    return x / n


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group's ranks; its gradient is the sum of
    the ranks' gradients (each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=ctx.group)
        return out, None
