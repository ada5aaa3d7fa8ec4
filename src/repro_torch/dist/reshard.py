"""Elastic resharding (the port of `repro/dist/reshard.py`): move a state
tree onto a (different) mesh.

The checkpoint layer saves full host arrays keyed by path with no record
of the mesh they were computed on (checkpoint/checkpoint.py).  Restoring
therefore only needs the *target* placement: `elastic_restore` derives it
from the auto rule table on the target mesh, so a run saved on a (2, 2)
mesh restarts bit-identically on a (1, 4) mesh, or on one rank.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..quant.quantize import QuantizedTensor
from ..sparse.nm import SparseTensor
from . import sharding


def place(x, target: "sharding.NamedSharding"):
    """One tensor onto `target`: a DTensor is redistributed (the
    collectives it needs), a plain tensor, which every rank holds in
    full, is cut to this rank's shard with no communication."""
    mesh, where = target.mesh, target.placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh, where)
    return distribute_tensor(x.to(torch.device(mesh.device_type)), mesh,
                             where, src_data_rank=None)


def reshard(tree, shardings):
    """`place` every leaf of `tree` onto its sharding in `shardings` (the
    same layout, as `sharding.params_shardings` or `cache_shardings`
    give it)."""
    if isinstance(tree, dict):
        return {k: reshard(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [reshard(v, s) for v, s in zip(tree, shardings, strict=True)]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(place(tree.q, shardings.q),
                               place(tree.scale, shardings.scale))
    if isinstance(tree, SparseTensor):
        return SparseTensor(
            place(tree.values, shardings.values),
            place(tree.indices, shardings.indices),
            None if tree.scale is None else place(tree.scale,
                                                  shardings.scale),
            n=tree.n, m=tree.m, k_dense=tree.k_dense)
    return place(tree, shardings)


def elastic_restore(ckpt, step: int, like, mesh):
    """Restore checkpoint `step` placed for `mesh`, whatever mesh shape it
    was saved under.  `like` is a state tree of the target's layout
    (values ignored); placement comes from `sharding.params_shardings` on
    the target mesh."""
    return ckpt.restore(step, like,
                        shardings=sharding.params_shardings(like, mesh))


def resume_or_init(ckpt, init_fn, mesh=None):
    """`checkpoint.resume_or_init` with placement derived from `mesh` by
    the auto rule table: the elastic-restart entry point.  A fresh start
    returns `init_fn()` as it is (the caller places it, as the launcher
    does with `reshard`)."""
    step = ckpt.latest_step()
    if step is None:
        return 0, init_fn()
    like = init_fn()
    if mesh is None:
        return step, ckpt.restore(step, like)
    return step, elastic_restore(ckpt, step, like, mesh)

