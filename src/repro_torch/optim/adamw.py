"""AdamW on PyTorch tensors (the port of `repro/optim/adamw.py`): f32
master weights and moments over compute-dtype params, global-norm
clipping, decoupled weight decay.

The state is a plain tree (dicts and lists of tensors, the params'
layout) so the checkpoint layer treats it like the params.  This is not
`torch.optim.AdamW`: that decays every leaf and folds the decay in
before the Adam step.  Here decay goes on leaves of ndim >= 2 only, read
from the leaf's own shape (a stacked norm scale of shape (periods, d) is
decayed, as in the reference), and is added to the Adam direction:
master -= lr * (mhat / (sqrt(vhat) + eps) + weight_decay * master).

On a sharded state (DTensor leaves placed by `dist.sharding`) the update
is elementwise on each rank's shards, and `global_norm` is one all-reduce
of the squared sum over the whole mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map, tree_unflatten


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _like(ref, local: torch.Tensor):
    """`local` as a shard placed as `ref` is (plain if `ref` is)."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _sharded_norm(leaves) -> torch.Tensor:
    """sqrt of the squared sum over leaves placed on one mesh: each rank's
    local sums, each divided by the count of ranks that hold the same
    shard, then one all-reduce over the mesh's ranks."""
    mesh = next(x.device_mesh for x in leaves if isinstance(x, DTensor))
    total = 0
    for x in leaves:
        sq = _local(x).float().square().sum()
        copies = (math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                            if p.is_replicate())
                  if isinstance(x, DTensor) else mesh.size())
        total = total + (sq / copies if copies > 1 else sq)
    total = torch.as_tensor(total, dtype=torch.float32)
    if mesh.size() == dist.get_world_size():
        dist.all_reduce(total)
    else:
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params) -> dict[str, Any]:
    """step 0, zero f32 moments, and an f32 master copy of the params
    (a copy even where the params are f32 already: the master never
    aliases them)."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
        "mu": tree_map(f32, params),
        "nu": tree_map(f32, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        return _sharded_norm(leaves)
    total = 0
    for x in leaves:
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(cfg: AdamWConfig, state, grads,
                  param_dtype=torch.bfloat16):
    """One AdamW step.  `grads` has the params' layout (any float dtype;
    the moments are f32), DTensors on a sharded state.  Returns
    (new_params, new_state, metrics)."""
    step = _local(state["step"]) + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones((), device=gnorm.device),
                          cfg.clip_norm / torch.clamp_min(gnorm, 1e-12))
    stepf = step.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=stepf.device)
    b1c = 1.0 - f32(cfg.b1) ** stepf
    b2c = 1.0 - f32(cfg.b2) ** stepf

    def upd(g, mu, nu, master):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if master.dim() >= 2:  # decoupled decay on matrices only
            delta = delta + cfg.weight_decay * master
        return mu, nu, master - lr * delta

    masters = tree_leaves(state["master"])
    out = [[_like(ref, x) for x in upd(*map(_local, leaves))]
           for ref, leaves in zip(masters, zip(
               *(tree_leaves(t) for t in (grads, state["mu"], state["nu"],
                                          state["master"])), strict=True))]
    mu, nu, master = (tree_unflatten(grads, [o[i] for o in out])
                      for i in range(3))
    params = tree_map(lambda w: _like(w, _local(w).to(param_dtype)), master)
    new_state = {"step": _like(state["step"], step), "mu": mu, "nu": nu,
                 "master": master}
    return params, new_state, {"grad_norm": gnorm,
                               "lr": torch.as_tensor(lr, dtype=torch.float32)}
