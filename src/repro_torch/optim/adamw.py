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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


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
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(cfg: AdamWConfig, state, grads,
                  param_dtype=torch.bfloat16):
    """One AdamW step.  `grads` has the params' layout (any float dtype;
    the moments are f32).  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
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

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (grads, state["mu"], state["nu"],
                                   state["master"])), strict=True)]
    mu, nu, master = (tree_unflatten(grads, [o[i] for o in out])
                      for i in range(3))
    params = tree_map(lambda w: w.to(param_dtype), master)
    new_state = {"step": step, "mu": mu, "nu": nu, "master": master}
    return params, new_state, {"grad_norm": gnorm,
                               "lr": torch.as_tensor(lr, dtype=torch.float32)}
