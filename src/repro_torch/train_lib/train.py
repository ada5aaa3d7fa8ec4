"""The train step (the port of `repro/train_lib/train.py`): loss,
microbatched gradient accumulation, AdamW, on one device.

  * params and their gradients are in the compute dtype (bf16 at full
    width), the moments and the master copy f32;
  * microbatches run one after another, each through
    `torch.autograd.grad`, and their gradients add into f32 buffers (the
    reference's f32 scan carry); the sum is divided by the count before
    AdamW;
  * each period of the stack is rematerialised inside the model
    (`models.transformer.forward`);
  * one `Engine` (one decision memo) spans every microbatch of a step and
    the step's backward: the checkpointed periods recompute their forward
    inside its `use_engine` scope, on the same kernels.

Under a mesh (`dist.sharding.use_mesh`, or a state of DTensors) the step
is sharded:

  * the state (params, mu, nu, master) lives as DTensors placed by
    `dist.sharding.params_shardings`, the moments taking their parameter's
    spec by the path suffix, as in the reference;
  * each step gathers the full params (`full_tensor()`) and computes on
    plain tensors: no DTensor reaches the engine or a VJP;
  * each rank takes its share of every global microbatch along
    `spec(labels.shape, ("batch", None))`, so the microbatches are the
    reference's; the MoE load-balance means are averaged over those ranks
    inside the forward (`dist.sharding.batch_mean`);
  * the gradients are reduced over the batch ranks into each leaf's shard
    (a `Partial` DTensor redistributed to the leaf's placements) and
    scaled to the global mean; with `shard_grad_accum` (the default, as
    in the reference) after every microbatch, into an f32 accumulator
    that lives in the shard, else once after the last;
  * AdamW runs on the shards, its clipping norm one all-reduce.

The `"model"` axis shards state only: the ranks along it compute the same
batch slice.  This is the reference's math at the reference's state
placement, without its tensor-parallel compute (ROADMAP queue 1, 9c).  A
data-parallel reduction sums in another order than one device does, so
the sharded step is not bit for bit the unsharded one, except on a (1, 1)
mesh, where nothing is reduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from .. import engine as engine_mod
from ..dist import reshard as reshard_mod
from ..dist import sharding as shd
from ..models import transformer as T
from ..models.config import ArchConfig
from ..optim import adamw
from ..quant.quantize import QuantizedTensor
from ..sparse.nm import SparseTensor
from ..tree import flatten_with_path, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    aux_weight: float = 0.01          # MoE load-balance loss weight
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    # under a mesh: reduce each microbatch's gradients into an f32
    # accumulator that lives in the leaf's shard (the reference's sharding
    # constraint on its scan carry); False keeps it full until the last
    shard_grad_accum: bool = True
    # the engine backend every model matmul runs through ("hopper",
    # "torch-ref", ...); None keeps plain `@`
    kernel_backend: str | None = None
    # the int8 forward plane: upgrade kernel_backend to its int8 sibling,
    # so every matmul quantizes its operands on the way into the kernel
    # while the VJPs keep cotangents in the float compute dtype
    quantize: bool = False
    # "N:M" upgrades kernel_backend to its sparse sibling; the weights
    # stay dense (the reference's launcher never prunes them)
    sparsity: str | None = None

    def __post_init__(self):
        if self.quantize:
            object.__setattr__(
                self, "kernel_backend",
                engine_mod.int8_sibling(self.kernel_backend))
        if self.sparsity is not None:
            from ..sparse import parse_sparsity

            parse_sparsity(self.sparsity)  # validate "N:M" early
            object.__setattr__(
                self, "kernel_backend",
                engine_mod.sparse_sibling(self.kernel_backend))


def init_state(cfg: ArchConfig, tcfg: TrainConfig, *,
               generator: torch.Generator, device=None) -> dict:
    """Params drawn in f32 from `generator` on `device`, cast to the
    compute dtype, and the AdamW state over the f32 draw."""
    params_f32 = T.init_params(cfg, generator=generator, device=device,
                               dtype=torch.float32)
    params = tree_map(lambda p: p.to(tcfg.compute_dtype), params_f32)
    return {"params": params, "opt": adamw.init_state(params_f32)}


def _split_batch(batch: dict, cfg: ArchConfig):
    """(inputs, labels) from a batch dict."""
    if cfg.embed_inputs:
        return {"embeds": batch["embeds"]}, batch["labels"]
    toks = batch["tokens"]
    inputs = {"tokens": toks[:, :-1]}
    labels = toks[:, 1:]
    if cfg.prefix_tokens:
        inputs["embeds"] = batch["pixel_embeds"]
    return inputs, labels


def make_loss_fn(cfg: ArchConfig, tcfg: TrainConfig):
    """loss_fn(params, inputs, labels) -> (ce + aux_weight * aux, (ce,
    aux)): the f32 cross-entropy by `log_softmax` and a gather (no
    one-hot over the vocabulary), a VLM's on its text positions only."""
    def loss_fn(params, inputs, labels):
        logits, aux = T.forward(
            params, cfg, inputs.get("tokens"), embeds=inputs.get("embeds"),
            compute_dtype=tcfg.compute_dtype)
        if cfg.prefix_tokens:       # VLM: loss only on text positions
            logits = logits[:, cfg.prefix_tokens:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None].long())[..., 0]
        ce = -ll.mean()
        return ce + tcfg.aux_weight * aux, (ce, aux)
    return loss_fn


def _refuse_storage(params) -> None:
    """The reference's `jax.value_and_grad` refuses int8 leaves ("grad
    requires real- or complex-valued inputs"); so does the port, naming
    them: int8 weights (`quantize_params`) and pruned ones
    (`prune_params`) are served, not trained."""
    bad = [path for path, leaf in flatten_with_path(params)
           if isinstance(leaf, (QuantizedTensor, SparseTensor))
           or not torch.is_floating_point(leaf)]
    if bad:
        shown = ", ".join(bad[:4]) + (" ..." if len(bad) > 4 else "")
        raise TypeError(
            f"train_step takes float params; {len(bad)} leaves hold int8 "
            f"storage ({shown}): grad requires real- or complex-valued "
            f"inputs, as in the reference")


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """train_step(state, batch) -> (state, metrics) with metrics `loss`,
    `ce`, `aux`, `grad_norm` and `lr` (0-d f32 tensors).  The step's engine
    is `train_step.engine` (None without a `kernel_backend`)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    eng = (engine_mod.Engine(backend=tcfg.kernel_backend)
           if tcfg.kernel_backend else None)

    def train_step(state: dict, batch: dict):
        scope = (engine_mod.use_engine(eng) if eng is not None
                 else contextlib.nullcontext())
        mesh = shd.active_mesh() or shd.tree_mesh(state)
        with scope:
            if mesh is not None:
                return _sharded_step(state, batch, mesh)
            return _train_step(state, batch)

    def _train_step(state: dict, batch: dict):
        params = state["params"]
        _refuse_storage(params)
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        inputs, labels = _split_batch(batch, cfg)
        n_micro = tcfg.microbatches
        if labels.shape[0] % n_micro:
            raise ValueError(f"batch {labels.shape[0]} is not a multiple "
                             f"of {n_micro} microbatches")
        rows = labels.shape[0] // n_micro
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        zero = lambda: torch.zeros((), dtype=torch.float32,
                                   device=labels.device)
        tot = {"loss": zero(), "ce": zero(), "aux": zero()}
        for i in range(n_micro):
            part = slice(i * rows, (i + 1) * rows)
            with torch.enable_grad():
                live = [p.detach().requires_grad_() for p in leaves]
                loss, (ce, aux) = loss_fn(
                    tree_unflatten(params, live),
                    {k: v[part] for k, v in inputs.items()}, labels[part])
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            del live
            for a, g in zip(acc, grads, strict=True):
                if g is not None:
                    a.add_(g)
            del grads
            for key, val in (("loss", loss), ("ce", ce), ("aux", aux)):
                tot[key] = tot[key] + val.detach().float()
        for a in acc:
            a.div_(n_micro)
        new_params, new_opt, om = adamw.apply_updates(
            tcfg.optimizer, state["opt"], tree_unflatten(params, acc),
            param_dtype=tcfg.compute_dtype)
        metrics = {key: val / n_micro for key, val in tot.items()}
        return {"params": new_params, "opt": new_opt}, {**metrics, **om}

    def _sharded_step(state: dict, batch: dict, mesh):
        _refuse_storage(shd.local_tree(state["params"]))
        state = reshard_mod.reshard(state,
                                    shd.params_shardings(state, mesh))
        params = state["params"]
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        full = [leaf.full_tensor() for leaf in leaves]
        inputs, labels = _split_batch(batch, cfg)
        n_micro = tcfg.microbatches
        if labels.shape[0] % n_micro:
            raise ValueError(f"batch {labels.shape[0]} is not a multiple "
                             f"of {n_micro} microbatches")
        rows = labels.shape[0] // n_micro
        split = _BatchSplit(mesh, (rows,) + tuple(labels.shape[1:]))
        dev = full[0].device
        acc = [torch.zeros(leaf.to_local().shape if tcfg.shard_grad_accum
                           else leaf.shape, dtype=torch.float32, device=dev)
               for leaf in leaves]
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        tot = {"loss": zero(), "ce": zero(), "aux": zero()}
        for i in range(n_micro):
            part = split.rows(i)
            with torch.enable_grad(), shd.batch_parallel(split.groups):
                live = [p.detach().requires_grad_() for p in full]
                loss, (ce, aux) = loss_fn(
                    tree_unflatten(params, live),
                    {k: v[part] for k, v in inputs.items()}, labels[part])
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            del live
            for j, g in enumerate(grads):
                if g is None:
                    continue
                acc[j].add_(split.reduce(g.float(), leaves[j])
                            if tcfg.shard_grad_accum else g)
            del grads
            for key, val in (("loss", loss), ("ce", ce), ("aux", aux)):
                tot[key] = tot[key] + val.detach().float()
        if not tcfg.shard_grad_accum:
            acc = [split.reduce(a, leaf) for a, leaf in zip(acc, leaves,
                                                              strict=True)]
        grads = []
        for a, leaf in zip(acc, leaves, strict=True):
            a.div_(n_micro * split.ranks)
            grads.append(DTensor.from_local(
                a, mesh, leaf.placements, run_check=False, shape=leaf.shape,
                stride=leaf.stride()))
        new_params, new_opt, om = adamw.apply_updates(
            tcfg.optimizer, state["opt"], tree_unflatten(params, grads),
            param_dtype=tcfg.compute_dtype)
        metrics = split.mean({key: val / n_micro for key, val in tot.items()})
        return {"params": new_params, "opt": new_opt}, {**metrics, **om}

    train_step.engine = eng
    return train_step


class _BatchSplit:
    """This rank's share of each (rows, ...) microbatch on `mesh`: the
    mesh axes that `spec(shape, ("batch", None))` puts on the rows, the
    process groups of those axes, and the reductions over them."""

    def __init__(self, mesh, shape: tuple):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        entry = shd.spec(shape, ("batch",) + (None,) * (len(shape) - 1),
                         mesh)[0]
        self.axes = shd.entry_axes(entry)
        self.groups = tuple(mesh.get_group(a) for a in self.axes)
        sizes = shd.mesh_sizes(mesh)
        self.ranks = math.prod(sizes[a] for a in self.axes)
        coord = mesh.get_coordinate()
        index = 0
        for a in self.axes:                  # mesh order: the first major
            index = index * sizes[a] + coord[names.index(a)]
        self.share = shape[0] // self.ranks
        self.index = index
        self.rows_each = shape[0]
        self.grad_placements = tuple(
            Partial() if a in self.axes else Replicate() for a in names)

    def rows(self, i: int) -> slice:
        """This rank's rows of microbatch `i`."""
        start = i * self.rows_each + self.index * self.share
        return slice(start, start + self.share)

    def reduce(self, g: torch.Tensor, leaf) -> torch.Tensor:
        """The sum over the batch ranks of each one's full gradient `g`,
        as this rank's local shard of `leaf`'s placement."""
        return DTensor.from_local(
            g, self.mesh, self.grad_placements, run_check=False).redistribute(
                self.mesh, leaf.placements).to_local()

    def mean(self, metrics: dict) -> dict:
        """Scalar metrics averaged over the batch ranks."""
        if self.ranks == 1:
            return metrics
        import torch.distributed as dist

        keys = sorted(metrics)
        vec = torch.stack([metrics[k] for k in keys])
        for g in self.groups:
            dist.all_reduce(vec, group=g)
        vec = vec / self.ranks
        return {k: vec[i] for i, k in enumerate(keys)}


def device_batch(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
