"""Mesh construction (the port of `repro/launch/mesh.py`) on a torch
`DeviceMesh` over the ranks of the process group.

Functions, not module constants: importing this module starts no process
group and touches no device.

Axes:
  data   batch parallelism and the FSDP shard axis of params/optimizer
  model  the reference's tensor-parallel axis (heads / mlp / vocab /
         experts); in the port it shards state only (train_lib/train.py)
  pod    the multi-pod axis; composes with data for batch parallelism

The device is explicit and defaults to the card: on `cuda` with no card
these functions raise, and never carry on on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {device!r} but no CUDA device is "
                           f"available; pass device='cpu' for a CPU mesh")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh on {device!r}: 'cuda' or 'cpu'")
    return dev


def _world(dev: torch.device, start: bool) -> int:
    """The process group's size; with no group and `start`, a one-rank
    group is started in this process (NCCL for cuda, gloo for cpu; an
    in-process store, so no port is opened)."""
    if not dist.is_initialized():
        if not start:
            return 1
        if dev.type == "cuda":
            dist.init_process_group(
                "nccl", store=dist.HashStore(), rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dist.get_world_size()


def _mesh(dev: torch.device, shape: tuple, axes: tuple) -> DeviceMesh:
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dev.type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over ('data', 'model'), or (2, 16, 16) over ('pod', 'data',
    'model'): a world of exactly that many ranks, started beforehand
    (torchrun); refused otherwise."""
    dev = _check_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world(dev, start=False)
    if world != math.prod(shape):
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{math.prod(shape)} ranks for its {shape} mesh; the process "
            f"group has {world}")
    return _mesh(dev, shape, axes)


def make_test_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ('data', 'model') mesh over however many ranks the process group
    has, clamped as the reference clamps it to its devices; with no group
    a one-rank group is started first."""
    dev = _check_device(device)
    n = _world(dev, start=True)
    d = min(data, n)
    m = min(model, n // d)
    return _mesh(dev, (d, m), ("data", "model"))
