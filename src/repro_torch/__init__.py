"""PyTorch/CUDA port of the ReDas reproduction for one NVIDIA H100.

A package beside the JAX reference `repro`: it imports nothing of it.
It runs the ten architectures of `configs` (decoders of "attn",
"local", "ssm" and "rglru" blocks, a VLM with prefix embeddings, an
encoder over frame embeddings): greedy serving in one static batch and
through the continuous-batching `serve_lib.scheduler.Scheduler` over a
contiguous or paged KV cache, with every engine GEMM on the
hand-written ReDas kernel (`kernels/csrc/redas_gemm.cu`), paged decode
attention on `kernels/csrc/paged_attention.cu`, and the int8, N:M-sparse
and grouped GEMMs under their postures; `kernels/csrc/flash_attention.cu`
sits behind `Engine.attention`.  Importing the package builds nothing;
the first CUDA tensor that reaches a kernel compiles it.

It trains too: `train_lib.train.make_train_step` (microbatched f32
gradient accumulation, AdamW from `optim`, per-period rematerialisation)
over `data`'s synthetic or memmapped batches, with `checkpoint`'s
async, atomic saves that load across both packages; every engine op and
the prefill attention scan carry the reference's VJPs as
`torch.autograd.Function`s, so the backward runs on the same kernels
(`launch/train.py` on one device).

`core` is the paper's own plane: the ReDas mapper, the Eq. 3-5
analytical model, the six accelerators, the energy/EDP model, the
paper's eight workload traces and the cycle-level simulator, which
executes a mapper decision on the card (`Engine(AnalyticalCostModel())`
runs its GEMMs on the "simulator" backend).  `plan_arch(cfg, ...)`
plans an arch's serving shapes ahead of time; its saved plan warm-starts
a server (`ServeConfig(plan_path=)`, the launcher's `--plan`).  The
names below resolve lazily, as the JAX package's do.
"""

from __future__ import annotations

import importlib

#: name -> submodule (lazy `repro_torch.<name>` package access)
_SUBMODULES = (
    "checkpoint", "configs", "core", "data", "engine", "kernels", "launch",
    "models", "optim", "quant", "serve_lib", "sparse", "train_lib",
)

#: name -> "module:attr" (lazy re-exports of the decision-surface API)
_EXPORTS = {
    # engine (the decide-then-execute surface)
    "Engine": "repro_torch.engine:Engine",
    "use_engine": "repro_torch.engine:use_engine",
    "active_engine": "repro_torch.engine:active_engine",
    "default_engine": "repro_torch.engine:default_engine",
    "matmul": "repro_torch.engine:matmul",
    "plan_arch": "repro_torch.engine:plan_arch",
    "decode_requests": "repro_torch.engine:decode_requests",
    "ExecutionPlan": "repro_torch.engine:ExecutionPlan",
    "KernelRequest": "repro_torch.engine:KernelRequest",
    "KernelDecision": "repro_torch.engine:KernelDecision",
    "KernelRegistry": "repro_torch.engine:KernelRegistry",
    "CostModel": "repro_torch.engine:CostModel",
    "HopperModel": "repro_torch.engine:HopperModel",
    "AnalyticalCostModel": "repro_torch.engine:AnalyticalCostModel",
    # quant (the int8 precision plane)
    "QuantizedTensor": "repro_torch.quant:QuantizedTensor",
    "quantize_params": "repro_torch.quant:quantize_params",
    # configs + workloads (numpy-level planning inputs)
    "GEMM": "repro_torch.core.analytical_model:GEMM",
    "WORKLOADS": "repro_torch.core.workloads:WORKLOADS",
    "arch_gemms": "repro_torch.core.workloads:arch_gemms",
    "get_config": "repro_torch.configs:get_config",
    "ArchConfig": "repro_torch.models.config:ArchConfig",
}

__all__ = [*_SUBMODULES, *_EXPORTS]


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.{name}")
    target = _EXPORTS.get(name)
    if target is not None:
        module, attr = target.split(":")
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
