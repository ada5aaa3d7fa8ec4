"""Decide-then-execute engine of the port: `KernelRequest` -> cost-model
decision (cached in an `ExecutionPlan`) -> registry backend.  Two cost
models satisfy the `CostModel` protocol: `HopperModel` (the H100's
kernels: "hopper" or "torch-ref", their int8 siblings "hopper-int8" and
"torch-ref-int8", and their sparse siblings "hopper-sparse" and
"torch-ref-sparse") and `AnalyticalCostModel` (the paper's ReDas mapper,
executed on the cycle-level "simulator").  `plan_arch` plans an arch's
serving shapes ahead of time (`decode_requests` lists the decode and
admit requests); `ExecutionPlan.save` writes the warm-start artifact."""

from .context import (INT8_BACKENDS, SPARSE_BACKENDS, Engine, active_engine,
                      backend_in_bytes, decode_requests, default_engine,
                      int8_sibling, matmul, plan_arch, sparse_sibling,
                      use_engine)
from .cost import AnalyticalCostModel, CostModel, HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import BACKENDS, KernelRegistry, default_registry

__all__ = ["AnalyticalCostModel", "BACKENDS", "CostModel", "Engine",
           "ExecutionPlan", "HopperModel", "INT8_BACKENDS", "KernelDecision",
           "KernelRegistry", "KernelRequest", "SPARSE_BACKENDS",
           "active_engine", "backend_in_bytes", "decode_requests",
           "default_engine", "default_registry", "int8_sibling", "matmul",
           "plan_arch", "sparse_sibling", "use_engine"]
