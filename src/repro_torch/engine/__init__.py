"""Decide-then-execute engine of the port: `KernelRequest` ->
`HopperModel` decision (cached in an `ExecutionPlan`) -> registry
backend ("hopper" or "torch-ref", their int8 siblings "hopper-int8" and
"torch-ref-int8", and their sparse siblings "hopper-sparse" and
"torch-ref-sparse")."""

from .context import (INT8_BACKENDS, SPARSE_BACKENDS, Engine, active_engine,
                      backend_in_bytes, int8_sibling, sparse_sibling,
                      use_engine)
from .cost import HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import BACKENDS, KernelRegistry, default_registry

__all__ = ["BACKENDS", "Engine", "ExecutionPlan", "HopperModel",
           "INT8_BACKENDS", "KernelDecision", "KernelRegistry",
           "KernelRequest", "SPARSE_BACKENDS", "active_engine",
           "backend_in_bytes", "default_registry", "int8_sibling",
           "sparse_sibling", "use_engine"]
