"""Decide-then-execute engine of the port: `KernelRequest` ->
`HopperModel` decision (cached in an `ExecutionPlan`) -> registry
backend ("hopper" or "torch-ref", and their int8 siblings "hopper-int8"
and "torch-ref-int8")."""

from .context import (INT8_BACKENDS, Engine, active_engine, backend_in_bytes,
                      int8_sibling, use_engine)
from .cost import HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import BACKENDS, KernelRegistry, default_registry

__all__ = ["BACKENDS", "Engine", "ExecutionPlan", "HopperModel",
           "INT8_BACKENDS", "KernelDecision", "KernelRegistry",
           "KernelRequest", "active_engine", "backend_in_bytes",
           "default_registry", "int8_sibling", "use_engine"]
