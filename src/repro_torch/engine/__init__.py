"""Decide-then-execute engine of the port: `KernelRequest` ->
`HopperModel` decision (cached in an `ExecutionPlan`) -> registry
backend ("hopper" or "torch-ref")."""

from .context import Engine, active_engine, use_engine
from .cost import HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import BACKENDS, KernelRegistry, default_registry

__all__ = ["BACKENDS", "Engine", "ExecutionPlan", "HopperModel",
           "KernelDecision", "KernelRegistry", "KernelRequest",
           "active_engine", "default_registry", "use_engine"]
