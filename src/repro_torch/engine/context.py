"""The Engine: decide (cost model + plan cache) then execute (registry),
the port of `repro/engine/context.py`.

Every `models.layers.dense` matmul inside a `use_engine` context routes
through the engine:

    with use_engine(backend="hopper") as eng:
        logits, _ = transformer.forward(params, cfg, tokens)
    eng.plan.stats

PyTorch runs eagerly, so the engine is consulted on every call (there
is no trace-time caveat as in the JAX package); a repeated shape costs
one dict hit.
"""

from __future__ import annotations

import contextlib
import dataclasses

from .cost import HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import KernelRegistry, default_registry

_STACK: list["Engine"] = []


class Engine:
    """One (cost model, backend, plan, registry) posture.  `backend`
    defaults to "hopper": the kernel on CUDA tensors, its plain version
    on CPU tensors."""

    def __init__(self, cost_model=None, *, backend: str | None = None,
                 plan: ExecutionPlan | None = None,
                 registry: KernelRegistry | None = None):
        self.cost_model = cost_model if cost_model is not None else HopperModel()
        self.backend = backend or "hopper"
        self.registry = registry if registry is not None else default_registry()
        self.plan = plan if plan is not None else ExecutionPlan(
            cost_model=self.cost_model.name, backend=self.backend)
        # raw shape key -> (decision, kernel): the steady-state fast path
        self._memo: dict[tuple, tuple] = {}

    def _rebind(self, decision: KernelDecision) -> KernelDecision:
        """Execute a decision (possibly from a warm-start plan recorded for
        another backend) on this engine's backend."""
        if decision.backend == self.backend:
            return decision
        return dataclasses.replace(decision, backend=self.backend)

    def decide(self, request: KernelRequest) -> KernelDecision:
        """Plan-cache lookup, cost-model search on miss."""
        hit = self.plan.lookup(request)
        if hit is not None:
            rebound = self._rebind(hit)
            if rebound is not hit:
                self.plan.add(request, rebound)
            return rebound
        decision = self._rebind(self.cost_model.decide(request))
        self.plan.add(request, decision)
        return decision

    def matmul(self, a, b, *, out_dtype=None):
        """(M, K) @ (K, N) through the planned schedule for this shape."""
        key = ("gemm", a.shape, a.dtype, b.shape, b.dtype)
        hit = self._memo.get(key)
        if hit is None:
            m, k = a.shape
            k2, n = b.shape
            if k != k2:
                raise ValueError(f"matmul dim mismatch {tuple(a.shape)} @ "
                                 f"{tuple(b.shape)}")
            req = KernelRequest("gemm", m, k, n, in_bytes=a.element_size(),
                                out_bytes=a.element_size())
            dec = self.decide(req)
            hit = self._memo[key] = (dec, self.registry.get(dec.backend, "gemm"))
        else:
            self.plan.hits += 1
        dec, fn = hit
        return fn(dec, a, b, out_dtype=out_dtype)


def active_engine() -> Engine | None:
    """The innermost `use_engine` engine, or None (plain `@` path)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_engine(engine: Engine | None = None, *, backend: str | None = None,
               cost_model=None, plan: ExecutionPlan | None = None):
    """Route every `models.layers.dense` matmul in scope through an
    engine.  Pass an existing `Engine` to share its plan across
    contexts, or kwargs to build a scoped one."""
    if engine is None:
        engine = Engine(cost_model, backend=backend, plan=plan)
    elif backend is not None or cost_model is not None or plan is not None:
        raise ValueError("pass either an engine or engine kwargs, not both")
    _STACK.append(engine)
    try:
        yield engine
    finally:
        _STACK.pop()
