"""KernelRegistry: named execution backends for planned decisions (the
port of `repro/engine/registry.py`).

A backend is a name mapping each op to a callable
``fn(decision, *tensors, **kw) -> tensor``.  The port has seven:

  hopper          — the hand-written Hopper kernels (`gemm`,
                    `grouped_gemm`, `attention`, `paged_attention`):
                    launched on CUDA tensors; a CPU tensor gets the
                    kernel's plain version.
  torch-ref       — the plain PyTorch versions, on any device (the
                    parity reference).
  hopper-int8     — the int8 plane: `gemm`, `gemm_w8` and `grouped_gemm`
                    through the int8 GEMM kernel (its plain version on
                    CPU tensors), plain float `attention`, and the paged
                    kernel for `paged_attention`.
  torch-ref-int8  — the same ops on the plain versions, on any device.
  hopper-sparse   — the N:M sparsity plane: `gemm_sparse` on the sparse
                    GEMM kernel (its plain version on CPU tensors), `gemm`
                    on the ReDas kernel, plain `grouped_gemm` and
                    `attention`, and the paged kernel for
                    `paged_attention`.
  torch-ref-sparse — the same ops on the plain versions, on any device.
  simulator       — `gemm` only: an `AnalyticalCostModel` decision (the
                    paper's ASIC mapping) executed on the cycle-level
                    simulator, on the operands' device.
"""

from __future__ import annotations

from typing import Callable

from . import backends

#: the backends the default registry holds.
BACKENDS = ("hopper", "torch-ref", "hopper-int8", "torch-ref-int8",
            "hopper-sparse", "torch-ref-sparse", "simulator")


class KernelRegistry:
    """(backend, op) -> kernel dispatch table."""

    def __init__(self):
        self._kernels: dict[tuple[str, str], Callable] = {}

    def register(self, backend: str, op: str, fn: Callable) -> None:
        self._kernels[(backend, op)] = fn

    def has(self, backend: str, op: str) -> bool:
        return (backend, op) in self._kernels

    def backends(self) -> tuple[str, ...]:
        return tuple(sorted({b for b, _ in self._kernels}))

    def ops(self, backend: str) -> tuple[str, ...]:
        return tuple(sorted(op for b, op in self._kernels if b == backend))

    def get(self, backend: str, op: str) -> Callable:
        try:
            return self._kernels[(backend, op)]
        except KeyError:
            raise KeyError(
                f"no kernel registered for backend={backend!r} op={op!r}; "
                f"have {sorted(self._kernels)}") from None


def default_registry() -> KernelRegistry:
    """A registry holding every backend of `BACKENDS`."""
    reg = KernelRegistry()
    backends.register_into(reg)
    return reg
