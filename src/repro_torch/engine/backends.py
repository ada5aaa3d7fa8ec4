"""Execution backends: decision -> kernel call (the port of
`repro/engine/backends.py`'s `_gemm_backend` and `pallas_gemm`).

The Hopper kernel masks ragged edges itself, so the GEMM entry passes
the operands straight through: no padding copies, no slicing.
"""

from __future__ import annotations

from ..kernels import redas_gemm
from .plan import KernelDecision


def hopper_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The decision's dataflow and CTA tile on the ReDas kernel."""
    return redas_gemm.gemm(a, b, dataflow=decision.dataflow, bm=decision.bm,
                           bk=decision.bk, bn=decision.bn,
                           out_dtype=out_dtype)


def ref_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The kernel's plain version; the decision is planned but ignored."""
    return redas_gemm.gemm_reference(a, b, out_dtype)


def register_into(registry) -> None:
    registry.register("hopper", "gemm", hopper_gemm)
    registry.register("torch-ref", "gemm", ref_gemm)
