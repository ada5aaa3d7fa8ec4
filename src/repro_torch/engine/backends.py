"""Execution backends: decision -> kernel call (the port of
`repro/engine/backends.py`'s `_gemm_backend` and `pallas_gemm`, and of
the grouped and attention registrations of
`repro/kernels/grouped_gemm.py`, `repro/kernels/flash_attention.py` and
`repro/kernels/paged_attention.py`).

The Hopper kernels mask ragged edges themselves, so the entries pass the
operands straight through: no padding copies, no slicing.
"""

from __future__ import annotations

from ..kernels import (flash_attention, grouped_gemm, paged_attention,
                       redas_gemm)
from .plan import KernelDecision


def hopper_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The decision's dataflow and CTA tile on the ReDas kernel."""
    return redas_gemm.gemm(a, b, dataflow=decision.dataflow, bm=decision.bm,
                           bk=decision.bk, bn=decision.bn,
                           out_dtype=out_dtype)


def ref_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The kernel's plain version; the decision is planned but ignored."""
    return redas_gemm.gemm_reference(a, b, out_dtype)


def hopper_grouped_gemm(decision: KernelDecision, x, w, *,
                        out_dtype=None):
    """The decision's per-expert OS tile on the grouped kernel."""
    return grouped_gemm.grouped_matmul(
        x, w, tile=(decision.bm, decision.bk, decision.bn),
        out_dtype=out_dtype)


def ref_grouped_gemm(decision: KernelDecision, x, w, *, out_dtype=None):
    """The grouped kernel's plain version; the decision is planned but
    ignored."""
    return grouped_gemm.grouped_matmul_reference(x, w, out_dtype)


def _blocks(decision: KernelDecision, q, k) -> tuple[int, int]:
    """The decision's (bq, bk) bent to divisors of the sequence lengths,
    as the JAX package's flash registration bends them."""
    return (flash_attention._legal_block(q.shape[2], decision.bm),
            flash_attention._legal_block(k.shape[2], decision.bn))


def hopper_attention(decision: KernelDecision, q, k, v, *, causal=True,
                     window=0):
    """q (B, H, Sq, D); k/v (B, H, Sk, D) on the flash kernel."""
    bq, bk = _blocks(decision, q, k)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           window=window, bq=bq, bk=bk)


def ref_attention(decision: KernelDecision, q, k, v, *, causal=True,
                  window=0):
    """The flash kernel's plain version over the same KV blocks."""
    _, bk = _blocks(decision, q, k)
    return flash_attention.flash_attention_reference(q, k, v, causal=causal,
                                                     window=window, bk=bk)


def hopper_paged_attention(decision: KernelDecision, q, k_pages, v_pages,
                           block_tables, kv_len, *, k_scale=None,
                           v_scale=None):
    """Paged decode on the kernel (its block is one (slot, KV head); the
    decision's blocks are planned but do not shape it)."""
    return paged_attention.paged_attention(q, k_pages, v_pages, block_tables,
                                           kv_len, k_scale, v_scale)


def ref_paged_attention(decision: KernelDecision, q, k_pages, v_pages,
                        block_tables, kv_len, *, k_scale=None, v_scale=None):
    """The paged kernel's plain version."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 paged pools are not ported yet (ROADMAP.md queue 1 item 2)")
    return paged_attention.paged_attention_reference(q, k_pages, v_pages,
                                                     block_tables, kv_len)


def register_into(registry) -> None:
    registry.register("hopper", "gemm", hopper_gemm)
    registry.register("torch-ref", "gemm", ref_gemm)
    registry.register("hopper", "grouped_gemm", hopper_grouped_gemm)
    registry.register("torch-ref", "grouped_gemm", ref_grouped_gemm)
    registry.register("hopper", "attention", hopper_attention)
    registry.register("torch-ref", "attention", ref_attention)
    registry.register("hopper", "paged_attention", hopper_paged_attention)
    registry.register("torch-ref", "paged_attention", ref_paged_attention)
