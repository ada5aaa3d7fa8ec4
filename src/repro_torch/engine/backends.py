"""Execution backends: decision -> kernel call (the port of
`repro/engine/backends.py`'s `_gemm_backend` and `pallas_gemm`, and of
the grouped and attention registrations of
`repro/kernels/grouped_gemm.py`, `repro/kernels/flash_attention.py` and
`repro/kernels/paged_attention.py`; the int8 entries port the
registrations of `repro/kernels/quant_gemm.py`, the sparse ones those of
`repro/kernels/sparse_gemm.py`).

The Hopper kernels mask ragged edges themselves, so the entries pass the
operands straight through: no padding copies, no slicing.

Every GEMM entry is differentiable.  The kernels are called through
ctypes, so their outputs carry no `grad_fn`; where autograd records and
an operand needs a gradient (`kernels.ref.wants_grad`), the call runs
through a `torch.autograd.Function` whose backward is itself made of
GEMMs, the reference's dispatch-layer custom VJPs: `DiffGemm` here (its
`_diff_gemm`, and `_diff_quant_gemm` too: the int8 GEMM's VJP is the
float GEMM's around an int8 forward), `grouped_gemm.DiffGrouped`,
`quant_gemm.DiffQuantGemmW8` and `sparse_gemm.DiffSparseGemm` /
`DiffSparseGemmQ`.  Each is handed its backward GEMM from here
(`backward_gemm`, `grouped_os`), so no kernel module reaches back into
the engine.  On the kernel backends the backward's GEMMs run on row 1's
OS kernel (`os_gemm`) or the grouped kernel (`grouped_os`) at
`HopperModel`'s OS rule for their shape, outside any engine's memo, as
the reference's backward calls `pallas_gemm` with default blocks outside
its engine: a plan never sees a backward shape.  On the plain backends
the backward takes the plain versions.
"""

from __future__ import annotations

import functools

import torch

from ..core import simulator
from ..kernels import (flash_attention, grouped_gemm, paged_attention,
                       quant_gemm, redas_gemm, sparse_gemm)
from ..kernels.ref import matmul_ref, wants_grad
from .cost import AnalyticalCostModel, HopperModel, decide_gemm, decide_grouped
from .plan import KernelDecision, KernelRequest


def gemm_args(decision: KernelDecision, a=None, b=None) -> dict:
    """The ReDas kernel's arguments a decision names: its dataflow and
    tile, and for WS/IS the `slabs` and `groups` its `meta` carries (a
    decision without them, e.g. from an older plan, leaves both to the
    wrapper's rules).  Given the operands, an OS tile that is not on the
    menu of the route they take (`redas_gemm.os_route`: a base that is not
    16-byte aligned, where the plan saw only the shape, or a plan from an
    older menu) snaps to that menu's nearest tile."""
    args = {"dataflow": decision.dataflow, "bm": decision.bm,
            "bk": decision.bk, "bn": decision.bn}
    if decision.dataflow != "os":
        meta = decision.meta_dict
        args.update(slabs=meta.get("slabs"), groups=meta.get("groups"))
    elif a is not None:
        menu = redas_gemm.tiles_for("os", redas_gemm.os_route(a, b))
        tile = (decision.bm, decision.bk, decision.bn)
        if tile not in menu:
            args.update(zip(("bm", "bk", "bn"),
                            quant_gemm.snap_tile(*tile, tiles=menu)))
    return args


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


@functools.lru_cache(maxsize=None)
def _os_tile(m: int, k: int, n: int, in_bytes: int, out_bytes: int,
             route: str) -> tuple[int, int, int]:
    """`HopperModel`'s OS tile for an (m, k, n) GEMM on `route`'s menu."""
    dec = decide_gemm(KernelRequest("gemm", m, k, n, in_bytes=in_bytes,
                                    out_bytes=out_bytes),
                      HopperModel.name, dataflows=("os",), route=route)
    return dec.bm, dec.bk, dec.bn


def os_gemm(a, b, out_dtype=None):
    """(M, K) @ (K, N) on row 1's OS kernel, on the route the operands take
    (`redas_gemm.os_route`), at `HopperModel`'s OS tile for the shape: the
    GEMM a backward runs on, outside any engine (the reference's
    `pallas_gemm` with default blocks).  CPU operands get the plain
    version, as every wrapper gives them."""
    out_dtype = out_dtype or a.dtype
    m, k = a.shape
    bm, bk, bn = _os_tile(m, k, b.shape[1], a.element_size(),
                          _itemsize(out_dtype), redas_gemm.os_route(a, b))
    return redas_gemm.gemm(a, b, dataflow="os", bm=bm, bk=bk, bn=bn,
                           out_dtype=out_dtype)


def backward_gemm(use_kernel: bool):
    """The float GEMM `bwd(a, b, out_dtype)` a backward runs on: `os_gemm`
    when the forward ran on a kernel, else the plain f32-accumulated
    product (the reference's `pallas_gemm` or `jnp.dot`)."""
    return os_gemm if use_kernel else matmul_ref


class DiffGemm(torch.autograd.Function):
    """The port of the reference's `_diff_gemm` (`engine/backends.py:87`):
    the forward is the decision's kernel call (`run`), the backward two
    GEMMs on `bwd` (`backward_gemm`), dA = g @ B^T in A's dtype and dB =
    A^T @ g in B's.  The transposes are contiguous copies: the kernels take
    row-major operands."""

    @staticmethod
    def forward(ctx, a, b, run, decision, out_dtype, bwd):
        ctx.save_for_backward(a, b)
        ctx.bwd = bwd
        return run(decision, a, b, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.bwd(g, b.T.contiguous(), a.dtype)
        if ctx.needs_input_grad[1]:
            db = ctx.bwd(a.T.contiguous(), g, b.dtype)
        return da, db, None, None, None, None


def _hopper_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    return redas_gemm.gemm(a, b, out_dtype=out_dtype,
                           **gemm_args(decision, a, b))


def _ref_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    return redas_gemm.gemm_reference(a, b, out_dtype)


def hopper_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The decision's dataflow, CTA tile, slabs and groups on the ReDas
    kernel (`gemm_args`), in `out_dtype`; through `DiffGemm` where a
    gradient is wanted."""
    if wants_grad(a, b):
        return DiffGemm.apply(a, b, _hopper_gemm, decision, out_dtype, os_gemm)
    return _hopper_gemm(decision, a, b, out_dtype=out_dtype)


def ref_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """The kernel's plain version; the decision is planned but ignored.
    Through `DiffGemm` (a plain backward) where a gradient is wanted."""
    if wants_grad(a, b):
        return DiffGemm.apply(a, b, _ref_gemm, decision, out_dtype,
                              matmul_ref)
    return _ref_gemm(decision, a, b, out_dtype=out_dtype)


def grouped_tile(decision: KernelDecision, x, w) -> tuple[int, int, int]:
    """The decision's per-expert OS tile, snapped to the nearest tile of
    the menu of the route the operands take (`grouped_gemm.grouped_route`)
    when it is not on it: a base that is not 16-byte aligned, where the
    plan saw only the shape, or a plan from an older menu."""
    menu = grouped_gemm.tiles_for(grouped_gemm.grouped_route(x, w))
    return quant_gemm.snap_tile(decision.bm, decision.bk, decision.bn,
                                tiles=menu)


@functools.lru_cache(maxsize=None)
def _grouped_tile(e: int, c: int, d: int, f: int, in_bytes: int,
                  out_bytes: int) -> tuple[int, int, int]:
    """`HopperModel`'s per-expert tile for an (e, c, d, f) grouped GEMM."""
    dec = decide_grouped(KernelRequest("grouped_gemm", c, d, f, groups=e,
                                       in_bytes=in_bytes,
                                       out_bytes=out_bytes),
                         HopperModel.name)
    return dec.bm, dec.bk, dec.bn


def grouped_os(x, w, out_dtype=None):
    """x (E, C, D) @ w (E, D, F) on the grouped kernel at `HopperModel`'s
    per-expert tile for the shape, snapped to the operands' route: the
    grouped GEMM a backward runs on, outside any engine."""
    out_dtype = out_dtype or x.dtype
    tile = _grouped_tile(*x.shape, w.shape[2], x.element_size(),
                         _itemsize(out_dtype))
    tile = quant_gemm.snap_tile(
        *tile, tiles=grouped_gemm.tiles_for(grouped_gemm.grouped_route(x, w)))
    return grouped_gemm.grouped_matmul(x, w, tile=tile, out_dtype=out_dtype)


def hopper_grouped_gemm(decision: KernelDecision, x, w, *,
                        out_dtype=None):
    """The decision's per-expert OS tile on the grouped kernel of the
    operands' route (`grouped_tile`); through `grouped_gemm.DiffGrouped`
    (its backward on `grouped_os`) where a gradient is wanted."""
    def run(x, w):
        return grouped_gemm.grouped_matmul(
            x, w, tile=grouped_tile(decision, x, w), out_dtype=out_dtype)
    if wants_grad(x, w):
        return grouped_gemm.DiffGrouped.apply(x, w, run, grouped_os)
    return run(x, w)


def ref_grouped_gemm(decision: KernelDecision, x, w, *, out_dtype=None):
    """The grouped kernel's plain version; the decision is planned but
    ignored.  Through `grouped_gemm.DiffGrouped` (a plain backward) where
    a gradient is wanted."""
    def run(x, w):
        return grouped_gemm.grouped_matmul_reference(x, w, out_dtype)
    if wants_grad(x, w):
        return grouped_gemm.DiffGrouped.apply(
            x, w, run, grouped_gemm.grouped_matmul_reference)
    return run(x, w)


def flash_blocks(decision: KernelDecision, q, k, v) -> tuple[int, int]:
    """The (bq, bk) of the flash route the operands take
    (`flash_attention.flash_route`): on the wgmma route its own tile,
    which `decide_attention` names (the kernel masks ragged edges); on the
    sync route the decision's blocks bent to divisors of the sequence
    lengths, as the JAX package's flash registration bends them."""
    if flash_attention.flash_route(q, k, v) == "wgmma":
        return flash_attention.route_tile("wgmma", q.shape[3])
    return (flash_attention._legal_block(q.shape[2], decision.bm),
            flash_attention._legal_block(k.shape[2], decision.bn))


def hopper_attention(decision: KernelDecision, q, k, v, *, causal=True,
                     window=0):
    """q (B, H, Sq, D); k/v (B, H, Sk, D) on the flash kernel of the
    operands' route, at `flash_blocks`."""
    bq, bk = flash_blocks(decision, q, k, v)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           window=window, bq=bq, bk=bk)


def ref_attention(decision: KernelDecision, q, k, v, *, causal=True,
                  window=0):
    """The flash kernel's plain version over the same KV blocks."""
    _, bk = flash_blocks(decision, q, k, v)
    return flash_attention.flash_attention_reference(q, k, v, causal=causal,
                                                     window=window, bk=bk)


def hopper_paged_attention(decision: KernelDecision, q, k_pages, v_pages,
                           block_tables, kv_len, *, k_scale=None,
                           v_scale=None):
    """Paged decode on the kernel, float pools or int8 pools with their
    scale pools (a cluster of `paged_attention.splits_for` blocks per
    (slot, KV head); the decision's blocks are planned but do not shape
    it)."""
    return paged_attention.paged_attention(q, k_pages, v_pages, block_tables,
                                           kv_len, k_scale, v_scale)


def ref_paged_attention(decision: KernelDecision, q, k_pages, v_pages,
                        block_tables, kv_len, *, k_scale=None, v_scale=None):
    """The paged kernel's plain version (int8 pools with their scales)."""
    return paged_attention.paged_attention_reference(
        q, k_pages, v_pages, block_tables, kv_len, k_scale, v_scale)


# --------------------------------------------------------------------------
# The int8 plane
# --------------------------------------------------------------------------


def _int8_tile(decision: KernelDecision) -> tuple[int, int, int]:
    """The decision's tile on the int8 kernel's tiled menu (a decision
    planned for another kernel, e.g. from a warm-start plan, snaps to
    it)."""
    return quant_gemm.snap_tile(decision.bm, decision.bk, decision.bn)


def int8_args(decision: KernelDecision) -> dict:
    """The int8 kernel's path arguments a decision names: its `meta`'s
    path and split_k (a decode decision), else the tiled path at the
    decision's tile snapped to the tiled menu (a tiled decision, or one
    planned for another kernel or an older menu)."""
    meta = decision.meta_dict
    if meta.get("path") == "decode":
        return {"path": "decode", "split_k": meta["split_k"]}
    return {"path": "tiled", "tile": _int8_tile(decision)}


def _quant_gemm(a, b, *, use_kernel: bool, out_dtype, **kernel_args):
    """`quant_gemm.quant_gemm` (int8 forward), through `DiffGemm` (its
    float backward, the reference's `_diff_quant_gemm`) where a gradient
    is wanted."""
    def run(_, a, b, *, out_dtype=None):
        return quant_gemm.quant_gemm(a, b, use_kernel=use_kernel,
                                     out_dtype=out_dtype, **kernel_args)
    if wants_grad(a, b):
        return DiffGemm.apply(a, b, run, None, out_dtype,
                              backward_gemm(use_kernel))
    return run(None, a, b, out_dtype=out_dtype)


def _int8_gemm(use_kernel: bool):
    def run(decision: KernelDecision, a, b, *, out_dtype=None):
        return _quant_gemm(a, b, use_kernel=use_kernel, out_dtype=out_dtype,
                           **int8_args(decision))
    run.__name__ = "hopper_int8_gemm" if use_kernel else "ref_int8_gemm"
    return run


def _int8_gemm_w8(use_kernel: bool):
    def run(decision: KernelDecision, a, w_q, w_scale, *, out_dtype=None):
        return quant_gemm.diff_quant_gemm_w8(a, w_q, w_scale,
                                             bwd=backward_gemm(use_kernel),
                                             use_kernel=use_kernel,
                                             out_dtype=out_dtype,
                                             **int8_args(decision))
    run.__name__ = "hopper_int8_gemm_w8" if use_kernel else "ref_int8_gemm_w8"
    return run


def _int8_grouped(use_kernel: bool):
    def run(decision: KernelDecision, x, w, *, out_dtype=None):
        """x (E, C, D) @ w (E, D, F), each expert through the int8 path
        (dynamic quantization of both operands) on the tiled kernel, as
        the JAX package's int8 grouped backend loops them (each
        expert's gradient through the same Function as `gemm`'s)."""
        tile = _int8_tile(decision)
        return torch.stack([_quant_gemm(
            x[e], w[e], tile=tile, use_kernel=use_kernel,
            out_dtype=out_dtype or x.dtype) for e in range(x.shape[0])])
    run.__name__ = ("hopper_int8_grouped_gemm" if use_kernel
                    else "ref_int8_grouped_gemm")
    return run


def plain_attention(decision: KernelDecision, q, k, v, *, causal=True,
                    window=0):
    """The plain chunked online softmax of `models.layers.flash_attention`
    (the JAX package's `_xla_attention`, which its int8 backends
    register): q/k/v (B, H, S, D) with GQA heads pre-expanded."""
    from ..models.layers import flash_attention as scan  # models import us

    b, h, sq, d = q.shape
    positions = torch.arange(sq, device=q.device)[None].expand(b, sq)
    kv_len = torch.full((b,), k.shape[2], dtype=torch.int32, device=q.device)
    o = scan(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             positions, kv_len, causal, window, min(512, sq))
    return o.transpose(1, 2)


# --------------------------------------------------------------------------
# The sparse plane
# --------------------------------------------------------------------------


def sparse_args(decision: KernelDecision) -> dict:
    """The sparse kernel's path arguments a decision names: its `meta`'s
    path and split_k (a decode decision), else the tiled path at the
    decision's tile snapped to the tiled menu (a tiled decision, or one
    planned for another kernel, e.g. from a warm-start plan)."""
    meta = decision.meta_dict
    if meta.get("path") == "decode":
        return {"path": "decode", "split_k": meta["split_k"]}
    return {"path": "tiled",
            "tile": quant_gemm.snap_tile(decision.bm, decision.bk,
                                         decision.bn,
                                         tiles=sparse_gemm.TILES)}


def hopper_sparse_gemm(decision: KernelDecision, a, values, indices,
                       scale=None, *, n_keep, m_group, out_dtype=None):
    """The decision's path on the sparse kernel (`sparse_args`); int8
    values with their per-column `scale` take its int8-value variant.
    Differentiable (`sparse_gemm.diff_sparse_gemm`)."""
    return sparse_gemm.diff_sparse_gemm(
        a, values, indices, scale, n_keep=n_keep, m_group=m_group,
        bwd=os_gemm, out_dtype=out_dtype, use_kernel=True,
        **sparse_args(decision))


def ref_sparse_gemm(decision: KernelDecision, a, values, indices,
                    scale=None, *, n_keep, m_group, out_dtype=None):
    """The sparse kernel's plain version; the decision is planned but
    ignored.  Differentiable (`sparse_gemm.diff_sparse_gemm`)."""
    return sparse_gemm.diff_sparse_gemm(
        a, values, indices, scale, n_keep=n_keep, m_group=m_group,
        bwd=matmul_ref, out_dtype=out_dtype, use_kernel=False)


# --------------------------------------------------------------------------
# The accelerator plane
# --------------------------------------------------------------------------


def simulator_gemm(decision: KernelDecision, a, b, *, out_dtype=None):
    """Execute an ASIC-plane decision on the cycle-level simulator
    (`core.simulator.simulate_mapping`, on the operands' device)."""
    if "shape_rows" not in decision.meta_dict:
        raise ValueError(
            "simulator backend needs an ASIC mapping in decision.meta "
            "(plan with AnalyticalCostModel, not HopperModel)")
    cfg = AnalyticalCostModel.mapping_config(decision)
    out, _ = simulator.simulate_mapping(a, b, cfg)
    return out.to(out_dtype or a.dtype)


def register_into(registry) -> None:
    registry.register("simulator", "gemm", simulator_gemm)
    registry.register("hopper", "gemm", hopper_gemm)
    registry.register("torch-ref", "gemm", ref_gemm)
    registry.register("hopper", "grouped_gemm", hopper_grouped_gemm)
    registry.register("torch-ref", "grouped_gemm", ref_grouped_gemm)
    registry.register("hopper", "attention", hopper_attention)
    registry.register("torch-ref", "attention", ref_attention)
    registry.register("hopper", "paged_attention", hopper_paged_attention)
    registry.register("torch-ref", "paged_attention", ref_paged_attention)
    for name, use_kernel in (("hopper-int8", True), ("torch-ref-int8", False)):
        registry.register(name, "gemm", _int8_gemm(use_kernel))
        registry.register(name, "gemm_w8", _int8_gemm_w8(use_kernel))
        registry.register(name, "grouped_gemm", _int8_grouped(use_kernel))
        # attention stays float and plain, as in the JAX package
        registry.register(name, "attention", plain_attention)
    registry.register("hopper-int8", "paged_attention", hopper_paged_attention)
    registry.register("torch-ref-int8", "paged_attention", ref_paged_attention)
    # the sparse plane: pruned weights on the sparse kernel, anything left
    # dense on the float GEMM; the grouped and attention ops plain, and
    # paged decode on its kernel, as the JAX package keeps the sparse
    # namespace total (MoE expert stacks are never pruned)
    for name, kernels in (("hopper-sparse", True), ("torch-ref-sparse", False)):
        registry.register(name, "gemm_sparse",
                          hopper_sparse_gemm if kernels else ref_sparse_gemm)
        registry.register(name, "gemm", hopper_gemm if kernels else ref_gemm)
        registry.register(name, "grouped_gemm", ref_grouped_gemm)
        registry.register(name, "attention", plain_attention)
        registry.register(name, "paged_attention",
                          hopper_paged_attention if kernels
                          else ref_paged_attention)
