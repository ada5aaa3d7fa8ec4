"""The grouped (per-expert) GEMM on Hopper: wrapper, launch counters and
plain version.

`grouped_matmul` computes what `repro.kernels.grouped_gemm.grouped_matmul`
computes — y[e] = x[e] @ w[e] for x (E, C, D) and w (E, D, F), with f32
accumulation, written in `out_dtype` (bf16 or f32; x's dtype unless
given), as the JAX package's grouped backend casts its f32 result —
through the CUDA kernels in `csrc/grouped_gemm.cu`: one block per
(expert, C tile, F tile), the D sweep inside the block (OS).

Two routes, decided before the launch by `grouped_route` from the
operands' dtype, shape and base addresses alone: "wgmma" (bf16 whose D
and F are multiples of 8 and whose bases are 16-byte aligned, TMA's
rules: the ReDas GEMM's TMA/wgmma ring over each expert, menu
`WGMMA_TILES`) and "sync" (everything else: the synchronous-load kernel,
menu `TILES`).  The decision's (bm, bk, bn) is the per-expert tile over
(C, D, F), and it must be on the route's menu.  A launch that fails
raises; no other route is tried.  Ragged C, D and F are masked inside the
kernels: nothing is padded or sliced here.

On a CUDA tensor the wrapper launches a kernel (or raises); on a CPU
tensor it returns the plain version `grouped_matmul_reference`, which is
what the tests compare against the JAX reference.  `launches` counts
kernel launches on both routes and nothing else, `wgmma_launches` those
on the wgmma route.

`DiffGrouped` is the port of the reference's `_diff_grouped`
(`grouped_gemm.py:92`): the engine's grouped entries run through it
where a gradient is wanted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import redas_gemm
from .redas_gemm import SMEM_LIMIT, smem_bytes, wgmma_smem_bytes

#: the sync route's per-expert tiles (bm, bk, bn), in both dtypes;
#: `GROUPED_TILES` in csrc/grouped_gemm.cu is the same list.  A block of
#: tile t uses `smem_bytes(*t, itemsize)` of shared memory (the ReDas
#: GEMM's OS tile layout, csrc/gemm_tile.cuh), at most SMEM_LIMIT.
TILES = ((16, 64, 64), (32, 64, 64), (64, 32, 64), (64, 64, 128),
         (128, 32, 128), (64, 256, 64))
#: the wgmma route's per-expert tiles (bm, bk, bn): the ReDas GEMM's wgmma
#: menu, whose ring the kernel shares; `GROUPED_WGMMA_TILES` in
#: csrc/grouped_gemm.cu is the same list.  A block of tile t uses
#: `wgmma_smem_bytes(*t)`.
WGMMA_TILES = redas_gemm.WGMMA_TILES

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_GRID_LIMIT = 65535   # gridDim.y and gridDim.z

#: kernel launches on both routes, and those on the wgmma route, since the
#: last reset (the CPU path and the plain version never count)
launches = 0
wgmma_launches = 0


def reset_launches() -> None:
    global launches, wgmma_launches
    launches = wgmma_launches = 0


def grouped_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route of a call on these operands: the ReDas GEMM's
    `shape_route` at (K, N) = (D, F) (what a planner, which sees no
    pointers, plans for: "wgmma" for bf16 with D and F multiples of 8),
    and "sync" as well when either base is not 16-byte aligned (TMA's
    address rule).  A pure function of dtype, shape and pointers."""
    route = redas_gemm.shape_route(x.element_size(), x.shape[-1],
                                   w.shape[-1])
    if route == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        return "sync"
    return route


def tiles_for(route: str) -> tuple:
    """The per-expert tile menu of a route."""
    return WGMMA_TILES if route == "wgmma" else TILES


def tile_smem(tile: tuple[int, int, int], in_bytes: int, route: str) -> int:
    """Shared memory one block of the route's kernel uses at this tile."""
    return (wgmma_smem_bytes(*tile) if route == "wgmma"
            else smem_bytes(*tile, in_bytes))


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             out_dtype: torch.dtype | None = None
                             ) -> torch.Tensor:
    """The plain version: each expert's (C, D) @ (D, F) in f32, cast to
    the output dtype (`x`'s unless given)."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, tile: tuple[int, int, int],
           out_dtype) -> str:
    """Raise on what the kernels do not take; else the call's route."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_matmul takes (E, C, D) @ (E, D, F), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped dim mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if min(*x.shape, w.shape[2]) < 1:
        raise ValueError(f"grouped_matmul of an empty operand "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"grouped_matmul takes two bf16 or two f32 operands, "
                        f"got {x.dtype} and {w.dtype}")
    if out_dtype not in (None, *_DTYPE_CODE):
        raise TypeError(f"the kernel writes bf16 or f32, not {out_dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul takes contiguous operands")
    route = grouped_route(x, w)
    menu = tiles_for(route)
    if tile not in menu:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the {route} "
                         f"route's menu {menu}")
    if tile_smem(tile, x.element_size(), route) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs more than the {SMEM_LIMIT} "
                         f"bytes of shared memory a block may use")
    if max(x.shape[0], -(-x.shape[1] // tile[0])) > _GRID_LIMIT:
        raise ValueError(f"{tuple(x.shape)} at tile {tile} exceeds the "
                         f"grid limit {_GRID_LIMIT}")
    return route


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("grouped_gemm")
    lib.grouped_gemm_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.grouped_wgmma_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.grouped_gemm_launch.restype = ctypes.c_int
    lib.grouped_wgmma_launch.restype = ctypes.c_int
    return lib


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   tile: tuple[int, int, int],
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in `out_dtype` (x's dtype if
    None) through the grouped kernel of `grouped_route(x, w)` with
    per-expert tile `tile` = (bm, bk, bn), which must be on that route's
    menu.

    CUDA operands launch the kernel on the current stream; CPU operands
    get `grouped_matmul_reference`.  Raises on anything the kernels do
    not take, and when a launch fails."""
    global launches, wgmma_launches
    tile = tuple(tile)
    route = _check(x, w, tile, out_dtype)
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=out_dtype or x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.grouped_wgmma_launch(
                _DTYPE_CODE[out.dtype], *tile, x.data_ptr(), w.data_ptr(),
                out.data_ptr(), e, c, d, f, stream)
        else:
            err = lib.grouped_gemm_launch(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[out.dtype], *tile,
                x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm {route} {tile} launch failed: CUDA "
                           f"error {err}")
    launches += 1
    if route == "wgmma":
        wgmma_launches += 1
    return out


class DiffGrouped(torch.autograd.Function):
    """The grouped GEMM's VJP (the reference's `_diff_grouped`): the
    forward is `run(x, w)`, the backward two grouped GEMMs on transposed
    operands, dx = g @ w^T per expert in x's dtype and dw = x^T @ g in
    w's, through `bwd(x, w, out_dtype)` (the kernel, or the plain
    version).  The transposes are contiguous copies: the kernels take
    row-major operands."""

    @staticmethod
    def forward(ctx, x, w, run, bwd):
        ctx.save_for_backward(x, w)
        ctx.bwd = bwd
        return run(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ctx.bwd(g, w.transpose(1, 2).contiguous(), x.dtype)
        if ctx.needs_input_grad[1]:
            dw = ctx.bwd(x.transpose(1, 2).contiguous(), g, w.dtype)
        return dx, dw, None, None
