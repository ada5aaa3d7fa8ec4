"""The int8 GEMM on Hopper: wrapper, launch counter, plain version, and
the quantize -> int32 GEMM -> rescale entry points (the port of
`repro/kernels/quant_gemm.py`).

`gemm_int8` computes what `repro.kernels.quant_gemm.gemm_int8` computes —
(M, K) int8 @ (K, N) int8 -> int32, OS, the int32 accumulator on chip for
the whole K loop — through the CUDA kernel in `csrc/quant_gemm.cu`.  The
tile (bm, bk, bn) must be one of `TILES`, the menu the kernel is compiled
for; ragged M, K and N are masked inside the kernel (zero padding is
exact for integers), so nothing is padded or sliced here.

`quant_gemm` (dynamic per-row / per-column quantization of both
operands) and `quant_gemm_w8` (pre-quantized weights, per-row dynamic
activations) keep the JAX package's arithmetic as its jitted functions
run it: the codec of `quant.quantize` with the scale XLA computes there
(`jitted=True`), then `(acc.float() * s_a[:, None]) * s_w[None, :]`
cast to the output dtype.  The quantization and the rescale are plain
torch, as they are jnp outside the `pallas_call` there.

On a CUDA tensor `gemm_int8` launches the kernel (or raises); on a CPU
tensor it returns the plain version `gemm_int8_reference`.  `launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..quant.quantize import kv_quantize, quantize
from . import _build
from .redas_gemm import SMEM_LIMIT

#: the CTA tiles (bm, bk, bn) the kernel is compiled for; `QUANT_TILES`
#: in csrc/quant_gemm.cu is the same list.  bm is 16 or a multiple of 32
#: (the 4-warp WMMA layout), bk and bn multiples of 64.
TILES = ((16, 128, 64), (16, 256, 64), (32, 128, 128), (64, 128, 128),
         (128, 64, 128), (128, 128, 128))

_WARPS = 4
_GRID_LIMIT = 65535   # gridDim.y

#: kernel launches since the last reset (the CPU path and the plain
#: version never count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Shared memory one block of tile (bm, bk, bn) uses: the int8 A and
    B tiles (in 16-byte slabs, no padding) and one 16 x 16 int32 staging
    tile per warp (the `Smem` struct of the CUDA source)."""
    return bm * bk + bk * bn + _WARPS * 256 * 4


def gemm_int8_reference(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The plain version, exact: an int32 matmul on the CPU; on the card,
    where torch has no integer matmul, float64 (every int8 x int8 sum at
    these K, |sum| <= K x 127^2 < 2^53, is exact there)."""
    if a_q.device.type == "cpu":
        return a_q.to(torch.int32) @ b_q.to(torch.int32)
    return (a_q.double() @ b_q.double()).to(torch.int32)


def _check(a_q: torch.Tensor, b_q: torch.Tensor,
           tile: tuple[int, int, int]) -> None:
    if a_q.dim() != 2 or b_q.dim() != 2:
        raise ValueError(f"gemm_int8 takes 2-D operands, got "
                         f"{tuple(a_q.shape)} @ {tuple(b_q.shape)}")
    if a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8 GEMM dim mismatch {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    if min(a_q.shape[0], a_q.shape[1], b_q.shape[1]) < 1:
        raise ValueError(f"gemm_int8 of an empty operand {tuple(a_q.shape)} "
                         f"@ {tuple(b_q.shape)}")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"gemm_int8 takes two int8 operands, got "
                        f"{a_q.dtype} and {b_q.dtype}")
    if a_q.device != b_q.device:
        raise ValueError(f"operands on {a_q.device} and {b_q.device}")
    if not (a_q.is_contiguous() and b_q.is_contiguous()):
        raise ValueError("gemm_int8 takes contiguous row-major operands")
    if tile not in TILES:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the "
                         f"kernel's menu {TILES}")
    if smem_bytes(*tile) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs more than the {SMEM_LIMIT} "
                         f"bytes of shared memory a block may use")
    if -(-a_q.shape[0] // tile[0]) > _GRID_LIMIT:
        raise ValueError(f"M = {a_q.shape[0]} at bm = {tile[0]} exceeds the "
                         f"grid limit {_GRID_LIMIT}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("quant_gemm")
    lib.quant_gemm_launch.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.quant_gemm_launch.restype = ctypes.c_int
    return lib


def gemm_int8(a_q: torch.Tensor, b_q: torch.Tensor, *,
              tile: tuple[int, int, int]) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through the kernel with
    CTA tile `tile` = (bm, bk, bn).

    CUDA operands launch the kernel on the current stream; CPU operands
    get `gemm_int8_reference`.  Raises on anything the kernel does not
    take, and when the launch fails (there is no fallback)."""
    global launches
    tile = tuple(tile)
    _check(a_q, b_q, tile)
    if a_q.device.type == "cpu":
        return gemm_int8_reference(a_q, b_q)
    if a_q.device.type != "cuda":
        raise ValueError(f"gemm_int8 runs on CUDA or CPU tensors, not "
                         f"{a_q.device}")
    m, k = a_q.shape
    n = b_q.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    lib = _library()
    with torch.cuda.device(a_q.device):
        err = lib.quant_gemm_launch(
            *tile, a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_gemm {tile} launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


# --------------------------------------------------------------------------
# Quantize -> int32 GEMM -> rescale
# --------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row quantization: x (M, K) float -> (q int8,
    scale (M,) float32).  One codec: this is `quant.kv_quantize`, in the
    form the JAX package runs inside its jitted GEMM (`jitted=True`)."""
    return kv_quantize(x, jitted=True)


def quantize_cols(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column twin for the right operand: x (K, N) float -> (q int8,
    scale (N,) float32), the weight codec reducing axis 0 (jitted form,
    as `quantize_rows`)."""
    qt = quantize(x, axis=0, jitted=True)
    return qt.q, qt.scale.reshape(-1)


def _int32(a_q, b_q, tile, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        return gemm_int8(a_q, b_q.contiguous(), tile=tile)
    return gemm_int8_reference(a_q, b_q)


def _rescale(acc, s_a, s_b, out_dtype) -> torch.Tensor:
    return (acc.float() * s_a[:, None] * s_b[None, :]).to(out_dtype)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, *,
               tile: tuple[int, int, int] = TILES[-1],
               use_kernel: bool = True,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Float (M, K) @ (K, N) through dynamic int8 quantization of both
    operands: per-row scales on A, per-column on B, int32 accumulation,
    one rescale.  `use_kernel=False` takes the plain int32 product on any
    device."""
    a_q, s_a = quantize_rows(a)
    b_q, s_b = quantize_cols(b)
    acc = _int32(a_q, b_q, tile, use_kernel)
    return _rescale(acc, s_a, s_b, out_dtype or a.dtype)


def quant_gemm_w8(a: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  *, tile: tuple[int, int, int] = TILES[-1],
                  use_kernel: bool = True,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Float activations (M, K) against pre-quantized weights
    (`quant.quantize_params` storage: w_q (K, N) int8, w_scale (1, N) or
    (N,) float32): the serving path that never makes a float weight."""
    a_q, s_a = quantize_rows(a)
    acc = _int32(a_q, w_q, tile, use_kernel)
    return _rescale(acc, s_a, w_scale.reshape(-1), out_dtype or a.dtype)


def snap_tile(bm: int, bk: int, bn: int,
              tiles=TILES) -> tuple[int, int, int]:
    """(bm, bk, bn) itself when it is on the menu `tiles` (the int8
    kernel's unless given), else the menu tile nearest to it in log2
    distance summed over the three dims (the first of equals): the int8
    kernel's counterpart of the JAX package's `align_int8_blocks`."""
    if (bm, bk, bn) in tiles:
        return bm, bk, bn

    def dist(t):
        return sum(abs(math.log2(x / y)) for x, y in zip(t, (bm, bk, bn)))

    return min(tiles, key=dist)
