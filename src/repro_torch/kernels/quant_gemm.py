"""The int8 GEMM on Hopper: wrapper, launch counters, plain version, and
the quantize -> int32 GEMM -> rescale entry points (the port of
`repro/kernels/quant_gemm.py`).

`gemm_int8` computes what `repro.kernels.quant_gemm.gemm_int8` computes —
(M, K) int8 @ (K, N) int8 -> int32, exact — through the CUDA kernels in
`csrc/quant_gemm.cu`, on one of two paths the caller names (the engine
plans it, `engine/cost.py::decide_int8`):

- "tiled" (any M): one block per (bm, bn) output tile, a pipelined ring
  of bk-deep K chunks; `tile` must be one of `TILES`;
- "decode" (M <= `DECODE_ROWS[-1]`): no tile; `DECODE_BN`-column tiles
  of the weight, K's 32-row slices split over `split_k` blocks of one
  thread-block cluster (`split_slices`), combined in the same launch.

Ragged M, K and N and operands at any base address are handled inside
the kernels (zero padding is exact for integers), so nothing is padded
or sliced here.  Integer sums are exact in any order: every path, tile
and split gives the plain version's bits.

`quant_gemm` (dynamic per-row / per-column quantization of both
operands) and `quant_gemm_w8` (pre-quantized weights, per-row dynamic
activations) keep the JAX package's arithmetic as its jitted functions
run it: the codec of `quant.quantize` with the scale XLA computes there
(`jitted=True`), then `(acc.float() * s_a[:, None]) * s_w[None, :]`
cast to the output dtype.  The quantization and the rescale are plain
torch, as they are jnp outside the `pallas_call` there.

On a CUDA tensor `gemm_int8` launches the path's kernel (or raises; there
is no fallback from one path to the other); on a CPU tensor it returns
the plain version `gemm_int8_reference`.  `launches` counts kernel
launches, one per call whatever the path, and `path_launches` splits
them by path.

`diff_quant_gemm_w8` is the differentiable entry of `quant_gemm_w8`
(the reference's `_diff_quant_gemm_w8`, `quant_gemm.py:263`): an int8
forward, a float backward whose cotangent never quantizes, on the
backward GEMM its caller passes.  `quant_gemm`'s VJP (the reference's
`_diff_quant_gemm`, `:234`) is the float GEMM's own, `DiffGemm` at the
dispatch layer (`engine/backends.py`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..quant.quantize import kv_quantize, quantize
from . import _build
from .redas_gemm import SMEM_LIMIT
from .ref import wants_grad

#: the tiled path's CTA tiles (bm, bk, bn); `QUANT_TILES` in
#: csrc/quant_gemm.cu is the same list.  4 warps (2 x 2) a block: bm a
#: multiple of 32, bn of 64 (a warp's columns, 4 or 8 a lane), bk the
#: ring's chunk depth.
TILES = ((32, 64, 64), (64, 64, 64), (64, 64, 128), (128, 64, 64),
         (128, 64, 128))
#: the decode path's row buckets (M <= bucket), the weight columns of a
#: block, the K rows of a slice and the most splits (the portable cluster
#: size); `QUANT_DECODE_*` in csrc/quant_gemm.cu
DECODE_ROWS = (8, 16)
DECODE_BN = 64
DECODE_SLICE = 32
DECODE_MAX_SPLIT = 8
PATHS = ("decode", "tiled")

_STAGES = 4                 # the tiled ring's depth
_DECODE_RING = 4 * 6 * DECODE_SLICE * DECODE_BN   # 4 warps x 6 stages
_GRID_LIMIT = 65535         # gridDim.y

#: kernel launches since the last reset, in all and by path (the CPU path
#: and the plain version never count).
launches = 0
path_launches = dict.fromkeys(PATHS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for path in PATHS:
        path_launches[path] = 0


def smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Shared memory one tiled block of tile (bm, bk, bn) uses: the ring's
    stages of the int8 A and B chunks (`Tiled::smem` in the CUDA
    source)."""
    return _STAGES * (bm * bk + bk * bn)


def decode_rows(m: int) -> int:
    """The decode row bucket the kernel runs an (m, K) activation at."""
    for rows in DECODE_ROWS:
        if m <= rows:
            return rows
    raise ValueError(f"M = {m} is above the decode path's largest row "
                     f"bucket {DECODE_ROWS[-1]}")


def split_slices(k: int, split_k: int) -> tuple[int, int]:
    """(base, extra) over K's ceil(K / 32) slices: split s takes base +
    (s < extra) slices from s * base + min(s, extra), so every slice is
    taken once and the splits differ by at most one (splits past the
    slices take none).  The wrapper hands both to the kernel."""
    if k < 1 or not 1 <= split_k <= DECODE_MAX_SPLIT:
        raise ValueError(f"need K >= 1 and split_k in 1..{DECODE_MAX_SPLIT}, "
                         f"got {k} and {split_k}")
    slices = -(-k // DECODE_SLICE)
    return slices // split_k, slices % split_k


def decode_smem_bytes(m: int, k: int, split_k: int) -> int:
    """Shared memory of one decode block: the warps' rings, then the
    row bucket's activation rows of the largest split's slices, each
    padded by 16 bytes (`dec_smem` in the CUDA source)."""
    base, extra = split_slices(k, split_k)
    slices = base + (extra > 0)
    return _DECODE_RING + decode_rows(m) * (slices * DECODE_SLICE + 16)


def gemm_int8_reference(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The plain version, exact: an int32 matmul on the CPU; on the card,
    where torch has no integer matmul, float64 (every int8 x int8 sum at
    these K, |sum| <= K x 128^2 < 2^53, is exact there)."""
    if a_q.device.type == "cpu":
        return a_q.to(torch.int32) @ b_q.to(torch.int32)
    return (a_q.double() @ b_q.double()).to(torch.int32)


def _check(a_q, b_q, path, tile, split_k) -> None:
    if a_q.dim() != 2 or b_q.dim() != 2:
        raise ValueError(f"gemm_int8 takes 2-D operands, got "
                         f"{tuple(a_q.shape)} @ {tuple(b_q.shape)}")
    if a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8 GEMM dim mismatch {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    if min(m, k, n) < 1:
        raise ValueError(f"gemm_int8 of an empty operand {tuple(a_q.shape)} "
                         f"@ {tuple(b_q.shape)}")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"gemm_int8 takes two int8 operands, got "
                        f"{a_q.dtype} and {b_q.dtype}")
    if a_q.device != b_q.device:
        raise ValueError(f"operands on {a_q.device} and {b_q.device}")
    if not (a_q.is_contiguous() and b_q.is_contiguous()):
        raise ValueError("gemm_int8 takes contiguous row-major operands")
    if path not in PATHS:
        raise ValueError(f"path {path!r} is not one of the kernel's {PATHS}")
    if path == "decode":
        if tile is not None:
            raise ValueError(f"the decode path takes no tile, got {tile}")
        decode_rows(m)
        if type(split_k) is not int or not 1 <= split_k <= DECODE_MAX_SPLIT:
            raise ValueError(f"split_k must be an int in "
                             f"1..{DECODE_MAX_SPLIT}, got {split_k!r}")
        if decode_smem_bytes(m, k, split_k) > SMEM_LIMIT:
            raise ValueError(f"K = {k} at split_k {split_k} needs more than "
                             f"the {SMEM_LIMIT} bytes of shared memory a "
                             f"block may use")
        if -(-n // DECODE_BN) > _GRID_LIMIT:
            raise ValueError(f"N = {n} exceeds the decode grid's limit")
        return
    if split_k != 1:
        raise ValueError(f"the tiled path takes split_k 1, got {split_k!r}")
    if tile not in TILES:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the "
                         f"kernel's menu {TILES}")
    if -(-m // tile[0]) > _GRID_LIMIT:
        raise ValueError(f"M = {m} at bm = {tile[0]} exceeds the grid limit "
                         f"{_GRID_LIMIT}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("quant_gemm")
    lib.quant_gemm_launch.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.quant_decode_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.quant_gemm_launch.restype = ctypes.c_int
    lib.quant_decode_launch.restype = ctypes.c_int
    return lib


def gemm_int8(a_q: torch.Tensor, b_q: torch.Tensor, *,
              tile: tuple[int, int, int] | None = None, path: str = "tiled",
              split_k: int = 1) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 on the kernel path
    `path`: "tiled" at CTA tile `tile` = (bm, bk, bn) (the menu's largest
    if None), or "decode" with K split over `split_k` blocks (M <=
    `DECODE_ROWS[-1]`, no tile).

    CUDA operands launch the kernel on the current stream; CPU operands
    get `gemm_int8_reference`.  Raises on anything the kernels do not
    take, and when the launch fails (there is no fallback)."""
    global launches
    if path == "tiled" and tile is None:
        tile = TILES[-1]
    tile = None if tile is None else tuple(tile)
    _check(a_q, b_q, path, tile, split_k)
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
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tiled":
            err = lib.quant_gemm_launch(
                *tile, a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), m, n,
                k, stream)
            what = f"tile {tile}"
        else:
            err = lib.quant_decode_launch(
                decode_rows(m), a_q.data_ptr(), b_q.data_ptr(),
                out.data_ptr(), m, n, k, split_k, *split_slices(k, split_k),
                stream)
            what = f"decode split_k {split_k}"
    if err != 0:
        raise RuntimeError(f"quant_gemm {what} launch failed: CUDA error "
                           f"{err}")
    launches += 1
    path_launches[path] += 1
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


def _int32(a_q, b_q, use_kernel: bool, kernel_args: dict) -> torch.Tensor:
    if use_kernel:
        return gemm_int8(a_q, b_q.contiguous(), **kernel_args)
    return gemm_int8_reference(a_q, b_q)


def _rescale(acc, s_a, s_b, out_dtype) -> torch.Tensor:
    return (acc.float() * s_a[:, None] * s_b[None, :]).to(out_dtype)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, *,
               tile: tuple[int, int, int] | None = None,
               path: str = "tiled", split_k: int = 1,
               use_kernel: bool = True,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Float (M, K) @ (K, N) through dynamic int8 quantization of both
    operands: per-row scales on A, per-column on B, int32 accumulation on
    the kernel path `path` (`gemm_int8`'s `tile`, `path` and `split_k`),
    one rescale.  `use_kernel=False` takes the plain int32 product on any
    device."""
    a_q, s_a = quantize_rows(a)
    b_q, s_b = quantize_cols(b)
    acc = _int32(a_q, b_q, use_kernel,
                 {"tile": tile, "path": path, "split_k": split_k})
    return _rescale(acc, s_a, s_b, out_dtype or a.dtype)


def quant_gemm_w8(a: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  *, tile: tuple[int, int, int] | None = None,
                  path: str = "tiled", split_k: int = 1,
                  use_kernel: bool = True,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Float activations (M, K) against pre-quantized weights
    (`quant.quantize_params` storage: w_q (K, N) int8, w_scale (1, N) or
    (N,) float32), read as stored: the serving path that never makes a
    float weight.  `tile`, `path` and `split_k` as in `gemm_int8`."""
    a_q, s_a = quantize_rows(a)
    acc = _int32(a_q, w_q, use_kernel,
                 {"tile": tile, "path": path, "split_k": split_k})
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


# --------------------------------------------------------------------------
# Dispatch-layer VJP: an int8 forward, a float backward
# --------------------------------------------------------------------------


class DiffQuantGemmW8(torch.autograd.Function):
    """`quant_gemm_w8`'s VJP (the reference's `_diff_quant_gemm_w8`): the
    activations' cotangent only, dA = g @ dequant(W)^T in A's dtype; the
    stored int8 weight is data, not a trainable leaf."""

    @staticmethod
    def forward(ctx, a, w_q, w_scale, run, bwd):
        ctx.save_for_backward(w_q, w_scale)
        ctx.bwd, ctx.a_dtype = bwd, a.dtype
        return run(a, w_q, w_scale)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        dtype = ctx.a_dtype
        w_f = (w_q.float() * w_scale.reshape(1, -1)).to(dtype)
        da = ctx.bwd(g.to(dtype).contiguous(), w_f.T.contiguous(), dtype)
        return da, None, None, None, None


def diff_quant_gemm_w8(a, w_q, w_scale, *, bwd, use_kernel: bool = True,
                       out_dtype=None, **kernel_args):
    """`quant_gemm_w8`, through `DiffQuantGemmW8` where a gradient is
    wanted; `bwd(a, b, out_dtype)` is the float GEMM of its backward."""
    def run(a, w_q, w_scale):
        return quant_gemm_w8(a, w_q, w_scale, use_kernel=use_kernel,
                             out_dtype=out_dtype, **kernel_args)
    if wants_grad(a):
        return DiffQuantGemmW8.apply(a, w_q, w_scale, run, bwd)
    return run(a, w_q, w_scale)
