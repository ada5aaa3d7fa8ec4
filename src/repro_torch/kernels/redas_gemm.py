"""The ReDas GEMM on Hopper: wrapper, launch counter and plain version.

`gemm` computes what `repro.kernels.redas_gemm.gemm` computes — (M, K) @
(K, N) with f32 accumulation, in the OS, WS or IS dataflow — through the
CUDA kernel in `csrc/redas_gemm.cu`.  The decision's (bm, bk, bn) is the
CTA tile, and it must be one of `TILES`, the menu the kernel is compiled
for.  Ragged M, K and N are masked inside the kernel: nothing is padded
or sliced here.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it returns the plain version `gemm_reference`, which is what the
tests compare against the JAX reference.  `launches` counts kernel
launches by dataflow and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_ref

DATAFLOWS = ("os", "ws", "is")

#: the CTA tiles (bm, bk, bn) the kernel is compiled for, in every dataflow
#: and both dtypes; `REDAS_TILES` in csrc/redas_gemm.cu is the same list.
TILES = ((16, 64, 64), (32, 64, 64), (64, 32, 64), (64, 64, 128),
         (128, 32, 128), (64, 256, 64))

#: shared memory a block may use on an H100 (227 KB, NVIDIA data sheet).
SMEM_LIMIT = 232_448

_PAD = 8          # shared-memory row padding, elements
_WARPS = 4        # 128 threads a block
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches by dataflow since the last reset (the CPU path and the
#: plain version never count).
launches = dict.fromkeys(DATAFLOWS, 0)

#: the plain version of the kernel: cast to f32, multiply, cast back.
gemm_reference = matmul_ref


def reset_launches() -> None:
    for df in DATAFLOWS:
        launches[df] = 0


def smem_bytes(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Shared memory one block of the (bm, bk, bn) kernel uses: the padded
    input and weight tiles plus the per-warp f32 epilogue tile (the
    `Smem` struct of the CUDA source)."""
    return (bm * (bk + _PAD) + bk * (bn + _PAD)) * in_bytes + _WARPS * 256 * 4


def _check(a: torch.Tensor, b: torch.Tensor, dataflow: str,
           tile: tuple[int, int, int], out_dtype) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm takes 2-D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm dim mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"gemm of an empty operand {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm takes two bf16 or two f32 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in (None, a.dtype):
        raise TypeError(f"the kernel writes its operand dtype {a.dtype}, "
                        f"not {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm takes contiguous row-major operands")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r} (known: {DATAFLOWS})")
    if tile not in TILES:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the "
                         f"kernel's menu {TILES}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("redas_gemm")
    lib.redas_gemm_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.redas_gemm_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _groups(dataflow: str, gm: int, gn: int, sms: int) -> int:
    """How many blocks share one stationary tile's sweep: enough to give
    the card about two blocks per SM, never more than the tiles swept."""
    if dataflow == "ws":
        return max(1, min(gm, -(-2 * sms // gn)))
    if dataflow == "is":
        return max(1, min(gn, -(-2 * sms // gm)))
    return 1


def gemm(a: torch.Tensor, b: torch.Tensor, *, dataflow: str = "os",
         bm: int, bk: int, bn: int,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) through the ReDas kernel with CTA tile (bm, bk, bn).

    CUDA operands launch the kernel on the current stream; CPU operands
    get `gemm_reference`.  Raises on anything the kernel does not take."""
    _check(a, b, dataflow, (bm, bk, bn), out_dtype)
    if a.device.type == "cpu":
        return gemm_reference(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on CUDA or CPU tensors, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    partial = None
    if dataflow != "os" and k > bk:
        partial = torch.empty((m, n), dtype=torch.float32, device=a.device)
    groups = _groups(dataflow, -(-m // bm), -(-n // bn),
                     _sm_count(a.device.index or 0))
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.redas_gemm_launch(
            DATAFLOWS.index(dataflow), _DTYPE_CODE[a.dtype], bm, bk, bn,
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            m, n, k, groups, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"redas_gemm {dataflow} ({bm},{bk},{bn}) launch "
                           f"failed: CUDA error {err}")
    launches[dataflow] += 1
    return out
