"""The N:M structured-sparse GEMM on Hopper: wrapper, launch counter and
plain version (the port of `repro/kernels/sparse_gemm.py`, float values).

`sparse_gemm` computes what `repro.kernels.sparse_gemm.sparse_gemm`
computes for float storage — (M, K) @ N:M-compressed (K_c, N) values and
int8 in-group offsets -> f32 accumulation, cast to `out_dtype or a.dtype`
— through the CUDA kernel in `csrc/sparse_gemm.cu`, which scatters each
compressed chunk back to a dense shared-memory tile (the one-hot sum of
`_scatter_dense`) and multiplies it densely, OS.  `n_keep` and `m_group`
are runtime arguments: every spec `sparse.parse_sparsity` admits runs.
The CTA tile (bm, bk, bn) must be one of `TILES`; bk is the chunk's dense
capacity, which holds `bk // m_group` whole groups.  The reference's entry
point zero-pads A to the group-padded K and every dim to its blocks
(`sparse_gemm.py:199-217`); the kernel reads those out-of-range operands
as zero instead, so nothing is padded or sliced here.

On a CUDA tensor `sparse_gemm` launches the kernel (or raises); on a CPU
tensor it returns the plain version `sparse_gemm_reference`, the
reference's `use_pallas=False` branch: the one-hot scatter, then one f32
product.  `launches` counts kernel launches and nothing else.  Sparse x
int8 storage (int8 values and a per-column scale) is not ported yet
(ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .redas_gemm import SMEM_LIMIT

#: the CTA tiles (bm, bk, bn) the kernel is compiled for; `SPARSE_TILES`
#: in csrc/sparse_gemm.cu is the same list.  bk = 128 holds at least one
#: group of the widest spec (M <= 128).
TILES = ((16, 128, 64), (32, 128, 128), (64, 128, 128), (128, 128, 128))

_PAD = 8          # shared-memory row padding of the float tiles, elements
_WARPS = 4        # 128 threads a block
_GRID_LIMIT = 65535   # gridDim.y
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches since the last reset (the CPU path and the plain
#: version never count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Shared memory one block of tile (bm, bk, bn) uses: the padded
    activation and dense weight tiles, the per-warp f32 epilogue tile, and
    the chunk's compressed values (padded rows) and int8 indices, each
    sized for bk rows (the `SparseSmem` struct of the CUDA source)."""
    return ((bm * (bk + _PAD) + 2 * bk * (bn + _PAD)) * in_bytes
            + _WARPS * 256 * 4 + bk * bn)


def scatter_dense(values: torch.Tensor, indices: torch.Tensor, n_keep: int,
                  m_group: int) -> torch.Tensor:
    """Compressed (K_c, N) storage -> the dense (K_c // n_keep * m_group,
    N) weight: the one-hot sum over the in-group offset of the reference's
    `_scatter_dense`.  An offset outside 0..m_group-1 adds nothing; kept
    values at one offset add."""
    k_c, n = values.shape
    groups = k_c // n_keep
    v3 = values.reshape(groups, n_keep, n)
    i3 = indices.reshape(groups, n_keep, n)
    planes = [torch.where(i3 == off, v3, 0.0).sum(dim=1)
              for off in range(m_group)]
    return torch.stack(planes, dim=1).reshape(groups * m_group, n)


def sparse_gemm_reference(a: torch.Tensor, values: torch.Tensor,
                          indices: torch.Tensor, *, n_keep: int,
                          m_group: int,
                          out_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """The plain version (the reference's `use_pallas=False` branch): the
    dense weight in f32 by the one-hot scatter, A in f32 zero-padded to the
    group-padded K, one f32 product, cast to `out_dtype or a.dtype`."""
    w = scatter_dense(values.float(), indices, n_keep, m_group)
    a_f = a.float()
    if w.shape[0] != a.shape[1]:
        a_f = F.pad(a_f, (0, w.shape[0] - a.shape[1]))
    return (a_f @ w).to(out_dtype or a.dtype)


def _check(a, values, indices, n_keep, m_group, tile) -> None:
    if a.dim() != 2 or values.dim() != 2:
        raise ValueError(f"sparse_gemm takes 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(values.shape)}")
    if not 1 <= n_keep < m_group <= 128:
        raise ValueError(f"need 1 <= N < M <= 128, got {n_keep}:{m_group}")
    if values.shape != indices.shape:
        raise ValueError(f"values {tuple(values.shape)} / indices "
                         f"{tuple(indices.shape)} mismatch")
    m, k = a.shape
    k_c, n = values.shape
    if k_c % n_keep or -(-k // m_group) != k_c // n_keep:
        raise ValueError(f"compressed K {k_c} does not match dense K {k} at "
                         f"{n_keep}:{m_group}")
    if min(m, k, n) < 1:
        raise ValueError(f"sparse_gemm of an empty operand {tuple(a.shape)} "
                         f"@ {tuple(values.shape)}")
    if values.dtype == torch.int8:
        raise NotImplementedError(
            "int8 values (sparse x int8 storage) are not ported yet "
            "(ROADMAP.md queue 1 item 2)")
    if a.dtype != values.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"sparse_gemm takes bf16 or f32 activations and "
                        f"values of the same dtype, got {a.dtype} and "
                        f"{values.dtype}")
    if indices.dtype != torch.int8:
        raise TypeError(f"indices must be int8, got {indices.dtype}")
    if not (a.device == values.device == indices.device):
        raise ValueError(f"operands on {a.device}, {values.device} and "
                         f"{indices.device}")
    if not (a.is_contiguous() and values.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError("sparse_gemm takes contiguous row-major operands")
    if tile not in TILES:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the "
                         f"kernel's menu {TILES}")
    if smem_bytes(*tile, a.element_size()) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs more than the {SMEM_LIMIT} "
                         f"bytes of shared memory a block may use")
    if -(-m // tile[0]) > _GRID_LIMIT:
        raise ValueError(f"M = {m} at bm = {tile[0]} exceeds the grid limit "
                         f"{_GRID_LIMIT}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sparse_gemm")
    lib.sparse_gemm_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.sparse_gemm_launch.restype = ctypes.c_int
    return lib


def sparse_gemm(a: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                *, n_keep: int, m_group: int,
                tile: tuple[int, int, int] = TILES[-1],
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) float @ N:M-compressed (K_c, N) storage -> (M, N) in
    `out_dtype or a.dtype`, through the kernel with CTA tile `tile`.

    CUDA operands launch the kernel on the current stream; CPU operands
    get `sparse_gemm_reference`.  Raises on anything the kernel does not
    take, and when the launch fails (there is no fallback)."""
    global launches
    tile = tuple(tile)
    _check(a, values, indices, n_keep, m_group, tile)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sparse_gemm_reference(a, values, indices, n_keep=n_keep,
                                     m_group=m_group, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sparse_gemm runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    m, k = a.shape
    k_c, n = values.shape
    # the kernel writes its operand dtype or the f32 accumulator
    direct = out_dtype == a.dtype
    out = torch.empty((m, n), dtype=a.dtype if direct else torch.float32,
                      device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.sparse_gemm_launch(
            _DTYPE_CODE[a.dtype], *tile, a.data_ptr(), values.data_ptr(),
            indices.data_ptr(), out.data_ptr(), int(not direct), m, n, k, k_c,
            n_keep, m_group, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_gemm {n_keep}:{m_group} {tile} launch "
                           f"failed: CUDA error {err}")
    launches += 1
    return out if direct else out.to(out_dtype)

