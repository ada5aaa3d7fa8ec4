"""The N:M structured-sparse GEMM on Hopper: wrapper, launch counters and
plain versions (the port of `repro/kernels/sparse_gemm.py`).

`sparse_gemm` computes what `repro.kernels.sparse_gemm.sparse_gemm`
computes — (M, K) float @ N:M-compressed (K_c, N) values and int8
in-group offsets -> f32 accumulation, times an optional per-column f32
`scale` after the whole K sum, cast to `out_dtype or a.dtype` — through
the CUDA kernels in `csrc/sparse_gemm.cu`.  The values are of A's dtype
(float storage) or int8 (sparse x int8 storage, `sparsify(...,
quantize=True)`, with its scale): the int8-value variant converts each
value to float exactly, so the kernel's arithmetic is the float one.  The
caller names one of two paths (the engine plans it,
`engine/cost.py::decide_sparse`):

- "decode" (M <= `DECODE_ROWS[-1]`): no dense tile; each kept value adds
  its product into registers (the one-hot sum of `_scatter_dense`), the
  groups split over `split_k` blocks (`split_groups`) whose f32 partials
  a second kernel sums in split order (and scales, `split_reduce`);
- "tiled": one block per (bm, bn) output tile, each chunk scattered back
  to a dense shared-memory tile and multiplied, OS, the next chunk's
  loads in flight meanwhile; `tile` must be one of `TILES`, and bk is the
  chunk's dense capacity, which holds `bk // m_group` whole groups.

`n_keep` and `m_group` are runtime arguments: every spec
`sparse.parse_sparsity` admits runs on both paths.  The reference's entry
point zero-pads A to the group-padded K and every dim to its blocks
(`sparse_gemm.py:199-217`); the kernels read those out-of-range operands
as zero instead, so nothing is padded or sliced here.

On a CUDA tensor `sparse_gemm` launches the path's kernels (or raises;
there is no fallback from one path to the other); on a CPU tensor it
returns the plain version `sparse_gemm_reference`, the reference's
`use_pallas=False` branch: the one-hot scatter, then one f32 product.
`launches` counts float-value sparse GEMMs launched, one per call
whatever the path (`path_launches` splits them by path), and
`int8_launches` / `int8_path_launches` the int8-value ones apart;
`reduce_launches` counts the split-K reduction's launches (either
variant's).

`diff_sparse_gemm` is the differentiable entry (the reference's
`_diff_sparse_gemm` and `_diff_sparse_gemm_q`, `sparse_gemm.py:246`,
`:290`): over float values the activations get the dense cotangent and
the values the dense weight cotangent gathered at the kept positions
(pruned positions get exactly zero); over int8 values the activations
only; the indices never.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .redas_gemm import SMEM_LIMIT
from .ref import wants_grad

#: the tiled path's CTA tiles (bm, bk, bn); `SPARSE_TILES` in
#: csrc/sparse_gemm.cu is the same list.  bk = 128 holds at least one
#: group of the widest spec (M <= 128).
TILES = ((16, 128, 64), (32, 128, 128), (64, 128, 128), (128, 128, 128))
#: the decode path's row buckets (M <= bucket); `SPARSE_DECODE_ROWS` in
#: csrc/sparse_gemm.cu is the same list
DECODE_ROWS = (4, 8, 16)
PATHS = ("decode", "tiled")
#: bytes of values one decode lane loads a compressed row, by value
#: itemsize: a 16-byte vector of float values, 8 int8 values (so that int8
#: keeps bf16's 8 columns a lane); `DecRow` in csrc/sparse_gemm.cu
DECODE_LANE_BYTES = {1: 8, 2: 16, 4: 16}

#: gridDim.y: the most splits the decode path takes, and of M / bm
#: blocks on the tiled path
SPLIT_LIMIT = 65535

_PAD = 8          # shared-memory row padding of the float tiles, elements
_WARPS = 4        # 128 threads a block
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

#: sparse GEMMs launched since the last reset, in all and by path, with
#: float values and with int8 values apart, and the split-K reduction's
#: launches (the CPU path and the plain versions never count).
launches = 0
path_launches = dict.fromkeys(PATHS, 0)
int8_launches = 0
int8_path_launches = dict.fromkeys(PATHS, 0)
reduce_launches = 0


def reset_launches() -> None:
    global launches, int8_launches, reduce_launches
    launches = int8_launches = reduce_launches = 0
    for path in PATHS:
        path_launches[path] = int8_path_launches[path] = 0


def smem_bytes(bm: int, bk: int, bn: int, in_bytes: int,
               rows: int | None = None, stages: int = 1,
               value_bytes: int | None = None) -> int:
    """Shared memory one tiled block of tile (bm, bk, bn) uses: the dense
    weight tile (at A's width `in_bytes`) and the per-warp f32 epilogue
    tile, then `stages` stages of the padded activation tile and `rows`
    compressed rows of values (at `value_bytes`, A's width by default;
    float rows padded, int8 rows not) and int8 indices (the `SparseSmem`
    struct of the CUDA source).  A chunk holds `(bk // m_group) * n_keep`
    compressed rows, fewer than bk, the default."""
    rows = bk if rows is None else rows
    value_bytes = value_bytes or in_bytes
    ldv = bn + (_PAD if value_bytes > 1 else 0)
    stage = (bm * (bk + _PAD) * in_bytes + rows * ldv * value_bytes
             + rows * bn)
    return bk * (bn + _PAD) * in_bytes + _WARPS * 256 * 4 + stages * stage


def tiled_stages(tile, in_bytes: int, n_keep: int, m_group: int,
                 value_bytes: int | None = None) -> int:
    """2 (the next chunk loads while this one is multiplied) where two
    stages of the spec's chunk fit a block's shared memory, else 1."""
    bm, bk, bn = tile
    rows = bk // m_group * n_keep
    return 2 if smem_bytes(bm, bk, bn, in_bytes, rows, 2,
                           value_bytes) <= SMEM_LIMIT else 1


def decode_columns(value_bytes: int) -> int:
    """Output columns of one decode block: 32 lanes x the values of
    `DECODE_LANE_BYTES[value_bytes]` bytes each."""
    return 32 * DECODE_LANE_BYTES[value_bytes] // value_bytes


def decode_rows(m: int) -> int:
    """The decode row bucket the kernel runs an (m, K) activation at."""
    for rows in DECODE_ROWS:
        if m <= rows:
            return rows
    raise ValueError(f"M = {m} is above the decode path's largest row "
                     f"bucket {DECODE_ROWS[-1]}")


def max_split(k: int, m_group: int) -> int:
    """The most splits that each take a group at dense K `k` (the kernel
    takes up to `SPLIT_LIMIT`; splits past the groups are empty and add
    zero partials)."""
    return min(-(-k // m_group), SPLIT_LIMIT)


def split_groups(groups: int, split_k: int) -> tuple[int, int]:
    """(base, extra): split s takes base + (s < extra) groups from
    s * base + min(s, extra), so every group is taken exactly once and
    the splits differ by at most one group (splits past the groups take
    none).  The wrapper hands both to the kernel."""
    if groups < 1 or not 1 <= split_k <= SPLIT_LIMIT:
        raise ValueError(f"need groups >= 1 and split_k in 1..{SPLIT_LIMIT}, "
                         f"got {groups} and {split_k}")
    return groups // split_k, groups % split_k


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
                          indices: torch.Tensor,
                          scale: torch.Tensor | None = None, *, n_keep: int,
                          m_group: int,
                          out_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """The plain version (the reference's `use_pallas=False` branch): the
    dense weight in f32 by the one-hot scatter of the f32 values (int8
    ones converted), A in f32 zero-padded to the group-padded K, one f32
    product, times `scale` per column if given, cast to `out_dtype or
    a.dtype`."""
    w = scatter_dense(values.float(), indices, n_keep, m_group)
    a_f = a.float()
    if w.shape[0] != a.shape[1]:
        a_f = F.pad(a_f, (0, w.shape[0] - a.shape[1]))
    acc = a_f @ w
    if scale is not None:
        acc = acc * scale.reshape(1, -1)
    return acc.to(out_dtype or a.dtype)


def split_reduce_reference(ws: torch.Tensor, out_dtype: torch.dtype,
                           scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The split-K reduction's plain version: the (split_k, M, N) f32
    partials summed in split order from zero, as the kernel sums them,
    times `scale` per column if given, cast to `out_dtype`."""
    total = torch.zeros_like(ws[0])
    for part in ws:
        total = total + part
    if scale is not None:
        total = total * scale.reshape(1, -1)
    return total.to(out_dtype)


def _check_scale(scale, n: int, device) -> None:
    if scale is None:
        return
    if scale.dtype != torch.float32 or tuple(scale.shape) not in ((1, n),
                                                                  (n,)):
        raise TypeError(f"scale must be f32 of shape (1, {n}) or ({n},), "
                        f"got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous on {device}, got "
                         f"{scale.device}")


def _check(a, values, indices, scale, n_keep, m_group, path, tile,
           split_k) -> None:
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
    if a.dtype not in _DTYPE_CODE or values.dtype not in (a.dtype,
                                                          torch.int8):
        raise TypeError(f"sparse_gemm takes bf16 or f32 activations and "
                        f"values of the same dtype or int8, got {a.dtype} "
                        f"and {values.dtype}")
    if indices.dtype != torch.int8:
        raise TypeError(f"indices must be int8, got {indices.dtype}")
    if not (a.device == values.device == indices.device):
        raise ValueError(f"operands on {a.device}, {values.device} and "
                         f"{indices.device}")
    if not (a.is_contiguous() and values.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError("sparse_gemm takes contiguous row-major operands")
    _check_scale(scale, n, a.device)
    if path not in PATHS:
        raise ValueError(f"path {path!r} is not one of the kernel's {PATHS}")
    if path == "decode":
        if tile is not None:
            raise ValueError(f"the decode path takes no tile, got {tile}")
        if m > DECODE_ROWS[-1]:
            raise ValueError(f"M = {m} is above the decode path's largest "
                             f"row bucket {DECODE_ROWS[-1]}")
        if type(split_k) is not int or not 1 <= split_k <= SPLIT_LIMIT:
            raise ValueError(f"split_k must be an int in 1..{SPLIT_LIMIT}, "
                             f"got {split_k!r}")
        return
    if split_k != 1:
        raise ValueError(f"the tiled path takes split_k 1, got {split_k!r}")
    if tile not in TILES:
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the "
                         f"kernel's menu {TILES}")
    if smem_bytes(*tile, a.element_size(),
                  value_bytes=values.element_size()) > SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs more than the {SMEM_LIMIT} "
                         f"bytes of shared memory a block may use")
    if -(-m // tile[0]) > SPLIT_LIMIT:
        raise ValueError(f"M = {m} at bm = {tile[0]} exceeds the grid limit "
                         f"{SPLIT_LIMIT}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sparse_gemm")
    lib.sparse_gemm_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    lib.sparse_decode_launch.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
        + [ctypes.c_void_p])
    lib.sparse_reduce_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    for fn in (lib.sparse_gemm_launch, lib.sparse_decode_launch,
               lib.sparse_reduce_launch):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def split_reduce(ws: torch.Tensor, out_dtype: torch.dtype,
                 scale: torch.Tensor | None = None) -> torch.Tensor:
    """(split_k, M, N) f32 partials -> (M, N) in `out_dtype` (bf16 or
    f32): their sum in split order from zero, times `scale` ((1, N) or
    (N,) f32) per column if given, through the decode path's second
    kernel on a CUDA tensor, `split_reduce_reference` on a CPU one."""
    global reduce_launches
    if ws.dim() != 3 or ws.dtype != torch.float32 or not ws.is_contiguous():
        raise ValueError(f"split_reduce takes contiguous (split_k, M, N) f32 "
                         f"partials, got {ws.dtype} {tuple(ws.shape)}")
    if ws.shape[0] < 2 or ws[0].numel() < 1:
        raise ValueError(f"split_reduce needs 2 or more non-empty partials, "
                         f"got {tuple(ws.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"split_reduce writes bf16 or f32, not {out_dtype}")
    split_k, m, n = ws.shape
    _check_scale(scale, n, ws.device)
    if ws.device.type == "cpu":
        return split_reduce_reference(ws, out_dtype, scale)
    out = torch.empty((m, n), dtype=out_dtype, device=ws.device)
    with torch.cuda.device(ws.device):
        _raise_on(_library().sparse_reduce_launch(
            _DTYPE_CODE[out_dtype], ws.data_ptr(), _ptr(scale),
            out.data_ptr(), int(out_dtype == torch.float32), m * n, n,
            split_k, torch.cuda.current_stream().cuda_stream),
            f"sparse_gemm reduction of {split_k} partials")
    reduce_launches += 1
    return out


def sparse_gemm(a: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                scale: torch.Tensor | None = None, *, n_keep: int,
                m_group: int, path: str = "tiled",
                tile: tuple[int, int, int] | None = None, split_k: int = 1,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) float @ N:M-compressed (K_c, N) storage (values of A's dtype
    or int8), times the per-column f32 `scale` if given, -> (M, N) in
    `out_dtype or a.dtype`, on the kernel path `path`: "tiled" at CTA
    tile `tile` (the menu's largest if None), or "decode" with the groups
    split over `split_k` blocks (M <= `DECODE_ROWS[-1]`, no tile).

    CUDA operands launch the path's kernels on the current stream; CPU
    operands get `sparse_gemm_reference`.  Raises on anything the kernels
    do not take, and when a launch fails (there is no fallback)."""
    global launches, int8_launches
    if path == "tiled" and tile is None:
        tile = TILES[-1]
    tile = None if tile is None else tuple(tile)
    _check(a, values, indices, scale, n_keep, m_group, path, tile, split_k)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return sparse_gemm_reference(a, values, indices, scale,
                                     n_keep=n_keep, m_group=m_group,
                                     out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sparse_gemm runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    m, k = a.shape
    k_c, n = values.shape
    # the kernels write their operand dtype or the f32 accumulator
    direct = out_dtype == a.dtype
    written = a.dtype if direct else torch.float32
    out = torch.empty((split_k, m, n) if split_k > 1 else (m, n),
                      dtype=torch.float32 if split_k > 1 else written,
                      device=a.device)
    lib, code = _library(), _DTYPE_CODE[a.dtype]
    int8 = values.dtype == torch.int8
    what = f"sparse_gemm {n_keep}:{m_group} {path}"
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tiled":
            stages = tiled_stages(tile, a.element_size(), n_keep, m_group,
                                  values.element_size())
            _raise_on(lib.sparse_gemm_launch(
                code, int(int8), *tile, a.data_ptr(), values.data_ptr(),
                indices.data_ptr(), _ptr(scale), out.data_ptr(),
                int(not direct), m, n, k, k_c, n_keep, m_group, stages,
                stream), f"{what} {tile}")
        else:
            base, extra = split_groups(k_c // n_keep, split_k)
            # with splits, the reduction applies the scale after the sum
            _raise_on(lib.sparse_decode_launch(
                code, int(int8), decode_rows(m), a.data_ptr(),
                values.data_ptr(), indices.data_ptr(),
                _ptr(scale if split_k == 1 else None), out.data_ptr(),
                int(not direct), m, n, k, k_c, n_keep, m_group, split_k,
                base, extra, stream), f"{what} split_k {split_k}")
    if int8:
        int8_launches += 1
        int8_path_launches[path] += 1
    else:
        launches += 1
        path_launches[path] += 1
    if split_k > 1:                     # out holds the f32 partials
        out = split_reduce(out, written, scale)
    return out if direct else out.to(out_dtype)


# --------------------------------------------------------------------------
# Dispatch-layer VJPs: masked weight cotangents
# --------------------------------------------------------------------------


class DiffSparseGemm(torch.autograd.Function):
    """The sparse GEMM's VJP over float values (the reference's
    `_diff_sparse_gemm`): dA = g @ densify(W)^T in A's dtype; dV = the
    dense dW = A^T @ g (f32), zero-padded to the group-padded K and
    gathered at the kept positions, in the values' dtype; none to the
    indices.  Both products on `bwd(a, b, out_dtype)`, the float GEMM the
    caller passes."""

    @staticmethod
    def forward(ctx, a, values, indices, run, bwd, n_keep: int,
                m_group: int):
        ctx.save_for_backward(a, values, indices)
        ctx.bwd, ctx.spec = bwd, (n_keep, m_group)
        return run(a, values, indices)

    @staticmethod
    def backward(ctx, g):
        a, values, indices = ctx.saved_tensors
        n_keep, m_group = ctx.spec
        k = a.shape[1]
        k_c, n = values.shape
        groups = k_c // n_keep
        k_store = groups * m_group
        g = g.to(a.dtype).contiguous()
        da = dv = None
        if ctx.needs_input_grad[0]:
            w = scatter_dense(values.float(), indices, n_keep,
                              m_group).to(a.dtype)
            da = ctx.bwd(g, w[:k].T.contiguous(), a.dtype)
        if ctx.needs_input_grad[1]:
            dw = ctx.bwd(a.T.contiguous(), g, torch.float32)
            if k_store != k:
                dw = F.pad(dw, (0, 0, 0, k_store - k))
            dv = dw.reshape(groups, m_group, n).gather(
                1, indices.reshape(groups, n_keep, n).long())
            dv = dv.reshape(k_c, n).to(values.dtype)
        return da, dv, None, None, None, None, None


class DiffSparseGemmQ(torch.autograd.Function):
    """The sparse x int8 GEMM's VJP (the reference's
    `_diff_sparse_gemm_q`): the activations' cotangent only, dA = g @
    (densify(W) * scale)^T in A's dtype, on `bwd` as `DiffSparseGemm`'s."""

    @staticmethod
    def forward(ctx, a, values, indices, scale, run, bwd, n_keep: int,
                m_group: int):
        ctx.save_for_backward(values, indices, scale)
        ctx.bwd, ctx.spec = bwd, (n_keep, m_group, a.dtype, a.shape[1])
        return run(a, values, indices)

    @staticmethod
    def backward(ctx, g):
        values, indices, scale = ctx.saved_tensors
        n_keep, m_group, dtype, k = ctx.spec
        w = (scatter_dense(values.float(), indices, n_keep, m_group)
             * scale.reshape(1, -1)).to(dtype)
        da = ctx.bwd(g.to(dtype).contiguous(), w[:k].T.contiguous(), dtype)
        return da, None, None, None, None, None, None, None


def diff_sparse_gemm(a, values, indices, scale=None, *, n_keep: int,
                     m_group: int, bwd, use_kernel: bool = True,
                     out_dtype=None, **kernel_args):
    """`sparse_gemm` (`use_kernel`) or `sparse_gemm_reference`, through
    `DiffSparseGemm` (float values) or `DiffSparseGemmQ` (int8 values and
    their scale) where a gradient is wanted; `bwd(a, b, out_dtype)` is the
    float GEMM of their backward."""
    def run(a, values, indices):
        if use_kernel:
            return sparse_gemm(a, values, indices, scale, n_keep=n_keep,
                               m_group=m_group, out_dtype=out_dtype,
                               **kernel_args)
        return sparse_gemm_reference(a, values, indices, scale,
                                     n_keep=n_keep, m_group=m_group,
                                     out_dtype=out_dtype)
    if scale is not None:
        if wants_grad(a):
            return DiffSparseGemmQ.apply(a, values, indices, scale, run, bwd,
                                         n_keep, m_group)
    elif wants_grad(a, values):
        return DiffSparseGemm.apply(a, values, indices, run, bwd, n_keep,
                                    m_group)
    return run(a, values, indices)
