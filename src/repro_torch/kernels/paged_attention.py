"""Paged-attention decode on Hopper: wrapper, launch counter and plain
version.

The serving plane's paged layout stores attention KV in a pool
`(P, page, KV, D)` shared by all slots; each slot's logical rows live at
the physical pages named by its block-table row `(n_bt,) int32` (-1 =
unallocated).  `paged_attention` computes what
`repro.kernels.paged_attention.paged_attention_tpu` computes — one
decode query per slot attending its first `kv_len` logical rows —
through the CUDA kernel in `csrc/paged_attention.cu`.

  paged_attention_reference  gather + the masked softmax of
                             `models.layers.cached_attention` (the same
                             einsums and masking), so paged and
                             contiguous greedy decode agree.  Unlike the
                             JAX reference, a slot with `kv_len == 0`
                             returns exact zeros, as both kernels do.
  paged_attention            the wrapper: on CUDA tensors it launches
                             the kernel (or raises); on CPU tensors it
                             returns the plain version.  `launches`
                             counts kernel launches and nothing else.

Unallocated table entries clamp to page 0; every position of such a page
that lies at or past `kv_len` masks to an exact 0, so stale or foreign
rows never reach the output.

int8 pools (the KV codec of `quant.kv_quantize`) come with their per-row
scale pools `k_scale`/`v_scale` (P, page, KV) f32, addressed through the
same block table.  The rows are read raw and the scales folded in where
the reference folds them: scores times the row's k scale before masking,
the softmax weights times the row's v scale after normalising by the
plain softmax denominator.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: rows of K and V one block stages per step (whole pages, at least one)
_CHUNK_ROWS = 64
#: shared memory a block may use on an H100 (227 KB, NVIDIA data sheet)
_SMEM_LIMIT = 232_448

#: kernel launches since the last reset (the CPU path never counts).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              kv_len: torch.Tensor,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """q (B, 1, H, D); k/v pools (P, page, KV, D); block_tables (B, n_bt)
    int32 (-1 = hole); kv_len (B,); for int8 pools the scale pools
    k_scale/v_scale (P, page, KV).  Returns o (B, 1, H, D) before `wo`.

    The gather reproduces each slot's logical rows [0, n_bt * page) in
    order; then the math is `cached_attention`'s: rows at positions >=
    kv_len score NEG_INF and their softmax weight is an exact 0."""
    b, sq, h, d = q.shape
    kv = k_pages.shape[2]
    g = h // kv
    n_pool = k_pages.shape[0]
    safe = block_tables.clamp(0, n_pool - 1).long()          # (B, n_bt)
    n_bt, page = block_tables.shape[1], k_pages.shape[1]
    s_rows = n_bt * page
    k = k_pages[safe].reshape(b, s_rows, kv, d)
    v = v_pages[safe].reshape(b, s_rows, kv, d)
    row = lambda sc: (sc[safe].reshape(b, s_rows, kv).float()
                      .transpose(1, 2)[:, :, None, None, :])
    qg = (q.reshape(b, sq, kv, g, d) / math.sqrt(d)).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if k_scale is not None:
        s = s * row(k_scale)
    srange = torch.arange(s_rows, device=q.device)
    valid = (srange[None, :] < kv_len[:, None])[:, None, :]     # (B, 1, S)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p_attn = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p_attn = p_attn * row(v_scale)
    o = torch.einsum("bkgqs,bskd->bqkgd", p_attn, v.float())
    o = o.reshape(b, sq, h, d)
    # a fully masked slot: exact zeros (the kernels' m == NEG_INF guard)
    o = o.masked_fill((kv_len == 0).view(b, 1, 1, 1), 0.0)
    return o.to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, kv_len, k_scale=None,
           v_scale=None) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools must be (P, page, KV, D) alike, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    n_pool, page, kv, d2 = k_pages.shape
    if d2 != d or h % kv or min(n_pool, page) < 1:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (B={b}, n_bt), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be (B={b},), got {tuple(kv_len.shape)}")
    if block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("block_tables and kv_len must be int32")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    quantized = k_scale is not None
    pools = torch.int8 if quantized else q.dtype
    if not (q.dtype in _DTYPE_CODE and k_pages.dtype == v_pages.dtype == pools):
        raise TypeError(f"paged_attention takes a bf16 or f32 q over pools of "
                        f"its dtype, or over int8 pools with their scale "
                        f"pools; got q {q.dtype}, pools {k_pages.dtype}, "
                        f"{v_pages.dtype}, scales "
                        f"{'given' if quantized else 'absent'}")
    tensors = [q, k_pages, v_pages, block_tables, kv_len]
    if quantized:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.shape != k_pages.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be f32 {tuple(k_pages.shape[:3])}"
                                 f" (P, page, KV), got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
        tensors += [k_scale, v_scale]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, pools, scales, block_tables and kv_len on "
                         "different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous tensors")


def smem_bytes(g: int, d: int, page: int, pool_itemsize: int,
               quantized: bool = False) -> int:
    """Shared memory one block uses: q, acc (G, D) f32; scores (G, R)
    f32; m, l, corr (G,) f32; for int8 pools the k and v scales of the R
    staged rows, f32; then the K rows (R, D + pad) and the V rows (R, D)
    of the pool's dtype, each region 16-byte aligned (the layout of
    csrc/paged_attention.cu; pad is one 16-byte vector, or one element
    where D takes no vector loads)."""
    rows = chunk_pages(page) * page
    vec = 16 // pool_itemsize if d % (16 // pool_itemsize) == 0 else 1
    pad = vec if vec > 1 else 1
    align = lambda n: -(-n // 16) * 16
    floats = 2 * g * d + g * rows + 3 * g + (2 * rows if quantized else 0)
    return (align(floats * 4) + align(rows * (d + pad) * pool_itemsize)
            + rows * d * pool_itemsize)


def chunk_pages(page: int) -> int:
    """Pages a block stages per step: whole pages up to _CHUNK_ROWS rows."""
    return max(1, _CHUNK_ROWS // page)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    kv_len: torch.Tensor, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """Decode attention through the block table: the kernel on CUDA
    tensors, `paged_attention_reference` on CPU tensors.  int8 pools
    take their scale pools `k_scale`/`v_scale` (P, page, KV) f32.
    Raises on anything the kernel does not take."""
    global launches
    _check(q, k_pages, v_pages, block_tables, kv_len, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         kv_len, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    b, _, h, d = q.shape
    n_pool, page, kv, _ = k_pages.shape
    g = h // kv
    quantized = k_scale is not None
    smem = smem_bytes(g, d, page, k_pages.element_size(), quantized)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention needs {smem} bytes of shared "
                         f"memory (G={g}, D={d}, page={page}); the card "
                         f"gives a block {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    lib = _library()
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized
              else (None, None))
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            _DTYPE_CODE[q.dtype], int(quantized), q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b,
            kv, g, d, n_pool, page, block_tables.shape[1], chunk_pages(page),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    launches += 1
    return out
