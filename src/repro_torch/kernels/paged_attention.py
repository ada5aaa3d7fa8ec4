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

On the card each (slot, KV head) is a thread-block cluster of
`splits_for(B, KV, n_bt)` blocks that split the slot's live pages and
combine their partial softmax states through distributed shared memory
(csrc/paged_attention.cu); `splits=` forces the cluster size, for tests
and measurements only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: shared memory a block may use on an H100 (227 KB, NVIDIA data sheet)
_SMEM_LIMIT = 232_448
#: the H100's SMs, which `splits_for` fills
SMS = 132
#: the largest portable thread-block cluster
MAX_SPLITS = 8
#: the kernel's ring stages (at most), the K and V bytes a stage holds
#: (whole pages, at least one) and its threads (csrc/paged_attention.cu)
STAGES, STAGE_BYTES, THREADS = 4, 16384, 256
#: a lane holds 8 elements of the head dim, a row at most a warp of lanes
MAX_HEAD_DIM = 256

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
    """q (B, Sq, H, D); k/v pools (P, page, KV, D); block_tables (B, n_bt)
    int32 (-1 = hole); kv_len (B,), or (B, Sq) a length per query (the
    W-wide speculative verify); for int8 pools the scale pools
    k_scale/v_scale (P, page, KV).  Returns o (B, Sq, H, D) before `wo`.

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
    if kv_len.dim() == 1:
        valid = (srange[None, :] < kv_len[:, None])[:, None, :]  # (B, 1, S)
    else:  # a length per query (B, Sq)
        valid = srange[None, None, :] < kv_len[:, :, None]       # (B, Sq, S)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p_attn = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p_attn = p_attn * row(v_scale)
    o = torch.einsum("bkgqs,bskd->bqkgd", p_attn, v.float())
    o = o.reshape(b, sq, h, d)
    # a fully masked slot: exact zeros (the kernels' m == NEG_INF guard)
    o = o.masked_fill((kv_len == 0).view(b, -1, 1, 1), 0.0)
    return o.to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, kv_len, k_scale=None,
           v_scale=None, splits=None) -> None:
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
    if splits is not None and not (type(splits) is int
                                   and 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"splits must be an int in 1..{MAX_SPLITS}, got "
                         f"{splits!r}")


@functools.cache
def splits_for(b: int, kv: int, n_bt: int) -> int:
    """The cluster size C, from the shapes alone: the least power of two
    whose B x KV x C blocks fill the SMS once, at most MAX_SPLITS and
    n_bt; 8 for qwen2-1.5b's decode (B 8, KV 2), 4 at 8 slots over 8 KV
    heads (granite's, qwen3-14b's and gemma3-12b's decode: there C = 4
    is the fastest of 1, 2, 4 and 8, or within 1.07x of it, on an
    NVIDIA H100 80GB HBM3, where C = 2 took up to 1.29x)."""
    want = -(-SMS // max(1, b * kv))
    c = 1 << (want - 1).bit_length()
    while c > 1 and c > min(MAX_SPLITS, n_bt):
        c //= 2
    return c


def heads_per_group(g: int) -> int:
    """Query heads a row group of the kernel holds in registers, 2 to 4:
    the KV head's G heads split into ceil(G / HN) chunks with the fewest
    padded heads, then the fewest chunks (3 for qwen2-1.5b's G = 6, 2 for
    granite's G = 2)."""
    return min(range(2, 5), key=lambda hn: (-(-g // hn) * hn - g, -(-g // hn)))


def stage_pages(page: int, d: int, pool_itemsize: int,
                quantized: bool = False) -> int:
    """Whole pages a ring stage holds: up to STAGE_BYTES of K and V rows
    (and their scales for int8 pools), at least one page."""
    row = d * pool_itemsize + (4 if quantized else 0)
    return max(1, STAGE_BYTES // (2 * page * row))


def smem_bytes(g: int, d: int, page: int, pool_itemsize: int,
               quantized: bool = False, *, n_bt: int) -> int:
    """Shared memory one block uses (the layout of
    csrc/paged_attention.cu), every piece 16-byte aligned: the block's
    partial (m, l, acc) for the KV head's G heads, f32; the slot's
    block-table row, int32; then the ring of STAGES stages (fewer, at
    least two, where they would not fit), each the K and V rows of
    `stage_pages` pages and, for int8 pools, their k and v scales (f32);
    after the walk the ring's bytes hold the warps' partials."""
    hn, warps = heads_per_group(g), THREADS // 32
    rows = stage_pages(page, d, pool_itemsize, quantized) * page
    align = lambda n: -(-n // 16) * 16
    stage = (2 * align(rows * d * pool_itemsize)
             + (2 * align(rows * 4) if quantized else 0))
    red = warps * hn * (d + 2) * 4
    total = lambda stages: (align(g * (d + 2) * 4) + align(n_bt * 4)
                            + max(stages * stage, red))
    stages = STAGES
    while stages > 2 and total(stages) > _SMEM_LIMIT:
        stages -= 1
    return total(stages)


@functools.cache
def _geometry(g, d, page, n_bt, pool_itemsize, quantized) -> int:
    """`stage_pages` of a shape the kernel takes, worked out once per
    shape (the wrapper runs on a host-bound decode tick); raises on a
    shape it does not take."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention takes a head dim of at most "
                         f"{MAX_HEAD_DIM}, got {d}")
    if -(-g // heads_per_group(g)) > THREADS // 32:
        raise ValueError(f"paged_attention takes at most {4 * THREADS // 32}"
                         f" query heads a KV head, got {g}")
    smem = smem_bytes(g, d, page, pool_itemsize, quantized, n_bt=n_bt)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention needs {smem} bytes of shared "
                         f"memory (G={g}, D={d}, page={page}, n_bt={n_bt}); "
                         f"the card gives a block {_SMEM_LIMIT}")
    return stage_pages(page, d, pool_itemsize, quantized)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    args = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
            + [ctypes.c_void_p])
    lib.paged_attention_launch.argtypes = args
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_max_active_clusters.argtypes = (
        args + [ctypes.POINTER(ctypes.c_int)])
    lib.paged_attention_max_active_clusters.restype = ctypes.c_int
    return lib


def _launch_args(q, k_pages, v_pages, block_tables, kv_len, k_scale,
                 v_scale, splits, out) -> tuple:
    """The C entry's arguments after `_check`; raises on what the kernel
    does not take."""
    b, _, h, d = q.shape
    n_pool, page, kv, _ = k_pages.shape
    g, n_bt = h // kv, block_tables.shape[1]
    quantized = k_scale is not None
    ppc = _geometry(g, d, page, n_bt, k_pages.element_size(), quantized)
    if splits is None:
        splits = splits_for(b, kv, n_bt)
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized
              else (None, None))
    return (_DTYPE_CODE[q.dtype], int(quantized), q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b,
            kv, g, d, n_pool, page, n_bt, ppc, splits,
            torch.cuda.current_stream(q.device).cuda_stream)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    kv_len: torch.Tensor, k_scale=None, v_scale=None,
                    splits: int | None = None) -> torch.Tensor:
    """Decode attention through the block table: the kernel on CUDA
    tensors, `paged_attention_reference` on CPU tensors.  int8 pools
    take their scale pools `k_scale`/`v_scale` (P, page, KV) f32.
    `splits` forces the cluster size (1..MAX_SPLITS; default
    `splits_for`).  Raises on anything the kernel does not take."""
    global launches
    _check(q, k_pages, v_pages, block_tables, kv_len, k_scale, v_scale,
           splits)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         kv_len, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    out = torch.empty_like(q)
    args = _launch_args(q, k_pages, v_pages, block_tables, kv_len, k_scale,
                        v_scale, splits, out)
    with torch.cuda.device(q.device):
        err = _library().paged_attention_launch(*args)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    launches += 1
    return out


def max_active_clusters(q, k_pages, v_pages, block_tables, kv_len,
                        k_scale=None, v_scale=None,
                        splits: int | None = None) -> int:
    """How many of the kernel's clusters the card holds at once
    (`cudaOccupancyMaxActiveClusters`) for a call with these arguments;
    launches nothing."""
    _check(q, k_pages, v_pages, block_tables, kv_len, k_scale, v_scale,
           splits)
    if q.device.type != "cuda":
        raise ValueError("max_active_clusters asks the card: CUDA tensors")
    clusters = ctypes.c_int(0)
    args = _launch_args(q, k_pages, v_pages, block_tables, kv_len, k_scale,
                        v_scale, splits, q)
    with torch.cuda.device(q.device):
        err = _library().paged_attention_max_active_clusters(
            *args, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err}")
    return clusters.value
