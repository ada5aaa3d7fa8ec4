"""Flash attention on Hopper: wrapper, route, launch counters and plain
version.

`flash_attention` computes what
`repro.kernels.flash_attention.flash_attention_tpu` computes: softmax
attention of q (B, H, Sq, D) over k/v (B, H, Sk, D) (GQA heads expanded
by the caller), with the causal and sliding-window masks taken from
absolute positions, masked scores at the finite `NEG_INF = -1e30` and
the denominator clamped at 1e-30, at any head dim D — through the CUDA
kernels in `csrc/flash_attention.cu`.

Two routes, decided before the launch by `flash_route` from dtype, D and
the base addresses alone (`shape_route` is what a planner, which sees no
pointers, plans for):

  wgmma  bf16 with D % 8 == 0, D <= 256 and 16-byte-aligned q, k, v
         (TMA's rules): `flash_wgmma_kernel`, a CTA of WGMMA_ROWS query
         rows, K and V through a ring of KV_STAGES stages of
         `WGMMA_TILES[padded_dim(D)]` keys, the products on wgmma; P is
         rounded to bf16 before P V, the one departure from the
         reference's f32 arithmetic (held at row rel-L2 <= 1e-2).
  sync   everything else (f32, D % 8 != 0, D > 256, a misaligned base):
         `flash_sync_kernel`, f32 FFMA; a block owns bq query rows and
         walks the keys bk at a time, V's columns in passes of the
         least of SYNC_WIDTHS that holds D (of the widest past it).

A call that fails raises; no other route is tried.

  flash_attention_reference  the online-softmax math of the TPU kernel's
                             body over the same KV blocks, in f32.
  flash_attention            the wrapper: on CUDA tensors it launches the
                             route's kernel (or raises); on CPU tensors it
                             returns the plain version.  `launches`
                             counts kernel launches on both routes and
                             nothing else, `wgmma_launches` those on the
                             wgmma route.

As in the JAX package, no model code calls it: it sits behind
`Engine.attention`, and the model's prefill keeps the plain chunked scan
of `models.layers.flash_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .redas_gemm import SMEM_LIMIT

NEG_INF = -1e30

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: the wgmma route's padded head dims and the keys a ring stage holds at
#: each (`FLASH_WGMMA_TILES` in csrc/flash_attention.cu)
WGMMA_TILES = {64: 128, 128: 128, 256: 64}
#: query rows a CTA of the wgmma route (two consumer warpgroups), and its
#: K/V ring stages (`kWgRows`, `kKvStages`)
WGMMA_ROWS = 128
KV_STAGES = 2
#: the sync route's output widths, columns of V a pass
#: (`FLASH_SYNC_WIDTHS`), its query rows a sub-tile and keys a step
#: (`kQT`, `kKT`: its default blocks), and the head-dim columns of q and k
#: it stages at once (`kKC`)
SYNC_WIDTHS = (32, 64, 128)
SYNC_ROWS = SYNC_KEYS = 64
SYNC_CHUNK = 128

#: kernel launches on both routes, and those on the wgmma route, since the
#: last reset (the CPU path and the plain version never count)
launches = 0
wgmma_launches = 0


def reset_launches() -> None:
    global launches, wgmma_launches
    launches = wgmma_launches = 0


def padded_dim(d: int) -> int | None:
    """The wgmma route's padded head dim for D: the least of WGMMA_TILES
    that holds it (None past the widest)."""
    return next((dp for dp in sorted(WGMMA_TILES) if d <= dp), None)


def shape_route(itemsize: int, d: int) -> str:
    """The route a call of this element size and head dim takes when its
    bases are 16-byte aligned (what a planner, which sees no pointers,
    plans for): "wgmma" for bf16 with D % 8 == 0 (TMA's 16-byte row
    stride) and D <= 256, else "sync"."""
    return ("wgmma" if itemsize == 2 and d % 8 == 0
            and padded_dim(d) is not None else "sync")


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of a call on these operands: `shape_route`, and "sync"
    as well when a base of q, k or v is not 16-byte aligned (TMA's address
    rule).  A pure function of dtype, shape and pointers."""
    route = shape_route(q.element_size(), q.shape[-1])
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        return "sync"
    return route


def route_tile(route: str, d: int) -> tuple[int, int]:
    """(query rows a CTA, keys a step) of a route at head dim D: the wgmma
    route's fixed tile, or the sync route's default blocks."""
    if route == "wgmma":
        return WGMMA_ROWS, WGMMA_TILES[padded_dim(d)]
    return SYNC_ROWS, SYNC_KEYS


def wgmma_smem_bytes(dp: int) -> int:
    """Shared memory of one wgmma CTA at padded head dim `dp` (the
    `FlashSmem` struct of csrc/flash_attention.cu): 1 KB to align, Q,
    KV_STAGES stages of K and V, and 1 + 4 x KV_STAGES mbarriers."""
    bk = WGMMA_TILES[dp]
    return (1024 + dp * WGMMA_ROWS * 2 + KV_STAGES * 2 * dp * bk * 2
            + 8 * (1 + 4 * KV_STAGES))


def sync_smem_bytes(dv: int) -> int:
    """Shared memory of one sync block at pass width `dv`
    (`sync_smem_bytes` of csrc/flash_attention.cu): Q and K chunks of
    SYNC_CHUNK columns (rows padded by one), V's pass and P, in f32."""
    return 4 * (SYNC_ROWS * (SYNC_CHUNK + 1) + SYNC_KEYS * (SYNC_CHUNK + 1)
                + SYNC_KEYS * dv + SYNC_ROWS * (SYNC_KEYS + 1))


def _legal_block(seq: int, want: int) -> int:
    """Largest divisor of `seq` that is <= want (the port's copy of the
    JAX package's rule; engine decisions are hints).  When no usable
    divisor exists near the hint, span the sequence with one block — but
    only while that block stays small; beyond that, fail with intent."""
    b = min(want, seq)
    while seq % b:
        b -= 1
    if b >= 8 or b == seq:
        return b
    if seq <= 2048:  # one block spans the seq
        return seq
    raise ValueError(
        f"no usable attention block for seq={seq} (largest divisor <= "
        f"{want} is {b}); pad the sequence to a multiple of 8")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              bk: int | None = None) -> torch.Tensor:
    """The TPU kernel's online softmax, every query row at once, over KV
    blocks of `bk` keys (the whole Sk when None).  A row whose keys are
    all masked averages v, as the TPU kernel's finite NEG_INF makes it."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = bk or sk
    qf = q.float() * (1.0 / math.sqrt(d))
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / l_run.clamp_min(1e-30)[..., None]).to(q.dtype)


def _check(q, k, v, bq: int | None, bk: int | None) -> tuple[str, int, int]:
    """The route and (bq, bk) of a call; raises on what no route takes."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, H, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (expand GQA heads first)")
    if min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError("flash_attention of an empty operand")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPE_CODE):
        raise TypeError(f"flash_attention takes bf16 or f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    route = flash_route(q, k, v)
    tile = route_tile(route, q.shape[3])
    bq = tile[0] if bq is None else bq
    bk = tile[1] if bk is None else bk
    if bq < 1 or bk < 1:
        raise ValueError(f"blocks must be >= 1, got bq={bq}, bk={bk}")
    if route == "wgmma" and (bq, bk) != tile:
        raise ValueError(f"the wgmma route runs its own tile {tile} at head "
                         f"dim {q.shape[3]}, not blocks ({bq}, {bk})")
    return route, bq, bk


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_wgmma_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.flash_wgmma_launch.restype = ctypes.c_int
    lib.flash_sync_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.flash_sync_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    bq: int | None = None,
                    bk: int | None = None) -> torch.Tensor:
    """Attention on the route `flash_route(q, k, v)` takes: the kernel on
    CUDA tensors, `flash_attention_reference` (over KV blocks of bk) on
    CPU tensors.  (bq, bk) default to `route_tile`; on the wgmma route
    they must be its tile, on the sync route any blocks >= 1 (a block owns
    bq query rows and walks the keys bk at a time; neither needs to divide
    the sequence: ragged edges are masked).  The result does not depend
    on the blocks beyond the order of f32 sums."""
    global launches, wgmma_launches
    route, bq, bk = _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.flash_wgmma_launch(
                d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, sq, sk, int(causal), int(window), stream)
        else:
            err = lib.flash_sync_launch(
                _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b * h, sq, sk, bq, bk,
                int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} launch failed: CUDA "
                           f"error {err}")
    launches += 1
    if route == "wgmma":
        wgmma_launches += 1
    return out
