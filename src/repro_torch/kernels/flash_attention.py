"""Flash attention on Hopper: wrapper, launch counter and plain version.

`flash_attention` computes what
`repro.kernels.flash_attention.flash_attention_tpu` computes: softmax
attention of q (B, H, Sq, D) over k/v (B, H, Sk, D) (GQA heads expanded
by the caller), with the causal and sliding-window masks taken from
absolute positions, masked scores at the finite `NEG_INF = -1e30` and
the denominator clamped at 1e-30 — through the CUDA kernel in
`csrc/flash_attention.cu`.

  flash_attention_reference  the online-softmax math of the TPU kernel's
                             body over the same KV blocks, in f32.
  flash_attention            the wrapper: on CUDA tensors it launches the
                             kernel (or raises); on CPU tensors it
                             returns the plain version.  `launches`
                             counts kernel launches and nothing else.

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

NEG_INF = -1e30

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: head dims the kernel is compiled for (`FLASH_HEAD_DIMS` in the source)
HEAD_DIMS = (32, 64, 128)

#: kernel launches since the last reset (the CPU path never counts).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def _check(q, k, v, bq: int, bk: int) -> None:
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
    if bq < 1 or bk < 1:
        raise ValueError(f"blocks must be >= 1, got bq={bq}, bk={bk}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int,
                    bk: int) -> torch.Tensor:
    """Attention with the kernel's (bq, bk) blocks: the kernel on CUDA
    tensors, `flash_attention_reference` on CPU tensors.  A block of
    the kernel owns `bq` query rows and walks the keys `bk` at a time;
    neither needs to divide the sequence (ragged edges are masked)."""
    global launches
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is compiled for head dims {HEAD_DIMS}, "
                         f"not {d}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b * h, sq, sk, bq, bk, int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
