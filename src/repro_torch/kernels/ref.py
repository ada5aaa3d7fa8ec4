"""Plain PyTorch oracles for the kernels package (the port of
`repro/kernels/ref.py`)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 accumulation — the GEMM oracle."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def wants_grad(*tensors) -> bool:
    """True when autograd is recording and a tensor among `tensors` needs
    a gradient: the kernels' wrappers then run through their
    `torch.autograd.Function` (the reference's dispatch-layer custom VJPs),
    and otherwise call the kernel alone (serving runs under
    `torch.inference_mode`)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
