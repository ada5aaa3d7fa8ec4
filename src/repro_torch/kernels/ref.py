"""Plain PyTorch oracles for the kernels package (the port of
`repro/kernels/ref.py`)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 accumulation — the GEMM oracle."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
