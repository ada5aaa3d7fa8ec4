"""Architecture configuration schema (the port's own copy of
`repro/models/config.py`).

One dataclass describes every family (dense, MoE, SSM, hybrid,
encoder-only, VLM); per-arch modules in `repro_torch.configs`
instantiate it.  `layer_pattern` is the repeating block-kind period,
e.g.:

    ("attn",)                      homogeneous decoder (qwen2, mistral, ...)
    ("local",) * 5 + ("attn",)     gemma3's 5:1 local:global
    ("rglru", "rglru", "local")    recurrentgemma's 1:2 attn:RG-LRU
    ("ssm",)                       mamba2
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Kind = Literal["decoder", "encoder", "vlm"]
BlockKind = Literal["attn", "local", "ssm", "rglru"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # dispatch: "einsum" (GShard one-hot dispatch, plain tensor ops) or
    # "sort" (argsort + scatter/gather; the expert matmuls go through the
    # engine's grouped GEMM)
    impl: str = "einsum"

    def capacity(self, seq: int) -> int:
        """Per-expert buffer slots for a length-`seq` dispatch:
        ceil(seq * top_k * cf / E), padded to a multiple of 4, at least 4."""
        c = math.ceil(seq * self.top_k * self.capacity_factor
                      / self.n_experts)
        return max(4 * ((c + 3) // 4), 4)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    kind: Kind
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free archs
    n_kv: int
    d_ff: int
    vocab: int
    layer_pattern: tuple[BlockKind, ...] = ("attn",)
    head_dim: int = 0     # 0 -> d_model // n_heads
    window: int = 0       # sliding-window size for "local" blocks / SWA
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru_width: int = 0  # 0 -> d_model
    gated_mlp: bool = True        # SwiGLU; False -> GELU (encoder archs)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_inputs: bool = False    # audio: whole input is frame embeddings
    prefix_tokens: int = 0        # vlm: image patch embeds prepended
    # cast the norm output to the compute dtype before the scale multiply
    # (the full-sequence `forward` path reads it; prefill and decode use
    # the default of `layers.rms_norm`, as in the JAX package)
    norm_cast_early: bool = True
    sub_quadratic: bool = False
    max_seq: int = 131072

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_causal(self) -> bool:
        return self.kind != "encoder"
