"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias [arXiv:2407.10671]."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    kind="decoder",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    head_dim=128,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=128,
    qkv_bias=True,
    head_dim=16,
)
