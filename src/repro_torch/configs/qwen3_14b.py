"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk-norm + GQA [hf:Qwen/Qwen3-8B].  Pure full attention
=> long_500k skipped."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    kind="decoder",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=128,
    qk_norm=True,
    head_dim=16,
)
