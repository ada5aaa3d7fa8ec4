"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 [arXiv:2404.16821].

The InternViT vision frontend is a stub: the model takes 256
precomputed patch embeddings (B, 256, 896), prepended to the text
tokens.  The LM backbone is the published config."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    kind="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    prefix_tokens=256,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="internvl2-1b-smoke",
    kind="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=128,
    head_dim=16,
    prefix_tokens=8,
)
