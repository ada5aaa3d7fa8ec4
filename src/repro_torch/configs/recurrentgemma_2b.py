"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427].  Pattern (rglru, rglru, local) x 8 + 2-layer tail;
window 2048."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    kind="decoder",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru_width=2560,
    head_dim=256,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-2b-smoke",
    kind="decoder",
    n_layers=5,           # 1 full period + (rglru, rglru) tail
    d_model=64,
    n_heads=2,
    n_kv=1,
    d_ff=128,
    vocab=128,
    layer_pattern=("rglru", "rglru", "local"),
    window=16,
    rglru_width=64,
    head_dim=32,
    sub_quadratic=True,
)
