"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].  long_500k RUNS: decode is dominated by the
1024-window local layers; the 8 global layers are O(L) per token."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    kind="decoder",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv=8,
    d_ff=15360,
    vocab=262144,
    layer_pattern=("local",) * 5 + ("attn",),
    window=1024,
    head_dim=240,
    rope_theta=1e6,
    sub_quadratic=True,      # 5:1 local => long_500k viable
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke",
    kind="decoder",
    n_layers=6,              # one full (5 local + 1 global) period
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=128,
    layer_pattern=("local",) * 5 + ("attn",),
    window=16,
    head_dim=16,
    sub_quadratic=True,
)
