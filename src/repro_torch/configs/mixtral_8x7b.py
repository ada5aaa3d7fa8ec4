"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  SWA => long_500k runs (ring KV cache).  The
per-expert GEMMs carry token counts that vary with routing — exactly the
irregular-GEMM population the ReDas mapper targets."""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    kind="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    layer_pattern=("local",),   # SWA on every layer
    window=4096,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2),
    rope_theta=1e6,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="mixtral-8x7b-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=128,
    layer_pattern=("local",),
    window=16,
    head_dim=16,
    moe=MoEConfig(n_experts=4, top_k=2),
    sub_quadratic=True,
)
