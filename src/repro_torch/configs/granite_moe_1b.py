"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].  The d_ff=512 expert GEMMs
are the skinny shapes ReDas targets."""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    kind="decoder",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8),
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=32,
    vocab=128,
    head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=4),
)
