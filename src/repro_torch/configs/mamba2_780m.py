"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD / state-space duality [arXiv:2405.21060].
Attention-free: decode carries an O(1) state per layer; the in/out
projections and the LM head are plain matmuls, as in the JAX package."""

from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    kind="decoder",
    n_layers=48,
    d_model=1536,
    n_heads=0,            # attention-free
    n_kv=0,
    d_ff=0,
    vocab=50280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, chunk=256),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=128,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1, chunk=16),
    sub_quadratic=True,
)
