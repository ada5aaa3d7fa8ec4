"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407].
Pure full attention => long_500k skipped.  The 123B scale is the
dry-run's FSDP + grad-accumulation stress case."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    kind="decoder",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="mistral-large-123b-smoke",
    kind="decoder",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv=2,
    d_ff=160,
    vocab=128,
    head_dim=16,
)
