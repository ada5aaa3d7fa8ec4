"""hubert-xlarge [audio]: 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as wav2vec2 [arXiv:2106.07447].

The convolutional waveform frontend is a stub: the model takes
precomputed frame embeddings (B, S, 1280), and the transformer backbone
classifies each frame over the 504-entry codebook.  Encoder-only: no
decode step."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    kind="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    vocab=504,
    gated_mlp=False,          # GELU FFN
    embed_inputs=True,        # stub frontend: frame embeddings in
    layer_pattern=("attn",),
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke",
    kind="encoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=59,
    gated_mlp=False,
    embed_inputs=True,
    layer_pattern=("attn",),
)
