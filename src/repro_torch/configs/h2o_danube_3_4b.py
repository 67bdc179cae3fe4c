"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L, d_model=3840, 32H (kv=8), d_ff=10240, vocab=32000, window=4096.
[arXiv:2401.16818]. All layers windowed → O(window) decode state →
long_500k runs.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    window=4096,
    attn_pattern=("window",),
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = reduced(CONFIG)
