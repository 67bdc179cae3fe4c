"""yi-6b [dense] — llama-arch GQA, kv=4.

32L, d_model=4096, 32H (kv=4), d_ff=11008, vocab=64000, rope 5M.
[arXiv:2403.04652; hf]. long_500k skipped (full attention).
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5000000.0,
    tie_embeddings=False,
)

SMOKE = reduced(CONFIG)
