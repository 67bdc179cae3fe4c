"""llama3.2-3b [dense] — small llama3; pure full attention.

28L, d_model=3072, 24H (kv=8), d_ff=8192, vocab=128256, rope 500k.
[hf:meta-llama/Llama-3.2-3B].
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = reduced(CONFIG)
