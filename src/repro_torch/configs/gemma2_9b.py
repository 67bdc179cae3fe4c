"""gemma2-9b [dense] — alternating local(4096)/global attention, softcaps.

42L, d_model=3584, 16H (kv=8), d_ff=14336, vocab=256000, head_dim=256,
GeGLU, sandwich norms, attn softcap 50, final softcap 30, scaled embeds.
[arXiv:2408.00118; hf]. Global layers are full attention → long_500k
skipped (DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    window=4096,
    attn_pattern=("window", "full"),
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    mlp_act="gelu",
    scale_embed=True,
    tie_embeddings=True,
)

SMOKE = reduced(CONFIG)
