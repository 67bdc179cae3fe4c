"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

48L, d_model=1536, ssm_state=128, headdim=64 (→ 48 SSD heads at expand=2),
vocab=50280. [arXiv:2405.21060]. O(1) decode state: a (H, N, P) fp32 state
and a (W-1, channels) conv window per layer and row.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # attention-free; SSD heads derive from ssm dims
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = reduced(CONFIG)
