"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, iRoPE.

48L, d_model=5120, 40H (kv=8), expert d_ff=8192, vocab=202048.
iRoPE: chunked-local attention (8192) on 3 of every 4 layers; every 4th
layer is global attention with NO rope (NoPE). Sigmoid router, top-1.
qk-norm (RMSNorm over the head dim) on q and k before RoPE. Text-only
LM shapes (the early-fusion vision input is not part of the model).
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500000.0,
    chunk=8192,
    attn_pattern=("chunked",),
    nope_every=4,
    n_experts=16,
    top_k=1,
    d_expert=8192,
    n_shared_experts=1,
    d_shared_expert=8192,
    router_act="sigmoid",
    router_norm_topk=False,
    qk_norm=True,
    tie_embeddings=False,
)

SMOKE = reduced(CONFIG)
