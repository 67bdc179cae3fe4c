"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L, d_model=2048, 16H (kv=16), expert d_ff=1408, vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]. The 60 routed experts are padded to 64 for
EP=16 divisibility (4 never-routed experts; capacity unaffected —
DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    n_experts=64,                 # 60 routed + 4 padding experts
    top_k=4,
    d_expert=1408,
    n_shared_experts=4,
    d_shared_expert=5632,         # 4 × 1408 always-on shared FFN
    router_norm_topk=True,
    tie_embeddings=False,
)

SMOKE = reduced(CONFIG)
