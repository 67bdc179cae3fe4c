"""Plain PyTorch decode-stat accumulation: the oracle of
``csrc/decode_stats.cu``, with P.V summed in fp32 whatever the cache dtype."""
import torch

NEG_INF = -2.0 ** 30


def decode_stats_accumulate_ref(s, m, v_cache):
    """s (B,KV,G,L) NEG_INF-masked fp32 scores, m (B,KV,G) fp32 row max,
    v (B,L,KV,D) -> (o (B,1,H,D) fp32, l (B,1,H) fp32), H = KV*G."""
    B, KV, G, _ = s.shape
    D = v_cache.shape[-1]
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, KV * G, D), l.reshape(B, 1, KV * G)
