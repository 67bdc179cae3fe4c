"""Plain PyTorch attention (exact masked softmax): the oracle of
``csrc/flash_attention.cu``."""
import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal=True, window=0, chunk=0, cap=0.0):
    """q (B,S,H,D), k/v (B,T,KV,D) with H % KV == 0; returns (B,S,H,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D).float()
    s = torch.einsum("bikgd,bjkd->bkgij", qg, k.float()) * (D ** -0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    if chunk:
        mask &= (qp // chunk) == (kp // chunk)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
