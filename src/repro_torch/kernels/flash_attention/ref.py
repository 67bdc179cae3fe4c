"""Plain PyTorch attention (exact masked softmax) and its backward: the
oracles of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``."""
import torch

NEG_INF = -2.0 ** 30


def visible(S, T, *, causal, window, chunk, device):
    """(S, T) bool: the keys each query may see (the kernels' masks)."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    if chunk:
        mask &= (qp // chunk) == (kp // chunk)
    return mask


def _scores(q, k, cap):
    """fp32 scaled (and capped) scores (B, KV, G, S, T) of q grouped over
    the kv heads (head h = kv * G + g)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D).float()
    s = torch.einsum("bikgd,bjkd->bkgij", qg, k.float()) * (D ** -0.5)
    return cap * torch.tanh(s / cap) if cap else s


def attention_ref(q, k, v, *, causal=True, window=0, chunk=0, cap=0.0):
    """q (B,S,H,D), k/v (B,T,KV,D) with H % KV == 0; returns (B,S,H,D)."""
    B, S, H, D = q.shape
    mask = visible(S, k.shape[1], causal=causal, window=window, chunk=chunk,
                   device=q.device)
    s = torch.where(mask, _scores(q, k, cap), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def attention_lse_ref(q, k, v, *, causal=True, window=0, chunk=0, cap=0.0):
    """(o, lse): :func:`attention_ref` and the rows' natural log-sum-exp of
    the visible scaled scores, (B, H, S) fp32, +inf for a row with no
    visible key (the forward kernel's ``lse`` output)."""
    B, S, H, _ = q.shape
    mask = visible(S, k.shape[1], causal=causal, window=window, chunk=chunk,
                   device=q.device)
    s = torch.where(mask, _scores(q, k, cap), -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isneginf(lse), torch.inf, lse)
    return (attention_ref(q, k, v, causal=causal, window=window, chunk=chunk,
                          cap=cap), lse.reshape(B, H, S))


def attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=0,
                      chunk=0, cap=0.0):
    """(dq, dk, dv) in the inputs' dtypes, in fp32 from P = exp(c - lse),
    c the scaled scores s (capped, c = cap tanh(s / cap), with ``cap``):
    dV = P^T dO, dS = P (dO v^T - rowsum(dO o)) (times 1 - (c / cap)^2
    with a cap), dQ = scale dS k, dK = scale dS^T q; a masked pair has
    P = 0 (the backward kernels' math)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    mask = visible(S, T, causal=causal, window=window, chunk=chunk,
                   device=q.device)
    qg = q.reshape(B, S, KV, G, D).float()
    kf, vf = k.float(), v.float()
    c = _scores(q, k, cap)
    p = torch.where(mask, torch.exp(c - lse.reshape(B, KV, G, S, 1)), 0.0)
    dog = do.reshape(B, S, KV, G, D).float()
    dv = torch.einsum("bkgij,bikgd->bjkd", p, dog)
    dp = torch.einsum("bikgd,bjkd->bkgij", dog, vf)
    delta = (dog * o.reshape(B, S, KV, G, D).float()).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if cap:
        ds = ds * (1.0 - torch.square(c / cap))
    dq = torch.einsum("bkgij,bjkd->bikgd", ds, kf) * scale
    dk = torch.einsum("bkgij,bikgd->bjkd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
