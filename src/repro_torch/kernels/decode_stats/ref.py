"""Plain PyTorch versions of one-token decode attention's two kernels: the
masked scores with their row max (the oracle of ``csrc/decode_scores.cu``)
and the accumulation (of ``csrc/decode_stats.cu``), P.V summed in fp32
whatever the cache dtype."""
import torch

NEG_INF = -2.0 ** 30


def _mask_bcast(mask: torch.Tensor) -> torch.Tensor:
    """Broadcast a slot mask over (B,KV,G,L) scores: an (L,) mask for a
    scalar position, a (B,L) mask for per-row (B,) positions."""
    return mask[None, None, None] if mask.ndim == 1 else mask[:, None, None, :]


def masked_scores_ref(q, k_cache, pos, *, slot_offset=0, total_len=None,
                      window=0, chunk=0, cap=0.0, ring=False):
    """Masked fp32 scores of one-token decode: q (B,1,H,D) against the cache
    k (B,L,KV,D), which holds the global slots [slot_offset, slot_offset +
    L) of a ``total_len``-slot cache (a cache shard; an offset of 0 and a
    total of L, or None, for a whole cache). ``pos`` is the query's
    absolute position, a 0-d tensor (lockstep batch) or (B,) (continuous
    batching, one per row). With ``ring`` the cache is a ring of
    ``total_len`` slots: global slot j holds token t_j = pos - ((pos - j)
    mod total_len), kept when t_j >= 0 and the window and chunk tests pass
    on t_j, the JAX package's ``decode_stats_scores``. Returns ``(s,
    mask)``: s (B,KV,G,L) with masked slots at NEG_INF, mask (L,) or
    (B,L)."""
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache).float() * (D ** -0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    p_ = pos[:, None] if pos.ndim == 1 else pos
    j = slot_offset + torch.arange(L, device=k_cache.device)
    T = total_len or L
    t = p_ - ((p_ - j) % T) if ring else j   # slot j's token
    mask = t >= 0 if ring else j <= p_
    if window:
        mask &= (p_ - t) < window
    if chunk:
        mask &= (t // chunk) == (p_ // chunk)
    return torch.where(_mask_bcast(mask), s, NEG_INF), mask


def decode_scores_ref(q, k_cache, pos, *, slot_offset=0, total_len=None,
                      window=0, chunk=0, cap=0.0, ring=False):
    """:func:`masked_scores_ref`'s s (B,KV,G,L) and its row max m (B,KV,G),
    both fp32 (NEG_INF where the cache shard keeps no slot)."""
    s, _ = masked_scores_ref(q, k_cache, pos, slot_offset=slot_offset,
                             total_len=total_len, window=window, chunk=chunk,
                             cap=cap, ring=ring)
    return s, torch.amax(s, dim=-1)


def decode_stats_accumulate_ref(s, m, v_cache):
    """s (B,KV,G,L) NEG_INF-masked fp32 scores, m (B,KV,G) fp32 row max,
    v (B,L,KV,D) -> (o (B,1,H,D) fp32, l (B,1,H) fp32), H = KV*G."""
    B, KV, G, _ = s.shape
    D = v_cache.shape[-1]
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, KV * G, D), l.reshape(B, 1, KV * G)
