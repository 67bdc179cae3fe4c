"""Grouped-query attention of the port: prefill and one-token decode.

Mirrors ``repro.models.attention`` for full causal attention:

* prefill: :func:`multihead_attention` goes through ``kernels/flash_attention``;
* decode: :func:`decode_stats_scores` (masked fp32 scores, plain torch as in
  the JAX package, where it sits outside the kernel) -> row max ->
  ``kernels/decode_stats`` (exp, row sums, P.V) -> ``o / l``.

Query heads are grouped over KV heads (G = H / KV); softmax is in fp32.
"""
from __future__ import annotations

import torch

from ..kernels.decode_stats import ops as stats_ops
from ..kernels.flash_attention import ops as flash_ops

NEG_INF = -2.0 ** 30  # large-negative mask value, as in the JAX package


# Full-sequence attention, q (B,S,H,D) and k/v (B,T,KV,D) -> (B,S,H,D): the
# JAX package's ``multihead_attention``, here the kernel's wrapper itself.
multihead_attention = flash_ops.flash_attention


def _mask_bcast(mask: torch.Tensor) -> torch.Tensor:
    """Broadcast a slot mask over (B,KV,G,L) scores: an (L,) mask for a
    scalar position, a (B,L) mask for per-row (B,) positions."""
    return mask[None, None, None] if mask.ndim == 1 else mask[:, None, None, :]


def decode_stats_scores(q, k_cache, pos, *, window=0, chunk=0, cap=0.0):
    """Masked fp32 scores of one-token decode: q (B,1,H,D) against the cache
    k (B,L,KV,D). ``pos`` is the query's absolute position, a 0-d tensor
    (lockstep batch) or (B,) (continuous batching, one per row). Returns
    ``(s, mask)``: s (B,KV,G,L) with masked slots at NEG_INF, mask (L,) or
    (B,L)."""
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache).float() * (D ** -0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    p_ = pos[:, None] if pos.ndim == 1 else pos
    j = torch.arange(L, device=k_cache.device)
    mask = j <= p_
    if window:
        mask &= (p_ - j) < window
    if chunk:
        mask &= (j // chunk) == (p_ // chunk)
    return torch.where(_mask_bcast(mask), s, NEG_INF), mask


def decode_attention(q, k_cache, v_cache, pos, *, window=0, chunk=0,
                     cap=0.0):
    """One-token decode: q (B,1,H,D) vs cache (B,L,KV,D) whose slot ``pos``
    already holds the query token's own key and value (so l > 0)."""
    s, _ = decode_stats_scores(q, k_cache, pos, window=window, chunk=chunk,
                               cap=cap)
    m = torch.amax(s, dim=-1)                         # (B,KV,G)
    o, l = stats_ops.accumulate(s, m, v_cache)
    return (o / l[..., None]).to(v_cache.dtype)


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """Write the decode token's (B,1,KV,D) key or value at slot ``pos``.

    Updates ``cache`` in place (the JAX package returns a new array from a
    vmapped ``dynamic_update_slice``). The slot is clamped to the last one,
    as ``dynamic_update_slice`` clamps its start index, so rows that hold no
    request and keep stepping never index past the cache.
    """
    slot = pos.clamp(max=cache.shape[1] - 1)
    if pos.ndim == 1:                                 # per-row positions
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot] = new[:, 0].to(cache.dtype)
    else:
        cache[:, slot] = new[:, 0].to(cache.dtype)
