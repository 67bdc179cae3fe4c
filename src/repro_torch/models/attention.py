"""Grouped-query attention of the port: prefill and one-token decode.

Mirrors ``repro.models.attention`` for full causal attention, the dense
variants' sliding-window layers and llama4's chunked-local ones, with an
optional tanh softcap:

* prefill: :func:`multihead_attention` goes through ``kernels/flash_attention``
  (causal, window, chunk, softcap);
* decode: ``kernels/decode_stats``, two kernels: the masked fp32 scores and
  their row max, reading the K cache in place (the JAX package computes
  them outside any kernel, ``decode_stats_scores``), then exp, row sums and
  P.V -> ``o / l``. A window or chunked layer's cache is a ring
  (``ring=True``) of L = min(cache_len, window or chunk) slots, token t at
  slot t % L, as the JAX package keeps it (``ring_cache_len``); a
  chunked ring keeps the current chunk's tokens, the slots [0, pos mod
  chunk]; a sequence-parallel rank holds a shard of it (``slot_offset``,
  ``total_len`` = L).

Query heads are grouped over KV heads (G = H / KV); softmax is in fp32.
"""
from __future__ import annotations

import torch

from ..kernels.decode_stats import ops as stats_ops
from ..kernels.flash_attention import ops as flash_ops

NEG_INF = stats_ops.NEG_INF  # large-negative mask value, as in the JAX package


# Full-sequence attention, q (B,S,H,D) and k/v (B,T,KV,D) -> (B,S,H,D): the
# JAX package's ``multihead_attention``, here the kernel's wrapper itself.
multihead_attention = flash_ops.flash_attention


def decode_stats_scores(q, k_cache, pos, *, slot_offset=0, total_len=None,
                        window=0, chunk=0, cap=0.0, ring=False):
    """Masked fp32 scores of one-token decode, ``(s, mask)``: the JAX
    package's ``decode_stats_scores`` in plain torch (the decode path itself
    runs the scores kernel, which returns the row max in place of the mask).

    q (B,1,H,D) against k (B,L_loc,KV,D) holding the global slots
    [slot_offset, slot_offset + L_loc) of a ``total_len``-slot cache
    (None: L_loc, a whole cache); a ring (``ring``) of ``total_len``
    slots, or a shard of one (``check_ring``), takes each slot's token
    modulo ``total_len``."""
    L_loc = k_cache.shape[1]
    if total_len is not None and slot_offset + L_loc > total_len:
        raise ValueError(f"a shard of {L_loc} slots at offset {slot_offset} "
                         f"exceeds the {total_len}-slot cache")
    if ring:
        stats_ops.check_ring("decode_stats_scores", L_loc, window, chunk,
                             slot_offset, total_len)
    return stats_ops.masked_scores_ref(q, k_cache, pos,
                                       slot_offset=slot_offset,
                                       total_len=total_len, window=window,
                                       chunk=chunk, cap=cap, ring=ring)


def decode_attention(q, k_cache, v_cache, pos, *, window=0, chunk=0,
                     cap=0.0, ring=False):
    """One-token decode: q (B,1,H,D) vs cache (B,L,KV,D) whose slot ``pos``
    (``pos % L`` on a ring) already holds the query token's own key and
    value (so l > 0)."""
    mask = dict(window=window, chunk=chunk, ring=ring)
    s, m = stats_ops.decode_scores(q, k_cache, pos, cap=cap, **mask)
    o, l = stats_ops.accumulate(s, m, v_cache, pos=pos, **mask)
    return (o / l[..., None]).to(v_cache.dtype)


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                *, slot_offset: int | None = None,
                total_len: int | None = None, ring: bool = False) -> None:
    """Write the decode token's (B,1,KV,D) key or value at slot ``pos``
    (``pos % L`` on a ring cache of L slots).

    Updates ``cache`` in place (the JAX package returns a new array from a
    vmapped ``dynamic_update_slice``), with tensor ops only, so that a CUDA
    graph captures it. The slot is clamped to the last one, as
    ``dynamic_update_slice`` clamps its start index, so rows that hold no
    request and keep stepping never index past the cache.

    With ``slot_offset`` the cache is a sequence-parallel shard holding the
    global slots [slot_offset, slot_offset + L) and ``pos`` one 0-d
    position: the shard writes only when it owns the global slot ``pos``
    (``pos % total_len`` on a ring of ``total_len`` slots) and is left as
    it was otherwise (the JAX region's ``owns`` mask), decided on the
    device, with no host synchronisation.
    """
    if slot_offset is not None:
        if pos.ndim:
            raise ValueError("a cache shard is written at one 0-d position")
        if ring and total_len is None:
            raise ValueError("a ring shard is written with its ring's "
                             "total_len")
        local = (pos % total_len if ring else pos) - slot_offset
        owns = (local >= 0) & (local < cache.shape[1])
        slot = local.clamp(0, cache.shape[1] - 1)
        cache[:, slot] = torch.where(owns, new[:, 0].to(cache.dtype),
                                     cache[:, slot])
        return
    slot = pos % cache.shape[1] if ring else pos.clamp(max=cache.shape[1] - 1)
    if pos.ndim == 1:                                 # per-row positions
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot] = new[:, 0].to(cache.dtype)
    else:
        cache[:, slot] = new[:, 0].to(cache.dtype)
