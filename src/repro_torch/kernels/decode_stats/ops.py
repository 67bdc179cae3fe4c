"""Decode-stat accumulation: the CUDA kernel for CUDA tensors, the plain
version for CPU ones. ``LAUNCHES`` counts kernel launches; CPU calls leave
it alone."""
from __future__ import annotations

import torch

from .. import _build
from .ref import decode_stats_accumulate_ref

LAUNCHES = 0
GROUPS = (2, 3)      # query heads per kv head the kernel is built for


def accumulate(s: torch.Tensor, m: torch.Tensor, v_cache: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """s (B,KV,G,L) NEG_INF-masked fp32 scores, m (B,KV,G) fp32 row max,
    v_cache (B,L,KV,D) -> fp32 (o (B,1,H,D), l (B,1,H)), H = KV*G."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (s, m, v_cache)):
        return decode_stats_accumulate_ref(s, m, v_cache)
    if s.device.type != "cuda" or m.device != s.device \
            or v_cache.device != s.device:
        raise ValueError(f"decode_stats: s on {s.device}, m on {m.device}, "
                         f"v on {v_cache.device}; all must be on one CUDA "
                         "device")
    if s.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"decode_stats: s {tuple(s.shape)}, v "
                         f"{tuple(v_cache.shape)}")
    B, KV, G, L = s.shape
    D = v_cache.shape[-1]
    if m.shape != (B, KV, G) or v_cache.shape[:3] != (B, L, KV):
        raise ValueError(f"decode_stats: s {tuple(s.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v_cache.shape)}")
    if s.dtype != torch.float32 or m.dtype != torch.float32:
        raise TypeError("decode_stats: s and m must be float32")
    if G not in GROUPS:
        raise ValueError(f"decode_stats: {G} query heads per kv head; the "
                         f"kernel is built for {GROUPS}")
    code = _build.dtype_code(v_cache.dtype)
    groups = D // (16 // v_cache.element_size())
    if D % (16 // v_cache.element_size()) or groups & (groups - 1) \
            or not 1 <= groups <= 256:
        raise ValueError(f"decode_stats: head_dim {D} is not a power-of-two "
                         "number of 16-byte vectors")
    if not all(t.is_contiguous() for t in (s, m, v_cache)) \
            or v_cache.data_ptr() % 16:
        raise ValueError("decode_stats: s, m and v must be contiguous and v "
                         "16-byte aligned")
    o = torch.empty((B, 1, KV * G, D), dtype=torch.float32, device=s.device)
    l = torch.empty((B, 1, KV * G), dtype=torch.float32, device=s.device)
    if B == 0 or KV == 0:
        return o, l
    err = _build.lib().repro_decode_stats(
        s.data_ptr(), m.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        l.data_ptr(), B, KV, G, L, D, code, _build.stream_of(s))
    _build.check(err, "decode_stats")
    LAUNCHES += 1
    return o, l
