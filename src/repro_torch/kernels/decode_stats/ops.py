"""One-token decode attention's two kernels: the masked scores with their
row max (``decode_scores``) and the accumulation (``accumulate``). Each runs
its CUDA kernel for CUDA tensors and its plain version for CPU ones.
``SCORES_LAUNCHES`` and ``LAUNCHES`` count the two kernels' launches,
``RING_SCORES_LAUNCHES`` and ``RING_LAUNCHES`` those of them over a ring
cache (a window or a chunked layer's); CPU calls leave them alone.

A ring cache (``ring=True``) is the cache of a sliding-window layer (T
slots, T <= the window) or of a chunked-local one (T <= the chunk), slot
pos % T written at position pos. A window ring keeps the slots [0, min(pos,
T - 1)]: every slot holds one of the last T tokens, all inside the window
once pos >= T - 1. A chunked ring keeps the slots [0, min(pos mod chunk,
T - 1)]: with T = chunk the current chunk's tokens fill the slots [0, pos
mod chunk] and the others hold the chunk before; with T < chunk the
positions never reach T. A shard of either holding the global slots [off,
off + L) (``slot_offset``, ``total_len`` = T: the ring split over ranks)
keeps the local slots [0, min(p' - off, L - 1)], p' = pos or pos mod chunk,
none where p' < off. The kernels compute that interval on the card, from
the position they read there, take it in slot order (the order of the JAX
package's einsum) and apply no window or chunk test to a slot index.

Both kernels split a row over a cluster of up to 8 blocks and reduce across
them through the cluster's shared memory: they need no scratch and no
state between calls.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .ref import (NEG_INF, decode_scores_ref,  # noqa: F401
                  decode_stats_accumulate_ref, masked_scores_ref)

LAUNCHES = 0          # accumulate kernel
SCORES_LAUNCHES = 0   # scores kernel
RING_LAUNCHES = 0         # of LAUNCHES, over a ring cache
RING_SCORES_LAUNCHES = 0  # of SCORES_LAUNCHES, over a ring cache
MAX_GROUPS = 8        # query heads per kv head the kernels are built for
MAX_HEAD_DIM = 256
MAX_SPLITS = 8        # blocks per row: the portable cluster size
BLOCKS_PER_SM = 2     # the grid's target (decode_sweep.py, PERF.md)


def check_heads(G: int, D: int) -> None:
    """Raise, naming G or D, unless the kernels take G query heads per kv
    head and head dim D."""
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"decode attention: G = {G} query heads per kv "
                         f"head; the kernels take 1 to {MAX_GROUPS}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"decode attention: head dim D = {D}; the kernels "
                         f"take a multiple of 8 up to {MAX_HEAD_DIM}")


def _check_cuda(name: str, named: dict[str, torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs); raises else."""
    ts = list(named.values())
    if all(t.device.type == "cpu" for t in ts):
        return True
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError(f"{name}: " + ", ".join(
            f"{k} on {t.device}" for k, t in named.items())
            + "; all must be on one CUDA device")
    return False


def check_ring(name: str, L: int, window: int, chunk: int,
               slot_offset: int, total_len: int | None = None) -> None:
    """Raise unless a ring cache shard of L slots is one the kernels take:
    the global slots [slot_offset, slot_offset + L) of a ring of
    ``total_len`` slots (None: L, a whole ring), a window layer's ring of
    at most ``window`` slots or a chunked layer's of at most ``chunk``
    (not both)."""
    T = L if total_len is None else total_len
    if slot_offset < 0 or slot_offset + L > T:
        raise ValueError(f"{name}: a ring shard of {L} slots at offset "
                         f"{slot_offset} exceeds the {T}-slot ring")
    if (window and chunk) or (window and T > window) or (chunk and T > chunk):
        raise ValueError(f"{name}: a ring of {T} slots with window {window} "
                         f"and chunk {chunk}; the kernels take a ring of at "
                         "most its window or its chunk, not both")


def _check_layout(name: str, named: dict[str, torch.Tensor],
                  aligned: tuple[str, ...]) -> None:
    for k, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} of shape {tuple(t.shape)} and "
                             f"strides {t.stride()} is not contiguous")
        if k in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} does not start on 16 bytes "
                             f"(address {t.data_ptr():#x})")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(rows: int, L: int, device) -> int:
    """Blocks per row (a cluster): BLOCKS_PER_SM per SM, at most
    MAX_SPLITS, and no more than L has 16-slot pieces."""
    want = -(-BLOCKS_PER_SM * _sms(device.index) // rows)
    return max(1, min(want, MAX_SPLITS, -(-L // 16)))


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, pos: torch.Tensor,
                  *, slot_offset: int = 0, total_len: int | None = None,
                  window: int = 0, chunk: int = 0, cap: float = 0.0,
                  ring: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B,1,H,D) against the cache k (B,L,KV,D), read in place, at
    ``pos`` (int64: 0-d, one position for every row, or (B,)) ->
    fp32 (s (B,KV,G,L) with masked slots at NEG_INF, m (B,KV,G) its row
    max, NEG_INF where no slot is kept), H = KV*G. ``k_cache`` holds the
    global slots [slot_offset, slot_offset + L) of a ``total_len``-slot
    cache (None: L from the offset on): a sequence-parallel cache shard.
    ``window``, ``chunk``, ``cap`` and ``ring`` as the JAX package's
    ``decode_stats_scores``."""
    global SCORES_LAUNCHES, RING_SCORES_LAUNCHES
    named = {"q": q, "k": k_cache, "pos": pos}
    if ring:
        check_ring("decode_scores", k_cache.shape[1], window, chunk,
                   slot_offset, total_len)
    if _check_cuda("decode_scores", named):
        return decode_scores_ref(q, k_cache, pos, slot_offset=slot_offset,
                                 total_len=total_len, window=window,
                                 chunk=chunk, cap=cap, ring=ring)
    if q.ndim != 4 or k_cache.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_scores: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}; want (B,1,H,D), (B,L,KV,D)")
    B, _, H, D = q.shape
    _, L, KV, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"decode_scores: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}")
    G = H // KV
    check_heads(G, D)
    if q.dtype != k_cache.dtype:
        raise TypeError(f"decode_scores: q is {q.dtype}, k is "
                        f"{k_cache.dtype}; they must match")
    code = _build.dtype_code(k_cache.dtype)
    if pos.dtype != torch.long or pos.shape not in ((), (B,)):
        raise ValueError(f"decode_scores: pos {pos.dtype} {tuple(pos.shape)}; "
                         f"want int64, 0-d or ({B},)")
    _check_layout("decode_scores", named, ("q", "k"))
    if window < 0 or chunk < 0 or cap < 0 or slot_offset < 0:
        raise ValueError(f"decode_scores: window {window}, chunk {chunk}, "
                         f"cap {cap} and slot_offset {slot_offset} must not "
                         "be negative")
    s = torch.empty((B, KV, G, L), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    rows = B * KV
    if L == 0:
        raise ValueError("decode_scores: the cache has L = 0 slots")
    if rows == 0:
        return s, m
    if rows > 65535:
        raise ValueError(f"decode_scores: B*KV = {rows} rows; the grid takes "
                         "65,535")
    nsplit = _splits(rows, L, q.device)
    err = _build.lib().repro_decode_scores(
        q.data_ptr(), k_cache.data_ptr(), pos.data_ptr(), int(pos.ndim == 1),
        int(slot_offset), s.data_ptr(), m.data_ptr(), B, KV, G, L, D, nsplit,
        float(D ** -0.5), int(window), int(chunk), int(bool(ring)),
        float(cap), code, _build.stream_of(q))
    _build.check(err, "decode_scores")
    SCORES_LAUNCHES += 1
    RING_SCORES_LAUNCHES += bool(ring)
    return s, m


def accumulate(s: torch.Tensor, m: torch.Tensor, v_cache: torch.Tensor, *,
               pos: torch.Tensor | None = None, slot_offset: int = 0,
               total_len: int | None = None, window: int = 0, chunk: int = 0,
               ring: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """s (B,KV,G,L) NEG_INF-masked fp32 scores, m (B,KV,G) fp32 row max,
    v_cache (B,L,KV,D) -> fp32 (o (B,1,H,D), l (B,1,H)), H = KV*G. A row
    with no slot kept gives o = 0 and l = 0.

    ``pos``, ``slot_offset``, ``total_len``, ``window``, ``chunk`` and
    ``ring``, when ``pos`` is given, are those the scores were masked with (by
    :func:`decode_scores`): the kernel then spreads only the slots they
    keep over its blocks. They change no result; the plain version does not
    read them. Without ``pos`` the kernel spreads all of L and skips the
    pieces whose p are all 0: the contract of the JAX package's
    ``decode_stats_accumulate_pallas`` (s, m and V alone)."""
    global LAUNCHES, RING_LAUNCHES
    named = {"s": s, "m": m, "v": v_cache}
    if pos is not None:
        named["pos"] = pos
    if ring:
        check_ring("decode_stats", v_cache.shape[1], window, chunk,
                   slot_offset, total_len)
    if _check_cuda("decode_stats", named):
        return decode_stats_accumulate_ref(s, m, v_cache)
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
    check_heads(G, D)
    code = _build.dtype_code(v_cache.dtype)
    if pos is not None and (pos.dtype != torch.long
                            or pos.shape not in ((), (B,))):
        raise ValueError(f"decode_stats: pos {pos.dtype} {tuple(pos.shape)}; "
                         f"want int64, 0-d or ({B},)")
    if slot_offset < 0:
        raise ValueError(f"decode_stats: slot_offset {slot_offset} must not "
                         "be negative")
    _check_layout("decode_stats", named, ("v",))
    o = torch.empty((B, 1, KV * G, D), dtype=torch.float32, device=s.device)
    l = torch.empty((B, 1, KV * G), dtype=torch.float32, device=s.device)
    rows = B * KV
    if L == 0:
        raise ValueError("decode_stats: the cache has L = 0 slots")
    if rows == 0:
        return o, l
    if rows > 65535 or L * KV * D >= 2 ** 31:
        raise ValueError(f"decode_stats: B*KV = {rows} rows (the grid takes "
                         f"65,535), L*KV*D = {L * KV * D} (the kernel "
                         "indexes a row's slots in 32 bits)")
    nsplit = _splits(rows, L, s.device)
    err = _build.lib().repro_decode_stats(
        s.data_ptr(), m.data_ptr(), v_cache.data_ptr(),
        None if pos is None else pos.data_ptr(),
        int(pos is not None and pos.ndim == 1), int(slot_offset),
        int(window), int(chunk), int(bool(ring)),
        o.data_ptr(), l.data_ptr(), B, KV, G, L, D, nsplit, code,
        _build.stream_of(s))
    _build.check(err, "decode_stats")
    LAUNCHES += 1
    RING_LAUNCHES += bool(ring)
    return o, l
