"""DMA allgather on one card: the CUDA kernel for CUDA tensors, the plain
version for CPU ones.

The p ranks of the gather are p slices of one device allocation:
``dma_allgather(x, sched)`` takes ``x`` (p, *shard), rank i's shard in
``x[i]``, and returns (p, p, *shard) with ``out[i]`` rank i's gathered
result in canonical order, as the JAX op returns it on device i. The
kernel runs the schedule's folded table (``DmaSchedule.folded``) in one
cooperative launch: messages land in canonical order, blocks received a
second time go to a (p, capacity - p, *shard) spill buffer. ``LAUNCHES``
counts kernel launches (1 per call); CPU calls leave it alone.
"""
from __future__ import annotations

import functools

import torch

from ...core import schedules as S
from .. import _build
from .ref import dma_allgather_ref
from .schedule_compile import DmaSchedule, compile_schedule, locality_bruck_raw

LAUNCHES = 0


@functools.lru_cache(maxsize=64)
def build_schedule(algorithm: str, p: int, p_local: int | None) -> DmaSchedule:
    if algorithm == "locality_bruck":
        return compile_schedule(locality_bruck_raw(p, p_local))
    if algorithm == "hierarchical":
        raise NotImplementedError(
            "hierarchical's master broadcast is not raw-contiguous; use the "
            "point-to-point path (core/collectives.py) for it")
    gen = S.ALGORITHMS[algorithm]
    sched = gen(p, p_local) if p_local else gen(p)
    return compile_schedule(sched)


def _vec_bytes(block_bytes: int, *ptrs: int) -> int:
    """Widest access of 16, 8, 4, 2 or 1 bytes that divides the block width
    and every pointer."""
    for v in (16, 8, 4, 2):
        if block_bytes % v == 0 and all(ptr % v == 0 for ptr in ptrs):
            return v
    return 1


def _device_tables(sched: DmaSchedule, device) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The folded table and the round sizes on ``device``, copied once per
    schedule."""
    key = str(device)
    if key not in sched.device_tables:
        sched.device_tables[key] = (
            torch.as_tensor(sched.folded, dtype=torch.int32).contiguous()
            .to(device),
            torch.as_tensor(sched.sizes, dtype=torch.int32).to(device))
    return sched.device_tables[key]


def dma_allgather(x: torch.Tensor, sched: DmaSchedule) -> torch.Tensor:
    """x (p, *shard) -> (p, p, *shard), any dtype (the kernel copies bytes)."""
    global LAUNCHES
    if x.ndim < 1 or x.shape[0] != sched.p:
        raise ValueError(f"dma_allgather: x {tuple(x.shape)} for a schedule "
                         f"of {sched.p} ranks")
    if x.device.type == "cpu":
        return dma_allgather_ref(x, sched)
    if x.device.type != "cuda":
        raise ValueError(f"dma_allgather: x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("dma_allgather: x must be contiguous")
    p = sched.p
    out = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    block_bytes = x[0].numel() * x.element_size()
    if block_bytes == 0:
        return out
    spill = (torch.empty((p, sched.spill, block_bytes), dtype=torch.uint8,
                         device=x.device) if sched.spill else None)
    table, sizes = _device_tables(sched, x.device)
    ptrs = [x.data_ptr(), out.data_ptr()]
    if spill is not None:
        ptrs.append(spill.data_ptr())
    vec = _vec_bytes(block_bytes, *ptrs)
    err = _build.lib().repro_dma_allgather(
        x.data_ptr(), out.data_ptr(), None if spill is None else
        spill.data_ptr(), table.data_ptr(), sizes.data_ptr(), p,
        len(sched.sizes), sched.folded.shape[2], sched.spill,
        max(sched.sizes, default=0), block_bytes, vec, _build.stream_of(x))
    _build.check(err, "dma_allgather")
    LAUNCHES += 1
    return out


def dma_locality_allgather(x: torch.Tensor, q: int, pl: int, *,
                           algorithm: str = "locality_bruck") -> torch.Tensor:
    """Allgather of ``x`` (q·pl, *shard) over q pods of pl ranks (grid rank
    R·pl + l in ``x[R·pl + l]``) by the named schedule."""
    p = q * pl
    if algorithm in ("bruck", "ring"):
        sched = build_schedule(algorithm, p, None)
    else:
        sched = build_schedule(algorithm, p, pl)
    return dma_allgather(x, sched)
