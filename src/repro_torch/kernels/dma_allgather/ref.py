"""Plain PyTorch DMA allgather: the oracle of ``csrc/dma_allgather.cu``.

The p ranks are p rows of one ``(p, capacity, n)`` buffer; the compiled
table's rounds copy block slices between rows, a per-rank permutation then
reads the canonical order, as the TPU kernel does. The CUDA kernel runs
the folded table instead (messages land in canonical order), so the two
share the schedule and nothing else.
"""
import torch


def dma_allgather_ref(x: torch.Tensor, sched) -> torch.Tensor:
    """x (p, *shard) -> (p, p, *shard): out[i] is rank i's gathered result."""
    p, cap = sched.p, sched.capacity
    n = x[0].numel()
    buf = torch.zeros((p, cap, n), dtype=x.dtype, device=x.device)
    buf[:, 0] = x.reshape(p, n)
    for r, size in enumerate(sched.sizes):
        for i in range(p):
            tgt, soff, roff, sflag, _ = (int(v) for v in sched.table[i, r])
            if sflag:
                buf[tgt, roff:roff + size] = buf[i, soff:soff + size]
    perm = torch.as_tensor(sched.perm, dtype=torch.long, device=x.device)
    out = buf[torch.arange(p, device=x.device)[:, None], perm]
    return out.reshape((p, p) + tuple(x.shape[1:]))
