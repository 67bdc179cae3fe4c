"""Flash attention: the CUDA kernel for CUDA tensors, the plain version for
CPU ones. ``LAUNCHES`` counts kernel launches; CPU calls leave it alone.

On the card the dtype picks the instance, explicitly: bf16 runs the
tensor-core kernel (wgmma, TMA), fp32 the CUDA-core one. A launch that
fails raises; neither stands in for the other."""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

LAUNCHES = 0
HEAD_DIMS = (32, 64, 128, 256)      # the head dims the kernel is built for


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D), H % KV == 0; returns (B,S,H,D) in q's
    dtype. Query i and key j are positions i and j of one sequence."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window,
                             chunk=chunk, cap=cap)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}; all must be on one CUDA device")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.dtype == torch.bfloat16:
        entry = "repro_flash_attention_bf16"
        what = "flash_attention (bf16, wgmma)"
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bf16 q, k and v must start on "
                             "16 bytes (TMA)")
    elif q.dtype == torch.float32:
        entry = "repro_flash_attention_fp32"
        what = "flash_attention (fp32)"
    else:
        raise TypeError(f"flash_attention: the kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    o = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return o
    if T == 0:
        raise ValueError("flash_attention: no keys to attend to")
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T, H,
        KV, D, float(D ** -0.5), int(bool(causal)), int(window), int(chunk),
        float(cap), _build.stream_of(q))
    _build.check(err, what)
    LAUNCHES += 1
    return o
