"""Flash attention: the CUDA kernels for CUDA tensors, the plain versions
for CPU ones. ``LAUNCHES`` counts forward kernel launches, ``BWD_DQ_LAUNCHES``
and ``BWD_DKDV_LAUNCHES`` the two backward kernels' (either instance), and
``BWD_WGMMA_LAUNCHES`` those of the two that the tensor-core instance made,
``D120_LAUNCHES`` the forward launches at head dim 120 and
``BWD_D120_LAUNCHES`` the backward kernels' at head dim 120; CPU calls
leave them alone.

Head dim 120 (h2o-danube-3-4b) runs in the D = 128 instances, forward and
backward, the 8 missing columns read as zeros by the kernels themselves
(their tensor maps end at 120). The tanh softcap (gemma2-9b's 50) is an
argument of every instance, forward and backward.

On the card the dtype picks the instance, forward and backward,
explicitly: bf16 runs the tensor-core kernels (wgmma, TMA), fp32 the
CUDA-core ones (TF32 would not hold the backward's 1e-4 tolerance). The
backward's tensor-core pair takes every head dim: at D = 256 (gemma2-9b)
it runs two warpgroups a block, each holding half of the head dim of
dQ, dK and dV (one warpgroup's dK and dV over 256 columns would not fit
its registers), the two reductions over D of a tile split between them
and swapped through shared memory. A launch that fails raises; no instance
stands in for another.

:func:`flash_attention` is the serving forward; :func:`flash_attention_train`
is differentiable (``FlashAttention``: the forward kernel writing the rows'
log-sum-exp, the two backward kernels of ``csrc/flash_attention_bwd.cu``).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKDV_LAUNCHES = 0
BWD_WGMMA_LAUNCHES = 0
D120_LAUNCHES = 0                   # of LAUNCHES, at head dim 120
BWD_D120_LAUNCHES = 0               # of the backward's, at head dim 120
HEAD_DIMS = (32, 64, 120, 128, 256)  # the forward's head dims
BWD_HEAD_DIMS = HEAD_DIMS            # the backward's
BWD_WGMMA_HEAD_DIMS = BWD_HEAD_DIMS  # bf16's backward: tensor cores at every D


def bwd_on_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the backward of (dtype, head_dim) runs the tensor-core pair
    (else the CUDA-core one)."""
    return dtype == torch.bfloat16 and head_dim in BWD_WGMMA_HEAD_DIMS


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D), H % KV == 0; returns (B,S,H,D) in q's
    dtype. Query i and key j are positions i and j of one sequence."""
    if _on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             chunk=chunk, cap=cap)
    return _forward(q, k, v, causal, window, chunk, cap, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        cap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): :func:`flash_attention` and the rows' natural log-sum-exp of
    the scaled scores, (B, H, S) fp32 (+inf for a row with no key)."""
    if _on_cpu(q, k, v):
        return attention_lse_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk, cap=cap)
    return _forward(q, k, v, causal, window, chunk, cap, with_lse=True)


def _check_qkv(name: str, q, k, v, head_dims=HEAD_DIMS) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}; all must be on one CUDA device")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if D not in head_dims:
        raise ValueError(f"{name}: head_dim {D} not in {head_dims}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be contiguous")


def _forward(q, k, v, causal, window, chunk, cap, *, with_lse: bool):
    global LAUNCHES, D120_LAUNCHES
    _check_qkv("flash_attention", q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
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
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or S == 0 or H == 0:
        return o, lse
    if T == 0:
        raise ValueError("flash_attention: no keys to attend to")
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, T, H, KV, D,
        float(D ** -0.5), int(bool(causal)), int(window), int(chunk),
        float(cap), _build.stream_of(q))
    _build.check(err, what)
    LAUNCHES += 1
    D120_LAUNCHES += D == 120
    return o, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, chunk: int = 0, cap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), from its output
    ``o``, the output's gradient ``do`` and the forward's ``lse`` (taken
    with the same masks and ``cap``); two kernels on the card (dq, writing
    rowsum(do * o), then dk and dv) of the instance
    :func:`bwd_on_tensor_cores` picks, deterministic."""
    global BWD_DQ_LAUNCHES, BWD_DKDV_LAUNCHES, BWD_WGMMA_LAUNCHES, \
        BWD_D120_LAUNCHES
    if _on_cpu(q, k, v, o, do, lse):
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                 window=window, chunk=chunk, cap=cap)
    name = "flash_attention_bwd"
    _check_qkv(name, q, k, v, BWD_HEAD_DIMS)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    for t, what in ((o, "o"), (do, "do")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} must be a contiguous tensor like q")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse {tuple(lse.shape)} {lse.dtype}, want "
                         f"({B}, {H}, {S}) float32 on {q.device}")
    code = _build.dtype_code(q.dtype)
    wgmma = bwd_on_tensor_cores(q.dtype, D)
    if wgmma and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError(f"{name}: bf16 q, k, v, o and do must start on 16 "
                         "bytes (TMA)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0 or H == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib, stream = _build.lib(), _build.stream_of(q)
    if cap < 0:
        raise ValueError(f"{name}: cap {cap} must be >= 0")
    dims = (B, S, T, H, KV, D, float(D ** -0.5), int(bool(causal)),
            int(window), int(chunk), float(cap))
    if wgmma:
        what, tail = "tensor cores", (*dims, stream)
        dq_fn, dkdv_fn = lib.repro_flash_bwd_dq_wgmma, \
            lib.repro_flash_bwd_dkdv_wgmma
    else:
        what, tail = "CUDA cores", (*dims, code, stream)
        dq_fn, dkdv_fn = lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dkdv
    err = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), *tail)
    _build.check(err, f"flash_attention_bwd (dq, {what})")
    BWD_DQ_LAUNCHES += 1
    BWD_WGMMA_LAUNCHES += wgmma
    BWD_D120_LAUNCHES += D == 120
    err = dkdv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *tail)
    _build.check(err, f"flash_attention_bwd (dk, dv, {what})")
    BWD_DKDV_LAUNCHES += 1
    BWD_WGMMA_LAUNCHES += wgmma
    BWD_D120_LAUNCHES += D == 120
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is :func:`flash_attention_bwd`: the forward
    keeps (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, cap):
        masks = dict(causal=causal, window=window, chunk=chunk, cap=cap)
        o, lse = flash_attention_lse(q, k, v, **masks)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = masks
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         **ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          chunk: int = 0, cap: float = 0.0) -> torch.Tensor:
    """Differentiable :func:`flash_attention` (the training path)."""
    return FlashAttention.apply(q, k, v, causal, window, chunk, cap)
