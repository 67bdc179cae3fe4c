"""Mamba2 SSD chunked scan: the CUDA kernel for CUDA tensors, the plain
version for CPU ones; and its backward (``csrc/ssd_bwd.cu``), with the
``autograd.Function`` that the training path calls (:func:`ssd_train`).

``LAUNCHES`` counts forward kernel launches, ``BWD_LAUNCHES`` the
backward's: ``BWD_KERNELS`` a call, the four kernels it runs in order (the
scans over the chunks, the per-group gradients, the per-head ones, dA's
sum); CPU calls leave them alone."""
from __future__ import annotations

import torch

from .. import _build
from .ref import ssd_bwd_ref, ssd_ref

LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_KERNELS = 4  # kernels one backward call launches (csrc/ssd_bwd.cu)
P_TILE = 16     # columns of P per block of the kernel (csrc/ssd.cu kPT)
MAX_N = 256     # the state size the kernels take (csrc/ssd*.cu kMaxN)


def _check(name: str, x, dt, A, B, C) -> None:
    """The kernels' contract on CUDA tensors (the forward's and the
    backward's): one device, shapes, dtypes, contiguity, N and P limits."""
    ts = (x, dt, A, B, C)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"{name}: x, dt, A, B and C are on "
                         f"{[str(t.device) for t in ts]}; all must be on one "
                         "CUDA device")
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    Bt, S, H, P = x.shape
    G = B.shape[2]
    if (B.shape[:2] != (Bt, S) or dt.shape != (Bt, S, H) or A.shape != (H,)
            or G == 0 or H % G):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(B.shape)}")
    if P % P_TILE:
        raise ValueError(f"{name}: head dim P={P} is not a multiple of the "
                         f"kernel's P tile {P_TILE}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if not (B.dtype == C.dtype == x.dtype):
        raise TypeError(f"{name}: x, B and C dtypes {x.dtype}, {B.dtype}, "
                        f"{C.dtype} differ")
    _build.dtype_code(x.dtype)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: x, dt, A, B and C must be contiguous")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, Q: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x (Bt,S,H,P), dt (Bt,S,H) fp32, A (H,) fp32, B/C (Bt,S,G,N) in x's
    dtype; returns (y (Bt,S,H,P) fp32, h_final (Bt,H,N,P) fp32).

    ``Q`` is the chunk length of the plain version (the CPU route); the
    kernel walks the sequence in its own 64-token chunks, which computes
    the same function up to fp32 rounding.
    """
    global LAUNCHES
    ts = (x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_ref(x, dt, A, B, C, Q=Q)
    _check("ssd", *ts)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bt, S, H, P), **f32)
    h = torch.empty((Bt, H, N, P), **f32)
    err = _build.lib().repro_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S, H, G, N, P,
        _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(err, f"ssd (N={N}, P={P})")
    LAUNCHES += 1
    return y, h


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
            Q: int = 256) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) of :func:`ssd`'s y for the output gradient dy
    (Bt,S,H,P) fp32; each in its input's dtype. On the card one call runs
    the backward's four kernels (deterministic: no atomics in a sum),
    within the forward's N and P limits; the states before the chunks are
    recomputed there, so the forward keeps none. ``Q`` is the plain
    version's chunk length, as in :func:`ssd`."""
    global BWD_LAUNCHES
    ts = (x, dt, A, B, C, dy)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_bwd_ref(x, dt, A, B, C, dy, Q=Q)
    _check("ssd_bwd", x, dt, A, B, C)
    if (dy.device != x.device or dy.shape != x.shape
            or dy.dtype != torch.float32 or not dy.is_contiguous()):
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}; it must be x's shape, float32, "
                         "contiguous, on x's device")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssd_bwd: state size N={N} (P={P}) is outside the "
                         f"kernel's 1..{MAX_N}")
    dev, f32 = x.device, torch.float32
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt = torch.empty((Bt, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    lib = _build.lib()
    # the chunks' states and state gradients and the partial sums, laid out
    # by the C side (csrc/ssd_bwd.cu scratch_of)
    scratch = torch.empty(lib.repro_ssd_bwd_scratch_bytes(Bt, S, H, N, P),
                          dtype=torch.uint8, device=dev)
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, dy, dx, ddt, dA, dB, dC,
                                   scratch)]
    err = lib.repro_ssd_bwd(*ptrs, Bt, S, H, G, N, P,
                            _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(err, f"ssd_bwd (N={N}, P={P})")
    BWD_LAUNCHES += BWD_KERNELS
    return dx, ddt, dA, dB, dC


class SSD(torch.autograd.Function):
    """:func:`ssd` whose backward is :func:`ssd_bwd`; the final state is not
    differentiable (training does not use it)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, Q):
        y, h = ssd(x, dt, A, B, C, Q=Q)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.Q = Q
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        grads = ssd_bwd(*ctx.saved_tensors, dy.contiguous(), Q=ctx.Q)
        return (*grads, None)


def ssd_train(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *, Q: int = 256
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`ssd` (the training path): (y, h_final), h_final
    not differentiable."""
    return SSD.apply(x, dt, A, B, C, Q)
