"""Mamba2 SSD chunked scan: the CUDA kernel for CUDA tensors, the plain
version for CPU ones. ``LAUNCHES`` counts kernel launches; CPU calls leave
it alone."""
from __future__ import annotations

import torch

from .. import _build
from .ref import ssd_ref

LAUNCHES = 0
P_TILE = 16     # columns of P per block of the kernel (csrc/ssd.cu kPT)


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
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("ssd: x, dt, A, B and C are on "
                         f"{[str(t.device) for t in ts]}; all must be on one "
                         "CUDA device")
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (B.shape[:2] != (Bt, S) or dt.shape != (Bt, S, H) or A.shape != (H,)
            or G == 0 or H % G):
        raise ValueError(f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(B.shape)}")
    if P % P_TILE:
        raise ValueError(f"ssd: head dim P={P} is not a multiple of the "
                         f"kernel's P tile {P_TILE}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd: dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if not (B.dtype == C.dtype == x.dtype):
        raise TypeError(f"ssd: x, B and C dtypes {x.dtype}, {B.dtype}, "
                        f"{C.dtype} differ")
    code = _build.dtype_code(x.dtype)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd: x, dt, A, B and C must be contiguous")
    y = torch.empty((Bt, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    err = _build.lib().repro_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S, H, G, N, P, code,
        _build.stream_of(x))
    _build.check(err, f"ssd (N={N}, P={P})")
    LAUNCHES += 1
    return y, h
