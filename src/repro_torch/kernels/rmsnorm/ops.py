"""RMSNorm: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

``LAUNCHES`` counts kernel launches; CPU calls leave it alone.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rmsnorm_ref

LAUNCHES = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,); returns x's shape and dtype."""
    global LAUNCHES
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device} and scale on "
                         f"{scale.device}; both must be on one CUDA device")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for x "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    x_code = _build.dtype_code(x.dtype)
    s_code = _build.dtype_code(scale.dtype)
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = int(d % (16 // x.element_size()) == 0
              and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    err = _build.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        x_code, s_code, vec, _build.stream_of(x))
    _build.check(err, "rmsnorm")
    LAUNCHES += 1
    return y
