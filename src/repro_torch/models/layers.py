"""Layer primitives of the port: init, RMSNorm, SwiGLU MLP, rotary embeddings.

Plain functions on tensors, mirroring ``repro.models.layers``. Weights keep
the JAX package's ``(d_in, d_out)`` layout, so ``x @ w`` is the product in
both packages. RMSNorm goes through ``kernels/rmsnorm``, as do its two
fused forms: the residual add before a norm and the Mamba2 gate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# fp32 RMSNorm with the ``(1 + scale)`` convention, cast back to x's dtype:
# the JAX package's ``layers.rmsnorm``, here the kernel's wrapper itself.
from ..kernels.rmsnorm.ops import (rmsnorm, rmsnorm_gated,  # noqa: F401
                                   rmsnorm_residual)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """N(0, 1/d_in), the JAX package's ``dense_init`` distribution."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    """N(0, 0.02^2), the JAX package's ``embed_init`` distribution."""
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def mlp_apply(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
              down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ gate) * (x @ up)) @ down."""
    return (F.silu(x @ gate) * (x @ up)) @ down


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of shape (..., S, 1, D/2) for positions (..., S),
    computed once per forward and shared by every layer."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device) / head_dim))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope_angles(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves of x (..., S, H, D) in fp32; cast back."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
