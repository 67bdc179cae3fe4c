"""Layer primitives of the port: init, RMSNorm, the gated MLP (SwiGLU and
GeGLU), rotary embeddings, the softcap and the embedding scale.

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
              down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP: (act(x @ gate) * (x @ up)) @ down, SwiGLU for
    ``act="silu"``, GeGLU for ``"gelu"`` (the tanh form, the default of the
    JAX package's ``jax.nn.gelu``)."""
    g = x @ gate
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * (x @ up)) @ down


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """cap * tanh(x / cap) in fp32, cast back to x's dtype (none for cap
    0): the JAX package's ``layers.softcap``."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def embed_scale(d_model: int, dtype) -> float:
    """The factor ``scale_embed`` multiplies the embedding by, sqrt(d_model)
    rounded to ``dtype`` first: the JAX package multiplies its ``dtype``
    activations by the Python float, a weakly typed scalar that JAX casts to
    the array's dtype (sqrt(3584) = 59.87 becomes 59.75 in bf16), while torch
    would multiply by the full factor. A product of two bf16 values is exact
    in fp32, so multiplying by the rounded factor and rounding once gives
    the JAX result."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


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
