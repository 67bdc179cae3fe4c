"""Plain PyTorch RMSNorm and its two fused forms: the oracles of
``csrc/rmsnorm.cu``. The fused forms are literally the eager ops they take
the place of on the serving paths, unfused."""
import torch
import torch.nn.functional as F


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_residual_ref(x: torch.Tensor, delta: torch.Tensor,
                         scale: torch.Tensor, *, eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, rmsnorm(s)) with s = x + delta in x's dtype: a decoder layer's
    residual add and the norm after it."""
    s = x + delta
    return s, rmsnorm_ref(s, scale, eps=eps)


def rmsnorm_gated_ref(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      *, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(y.to(z.dtype) * silu(z)): the Mamba2 mixer's gate and norm;
    y fp32, z and the result in the working dtype."""
    return rmsnorm_ref(y.to(z.dtype) * F.silu(z), scale, eps=eps)
