"""Plain PyTorch RMSNorm and its two fused forms, and the backward of the
plain and residual forms: the oracles of ``csrc/rmsnorm.cu`` and
``csrc/rmsnorm_bwd.cu``. The fused forms are literally the eager ops they
take the place of on the serving paths, unfused."""
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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    *, ds: torch.Tensor | None = None, eps: float = 1e-5
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rmsnorm_ref(x, scale)`` for the output gradient dy,
    in fp32: dx = rstd (g - x^ mean(g x^)) with g = dy (1 + scale) and x^ =
    x rstd, rounded to x's dtype; dscale = sum over rows of dy x^, rounded
    to scale's. With ``ds`` (the residual form's input is the sum s, and ds
    the gradient of its s output) dx + ds, added as the eager add adds."""
    d = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    rstd = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * rstd
    g = dy32 * (1.0 + scale.float())
    dx = (rstd * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
          ).to(x.dtype)
    if ds is not None:
        dx = dx + ds
    dscale = (dy32 * xhat).reshape(-1, d).sum(0)
    return dx, dscale.to(scale.dtype)


def rmsnorm_gated_ref(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      *, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(y.to(z.dtype) * silu(z)): the Mamba2 mixer's gate and norm;
    y fp32, z and the result in the working dtype."""
    return rmsnorm_ref(y.to(z.dtype) * F.silu(z), scale, eps=eps)
