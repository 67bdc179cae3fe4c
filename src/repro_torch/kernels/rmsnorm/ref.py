"""Plain PyTorch RMSNorm and its two fused forms, and the backward of all
three: the oracles of ``csrc/rmsnorm.cu`` and ``csrc/rmsnorm_bwd.cu``. The
fused forms are literally the eager ops they take the place of on the
serving paths, unfused."""
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


def rmsnorm_gated_bwd_ref(y: torch.Tensor, z: torch.Tensor,
                          scale: torch.Tensor, dout: torch.Tensor, *,
                          eps: float = 1e-5
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy fp32, dz in z's dtype, dscale in scale's) of
    ``rmsnorm_gated_ref(y, z, scale)`` for the output gradient dout: the
    gated product g = round(y) * silu(z) recomputed as the forward rounds
    it, the plain backward's row math for dg and dscale (fp32, dg not
    rounded), then dy = dg silu(z) and dz = dg round(y) silu'(z) with
    silu'(z) = sigmoid(z) (1 + z (1 - sigmoid(z))), in fp32 from z."""
    d = z.shape[-1]
    yr = y.to(z.dtype)
    g = (yr * F.silu(z)).float()
    z32, dout32 = z.float(), dout.float()
    rstd = torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    ghat = g * rstd
    gs = dout32 * (1.0 + scale.float())
    dg = rstd * (gs - ghat * torch.mean(gs * ghat, dim=-1, keepdim=True))
    sig = torch.sigmoid(z32)
    dy = dg * (z32 * sig)
    dz = (dg * yr.float() * sig * (1.0 + z32 * (1.0 - sig))).to(z.dtype)
    dscale = (dout32 * ghat).reshape(-1, d).sum(0)
    return dy, dz, dscale.to(scale.dtype)
