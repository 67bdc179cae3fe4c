"""Plain PyTorch RMSNorm and its two fused forms, and the backward of all
three: the oracles of ``csrc/rmsnorm.cu`` and ``csrc/rmsnorm_bwd.cu``. The
fused forms are literally the eager ops they take the place of on the
serving paths, unfused.

The gated form split over a model tier (each rank holding some columns of
every row, the statistic over the whole row) has four pieces: the rows'
partial sums of squares (:func:`rmsnorm_gated_rowsq_ref`), the norm from
their total (:func:`rmsnorm_gated_finish_ref`), the backward's partial row
dot products (:func:`rmsnorm_gated_rowdot_ref`) and the backward from both
totals (:func:`rmsnorm_gated_bwd_ref` with ``row_ss`` and ``row_dot``); the
caller sums the partials over the tier between them."""
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


def _gated_product(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = round(y) * silu(z), rounded as the forward rounds it, in fp32."""
    return (y.to(z.dtype) * F.silu(z)).float()


def _row_col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (rows,) vector as a column against ``like``'s rows."""
    return v.reshape(like.shape[:-1] + (1,))


def rmsnorm_gated_rowsq_ref(y: torch.Tensor, z: torch.Tensor
                            ) -> torch.Tensor:
    """Each row's fp32 sum of g^2 over its columns, (rows,): the split
    gated form's first step."""
    g = _gated_product(y, z)
    return (g * g).sum(-1).reshape(-1)


def rmsnorm_gated_finish_ref(y: torch.Tensor, z: torch.Tensor,
                             scale: torch.Tensor, row_ss: torch.Tensor, *,
                             d_norm: int, eps: float = 1e-5) -> torch.Tensor:
    """The gated norm of these columns from ``row_ss``, the whole rows'
    sums of g^2 over ``d_norm`` columns: g rsqrt(row_ss / d_norm + eps)
    (1 + scale), in z's dtype."""
    g = _gated_product(y, z)
    rstd = torch.rsqrt(_row_col(row_ss, g) / d_norm + eps)
    return (g * rstd * (1.0 + scale.float())).to(z.dtype)


def rmsnorm_gated_rowdot_ref(y: torch.Tensor, z: torch.Tensor,
                             scale: torch.Tensor, dout: torch.Tensor
                             ) -> torch.Tensor:
    """Each row's fp32 sum of dout (1 + scale) g over its columns, (rows,):
    the split gated backward's first step."""
    g = _gated_product(y, z)
    return (dout.float() * (1.0 + scale.float()) * g).sum(-1).reshape(-1)


def rmsnorm_gated_bwd_ref(y: torch.Tensor, z: torch.Tensor,
                          scale: torch.Tensor, dout: torch.Tensor, *,
                          eps: float = 1e-5,
                          row_ss: torch.Tensor | None = None,
                          row_dot: torch.Tensor | None = None,
                          d_norm: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy fp32, dz in z's dtype, dscale in scale's) of
    ``rmsnorm_gated_ref(y, z, scale)`` for the output gradient dout: the
    gated product g = round(y) * silu(z) recomputed as the forward rounds
    it, the plain backward's row math for dg and dscale (fp32, dg not
    rounded), then dy = dg silu(z) and dz = dg round(y) silu'(z) with
    silu'(z) = sigmoid(z) (1 + z (1 - sigmoid(z))), in fp32 from z. With
    ``row_ss`` and ``row_dot`` (the split form: the whole rows' sums of g^2
    and of dout (1 + scale) g over ``d_norm`` columns) the row statistics
    come from those, and dscale is these columns'."""
    d = z.shape[-1]
    yr = y.to(z.dtype)
    g = (yr * F.silu(z)).float()
    z32, dout32 = z.float(), dout.float()
    gs = dout32 * (1.0 + scale.float())
    if row_ss is None:
        rstd = torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
        ghat = g * rstd
        dg = rstd * (gs - ghat * torch.mean(gs * ghat, dim=-1, keepdim=True))
    else:
        rstd = torch.rsqrt(_row_col(row_ss, g) / d_norm + eps)
        ghat = g * rstd
        dg = rstd * (gs - ghat * rstd * _row_col(row_dot, g) / d_norm)
    sig = torch.sigmoid(z32)
    dy = dg * (z32 * sig)
    dz = (dg * yr.float() * sig * (1.0 + z32 * (1.0 - sig))).to(z.dtype)
    dscale = (dout32 * ghat).reshape(-1, d).sum(0)
    return dy, dz, dscale.to(scale.dtype)
