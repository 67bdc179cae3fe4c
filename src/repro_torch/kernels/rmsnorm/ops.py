"""RMSNorm and its two fused forms: the CUDA kernel for CUDA tensors, the
plain versions for CPU ones; and the backward of all three forms
(``csrc/rmsnorm_bwd.cu``), with the ``autograd.Function``s that the
training path calls (:func:`rmsnorm_train`, :func:`rmsnorm_residual_train`,
:func:`rmsnorm_gated_train`).

The gated form split over a model tier (:func:`rmsnorm_gated_tier`,
:func:`rmsnorm_gated_tier_train`: each rank holds some columns of every
row, and the statistic is the whole row's) takes two launches a norm, the
rows' partial sums of squares and the finish, with the tier's sum of the
(rows,) partials between them; its backward likewise, the partial row dot
products and the finish.

``LAUNCHES`` counts forward kernel launches of every form, ``FORM_LAUNCHES``
each form's (the split form's two launches as ``gated_rowsq`` and
``gated_finish``); ``BWD_LAUNCHES`` the backward's (one kernel: the rows
and the scale gradient's column sums; the split form's two as
``gated_rowdot`` and ``gated_finish``), and ``FORM_BWD_LAUNCHES`` the
backward's per form. CPU calls leave them alone.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import (rmsnorm_bwd_ref, rmsnorm_gated_bwd_ref,
                  rmsnorm_gated_finish_ref, rmsnorm_gated_ref,
                  rmsnorm_gated_rowdot_ref, rmsnorm_gated_rowsq_ref,
                  rmsnorm_ref, rmsnorm_residual_ref)

LAUNCHES = 0
FORM_LAUNCHES = {"plain": 0, "residual": 0, "gated": 0, "gated_rowsq": 0,
                 "gated_finish": 0}
BWD_LAUNCHES = 0
FORM_BWD_LAUNCHES = {"plain": 0, "residual": 0, "gated": 0,
                     "gated_rowdot": 0, "gated_finish": 0}
BWD_MAX_D = 8192
_BWD_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def bwd_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The backward kernel's 8 counters for launches on ``stream`` (the
    ``cuda_stream`` handle of a stream of ``device``, 0 the default one):
    zero before and after every launch, which sets them back itself. One
    set a stream, so the launches that share a set run one after
    another."""
    key = (device, stream)
    if key not in _BWD_COUNTERS:
        _BWD_COUNTERS[key] = torch.zeros(8, dtype=torch.int32, device=device)
    return _BWD_COUNTERS[key]


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs); raises else."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}; "
                         "all must be on one CUDA device")
    return False


def _rows(t: torch.Tensor, d: int) -> int | None:
    """The row stride of ``t`` seen as rows of d unit-stride values (a
    contiguous tensor, or a slice of the last dim of one), else None."""
    if d > 1 and t.stride(-1) != 1:
        return None
    ld, span = None, None
    for size, stride in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if ld is None:
            ld = stride
        elif stride != span:
            return None
        span = stride * size
    return d if ld is None else ld


def _vec(d: int, elem: int, ptrs, strides_bytes) -> int:
    """1 when every row can be read and written in 16-byte vectors."""
    return int(d % (16 // elem) == 0 and all(p % 16 == 0 for p in ptrs)
               and all(s % 16 == 0 for s in strides_bytes))


def _count(form: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    FORM_LAUNCHES[form] += 1


def _check_scale(name: str, scale: torch.Tensor, x: torch.Tensor) -> None:
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for "
                         f"{tuple(x.shape)}")
    if not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,); returns x's shape and dtype."""
    if _on_cpu("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps=eps)
    _check_scale("rmsnorm", scale, x)
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    x_code, s_code = _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype)
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = _vec(d, x.element_size(),
               (x.data_ptr(), y.data_ptr(), scale.data_ptr()), ())
    err = _build.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        x_code, s_code, vec, _build.stream_of(x))
    _build.check(err, "rmsnorm")
    _count("plain")
    return y


def rmsnorm_residual(x: torch.Tensor, delta: torch.Tensor,
                     scale: torch.Tensor, *, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, rmsnorm(s)) with s = x + delta rounded to x's dtype, in one pass;
    x and delta (..., d) of one dtype, scale (d,)."""
    if _on_cpu("rmsnorm_residual", x, delta, scale):
        return rmsnorm_residual_ref(x, delta, scale, eps=eps)
    _check_scale("rmsnorm_residual", scale, x)
    if delta.shape != x.shape or delta.dtype != x.dtype:
        raise ValueError(f"rmsnorm_residual: x {tuple(x.shape)} {x.dtype}, "
                         f"delta {tuple(delta.shape)} {delta.dtype}")
    if not (x.is_contiguous() and delta.is_contiguous()):
        raise ValueError("rmsnorm_residual: x and delta must be contiguous")
    x_code, s_code = _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype)
    s, y = torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return s, y
    vec = _vec(d, x.element_size(), (x.data_ptr(), delta.data_ptr(),
                                     s.data_ptr(), y.data_ptr(),
                                     scale.data_ptr()), ())
    err = _build.lib().repro_rmsnorm_residual(
        x.data_ptr(), delta.data_ptr(), scale.data_ptr(), s.data_ptr(),
        y.data_ptr(), rows, d, float(eps), x_code, s_code, vec,
        _build.stream_of(x))
    _build.check(err, "rmsnorm_residual")
    _count("residual")
    return s, y


def _gated_rows(name: str, y: torch.Tensor, z: torch.Tensor
                ) -> tuple[int, int]:
    """The row strides of the gated form's y (fp32) and z (one shape)."""
    if y.shape != z.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)}, z {tuple(z.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"{name}: y must be float32, got {y.dtype}")
    d = z.shape[-1]
    ld_y, ld_z = _rows(y, d), _rows(z, d)
    if ld_y is None or ld_z is None:
        raise ValueError(f"{name}: y and z must be rows of unit-stride "
                         f"values, got strides {y.stride()} and {z.stride()}")
    return ld_y, ld_z


def rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(round(round(y) * round(silu(z)))) in one pass: y (..., d)
    fp32, z (..., d) in the working dtype (rows may be a slice of a wider
    tensor's last dim), scale (d,); returns z's shape and dtype."""
    if _on_cpu("rmsnorm_gated", y, z, scale):
        return rmsnorm_gated_ref(y, z, scale, eps=eps)
    _check_scale("rmsnorm_gated", scale, z)
    ld_y, ld_z = _gated_rows("rmsnorm_gated", y, z)
    d = z.shape[-1]
    x_code, s_code = _build.dtype_code(z.dtype), _build.dtype_code(scale.dtype)
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    rows = z.numel() // d if d else 0
    if rows == 0:
        return out
    vec = _vec(d, z.element_size(), (y.data_ptr(), z.data_ptr(),
                                     out.data_ptr(), scale.data_ptr()),
               (4 * ld_y, z.element_size() * ld_z))
    err = _build.lib().repro_rmsnorm_gated(
        y.data_ptr(), ld_y, z.data_ptr(), ld_z, scale.data_ptr(),
        out.data_ptr(), rows, d, float(eps), x_code, s_code, vec,
        _build.stream_of(z))
    _build.check(err, "rmsnorm_gated")
    _count("gated")
    return out


def rmsnorm_gated_rowsq(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The split gated form's first launch: each row's fp32 sum of u^2, u =
    round(round(y) * round(silu(z))), over its d columns; (rows,) fp32. y
    and z as :func:`rmsnorm_gated` takes them."""
    if _on_cpu("rmsnorm_gated_rowsq", y, z):
        return rmsnorm_gated_rowsq_ref(y, z)
    ld_y, ld_z = _gated_rows("rmsnorm_gated_rowsq", y, z)
    d = z.shape[-1]
    rows = z.numel() // d if d else 0
    out = torch.empty((rows,), dtype=torch.float32, device=z.device)
    if rows == 0:
        return out
    vec = _vec(d, z.element_size(), (y.data_ptr(), z.data_ptr()),
               (4 * ld_y, z.element_size() * ld_z))
    err = _build.lib().repro_rmsnorm_gated_rowsq(
        y.data_ptr(), ld_y, z.data_ptr(), ld_z, out.data_ptr(), rows, d,
        _build.dtype_code(z.dtype), vec, _build.stream_of(z))
    _build.check(err, "rmsnorm_gated_rowsq")
    _count("gated_rowsq")
    return out


def rmsnorm_gated_finish(y: torch.Tensor, z: torch.Tensor,
                         scale: torch.Tensor, row_ss: torch.Tensor, *,
                         d_norm: int, eps: float = 1e-5) -> torch.Tensor:
    """The split gated form's second launch: u rsqrt(row_ss / d_norm + eps)
    (1 + scale) in z's dtype, ``row_ss`` (rows,) fp32 the whole rows' sums
    of u^2 over ``d_norm`` columns (the tier's sum of
    :func:`rmsnorm_gated_rowsq`'s); scale (d,) these columns'."""
    if _on_cpu("rmsnorm_gated_finish", y, z, scale, row_ss):
        return rmsnorm_gated_finish_ref(y, z, scale, row_ss, d_norm=d_norm,
                                        eps=eps)
    _check_scale("rmsnorm_gated_finish", scale, z)
    ld_y, ld_z = _gated_rows("rmsnorm_gated_finish", y, z)
    d = z.shape[-1]
    rows = z.numel() // d if d else 0
    if row_ss.dtype != torch.float32 or row_ss.shape != (rows,) \
            or not row_ss.is_contiguous() or d_norm < d:
        raise ValueError(f"rmsnorm_gated_finish: row_ss {tuple(row_ss.shape)}"
                         f" {row_ss.dtype} for {rows} rows, d_norm {d_norm} "
                         f"for {d} columns")
    out = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    if rows == 0:
        return out
    vec = _vec(d, z.element_size(), (y.data_ptr(), z.data_ptr(),
                                     out.data_ptr(), scale.data_ptr()),
               (4 * ld_y, z.element_size() * ld_z))
    err = _build.lib().repro_rmsnorm_gated_finish(
        y.data_ptr(), ld_y, z.data_ptr(), ld_z, scale.data_ptr(),
        row_ss.data_ptr(), out.data_ptr(), rows, d, int(d_norm), float(eps),
        _build.dtype_code(z.dtype), _build.dtype_code(scale.dtype), vec,
        _build.stream_of(z))
    _build.check(err, "rmsnorm_gated_finish")
    _count("gated_finish")
    return out


def rmsnorm_gated_tier(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                       tier, *, d_norm: int, eps: float = 1e-5
                       ) -> torch.Tensor:
    """:func:`rmsnorm_gated` on one rank of a model tier that splits every
    row's ``d_norm`` columns (this rank's y, z and scale columns): the
    rows' partial sums of squares, their sum over the tier
    (``tier.all_reduce``), the finish. Serving (no gradient)."""
    ss = tier.all_reduce(rmsnorm_gated_rowsq(y, z))
    return rmsnorm_gated_finish(y, z, scale, ss, d_norm=d_norm, eps=eps)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                ds: torch.Tensor | None = None, eps: float = 1e-5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rmsnorm` at (x, scale) for the output gradient
    ``dy``; with ``ds``, the residual form's: x is its sum s, ds the
    gradient of its s output, and dx the gradient of both x and delta. One
    kernel on the card, deterministic (no atomics in a sum)."""
    ts = (x, scale, dy) + (() if ds is None else (ds,))
    if _on_cpu("rmsnorm_bwd", *ts):
        return rmsnorm_bwd_ref(x, scale, dy, ds=ds, eps=eps)
    _check_scale("rmsnorm_bwd", scale, x)
    for t, what in ((dy, "dy"), (ds, "ds")):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype):
            raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, "
                             f"{what} {tuple(t.shape)} {t.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rmsnorm_bwd: x, dy and ds must be contiguous")
    d = x.shape[-1]
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {d} exceed {BWD_MAX_D}")
    x_code, s_code = _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dscale.zero_()
    lib, stream = _build.lib(), _build.stream_of(x)
    partial = torch.empty((lib.repro_rmsnorm_bwd_partial_rows(), d),
                          dtype=torch.float32, device=x.device)
    err = lib.repro_rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
        None if ds is None else ds.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(),
        bwd_counters(x.device, stream.value or 0).data_ptr(), rows, d,
        float(eps), x_code, s_code, stream)
    _build.check(err, "rmsnorm_bwd")
    _count_bwd("plain" if ds is None else "residual")
    return dx, dscale


def _check_dout(name: str, z: torch.Tensor, dout: torch.Tensor) -> None:
    if dout.shape != z.shape or dout.dtype != z.dtype \
            or not dout.is_contiguous():
        raise ValueError(f"{name}: z {tuple(z.shape)} {z.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype} (contiguous: "
                         f"{dout.is_contiguous()})")


def rmsnorm_gated_rowdot(y: torch.Tensor, z: torch.Tensor,
                         scale: torch.Tensor, dout: torch.Tensor
                         ) -> torch.Tensor:
    """The split gated backward's first launch: each row's fp32 sum of
    dout (1 + scale) u over its d columns, (rows,) fp32; y, z, scale and
    dout as :func:`rmsnorm_gated_bwd` takes them."""
    if _on_cpu("rmsnorm_gated_rowdot", y, z, scale, dout):
        return rmsnorm_gated_rowdot_ref(y, z, scale, dout)
    _check_scale("rmsnorm_gated_rowdot", scale, z)
    ld_y, ld_z = _gated_rows("rmsnorm_gated_rowdot", y, z)
    _check_dout("rmsnorm_gated_rowdot", z, dout)
    d = z.shape[-1]
    rows = z.numel() // d if d else 0
    out = torch.empty((rows,), dtype=torch.float32, device=z.device)
    if rows == 0:
        return out
    err = _build.lib().repro_rmsnorm_gated_rowdot(
        y.data_ptr(), ld_y, z.data_ptr(), ld_z, scale.data_ptr(),
        dout.data_ptr(), out.data_ptr(), rows, d, _build.dtype_code(z.dtype),
        _build.dtype_code(scale.dtype), _build.stream_of(z))
    _build.check(err, "rmsnorm_gated_rowdot")
    _count_bwd("gated_rowdot")
    return out


def _count_bwd(form: str) -> None:
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    FORM_BWD_LAUNCHES[form] += 1


def rmsnorm_gated_bwd(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                      dout: torch.Tensor, *, eps: float = 1e-5,
                      row_ss: torch.Tensor | None = None,
                      row_dot: torch.Tensor | None = None,
                      d_norm: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy fp32, dz in z's dtype, dscale) of :func:`rmsnorm_gated` at (y, z,
    scale) for the output gradient ``dout`` (z's shape and dtype,
    contiguous); y and z may be rows of a wider tensor, as the forward
    takes them; dy and dz come back contiguous. One kernel on the card, the
    plain and residual forms' grid and column sums (deterministic). With
    ``row_ss`` and ``row_dot`` ((rows,) fp32: the whole rows' sums of u^2
    and of dout (1 + scale) u over ``d_norm`` columns), the split form's
    finish: the same kernel on these columns, its row statistics those."""
    split = row_ss is not None
    if split != (row_dot is not None) or split != (d_norm is not None):
        raise ValueError("rmsnorm_gated_bwd: row_ss, row_dot and d_norm go "
                         "together")
    stats = (row_ss, row_dot) if split else ()
    if _on_cpu("rmsnorm_gated_bwd", y, z, scale, dout, *stats):
        return rmsnorm_gated_bwd_ref(y, z, scale, dout, eps=eps,
                                     row_ss=row_ss, row_dot=row_dot,
                                     d_norm=d_norm)
    _check_scale("rmsnorm_gated_bwd", scale, z)
    ld_y, ld_z = _gated_rows("rmsnorm_gated_bwd", y, z)
    _check_dout("rmsnorm_gated_bwd", z, dout)
    d = z.shape[-1]
    rows = z.numel() // d if d else 0
    if split and (d_norm < d or any(
            t.dtype != torch.float32 or t.shape != (rows,)
            or not t.is_contiguous() for t in stats)):
        raise ValueError(f"rmsnorm_gated_bwd: row_ss {tuple(row_ss.shape)}, "
                         f"row_dot {tuple(row_dot.shape)} for {rows} rows, "
                         f"d_norm {d_norm} for {d} columns")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_gated_bwd: rows of {d} exceed {BWD_MAX_D}")
    x_code, s_code = _build.dtype_code(z.dtype), _build.dtype_code(scale.dtype)
    dy = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    dz = torch.empty(z.shape, dtype=z.dtype, device=z.device)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dy, dz, dscale.zero_()
    lib, stream = _build.lib(), _build.stream_of(z)
    partial = torch.empty((lib.repro_rmsnorm_bwd_partial_rows(), d),
                          dtype=torch.float32, device=z.device)
    err = lib.repro_rmsnorm_gated_bwd(
        y.data_ptr(), ld_y, z.data_ptr(), ld_z, scale.data_ptr(),
        dout.data_ptr(), dy.data_ptr(), dz.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(),
        bwd_counters(z.device, stream.value or 0).data_ptr(),
        row_ss.data_ptr() if split else None,
        row_dot.data_ptr() if split else None, rows, d,
        int(d_norm) if split else d, float(eps), x_code, s_code, stream)
    _build.check(err, "rmsnorm_gated_bwd")
    _count_bwd("gated_finish" if split else "gated")
    return dy, dz, dscale


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` whose backward is :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), eps=ctx.eps)
        return dx, dscale, None


class RMSNormResidual(torch.autograd.Function):
    """:func:`rmsnorm_residual` whose backward is :func:`rmsnorm_bwd` of the
    sum, the sum's own gradient added in; x and delta get the same
    gradient."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps):
        s, y = rmsnorm_residual(x, delta, scale, eps=eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, scale = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(s)
        dx, dscale = rmsnorm_bwd(s, scale, dy.contiguous(),
                                 ds=None if ds is None else ds.contiguous(),
                                 eps=ctx.eps)
        return dx, dx, dscale, None


class RMSNormGated(torch.autograd.Function):
    """:func:`rmsnorm_gated` whose backward is :func:`rmsnorm_gated_bwd`; z
    may be a column slice of a wider tensor, and its gradient comes back
    contiguous (autograd's slice or split backward puts it in place)."""

    @staticmethod
    def forward(ctx, y, z, scale, eps):
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return rmsnorm_gated(y, z, scale, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        y, z, scale = ctx.saved_tensors
        dy, dz, dscale = rmsnorm_gated_bwd(y, z, scale, dout.contiguous(),
                                           eps=ctx.eps)
        return dy, dz, dscale, None


class RMSNormGatedTier(torch.autograd.Function):
    """:func:`rmsnorm_gated_tier` whose backward is the split form's: the
    rows' partial dot products (:func:`rmsnorm_gated_rowdot`), their sum
    over the tier, the finish (:func:`rmsnorm_gated_bwd` with the rows'
    totals). The tier's two sums run inside this node, forward and
    backward, so every rank of the tier issues them in one order."""

    @staticmethod
    def forward(ctx, y, z, scale, eps, tier, d_norm):
        ss = tier.all_reduce(rmsnorm_gated_rowsq(y, z))
        ctx.save_for_backward(y, z, scale, ss)
        ctx.eps, ctx.tier, ctx.d_norm = eps, tier, d_norm
        return rmsnorm_gated_finish(y, z, scale, ss, d_norm=d_norm, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        y, z, scale, ss = ctx.saved_tensors
        dout = dout.contiguous()
        dot = ctx.tier.all_reduce(rmsnorm_gated_rowdot(y, z, scale, dout))
        dy, dz, dscale = rmsnorm_gated_bwd(y, z, scale, dout, eps=ctx.eps,
                                           row_ss=ss, row_dot=dot,
                                           d_norm=ctx.d_norm)
        return dy, dz, dscale, None, None, None


def rmsnorm_train(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """Differentiable :func:`rmsnorm` (the training path)."""
    return RMSNorm.apply(x, scale, eps)


def rmsnorm_residual_train(x: torch.Tensor, delta: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-5
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`rmsnorm_residual` (the training path)."""
    return RMSNormResidual.apply(x, delta, scale, eps)


def rmsnorm_gated_train(y: torch.Tensor, z: torch.Tensor,
                        scale: torch.Tensor, *, eps: float = 1e-5
                        ) -> torch.Tensor:
    """Differentiable :func:`rmsnorm_gated` (the training path)."""
    return RMSNormGated.apply(y, z, scale, eps)


def rmsnorm_gated_tier_train(y: torch.Tensor, z: torch.Tensor,
                             scale: torch.Tensor, tier, *, d_norm: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """Differentiable :func:`rmsnorm_gated_tier` (the training path on a
    model tier)."""
    return RMSNormGatedTier.apply(y, z, scale, eps, tier, d_norm)
