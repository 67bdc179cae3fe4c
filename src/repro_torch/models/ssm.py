"""Mamba2 (SSD — state-space duality) mixer of the port: chunked prefill
scan and O(1)-state decode. [Dao & Gu 2024, arXiv:2405.21060]

Mirrors ``repro.models.ssm``. Recurrence (per head h, state N, head dim P):
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t        h ∈ R^{N×P}
    y_t = C_t · h_t + D · x_t

Prefill and training go through ``kernels/ssd`` where the JAX model calls
``ssd_chunked``: the hand-written kernel on the card (fp32, the function
``ssd_pallas`` computes), its plain version ``ssd_chunked(precise=True)``
on the CPU; training (``cache=None``) takes the differentiable forms of the
scan and of the gated RMSNorm, whose backward passes are kernels too.
Decode is the recurrence in plain torch ops, as in the JAX package, where
it has no kernel. Parameters are a flat dict per layer:
``in_proj, conv_w, conv_b, dt_bias, A_log, D, norm, out_proj`` (``norm`` is
the gated RMSNorm's scale), weights in the JAX ``(d_in, d_out)`` layout.

On a model tier (``tp``, ``models/tp.TensorParallel``) the mixer runs one
rank's H/m SSD heads: its parameters are the rank's part
(``TensorParallel._ssm_part``: the heads' z, x and dt, B and C of every
group), it takes the groups its heads read from B and C, normalises the
gated product with the whole d_inner row's statistic summed over the tier,
and returns ``out_proj``'s partial sums in fp32, which the caller sums over
it and rounds to the working dtype once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import (rmsnorm_gated_tier,
                                   rmsnorm_gated_tier_train,
                                   rmsnorm_gated_train)
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ref import chunk_len
from ..kernels.ssd.ref import ssd_chunked  # noqa: F401  (the JAX name)
from .layers import dense_init, rmsnorm_gated

MAMBA_PARAMS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                "norm", "out_proj")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def ssm_dims(cfg, m: int = 1) -> tuple[int, int, int, int, int]:
    """(d_inner, H, P, N, G) of a Mamba2 layer; with m, one rank's of a
    model tier of m: d_inner / m and H / m, every group's B and C."""
    d_inner = cfg.ssm_expand * cfg.d_model // m
    P = cfg.ssm_headdim
    H = d_inner // P
    N = cfg.ssm_state
    G = cfg.ssm_ngroups
    return d_inner, H, P, N, G


def mamba_init(gen: torch.Generator, cfg, device) -> dict[str, torch.Tensor]:
    """The JAX ``mamba_init`` distributions (other bits), drawn in fp32 on
    ``device`` and stored in ``cfg.dtype``."""
    d_inner, H, P, N, G = ssm_dims(cfg)
    W = cfg.ssm_conv
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    dtype = cfg.dtype
    uniform = lambda n: torch.rand((n,), generator=gen, dtype=torch.float32,
                                   device=device)
    dt = torch.exp(uniform(H) * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    conv_w = torch.randn((W, conv_ch), generator=gen, dtype=torch.float32,
                         device=device) / math.sqrt(W)
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "A_log": torch.log(1.0 + uniform(H) * 15.0).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype, device),
    }


def mamba_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """The shape of each of one layer's ``MAMBA_PARAMS``."""
    d_inner, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {"in_proj": (cfg.d_model, 2 * d_inner + 2 * G * N + H),
            "conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,),
            "dt_bias": (H,), "A_log": (H,), "D": (H,), "norm": (d_inner,),
            "out_proj": (d_inner, cfg.d_model)}


def mamba_param_count(cfg) -> int:
    d_inner, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return (cfg.d_model * d_in_proj + cfg.ssm_conv * conv_ch + conv_ch +
            3 * H + d_inner + d_inner * cfg.d_model)


def mamba_cache_shapes(cfg, batch: int, m: int = 1) -> dict[str, tuple]:
    """(shape, dtype) of one layer's decode cache: the conv window of the
    last W-1 raw inputs in ``cfg.dtype`` and the fp32 SSD state; a rank's
    of a model tier of m: its heads' state and x channels, B and C's."""
    d_inner, H, P, N, G = ssm_dims(cfg, m)
    conv_ch = d_inner + 2 * G * N
    return {"conv": ((batch, cfg.ssm_conv - 1, conv_ch), cfg.dtype),
            "h": ((batch, H, N, P), torch.float32)}


# ---------------------------------------------------------------------------
# layer apply
# ---------------------------------------------------------------------------
def _causal_conv(u, w, b):
    """u (B,S,Ch), w (W,Ch), b (Ch,): depthwise causal conv of width W,
    ``lax.conv_general_dilated`` with left padding W-1 in the JAX package."""
    W, Ch = w.shape
    up = F.pad(u.transpose(1, 2), (W - 1, 0))        # (B,Ch,S+W-1)
    out = F.conv1d(up, w.t().unsqueeze(1), groups=Ch)
    return out.transpose(1, 2) + b


def _split_proj(dims, proj):
    d_inner, H, P, N, G = dims
    return torch.split(proj, [d_inner, d_inner + 2 * G * N, H], dim=-1)


def _gated_norm(y, z, scale, cfg, tp, train: bool):
    """rmsnorm(round(y) * silu(z)) with the differentiable form in
    training; on a model tier the split form, its statistic over the whole
    d_inner row (the tier's sum)."""
    if tp is None:
        return (rmsnorm_gated_train if train else rmsnorm_gated)(
            y, z, scale, eps=cfg.norm_eps)
    return (rmsnorm_gated_tier_train if train else rmsnorm_gated_tier)(
        y, z, scale, tp.tier, d_norm=ssm_dims(cfg)[0], eps=cfg.norm_eps)


def _out_proj(y, params, dt_, tp):
    """``y @ out_proj`` in ``dt_``; on a model rank its partial sum in
    fp32 (the product of the same ``dt_`` values), so that the tier's sum
    is rounded once, as one rank's product is."""
    w = params["out_proj"].to(dt_)
    return y @ w if tp is None else y.float() @ w.float()


def mamba_apply(params, x_in, cfg, *, cache=None, tp=None):
    """Mamba2 mixer, x_in (B,S,d_model) -> (out, new_cache).

    ``cache=None``: full sequence, no cache (train: the differentiable
    SSD scan and gated RMSNorm). ``cache={}``: prefill, returns the decode
    cache ``{"conv": (B,W-1,Ch), "h": (B,H,N,P)}``.
    A cache with those leaves and S == 1: one decode step, returns the
    updated cache (new tensors; the caller stores them).
    ``tp``: one rank of a model tier (module docstring); ``out`` is then
    its partial sum, in fp32.
    """
    dims = ssm_dims(cfg, 1 if tp is None else tp.m)
    d_inner, H, P, N, G = dims
    g_lo, g_hi = (0, G) if tp is None else tp.ssm_groups()
    W = cfg.ssm_conv
    dt_ = x_in.dtype
    f32 = torch.float32
    Bt, S, _ = x_in.shape

    proj = x_in @ params["in_proj"].to(dt_)
    z, xBC_raw, dt_raw = _split_proj(dims, proj)
    A = -torch.exp(params["A_log"].to(f32))
    D = params["D"].to(f32)

    if cache:
        if S != 1:
            raise ValueError(f"decode takes one token, got {S}")
        conv_cache = cache["conv"]
        window = torch.cat([conv_cache, xBC_raw.to(conv_cache.dtype)], 1)
        u = torch.einsum("bwc,wc->bc", window.to(f32),
                         params["conv_w"].to(f32))
        xBC_c = F.silu(u + params["conv_b"].to(f32))[:, None]
        x, Bs, Cs = torch.split(xBC_c, [d_inner, G * N, G * N], dim=-1)
        x = x.reshape(Bt, H, P)
        Bs = Bs.reshape(Bt, G, N)[:, g_lo:g_hi]
        Cs = Cs.reshape(Bt, G, N)[:, g_lo:g_hi]
        dtv = F.softplus(dt_raw[:, 0].to(f32) + params["dt_bias"].to(f32))
        Hg = H // (g_hi - g_lo)
        Bh = torch.repeat_interleave(Bs, Hg, dim=1)[:, :H]
        Ch = torch.repeat_interleave(Cs, Hg, dim=1)[:, :H]
        h = (torch.exp(dtv * A)[..., None, None] * cache["h"]
             + torch.einsum("bh,bhn,bhp->bhnp", dtv, Bh, x))
        y = torch.einsum("bhn,bhnp->bhp", Ch, h)
        y = y + D[None, :, None] * x
        y = _gated_norm(y.reshape(Bt, 1, d_inner), z, params["norm"], cfg,
                        tp, False)
        return _out_proj(y, params, dt_, tp), {"conv": window[:, 1:],
                                               "h": h}

    xBC = F.silu(_causal_conv(xBC_raw.to(dt_), params["conv_w"].to(dt_),
                              params["conv_b"].to(dt_)))
    x, Bs, Cs = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    x = x.reshape(Bt, S, H, P).contiguous()
    Bs = Bs.reshape(Bt, S, G, N)[:, :, g_lo:g_hi].contiguous()
    Cs = Cs.reshape(Bt, S, G, N)[:, :, g_lo:g_hi].contiguous()
    dtv = F.softplus(dt_raw.to(f32) + params["dt_bias"].to(f32)).contiguous()
    train = cache is None
    scan = ssd_ops.ssd_train if train else ssd_ops.ssd
    y, h_fin = scan(x, dtv, A.contiguous(), Bs, Cs,
                    Q=chunk_len(S, cfg.ssm_chunk))
    y = y + D[None, None, :, None] * x.to(f32)
    # rmsnorm(y.to(dt_) * silu(z)): one pass on the card (two over a tier)
    y = _gated_norm(y.reshape(Bt, S, d_inner), z, params["norm"], cfg, tp,
                    train)
    out = _out_proj(y, params, dt_, tp)

    if not train:          # prefill: conv window = last W-1 raw inputs
        pad = torch.zeros((Bt, max(0, W - 1 - S), xBC_raw.shape[-1]),
                          dtype=cfg.dtype, device=x_in.device)
        tail = xBC_raw[:, max(0, S - (W - 1)):].to(cfg.dtype)
        return out, {"conv": torch.cat([pad, tail], 1), "h": h_fin}
    return out, None
