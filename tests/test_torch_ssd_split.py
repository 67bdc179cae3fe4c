"""The SSD kernel's tensor-core arithmetic, emulated in torch on the CPU.

``csrc/ssd.cu`` runs its four products per 64-token chunk (the score
C B^T, L x, C h and B^T (w x)) as bf16 tensor-core products with fp32
sums. bf16 inputs enter them exactly as they are; every fp32 operand (L,
h, w x, and on the fp32-input path C, B and x as well) is split into
hi = bf16(v) and lo = bf16(v - hi), and a product takes hi*b + lo*b (one
split operand) or hi*hi + hi*lo + lo*hi (two). This file computes the same
split products with fp32 matmuls of the bf16-valued parts (the products of
bf16 values are exact in fp32) and holds the result to the kernel's
tolerance against the plain version ``ssd_ref``, max |y - y_ref| /
max |y_ref| < 1e-4 and the same for the final state, at the mamba2-780m
widths (H = 48, N = 128, P = 64, G = 1) and at a ragged S; without the lo
terms the products miss that tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd.ref import ssd_ref

CHUNK = 64
REL_TOL = 1e-4


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split(t, lo=True):
    hi = _bf(t)
    return hi, (_bf(t - hi) if lo else None)


def _mm(a, b):
    """The products the kernel issues for a = (hi, lo) and b = (hi, lo),
    lo None for an operand that enters exactly: hi*hi (+ hi*lo) (+ lo*hi)."""
    out = a[0] @ b[0]
    if b[1] is not None:
        out = out + a[0] @ b[1]
    if a[1] is not None:
        out = out + a[1] @ b[0]
    return out


def _t(parts):
    return tuple(None if p is None else p.transpose(-1, -2) for p in parts)


def ssd_split_emulation(x, dt, A, B, C, *, lo=True):
    """(y, h_final) as the kernel computes them; ``lo=False`` drops the lo
    terms of the fp32 operands (single bf16 products)."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    exact = x.dtype == torch.bfloat16
    parts = (lambda t: (t, None)) if exact else (lambda t: _split(t, lo))
    h = torch.zeros((Bt, H, N, P))
    y = torch.empty((Bt, S, H, P))
    causal = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool))
    for s0 in range(0, S, CHUNK):
        n = min(CHUNK, S - s0)
        pad = lambda t: torch.nn.functional.pad(
            t[:, s0:s0 + n].float(), (0, 0) * (t.ndim - 2) + (0, CHUNK - n))
        xc = pad(x).transpose(1, 2)                          # (Bt,H,64,P)
        Bc = pad(B).transpose(1, 2).repeat_interleave(H // G, 1)
        Cc = pad(C).transpose(1, 2).repeat_interleave(H // G, 1)
        dtc = pad(dt).transpose(1, 2)                        # (Bt,H,64)
        cum = torch.cumsum(dtc * A[:, None], -1)
        seg = cum[..., -1:]
        Cp, Bp, xp = parts(Cc), parts(Bc), parts(xc)
        score = _mm(Cp, _t(Bp))
        diff = cum[..., :, None] - cum[..., None, :]
        decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                            0.0)
        L = score * decay * dtc[..., None, :]
        yc = (_mm(_split(L, lo), xp)
              + torch.exp(cum)[..., None] * _mm(Cp, _split(h, lo)))
        y[:, s0:s0 + n] = yc[:, :, :n].transpose(1, 2)
        xr = xp[0] if xp[1] is None else xp[0] + xp[1]       # x as staged
        wx = (torch.exp(seg - cum) * dtc)[..., None] * xr
        h = torch.exp(seg)[..., None] * h + _mm(_t(Bp), _split(wx, lo))
    return y, h


def _inputs(S, H, P, G, N, dtype, seed=0):
    """The model's statistics (``chip_smoke.ssd_inputs``), from numpy."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    dt0 = np.exp(rng.random(H) * (np.log(0.1) - np.log(0.001))
                 + np.log(0.001))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = t(np.log1p(np.exp(rng.standard_normal((1, S, H)) * 0.5 + dt_bias)))
    A = t(-np.exp(np.log(1.0 + rng.random(H) * 15.0)))
    x = t(rng.standard_normal((1, S, H, P))).to(dtype)
    B = (t(rng.standard_normal((1, S, G, N))) * 0.5).to(dtype)
    C = (t(rng.standard_normal((1, S, G, N))) * 0.5).to(dtype)
    return x, dt, A, B, C


def _rel(out, ref):
    return float((out - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [512, 300])
def test_split_products_hold_the_tolerance_at_mamba2_widths(dtype, S):
    ins = _inputs(S, 48, 64, 1, 128, dtype)
    y, h = ssd_split_emulation(*ins)
    ry, rh = ssd_ref(*ins, Q=256)
    assert _rel(y, ry) < REL_TOL and _rel(h, rh) < REL_TOL


def test_split_products_hold_it_with_groups_and_a_small_state():
    ins = _inputs(130, 6, 64, 2, 64, torch.float32, seed=1)
    y, h = ssd_split_emulation(*ins)
    ry, rh = ssd_ref(*ins, Q=256)
    assert _rel(y, ry) < REL_TOL and _rel(h, rh) < REL_TOL


def test_single_bf16_products_would_miss_it():
    ins = _inputs(512, 48, 64, 1, 128, torch.bfloat16)
    y, h = ssd_split_emulation(*ins, lo=False)
    ry, rh = ssd_ref(*ins, Q=256)
    assert max(_rel(y, ry), _rel(h, rh)) > REL_TOL
