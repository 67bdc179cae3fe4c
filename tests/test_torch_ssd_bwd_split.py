"""The SSD backward kernel's tensor-core arithmetic, emulated in torch on
the CPU.

``csrc/ssd_bwd.cu`` runs every product of the chunked backward as bf16
tensor-core products with fp32 sums, in 64-token chunks, in four launches:
the scans over the chunks (the state before each chunk, h, and the
gradient of the state after it, Dh), the per-group gradients (dB, dC summed
over the group's heads, with each head's C_i . (dy h^T)_i and <Dh, h>), the
per-head ones (dx, ddt, dA's shares) and dA's sum, which takes no product.
The per-group kernel splits a group's heads over the blocks of a cluster
(at most 8) and sums G (G^T) over a block's heads in fp32 before its one
product with B (C). bf16 inputs
(x, B, C) enter exactly; every fp32 operand (dy, h, Dh, M, G, the scaled
w x and exp(cum) dy of the scans, and x, B, C on the fp32 path) is split
into hi = bf16(v) and lo = bf16(v - hi), and a product takes hi*b + lo*b
(one split operand) or hi*hi + hi*lo + lo*hi (two), with the helpers of
``test_torch_ssd_split``. This file computes the kernel's products in that
form, as the kernel orders them, and holds dx, ddt, dA, dB and dC (fp32,
before any bf16 rounding of the outputs) to the card tests' limits
``SSD_BWD_REL`` against the plain backward ``ssd_bwd_ref``; with single
bf16 products (no lo terms) they miss them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd.checks import BWD_REL as SSD_BWD_REL
from repro_torch.kernels.ssd.ref import ssd_bwd_ref
from test_torch_ssd_split import CHUNK, _inputs, _mm, _split, _t


def ssd_bwd_split_emulation(x, dt, A, B, C, dy, *, lo=True):
    """(dx, ddt, dA, dB, dC) in fp32 as the kernel computes them; ``lo=False``
    drops the lo terms of every split operand (single bf16 products)."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Hg = H // G
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S
    exact = x.dtype == torch.bfloat16
    ins = (lambda t: (t, None)) if exact else (lambda t: _split(t, lo))
    sp = lambda t: _split(t, lo)

    def chunks(t, heads):
        """(Bt, S, K, X) -> (Bt, nc, K, 64, X), zero rows past S."""
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(Bt, nc, CHUNK, heads, -1).permute(0, 1, 3, 2, 4)

    xc, dyc = chunks(x, H), chunks(dy, H)                  # (Bt,nc,H,64,P)
    Bg, Cg = chunks(B, G), chunks(C, G)                    # (Bt,nc,G,64,N)
    Bh, Ch_ = (t.repeat_interleave(Hg, 2) for t in (Bg, Cg))
    dtc = chunks(dt[..., None], H)[..., 0]                 # (Bt,nc,H,64)
    cum = torch.cumsum(dtc * A[:, None], -1)
    seg = cum[..., -1]
    ecum, wp = torch.exp(cum), torch.exp(seg[..., None] - cum)
    w = wp * dtc
    causal = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool))
    # E[i, j] = exp(cum_i - cum_j) on and below the diagonal
    diff = cum[..., :, None] - cum[..., None, :]
    E = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    xp, Bp, Cp = ins(xc), ins(Bh), ins(Ch_)

    # ---- launch 1: the chunks' contributions and the scans over chunks ----
    Hc = _mm(_t(Bp), sp(w[..., None] * xc))                # B^T (w x)
    Dc = _mm(_t(Cp), sp(ecum[..., None] * dyc))            # C^T (e^cum dy)
    eseg = torch.exp(seg)[..., None, None]
    h = torch.zeros_like(Hc)                               # state before c
    Dh = torch.zeros_like(Dc)                              # grad after c
    for c in range(1, nc):
        h[:, c] = eseg[:, c - 1] * h[:, c - 1] + Hc[:, c - 1]
    for c in range(nc - 2, -1, -1):
        Dh[:, c] = eseg[:, c + 1] * Dh[:, c + 1] + Dc[:, c + 1]

    # ---- launch 2: per group, the heads summed as one product's K ----
    dyp = sp(dyc)
    D = _mm(dyp, _t(xp))                                   # D[i, j]
    Gm = D * E * dtc[..., None, :]
    T = _mm(dyp, _t(sp(h)))                                # dy h^T
    Et = E.transpose(-1, -2)
    Dt = _mm(xp, _t(dyp))                                  # D^T[j, i]
    Gt = Dt * Et * dtc[..., :, None]
    grp = lambda t: t.reshape(Bt, nc, G, Hg, *t.shape[-2:]).sum(3)
    # a cluster of min(8, Hg) blocks, ceil(Hg / blocks) heads a block: G
    # summed over a block's heads, then one product a block
    per = -(-Hg // min(8, Hg))
    blocks = lambda t: [t.reshape(Bt, nc, G, Hg, CHUNK, CHUNK)[:, :, :,
                                                               k:k + per]
                        .sum(3) for k in range(0, Hg, per)]
    Bgp, Cgp = ins(Bg), ins(Cg)
    dC = grp(ecum[..., None] * T) + sum(_mm(sp(g), Bgp) for g in blocks(Gm))
    dB = (grp(w[..., None] * _mm(xp, _t(sp(Dh))))
          + sum(_mm(sp(g), Cgp) for g in blocks(Gt)))
    inter = ecum * (Ch_ * T).sum(-1)                       # C_i . (dy h^T)_i
    planes = lambda t: sum(q for q in sp(t) if q is not None)   # as stored
    hd = (planes(Dh) * planes(h)).sum((-1, -2))

    # ---- launch 3: per head (rows j of the transposed products) ----
    St = _mm(Bp, _t(Cp))                                   # S^T[j, i]
    gs = Gt * St
    colsum, rowsum = gs.sum(-1), gs.sum(-2)                # by j, by i
    MTdy = _mm(sp(St * Et), dyp)                           # M^T dy
    U = _mm(Bp, sp(Dh))                                    # B Dh
    v = MTdy + wp[..., None] * U
    dx = dtc[..., None] * v
    bsum = (xc * U).sum(-1)
    dsum = (xc * v).sum(-1)
    dcum = rowsum - colsum + inter - w * bsum
    dcum[..., -1] += torch.exp(seg) * hd + (w * bsum).sum(-1)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = A[:, None] * dda + dsum
    dA = (dtc * dda).sum((0, 1, 3))

    def tokens(t):
        """(Bt, nc, K, 64, X) -> (Bt, S, K, X)."""
        return t.permute(0, 1, 3, 2, 4).reshape(Bt, nc * CHUNK, t.shape[2],
                                                -1)[:, :S]

    return (tokens(dx), tokens(ddt[..., None])[..., 0], dA, tokens(dB),
            tokens(dC))


def _dy(shape, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _errors(ins, dy, lo=True):
    got = ssd_bwd_split_emulation(*ins, dy, lo=lo)
    up = [t.float() for t in ins]
    want = ssd_bwd_ref(*up, dy, Q=256)
    return {n: float((a - b).abs().max()) / float(b.abs().max())
            for n, a, b in zip(SSD_BWD_REL, got, want)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [512, 300])
def test_split_backward_holds_the_limits_at_mamba2_widths(dtype, S):
    ins = _inputs(S, 48, 64, 1, 128, dtype)
    errs = _errors(ins, _dy((1, S, 48, 64)))
    assert all(errs[n] < SSD_BWD_REL[n] for n in errs), errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_backward_holds_them_with_groups_and_a_small_state(dtype):
    ins = _inputs(200, 8, 64, 2, 64, dtype, seed=2)
    errs = _errors(ins, _dy((1, 200, 8, 64), seed=3))
    assert all(errs[n] < SSD_BWD_REL[n] for n in errs), errs


def test_single_bf16_products_would_miss_the_limits():
    ins = _inputs(512, 48, 64, 1, 128, torch.bfloat16)
    errs = _errors(ins, _dy((1, 512, 48, 64)), lo=False)
    assert any(errs[n] > SSD_BWD_REL[n] for n in errs), errs
