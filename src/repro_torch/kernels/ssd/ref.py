"""Plain PyTorch chunked SSD: the oracle of ``csrc/ssd.cu``.

``ssd_chunked`` is the JAX package's ``models.ssm.ssd_chunked`` in torch,
both of its precisions: ``precise=True`` is fp32 throughout (what the
Pallas kernel ``ssd_pallas`` computes), ``precise=False`` keeps the
mixed-precision data path of the JAX model (bf16 (…,P)/(…,N)-scale tensors
and dual-form products, an fp32 scalar path and state carry), with the
same casts at the same places so each precision can be held against JAX.
``ssd_ref`` is the precise one, the plain version of the kernel;
``ssd_bwd_ref``, its autograd backward, is the plain version of the
backward kernel (``csrc/ssd_bwd.cu``).
"""
from __future__ import annotations

import torch


def chunk_len(S: int, Q: int) -> int:
    """The chunk length ``ssd_pallas`` and ``mamba_apply`` use for S tokens
    asked to run in chunks of Q: ``min(Q, S)``, or S when that does not
    divide S."""
    q = min(Q, S)
    return S if S % q else q


def ssd_chunked(x, dt, A, B, C, Q: int, *, precise: bool = False):
    """x (Bt,S,H,P), dt (Bt,S,H), A (H,), B/C (Bt,S,G,N); Q divides S.

    Returns (y (Bt,S,H,P) fp32, h_final (Bt,H,N,P) fp32). Within a chunk of
    Q tokens the quadratic (dual) form; across chunks a sequential loop
    carries the fp32 state from zero (the JAX function's ``h0`` argument
    has no caller on the serving path and is not ported).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Hg = H // G
    nc = S // Q
    assert nc * Q == S, f"seq {S} not divisible by chunk {Q}"
    f32 = torch.float32
    lo = f32 if precise else torch.bfloat16
    xc = x.reshape(Bt, nc, Q, H, P).to(lo)
    dtc = dt.reshape(Bt, nc, Q, H).to(f32)
    Bc = B.reshape(Bt, nc, Q, G, N).to(lo)
    Cc = C.reshape(Bt, nc, Q, G, N).to(lo)

    da = dtc * A.to(f32)                             # (Bt,nc,Q,H), negative
    cum = torch.cumsum(da, dim=2)                    # within-chunk cumulative
    seg_end = cum[:, :, -1]                          # (Bt,nc,H)

    def to_heads(t, dim):
        """Repeat each group Hg times along ``dim`` (the group axis)."""
        if G == 1:
            shape = list(t.shape)
            shape[dim] = H
            return t.expand(shape)
        return torch.repeat_interleave(t, Hg, dim=dim)

    # --- intra-chunk (dual quadratic form) --------------------------------
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)  # (Bt,nc,G,Q,Q)
    CBh = to_heads(CB, 2)
    cum_h = cum.transpose(2, 3)                      # (Bt,nc,H,Q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    # exp only where j <= i: above the diagonal cum_i - cum_j > 0 can overflow
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                        0.0)
    dtx = dtc.to(lo)[..., None] * xc                 # (Bt,nc,Q,H,P)
    L = CBh * decay.to(lo)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", L, dtx)

    # --- chunk states -------------------------------------------------------
    dec_to_end = torch.exp(seg_end[:, :, None] - cum)  # (Bt,nc,Q,H)
    Bh = to_heads(Bc, 3)
    S_c = torch.einsum("bcjh,bcjhn,bcjhp->bchnp",
                       (dec_to_end * dtc).to(lo), Bh, xc)

    # --- inter-chunk recurrence (fp32 carry: exact state) --------------------
    h = torch.zeros((Bt, H, N, P), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                             # state BEFORE chunk c
        h = torch.exp(seg_end[:, c])[..., None, None] * h + S_c[:, c].to(f32)
    h_prev = torch.stack(h_prev, 1)                  # (Bt,nc,H,N,P)

    Ch = to_heads(Cc, 3)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           torch.exp(cum).to(lo)[..., None] * Ch,
                           h_prev.to(lo))

    y = (y_intra.to(f32) + y_inter.to(f32)).reshape(Bt, S, H, P)
    return y, h


def ssd_ref(x, dt, A, B, C, *, Q: int = 256):
    """The chunked SSD in full fp32, as the kernel computes it; any S (the
    chunk length follows :func:`chunk_len`)."""
    return ssd_chunked(x, dt, A, B, C, chunk_len(x.shape[1], Q),
                       precise=True)


def ssd_bwd_ref(x, dt, A, B, C, dy, *, Q: int = 256):
    """(dx, ddt, dA, dB, dC) of ``ssd_ref``'s y for the output gradient dy
    (Bt,S,H,P) fp32: ``torch.autograd.grad`` through the fp32 chunked form,
    each gradient in its input's dtype (the final state takes no
    gradient: training does not use it)."""
    ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        y, _ = ssd_ref(*ins, Q=Q)
        return torch.autograd.grad(y, ins, dy)
