"""The plain versions of the port's backward kernels (flash attention and
RMSNorm, plain and residual forms) and the autograd Functions around them,
on the CPU: against torch.autograd of the plain forward versions
(``attention_ref``, ``rmsnorm_ref``) and against ``jax.vjp`` of the JAX
package's ``multihead_attention`` and ``layers.rmsnorm`` on the same numpy
inputs. Tolerances: fp32 2e-5 absolute on gradients of O(1) (sums of up to
S products in another order; the JAX attention chunks its queries), bf16
2e-2 where the dtype is bf16 (one rounding of an fp32 result; 1.6e-2 is an
ulp at 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (B, S, H, KV, D, mask)
ATTN_CASES = [(2, 37, 4, 2, 32, dict(causal=True)),
              (1, 64, 6, 2, 64, dict(causal=True, window=16)),
              (1, 50, 4, 1, 32, dict(causal=True, chunk=16)),
              (2, 29, 3, 3, 32, dict(causal=False)),
              (1, 130, 8, 2, 128, dict(causal=True)),
              # the card's tensor-core tiles are 64 rows: lengths at their
              # edges and G = 8, so that the oracle the card is held to is
              # itself held against jax.vjp there
              (1, 64, 8, 1, 32, dict(causal=True)),
              (2, 65, 8, 1, 32, dict(causal=True, chunk=32)),
              (1, 129, 8, 1, 64, dict(causal=True, window=48)),
              # the dense variants: the softcap (gemma2's 50 and 30) with a
              # window, and h2o-danube's head dim 120
              (1, 90, 4, 2, 32, dict(causal=True, window=40, cap=50.0)),
              (2, 70, 4, 1, 120, dict(causal=True, window=24)),
              (1, 66, 4, 2, 120, dict(causal=True, cap=30.0)),
              # gemma2's head dim 256 at the 64-row edges, as the card's
              # two-warpgroup tensor-core pair takes it
              (1, 129, 4, 2, 256, dict(causal=True, window=64, cap=50.0)),
              (2, 65, 8, 1, 256, dict(causal=True, chunk=32)),
              (1, 64, 2, 2, 256, dict(causal=False))]


def _inputs(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, D), f(B, S, KV, D), f(B, S, KV, D), f(B, S, H, D)


def _close(a, b, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_backward_plain_matches_autograd(case, dtype):
    """``attention_bwd_ref`` on the forward's (o, lse), and the
    ``FlashAttention`` Function end to end, against autograd of
    ``attention_ref``; lse against logsumexp of the masked scores."""
    *dims, mask = case
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(*dims))
    o, lse = flash_ops.flash_attention_lse(q, k, v, **mask)
    assert torch.equal(o, flash_ops.attention_ref(q, k, v, **mask))
    got = flash_ops.attention_bwd_ref(q, k, v, o, do, lse, **mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_ops.attention_ref(*leaves, **mask),
                               leaves, do)
    train = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_ops.flash_attention_train(*train, **mask)
    assert torch.equal(out, o)
    fn = torch.autograd.grad(out, train, do)
    for a, b, c in zip(got, want, fn):
        assert a.dtype == dtype and torch.equal(a, c)
        _close(a.float(), b.float(), dtype)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_backward_plain_matches_jax_vjp(case):
    """The same gradients as ``jax.vjp`` of the JAX package's training
    attention (``multihead_attention``, plain jnp) in fp32."""
    *dims, mask = case
    q, k, v, do = _inputs(*dims)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = flash_ops.flash_attention_lse(*t[:3], **mask)
    got = flash_ops.attention_bwd_ref(*t[:3], o, t[3], lse, **mask)
    jo, vjp = jax.vjp(lambda a, b, c: jattention.multihead_attention(
        a, b, c, **mask), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    _close(o.numpy(), jo, torch.float32)
    for a, b in zip(got, want):
        _close(a.numpy(), b, torch.float32)


def test_flash_train_refuses_a_softcap():
    """The refusal this test held (no softcap in the flash backward) is
    lifted: ``flash_attention_train`` with a cap and a window, at D = 32
    and at 120, gives autograd's gradients of the capped
    ``attention_ref``."""
    for dims in ((1, 40, 2, 1, 32), (1, 30, 4, 2, 120)):
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(*dims))
        mask = dict(causal=True, window=20, cap=30.0)
        train = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(
            flash_ops.flash_attention_train(*train, **mask), train, do)
        ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(flash_ops.attention_ref(*ref, **mask),
                                   ref, do)
        for a, b in zip(got, want):
            _close(a, b, torch.float32)


RMS_SHAPES = [(4, 7, 64), (33, 128), (3, 3072)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_backward_plain_matches_autograd(shape, dtype):
    """``rmsnorm_bwd_ref`` (plain and with the residual sum's gradient) and
    both Functions, against autograd of ``rmsnorm_ref`` and of the eager
    add before it."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype)
    x, delta, dy, ds = f(*shape), f(*shape), f(*shape), f(*shape)
    sc = (f(shape[-1]).float() * 0.2).to(dtype)
    dx, dsc = rms_ops.rmsnorm_bwd_ref(x, sc, dy)
    lx, ls = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
    want = torch.autograd.grad(rms_ops.rmsnorm_ref(lx, ls), (lx, ls), dy)
    fx, fs = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
    fn = torch.autograd.grad(rms_ops.rmsnorm_train(fx, fs), (fx, fs), dy)
    for a, b, c in zip((dx, dsc), want, fn):
        assert a.dtype == dtype and torch.equal(a, c)
        _close(a.float(), b.float(), dtype)
    # the residual form: s = x + delta, then the norm; ds flows into both
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, sc)]
    s, y = rms_ops.rmsnorm_residual_ref(*leaves)
    want = torch.autograd.grad((s, y), leaves, (ds, dy))
    fl = [t.clone().requires_grad_(True) for t in (x, delta, sc)]
    fn = torch.autograd.grad(rms_ops.rmsnorm_residual_train(*fl), fl,
                             (ds, dy))
    ref_dx, ref_dsc = rms_ops.rmsnorm_bwd_ref(x + delta, sc, dy, ds=ds)
    for a, b in zip(fn, want):
        _close(a.float(), b.float(), dtype)
    assert torch.equal(fn[0], ref_dx) and torch.equal(fn[1], ref_dx)
    assert torch.equal(fn[2], ref_dsc)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_backward_plain_matches_jax_vjp(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    sc = (rng.standard_normal(shape[-1]) * 0.2).astype(np.float32)
    dx, dsc = rms_ops.rmsnorm_bwd_ref(torch.from_numpy(x),
                                      torch.from_numpy(sc),
                                      torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, s: jlayers.rmsnorm({"scale": s}, a),
                     jnp.asarray(x), jnp.asarray(sc))
    jdx, jdsc = vjp(jnp.asarray(dy))
    _close(dx.numpy(), jdx, torch.float32)
    np.testing.assert_allclose(dsc.numpy(), np.asarray(jdsc), rtol=2e-5,
                               atol=1e-4)


def test_flash_backward_instance_is_picked_by_dtype_and_head_dim():
    """On the card bf16 runs the tensor-core pair at every head dim (at
    D = 256 its two-warpgroup form), fp32 the CUDA-core pair at every head
    dim; the backward takes every head dim the forward takes."""
    pick = flash_ops.bwd_on_tensor_cores
    assert all(pick(torch.bfloat16, d) for d in (32, 64, 120, 128, 256))
    assert not any(pick(torch.float32, d) for d in (32, 64, 120, 128, 256))
    assert flash_ops.BWD_HEAD_DIMS == flash_ops.HEAD_DIMS
