"""The port's kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) and oracles, on the CPU: fp32, atol = rtol = 1e-5.
The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.decode_stats.ref import decode_stats_accumulate_ref
from repro.kernels.decode_stats.stats import decode_stats_accumulate_pallas
from repro.kernels.flash_attention.flash import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jrmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas
from repro.models import layers as jlayers
from repro.models.attention import decode_stats_scores as jscores
from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as tattention

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (5, 100)])
def test_rmsnorm_plain_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32) * 3
    sc = rng.standard_normal(shape[-1], dtype=np.float32) * 0.2
    pallas = rmsnorm_pallas(jnp.asarray(x), jnp.asarray(sc), interpret=True)
    ref = jrmsnorm_ref(jnp.asarray(x), jnp.asarray(sc))
    out = rms_ops.rmsnorm(_t(x), _t(sc)).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 3072), (3, 5, 128), (4, 37)])
def test_rmsnorm_fused_forms_plain_versions_are_the_eager_ops(dtype, shape):
    rng = np.random.default_rng(1)
    rn = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    x, delta = (rn(*shape) * 3).to(dtype), rn(*shape).to(dtype)
    y, z, sc = rn(*shape), (rn(*shape) * 2).to(dtype), (rn(shape[-1]) * 0.2
                                                         ).to(dtype)
    before = (rms_ops.LAUNCHES, dict(rms_ops.FORM_LAUNCHES))
    s, out = rms_ops.rmsnorm_residual(x, delta, sc)
    eager = x + delta                      # the decoder layer before ln2
    assert s.dtype == dtype and torch.equal(s, eager)
    assert torch.equal(out, rms_ops.rmsnorm(eager, sc))
    gated = rms_ops.rmsnorm_gated(y, z, sc)
    eager = rms_ops.rmsnorm((y.to(dtype) * F.silu(z)).contiguous(), sc)
    assert gated.dtype == dtype and torch.equal(gated, eager)
    assert (rms_ops.LAUNCHES, rms_ops.FORM_LAUNCHES) == before


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (5, 100)])
def test_rmsnorm_fused_forms_match_jax(shape):
    rng = np.random.default_rng(2)
    x, delta, y, z = (rng.standard_normal(shape, dtype=np.float32) * k
                      for k in (3, 1, 2, 2))
    sc = rng.standard_normal(shape[-1], dtype=np.float32) * 0.2
    jparams = {"scale": jnp.asarray(sc)}
    s, out = rms_ops.rmsnorm_residual(_t(x), _t(delta), _t(sc))
    np.testing.assert_allclose(s.numpy(), x + delta, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jlayers.rmsnorm(
        jparams, jnp.asarray(x) + jnp.asarray(delta))), **TOL)
    gated = rms_ops.rmsnorm_gated(_t(y), _t(z), _t(sc))
    np.testing.assert_allclose(gated.numpy(), np.asarray(jlayers.rmsnorm(
        jparams, jnp.asarray(y) * jax.nn.silu(jnp.asarray(z)))), **TOL)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (B, S, T, H, KV, D, mask)
    (2, 64, 64, 4, 2, 32, dict(causal=True)),
    (1, 48, 48, 4, 4, 32, dict(causal=False)),
    (1, 64, 64, 6, 2, 64, dict(causal=True, window=16)),
    (1, 64, 64, 4, 1, 32, dict(causal=True, chunk=16)),
    (1, 40, 40, 4, 2, 32, dict(causal=True, cap=30.0)),
    (1, 37, 37, 4, 2, 32, dict(causal=True, window=8, cap=50.0)),
    (2, 23, 41, 8, 2, 32, dict(causal=False)),          # ragged S != T
    (1, 29, 29, 3, 1, 64, dict(causal=True)),           # GQA G=3, odd S
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, S, T, H, KV, D, mask = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jflash(jq, jk, jv, block_q=16, block_k=16, interpret=True, **mask)
    ref = jattention_ref(jq, jk, jv, **mask)
    out = flash_ops.flash_attention(_t(q), _t(k), _t(v), **mask).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# Decode stats
# ---------------------------------------------------------------------------
def _decode_inputs(seed, B, H, KV, D, L, pos, **kw):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    k = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    s, _ = jscores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), **kw)
    m = jnp.max(s, axis=-1)
    return np.array(s), np.array(m), v


@pytest.mark.parametrize("pos,kw", [
    (np.int32(17), {}),                                 # scalar position
    (np.array([0, 30, 63], np.int32), {}),              # per-row positions
    (np.array([5, 40, 12], np.int32), dict(window=16)),
    (np.int32(3), dict(slot_offset=64, total_len=128)),  # all rows masked
])
def test_decode_stats_plain_matches_pallas(pos, kw):
    s, m, v = _decode_inputs(2, 3, 6, 2, 32, 64, pos, **kw)
    po, pl = decode_stats_accumulate_pallas(jnp.asarray(s), jnp.asarray(m),
                                            jnp.asarray(v), block_k=16,
                                            interpret=True)
    ro, rl = decode_stats_accumulate_ref(jnp.asarray(s), jnp.asarray(m),
                                         jnp.asarray(v))
    o, l = stats_ops.accumulate(_t(s), _t(m), _t(v))
    for ours, theirs in ((o, po), (l, pl), (o, ro), (l, rl)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    if kw.get("slot_offset"):           # fully masked: exact zeros, not 1s
        assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0.0


def test_decode_stats_fully_masked_row_gives_zeros():
    """Row 1 of s masked entirely (m = NEG_INF): p = 0 there, not
    exp(0) = 1, so o = l = 0; the other row is unaffected."""
    s, m, v = _decode_inputs(4, 2, 4, 2, 32, 16, np.array([7, 9], np.int32))
    s[1] = tattention.NEG_INF
    m = s.max(-1)
    o, l = stats_ops.accumulate(_t(s), _t(m), _t(v))
    assert float(l[1].abs().max()) == 0.0 and float(o[1].abs().max()) == 0.0
    ro, rl = decode_stats_accumulate_ref(jnp.asarray(s), jnp.asarray(m),
                                         jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), **TOL)
