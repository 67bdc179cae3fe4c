"""The port's Mamba2 mixer and SSD plain version against the JAX package's,
on the CPU, fp32 inputs made with numpy.

Tolerances:
* ``ssd_chunked(precise=True)``: max |y - y_jax| / max |y_jax| < 1e-5 and
  the same for h (fp32 in both, summed in another order);
* ``ssd_chunked(precise=False)``: 2e-2 of the same relative error, a few
  bf16 roundings (one bf16 ulp is 2^-8 = 3.9e-3 relative), since both
  round the same tensors to bf16 but contract the products in another
  order;
* ``ssd_ref`` against ``ssd_pallas(interpret=True)``: the tolerances of
  ``tests/test_kernels.py::test_ssd_kernel`` (y relative 1e-5, h 1e-4);
* ``mamba_apply`` against the JAX one with its ``ssd_chunked`` made precise
  (the port's kernel computes the precise function): 1e-5 absolute and
  relative on outputs and caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.kernels.ssd.ssd import ssd_pallas
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import chunk_len, ssd_ref
from repro_torch.models import ssm, transformer

# (Bt, S, H, P, G, N): the grid of tests/test_kernels.py::test_ssd_kernel
DIMS = [(2, 128, 4, 16, 1, 32), (1, 64, 2, 8, 2, 16), (2, 96, 6, 32, 3, 8)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, Bt, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(size=H)).astype(np.float32)
    B = (rng.standard_normal((Bt, S, G, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bt, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _rel(out, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max()) / (
        float(np.abs(ref).max()) + 1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("precise,tol", [(True, 1e-5), (False, 2e-2)])
@pytest.mark.parametrize("q", [16, 32, "S"])
@pytest.mark.parametrize("dims", DIMS)
def test_ssd_chunked_matches_jax(dims, q, precise, tol):
    ins = _inputs(0, *dims)
    Q = dims[1] if q == "S" else q
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, ins), Q, precise=precise)
    y, h = ssm.ssd_chunked(*map(_t, ins), Q, precise=precise)
    assert y.dtype == h.dtype == torch.float32
    assert _rel(y.numpy(), jy) < tol
    assert _rel(h.numpy(), jh) < tol


@pytest.mark.parametrize("dims", DIMS)
def test_ssd_ref_matches_pallas_interpret(dims):
    ins = _inputs(1, *dims)
    py, ph = ssd_pallas(*map(jnp.asarray, ins), Q=32, interpret=True)
    ry, rh = jssd_ref(*map(jnp.asarray, ins), Q=32)
    for Q in (32, 1000):           # 1000: one chunk of S, as min(Q, S) gives
        y, h = ssd_ref(*map(_t, ins), Q=Q)
        assert _rel(y.numpy(), py) < 1e-5 and _rel(y.numpy(), ry) < 1e-5
        assert float(np.abs(h.numpy() - np.asarray(ph)).max()) < 1e-4
        assert float(np.abs(h.numpy() - np.asarray(rh)).max()) < 1e-4


def test_ssd_ops_cpu_route_is_the_plain_version_for_ragged_s():
    """S = 40 with Q = 32: one chunk of 40, as ``ssd_pallas`` and
    ``mamba_apply`` chunk it; no launch is counted on the CPU."""
    ins = [_t(a) for a in _inputs(2, 1, 40, 2, 16, 1, 16)]
    before = ssd_ops.LAUNCHES
    y, h = ssd_ops.ssd(*ins, Q=32)
    assert ssd_ops.LAUNCHES == before
    assert chunk_len(40, 32) == 40 and chunk_len(64, 32) == 32
    assert chunk_len(20, 32) == 20
    ry, rh = ssm.ssd_chunked(*ins, 40, precise=True)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    jy, _ = ssd_pallas(*(jnp.asarray(t.numpy()) for t in ins), Q=32,
                       interpret=True)
    assert _rel(y.numpy(), jy) < 1e-5


def test_ssd_chunk_invariance_of_the_plain_version():
    """The chunked scan is exact algebra: any chunk length gives the same
    function (the property the kernel's own 64-token chunks rely on), at
    the 1e-4 of tests/test_kernels.py::test_ssd_chunk_invariance."""
    ins = [_t(a) for a in _inputs(3, 1, 128, 2, 8, 1, 16)]
    outs = [ssd_ref(*ins, Q=q) for q in (16, 32, 64, 128)]
    for y, h in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(h, outs[0][1], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# mamba_apply against the JAX mixer
# ---------------------------------------------------------------------------
@pytest.fixture
def precise_jax(monkeypatch):
    """The JAX mixer with ``ssd_chunked(precise=True)``, the function the
    port's kernel computes (this test process only)."""
    calls = []

    def patched(*a, **kw):
        calls.append(1)
        return _JAX_SSD(*a, **{**kw, "precise": True})

    monkeypatch.setattr(jssm, "ssd_chunked", patched)
    return calls


_JAX_SSD = jssm.ssd_chunked


def _mixer_pair(seed=0, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-780m"),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.get_smoke("mamba2-780m"),
                               dtype=torch.float32, **over)
    jp = jax.tree.map(np.asarray,
                      jssm.mamba_init(jax.random.PRNGKey(seed), jcfg))
    tp = {"norm": _t(jp["norm"]["scale"]),
          **{n: _t(jp[n]) for n in ssm.MAMBA_PARAMS if n != "norm"}}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S,groups", [(64, 1), (40, 1), (2, 1), (48, 2)])
def test_mamba_apply_prefill_and_decode_match_jax(precise_jax, S, groups):
    """Prefill (S = 64: two chunks of 32; S = 40: one chunk of 40; S = 2:
    shorter than the conv window; G = 2 groups), then 3 decode steps:
    outputs, the conv window and the state against the JAX mixer."""
    jcfg, tcfg, jp, tp = _mixer_pair(ssm_ngroups=groups)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, tcfg.d_model), dtype=np.float32)
    jout, jc = jssm.mamba_apply(jp, jnp.asarray(x), jcfg, cache={})
    out, c = ssm.mamba_apply(tp, _t(x), tcfg, cache={})
    assert precise_jax, "the JAX mixer did not call the patched ssd_chunked"
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("conv", "h"):
        assert tuple(c[name].shape) == jc[name].shape
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    for step in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jout, jc = jssm.mamba_apply(jp, jnp.asarray(xt), jcfg, cache=jc)
        out, c = ssm.mamba_apply(tp, _t(xt), tcfg, cache=c)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]),
                                       **TOL)


def test_mamba_train_mode_and_param_count_match_jax(precise_jax):
    jcfg, tcfg, jp, tp = _mixer_pair(seed=1)
    x = np.random.default_rng(5).standard_normal((1, 32, tcfg.d_model),
                                                 dtype=np.float32)
    jout, jc = jssm.mamba_apply(jp, jnp.asarray(x), jcfg)
    out, c = ssm.mamba_apply(tp, _t(x), tcfg)
    assert c is None and jc is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for cfg_name in ("mamba2-780m",):
        jc_, tc_ = jconfigs.get(cfg_name), configs.get(cfg_name)
        assert ssm.mamba_param_count(tc_) == jssm.mamba_param_count(jc_)
        assert ssm.ssm_dims(tc_) == jssm._dims(jc_) == (3072, 48, 64, 128, 1)
    for name, (shape, dtype) in ssm.mamba_cache_shapes(tcfg, 3).items():
        spec = jssm.mamba_cache_specs(jcfg, 3)[name]
        assert shape == spec.shape
        assert str(dtype).split(".")[-1] == str(spec.dtype)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    ref = jssm._causal_conv(*map(jnp.asarray, (u, w, b)))
    out = ssm._causal_conv(*map(_t, (u, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mamba_init_distributions():
    cfg = configs.get_smoke("mamba2-780m")
    p = ssm.mamba_init(torch.Generator().manual_seed(0), cfg, "cpu")
    d_inner, H, P, N, G = ssm.ssm_dims(cfg)
    assert p["in_proj"].shape == (cfg.d_model, 2 * d_inner + 2 * G * N + H)
    assert p["conv_w"].shape == (cfg.ssm_conv, d_inner + 2 * G * N)
    dt = torch.nn.functional.softplus(p["dt_bias"].float())
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    A = torch.exp(p["A_log"].float())
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0
    assert torch.equal(p["D"], torch.ones(H, dtype=cfg.dtype))
    assert float(p["norm"].abs().max()) == 0.0
    assert all(t.dtype == cfg.dtype for t in p.values())


def test_one_token_prompt_prefills():
    """A prompt of one token: the JAX forward raises (its mixer takes the
    decode branch of an empty prefill cache, ``KeyError: 'conv'``); the
    port prefills it. Its logits equal the JAX train-mode logits of the
    same token."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-780m"),
                               n_layers=2, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("mamba2-780m"),
                               n_layers=2, dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    model = transformer.Transformer(
        tcfg, transformer.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg), "cpu")
    tok = np.array([[7]], np.int32)
    with pytest.raises(KeyError):
        jtransformer.forward(jparams, jcfg, jnp.asarray(tok), mode="prefill",
                             cache_len=8)
    jl, _, _ = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                    mode="train")
    tl, tc = model(torch.from_numpy(tok).long(), mode="prefill", cache_len=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert int(tc["pos"]) == 1 and tc["h"].shape[:2] == (2, 1)


def test_ssd_wrapper_refuses_bad_inputs():
    x, dt, A, B, C = (_t(a) for a in _inputs(7, 1, 8, 2, 16, 1, 16))
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt, A.to("meta"), B, C)
    with pytest.raises(ValueError):
        ssd_ops.ssd(x.to("meta"), dt, A, B, C)
