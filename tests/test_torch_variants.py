"""The dense variants of the port (yi-6b, h2o-danube-3-4b, gemma2-9b)
against the JAX package, on the CPU.

The configs field for field; GeGLU, the softcap and the bf16 embedding
scale; the ring cache's decode scores and stats before, at and after the
wrap; the flash plain version at head dim 120 with a window and a cap;
the reduced models with parameters carried across, on the recipe of
``tests/test_ring_cache.py`` (a 96-token prefill and three decode steps
past a 64-token window, fp32, within ``FWD_TOL`` of the JAX forward); the
port's engine against the JAX engine, tokens and rows equal, with requests
that cross the window; and the refusal that names the slice still to come
(their training on a model tier; their training on one rank's model is
``tests/test_torch_variants_train.py``'s, their serving on grids
``tests/test_torch_variants_grid.py``'s). JAX runs under a mesh of its
own, as in ``tests/test_torch_serve.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeSpec as JServeSpec
from repro.serve import StepClock as JStepClock
from repro_torch import configs
from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as tattention
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, Request, ServeSpec, StepClock

VARIANTS = ("yi-6b", "h2o-danube-3-4b", "gemma2-9b")
FWD_TOL = 1e-4            # fp32 logits against the JAX forward (seen ~1e-6)
# (prompt length, new tokens) at cache_len 128 with the smoke window of 64:
# two prompts longer than the window (the prefill rolls the ring), one that
# crosses it while decoding
PROMPTS = [(80, 6), (40, 30), (12, 5), (60, 10), (100, 8)]


def _mesh():
    return jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def _pair(arch: str, n_layers: int):
    """(JAX config, port config, JAX params, port params): the smoke
    config at ``n_layers`` in fp32, the port's parameters converted from
    the JAX ``init_params`` of seed 0."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=n_layers,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke(arch), n_layers=n_layers,
                               dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, T.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize("arch", VARIANTS)
def test_configs_mirror_jax(arch):
    for jc, tc in [(jconfigs.get(arch), configs.get(arch)),
                   (jconfigs.get_smoke(arch), configs.get_smoke(arch))]:
        for f in dataclasses.fields(tc):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.padded_vocab == jc.padded_vocab
        assert tc.head_dim_ == jc.head_dim_
        assert [s.key() for s in tc.layer_plan()] == \
            [s.key() for s in jc.layer_plan()]
        configs.check_supported(tc)
    assert arch in configs.ARCHS and arch not in configs.PENDING
    assert configs.get(arch).dtype == torch.bfloat16


def test_geglu_and_softcap_match_jax():
    rng = np.random.default_rng(0)
    x, g, u, d = (rng.standard_normal(s, dtype=np.float32) * 0.5
                  for s in ((3, 5, 16), (16, 24), (16, 24), (24, 16)))
    want = jlayers.mlp_apply({"gate": g, "up": u, "down": d},
                             jnp.asarray(x), "gelu")
    got = tlayers.mlp_apply(*(torch.from_numpy(a) for a in (x, g, u, d)),
                            act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    big = rng.standard_normal((4, 64), dtype=np.float32) * 80
    # fp32: the two libraries' tanh differ by an ulp; bf16: the fp32 tanh
    # rounded once, within one bf16 ulp (2^-8 relative)
    for dtype, jdt, rtol in ((torch.float32, jnp.float32, 1e-6),
                             (torch.bfloat16, jnp.bfloat16, 2 ** -8)):
        t = torch.from_numpy(big).to(dtype)
        got = tlayers.softcap(t, 30.0)
        want = jlayers.softcap(jnp.asarray(big).astype(jdt), 30.0)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=0)
    assert tlayers.softcap(t, 0.0) is t


def test_embed_scale_rounds_as_jax_in_bf16():
    """JAX multiplies bf16 activations by a weakly typed Python float,
    which it first rounds to bf16: the port must give the same bits."""
    d = configs.get("gemma2-9b").d_model
    scale = tlayers.embed_scale(d, torch.bfloat16)
    assert scale == 59.75 and math.sqrt(d) != scale
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    x[0] = 1.5
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16)
                       * math.sqrt(d)).astype(jnp.float32))
    got = (torch.from_numpy(x).bfloat16() * scale).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 89.5          # the full factor would round to 90.0
    assert tlayers.embed_scale(d, torch.float32) == \
        float(np.float32(math.sqrt(d)))


@pytest.mark.parametrize("positions", [[5, 9], [15, 15], [16, 17],
                                       [40, 3], [63, 64]])
def test_ring_scores_and_stats_match_jax(positions):
    """A 16-slot ring (window 16) at positions before, at and past the wrap
    (slot pos % 16 holds the query's own key): the port's plain scores and
    stats against ``decode_stats_scores(..., ring=True)`` and
    ``decode_stats_accumulate``, per-row and one shared position."""
    B, L, KV, G, D, W = 2, 16, 2, 3, 8, 16
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, L, KV, D), dtype=np.float32)
            for _ in range(2))
    for pos in (np.asarray(positions, np.int64),
                np.asarray(positions[0], np.int64)):
        js, jmask = jattention.decode_stats_scores(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), window=W,
            cap=50.0, ring=True)
        jm = jnp.max(js, axis=-1)
        jo, jl = jattention.decode_stats_accumulate(js, jmask, jm,
                                                    jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tp = torch.from_numpy(pos)
        s, mask = tattention.decode_stats_scores(tq, tk, tp, window=W,
                                                 cap=50.0, ring=True)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
        s2, m = stats_ops.decode_scores(tq, tk, tp, window=W, cap=50.0,
                                        ring=True)
        assert torch.equal(s2, s)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
        o, l = stats_ops.accumulate(s2, m, tv, pos=tp, window=W, ring=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        out = tattention.decode_attention(tq, tk, tv, tp, window=W,
                                          cap=50.0, ring=True)
        want = jattention.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            window=W, cap=50.0, ring=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    # the kept slots are [0, min(pos, L - 1)]: all of them once wrapped
    kept = mask.numpy().reshape(-1, L)[0] if mask.ndim == 2 else mask.numpy()
    assert kept.sum() == min(int(pos), L - 1) + 1


def test_ring_write_lands_at_pos_mod_len():
    cache = torch.zeros(2, 8, 1, 2)
    new = torch.ones(2, 1, 1, 2)
    tattention.write_cache(cache, new, torch.tensor([3, 21]), ring=True)
    assert cache[0, 3].sum() == 2 and cache[1, 21 % 8].sum() == 2
    assert cache.sum() == 4                 # nothing else written


def test_flash_plain_d120_window_cap_matches_jax():
    rng = np.random.default_rng(3)
    S, H, KV, D = 70, 8, 2, 120
    q = rng.standard_normal((1, S, H, D), dtype=np.float32)
    k, v = (rng.standard_normal((1, S, KV, D), dtype=np.float32)
            for _ in range(2))
    mask = dict(window=24, cap=50.0)
    want = jattention.multihead_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          **mask)
    got = flash_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # and its backward (the training path at head dim 120, window and cap)
    # against jax.vjp
    assert 120 in flash_ops.HEAD_DIMS and 120 in flash_ops.BWD_HEAD_DIMS
    do = rng.standard_normal((1, S, H, D), dtype=np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad(flash_ops.flash_attention_train(
        *leaves, **mask), leaves, torch.from_numpy(do))
    _, vjp = jax.vjp(lambda *a: jattention.multihead_attention(*a, **mask),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("arch", VARIANTS)
def test_ring_cache_recipe_matches_jax_forward(arch):
    """``tests/test_ring_cache.py``'s recipe on the port: a 96-token
    prefill into a 99-slot cache (the window layers' rings hold 64 and
    wrap) and three decode steps, each within ``FWD_TOL`` of the JAX
    full-sequence forward."""
    B, S = 2, 96
    jcfg, tcfg, jparams, tparams = _pair(arch, 4)
    model = T.Transformer(tcfg, tparams, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S + 3)).astype(np.int32)
    with jax.set_mesh(_mesh()):
        full, _, _ = jtransformer.forward(jparams, jcfg, jnp.asarray(tokens),
                                          mode="train")
    full = np.asarray(full)
    logits, cache = model(torch.from_numpy(tokens[:, :S]).long(),
                          mode="prefill", cache_len=S + 3)
    rings = T.RING_LEAVES[0] in cache
    assert rings == (arch != "yi-6b")
    if rings:
        assert cache["k_ring"].shape[2] == tcfg.window == 64
    assert np.abs(logits.numpy() - full[:, S - 1:S]).max() < FWD_TOL
    cache["pos"] = cache["pos"].expand(B).clone()       # per-row positions
    for t in range(3):
        logits, cache = model(torch.from_numpy(tokens[:, S + t:S + t + 1])
                              .long(), mode="decode", cache=cache)
        err = np.abs(logits.numpy() - full[:, S + t:S + t + 1]).max()
        assert err < FWD_TOL, f"decode step {t}: {err}"


@pytest.mark.parametrize("arch", VARIANTS)
def test_engine_tokens_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch, 2)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, tcfg.vocab_size, n, dtype=np.int32), m)
               for n, m in PROMPTS]
    spec_kw = dict(batch=3, cache_len=128)
    with jax.set_mesh(_mesh()):
        eng = JEngine(jcfg, _mesh(), jparams, JServeSpec(**spec_kw),
                      clock=JStepClock())
        for toks, m in prompts:
            eng.submit(JRequest(tokens=toks, max_new=m))
        ref = eng.drain()
    eng = Engine(tcfg, tparams, ServeSpec(**spec_kw), device="cpu",
                 clock=StepClock())
    rids = [eng.submit(Request(tokens=t, max_new=m)) for t, m in prompts]
    out = eng.drain()
    assert sorted(out) == sorted(ref) == rids
    for rid in rids:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens)
        assert out[rid].slot == ref[rid].slot
        assert out[rid].n_tokens == PROMPTS[rid][1]
    shapes = eng.model.cache_shapes(3, 128)
    if tcfg.window:
        assert shapes["k_ring"][0][2] == 64          # min(cache_len, window)


@pytest.mark.parametrize("arch", VARIANTS)
def test_training_and_grids_refuse_the_variants(arch):
    """Nothing of the variants is refused any more: serving takes them on
    grids and on a model tier (tests/test_torch_variants_grid.py), training
    on one rank, FSDP ranks and a model tier of 2 or 4, the untied head of
    yi-6b and h2o-danube by its vocabulary columns
    (tests/test_torch_variants_tp.py); the MoE family takes a model tier
    too (tests/test_torch_moe_tp.py), but for experts that m does not
    divide."""
    from repro_torch.models.tp import check_tp
    cfg = configs.get_smoke(arch)

    class Grid:
        q, pl, m = 2, 2, 2
    configs.check_supported(cfg, "train")
    tree = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(T.train_layers(tree, cfg)) == cfg.n_layers
    res = ServeSpec(batch=4, cache_len=128).resolve(cfg, Grid())
    assert res.batch_sharded and res.m == 2
    check_tp(cfg, 2, "serve")
    for m in (2, 4):
        check_tp(cfg, m, "train")
    assert bool(configs.variant_features(cfg)) == (arch != "yi-6b")
    moe = configs.get_smoke("qwen2-moe-a2.7b")
    check_tp(moe, 2, "train")
    with pytest.raises(NotImplementedError, match="n_experts 6"):
        check_tp(dataclasses.replace(moe, n_experts=6), 4, "train")
