"""The port's transformer (dense and Mamba2) against the JAX package's, on
the CPU.

Both get the same parameters (the JAX ``init_params`` tree converted by
``params_from_jax``) and the same numpy tokens. fp32 throughout; logits
agree to 1e-4 (summation order differs between XLA and PyTorch), caches to
1e-5. The Mamba2 stack is held twice: against the JAX forward with its
``ssd_chunked`` made precise (the function the port's SSD kernel
computes), at 1e-4; and against the unpatched JAX forward, whose SSD runs
its bf16 data path, at twice the gap between JAX's own precise and mixed
outputs on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import attention, layers, transformer

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(n_layers):
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"),
                               n_layers=n_layers, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                               n_layers=n_layers, dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs(3)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = transformer.Transformer(
        tcfg, transformer.params_from_jax(tree, tcfg), "cpu")
    return jcfg, tcfg, jparams, model


def _jax_kv(cache):
    """Stacked (n_layers, B, L, KV, D) k and v of a JAX cache tree."""
    slot = cache["blocks"]["slot0"]
    return np.asarray(slot["k"]), np.asarray(slot["v"])


def test_config_mirrors_jax():
    for jc, tc in [(jconfigs.get("llama3.2-3b"), configs.get("llama3.2-3b")),
                   (jconfigs.get_smoke("llama3.2-3b"),
                    configs.get_smoke("llama3.2-3b"))]:
        for f in dataclasses.fields(tc):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.padded_vocab == jc.padded_vocab
        assert tc.head_dim_ == jc.head_dim_
        assert [s.key() for s in tc.layer_plan()] == \
            [s.key() for s in jc.layer_plan()]
    assert configs.get("llama3.2-3b").dtype == torch.bfloat16


def test_mamba_config_mirrors_jax():
    for jc, tc in [(jconfigs.get("mamba2-780m"), configs.get("mamba2-780m")),
                   (jconfigs.get_smoke("mamba2-780m"),
                    configs.get_smoke("mamba2-780m"))]:
        for f in dataclasses.fields(tc):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.padded_vocab == jc.padded_vocab
        assert [s.key() for s in tc.layer_plan()] == \
            [s.key() for s in jc.layer_plan()]
        configs.check_supported(tc)
    smoke = configs.get_smoke("mamba2-780m")
    assert (smoke.ssm_state, smoke.ssm_headdim, smoke.ssm_chunk) == (16, 16, 32)
    assert configs.get("mamba2-780m").dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["internvl2-26b", "zamba2-1.2b",
                                  "llama4-scout-17b-a16e", "whisper-tiny"])
def test_registry_names_the_waiting_slice(name):
    """A pending architecture raises naming the slice it waits for;
    llama4-scout, served since its slice, still names the slice that
    trains it (ROADMAP.md Queue 1 item 15)."""
    if name not in configs.PENDING:
        cfg = configs.get(name)
        configs.check_supported(cfg, "serve")
        with pytest.raises(NotImplementedError, match="item 15"):
            configs.check_supported(cfg, "train")
        return
    with pytest.raises(NotImplementedError, match="slice"):
        configs.get(name)


@pytest.mark.parametrize("flag", [dict(qk_norm=True), dict(window=64),
                                  dict(attn_softcap=50.0),
                                  dict(sandwich_norm=True),
                                  dict(scale_embed=True),
                                  dict(n_experts=4, top_k=2),
                                  dict(mlp_act="gelu"),
                                  dict(family="hybrid", ssm_state=16,
                                       shared_attn_every=2)])
def test_unported_flags_raise_when_built(flag):
    """The dense variants' flags (window, softcap, sandwich norm,
    scale_embed, GeGLU) are built for serving and for training
    (tests/test_torch_variants.py, tests/test_torch_variants_train.py);
    llama4's (qk-norm, chunked and NoPE layers) for serving alone
    (tests/test_torch_llama4.py); every other flag raises when a model is
    built for either."""
    cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), **flag)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    if configs.llama4_features(cfg):
        transformer.Transformer(cfg, params, "cpu")
        with pytest.raises(NotImplementedError, match="item 15"):
            transformer.init_train_params(
                cfg, torch.Generator().manual_seed(0), "cpu")
        return
    if configs.variant_features(cfg):
        transformer.init_train_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        transformer.Transformer(cfg, params, "cpu")
        return
    with pytest.raises(NotImplementedError):
        transformer.init_train_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    with pytest.raises(NotImplementedError):
        transformer.Transformer(cfg, params, "cpu")


def test_find_period_matches_jax():
    for name in jconfigs.ARCHS:
        plan = jconfigs.get(name).layer_plan()
        assert transformer.find_period(plan) == jtransformer.find_period(plan)


def test_init_params_distributions():
    _, tcfg = _cfgs(2)
    p = transformer.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    d = tcfg.d_model
    assert p["embed"].shape == (tcfg.padded_vocab, d)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["layers.0.gate"].std()) - d ** -0.5) < 0.01
    assert float(p["layers.1.ln2"].abs().max()) == 0.0
    # the port's model consumes exactly the keys init_params makes
    model = transformer.Transformer(tcfg, p, "cpu")
    assert set(model.state_dict()) == set(p)


def test_rope_matches_jax():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32), dtype=np.float32)
    pos = np.array([[3], [17]], np.int32) + np.arange(5, dtype=np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), 32, 5e5)
    out = layers.apply_rope_angles(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_prefill_logits_and_cache_match_jax(pair):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13), dtype=np.int32)
    jl, _, jc = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                     mode="prefill", cache_len=24)
    tl, tc = model(torch.from_numpy(toks).long(), mode="prefill",
                   cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jk, jv = _jax_kv(jc)
    np.testing.assert_allclose(tc["k"].numpy(), jk, **CACHE_TOL)
    np.testing.assert_allclose(tc["v"].numpy(), jv, **CACHE_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 13


def test_continuous_batching_decode_matches_jax(pair):
    """Three rows prefilled at different lengths, then 6 decode steps with a
    per-row (B,) position vector, as the scheduler runs them."""
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(2)
    L, lens = 32, (5, 11, 8)
    jk, jv, tk, tv, first = [], [], [], [], []
    for S in lens:
        toks = rng.integers(0, tcfg.vocab_size, (1, S), dtype=np.int32)
        jl, _, jc = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                         mode="prefill", cache_len=L)
        tl, tc = model(torch.from_numpy(toks).long(), mode="prefill",
                       cache_len=L)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        k, v = _jax_kv(jc)
        jk.append(k)
        jv.append(v)
        tk.append(tc["k"])
        tv.append(tc["v"])
        first.append(int(np.argmax(np.asarray(jl)[0, -1])))
    pos = np.asarray(lens, np.int32)
    jcache = {"blocks": {"slot0": {"k": jnp.asarray(np.concatenate(jk, 1)),
                                   "v": jnp.asarray(np.concatenate(jv, 1))}},
              "rest": [], "pos": jnp.asarray(pos)}
    tcache = {"k": torch.cat(tk, 1), "v": torch.cat(tv, 1),
              "pos": torch.from_numpy(pos).long()}
    tok = np.asarray(first, np.int32)[:, None]
    for _ in range(6):
        jl, _, jcache = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                             cache=jcache)
        tl, tcache = model(torch.from_numpy(tok).long(), mode="decode",
                           cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    k, v = _jax_kv(jcache)
    np.testing.assert_allclose(tcache["k"].numpy(), k, **CACHE_TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), v, **CACHE_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_decode_scores_mask_matches_jax():
    from repro.models import attention as jattn
    rng = np.random.default_rng(3)
    B, H, KV, D, L = 3, 4, 2, 32, 40
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    k = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    for pos in (np.int32(17), np.array([0, 9, 39], np.int32)):
        for kw in (dict(), dict(window=8), dict(chunk=16), dict(cap=30.0)):
            js, jm = jattn.decode_stats_scores(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(pos), **kw)
            ts, tm = attention.decode_stats_scores(
                torch.from_numpy(q), torch.from_numpy(k),
                torch.as_tensor(pos).long(), **kw)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                                       rtol=1e-5)
        jo = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos))
        to = attention.decode_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v),
                                        torch.as_tensor(pos).long())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the Mamba2 stack
# ---------------------------------------------------------------------------
from repro.models import ssm as jssm  # noqa: E402

_JAX_SSD = jssm.ssd_chunked


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-780m"), n_layers=3,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("mamba2-780m"), n_layers=3,
                               dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = transformer.Transformer(
        tcfg, transformer.params_from_jax(tree, tcfg), "cpu")
    return jcfg, tcfg, jparams, model


def _jax_mamba_run(jparams, jcfg, prompts, steps, precise):
    """JAX logits of B=1 prefills of ``prompts`` (rows stacked into one
    cache), then ``steps`` greedy decode steps of the batch; the calls that
    went to ``ssd_chunked`` are counted (each forward traces afresh)."""
    calls = []

    def ssd(*a, **kw):
        calls.append(1)
        return _JAX_SSD(*a, **{**kw, "precise": precise or kw.get("precise",
                                                                   False)})

    old = jssm.ssd_chunked
    jssm.ssd_chunked = ssd
    try:
        logits, caches = [], []
        for toks in prompts:
            jl, _, jc = jtransformer.forward(jparams, jcfg,
                                             jnp.asarray(toks[None]),
                                             mode="prefill", cache_len=96)
            logits.append(np.asarray(jl))
            caches.append(jc)
        slot = lambda n: jnp.concatenate(
            [c["blocks"]["slot0"][n] for c in caches], 1)
        jcache = {"blocks": {"slot0": {"conv": slot("conv"), "h": slot("h")}},
                  "rest": [], "pos": jnp.asarray([len(p) for p in prompts],
                                                 jnp.int32)}
        tok = np.argmax(np.concatenate(logits)[:, -1], -1)[:, None]
        out = [np.concatenate(logits)]
        for _ in range(steps):
            jl, _, jcache = jtransformer.forward(
                jparams, jcfg, jnp.asarray(tok, jnp.int32), cache=jcache)
            out.append(np.asarray(jl))
            tok = np.argmax(out[-1][:, -1], -1)[:, None]
    finally:
        jssm.ssd_chunked = old
    return out, jcache, len(calls)


def _torch_mamba_run(model, prompts, steps, jax_logits):
    """The port on the same prompts, fed JAX's greedy tokens."""
    logits, caches = [], []
    for toks in prompts:
        tl, tc = model(torch.from_numpy(toks[None]).long(), mode="prefill",
                       cache_len=96)
        logits.append(tl.numpy())
        caches.append(tc)
    tcache = {n: torch.cat([c[n] for c in caches], 1) for n in ("conv", "h")}
    tcache["pos"] = torch.tensor([len(p) for p in prompts])
    out = [np.concatenate(logits)]
    for i in range(steps):
        tok = np.argmax(jax_logits[i][:, -1], -1)[:, None]
        tl, tcache = model(torch.from_numpy(tok).long(), mode="decode",
                           cache=tcache)
        out.append(tl.numpy())
    return out, tcache


def _mamba_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (40, 7, 64)]


def test_mamba_logits_match_jax_with_its_precise_ssd(mamba_pair):
    """Prefill (one chunk of 40, 7 tokens, two chunks of 32) and 4 decode
    steps against the JAX forward with ``ssd_chunked(precise=True)``:
    logits 1e-4, caches 1e-4 after the decode steps."""
    jcfg, tcfg, jparams, model = mamba_pair
    prompts = _mamba_prompts()
    ref, jcache, n = _jax_mamba_run(jparams, jcfg, prompts, 4, precise=True)
    assert n == len(prompts), "the patched ssd_chunked was not traced"
    mixed, _, _ = _jax_mamba_run(jparams, jcfg, prompts, 0, precise=False)
    assert np.abs(mixed[0] - ref[0]).max() > 1e-4, "the patch had no effect"
    out, tcache = _torch_mamba_run(model, prompts, 4, ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, **LOGIT_TOL)
    slot = jcache["blocks"]["slot0"]
    for name in ("conv", "h"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(slot[name]), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_mamba_logits_match_unpatched_jax_within_its_own_precision_gap(
        mamba_pair):
    """Against the JAX forward as it stands (bf16 SSD data path): the port's
    logits sit within twice the gap between JAX's precise and mixed
    logits on the same inputs."""
    jcfg, tcfg, jparams, model = mamba_pair
    prompts = _mamba_prompts()
    mixed, _, n = _jax_mamba_run(jparams, jcfg, prompts, 2, precise=False)
    assert n == len(prompts)
    precise, _, _ = _jax_mamba_run(jparams, jcfg, prompts, 0, precise=True)
    gap = float(np.abs(mixed[0] - precise[0]).max())
    assert gap > 0
    out, _ = _torch_mamba_run(model, prompts, 2, mixed)
    for o, r in zip(out, mixed):
        assert float(np.abs(o - r).max()) <= 2 * gap


def test_mamba_init_params_feed_the_model():
    cfg = dataclasses.replace(configs.get_smoke("mamba2-780m"), n_layers=2,
                              dtype=torch.float32)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = transformer.Transformer(cfg, p, "cpu")
    assert set(model.state_dict()) == set(p)
    assert all(isinstance(b, transformer.MambaBlock) for b in model.layers)
    cache = model.empty_cache(3, 64, vector_pos=True)
    assert set(cache) == {"conv", "h", "pos"}
    assert cache["h"].dtype == torch.float32 and cache["h"].shape[:2] == (2, 3)
    n = sum(t.numel() for t in p.values())
    from repro.models.transformer import param_count
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-780m"), n_layers=2)
    assert n == param_count(jcfg)
