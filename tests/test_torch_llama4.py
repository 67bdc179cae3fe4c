"""llama4-scout-17b-a16e in the port against the JAX package, on the CPU.

The reduced config (4 layers: three chunked-local layers with a chunk of
64 and one global NoPE layer, qk-norm, 8 routed experts at sigmoid top-1
with one shared expert, the untied head), fp32, parameters converted from
the JAX ``init_params`` of seed 0 with the qk-norm scales drawn at random
(JAX draws them 0, which would hide the ``(1 + scale)`` convention):

* the config field for field, and its refusals: training (ROADMAP.md
  Queue 1 item 15) and a model tier (item 14);
* the MoE MLP (sigmoid top-1, a shared expert) against the JAX
  ``moe_apply`` at a decode step and an 80-token prefill (``TOL``);
* ``ln1`` and the attention layer, a chunked layer with qk-norm and RoPE
  and the NoPE layer, against the JAX ``attention`` layer (``ATTN_TOL``);
* the forward logits of a prefill past one and two chunk boundaries (S =
  80, 150; and 60, whose decode crosses one) and of six decode steps,
  against the JAX full-sequence forward (``FWD_TOL``, the tolerance of
  ``tests/test_torch_variants.py``), with the experts' capacity factor
  raised as ``tests/test_ring_cache.py`` raises it, so that no token is
  dropped in either;
* the decode pair's plain versions on a chunked ring and on the shards of
  one (every slot kept, some, none), against the JAX
  ``decode_stats_scores`` and ``decode_stats_accumulate`` (``TOL``);
* the engine's greedy tokens and rows, with requests whose prefill rolls
  the ring and whose decode crosses the ring's wrap and a chunk boundary,
  equal to the JAX engine's on one device;
* the launcher's ``--layers``.

The CUDA decode pair on chunked rings is held against these plain versions
on the card by ``tests/test_torch_cuda.py``; the (pod, data) grids by
``tests/test_torch_moe_grid.py``.
"""
import dataclasses
import functools

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
from repro_torch.models import transformer as T
from repro_torch.models.layers import rope_angles
from repro_torch.models.tp import check_tp
from repro_torch.serve import Engine, Request, ServeSpec, StepClock

ARCH = "llama4-scout-17b-a16e"
TOL = dict(atol=1e-5, rtol=1e-5)   # fp32 decode pair against JAX
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 attention layer against JAX
FWD_TOL = 1e-4            # fp32 logits against the JAX forward (seen ~1e-6)
CHUNK = 64                # the reduced config's chunk
# (prompt length, new tokens) at cache_len 160 with the reduced chunk of
# 64: prompts past one and two chunk boundaries (the prefill rolls the
# ring), decodes that cross the ring's wrap and a chunk boundary (64, 128)
PROMPTS = [(80, 6), (40, 30), (12, 5), (60, 10), (100, 40), (150, 8)]
ENGINE_CACHE = 160


def _mesh():
    return jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX ``init_params`` of seed 0 for the reduced config in fp32
    (jitted: eager JAX takes seconds a leaf here), every qk-norm scale then
    drawn from N(0, 0.3^2); the same tree for every capacity factor."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    jparams = jax.jit(jtransformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    for slot in [*jparams["blocks"].values(), *jparams["rest"]]:
        for name in ("q_norm", "k_norm"):
            shape = slot["attn"][name]["scale"].shape
            slot["attn"][name]["scale"] = jnp.asarray(
                0.3 * rng.standard_normal(shape), jnp.float32)
    return jparams


@functools.lru_cache(maxsize=None)
def _pair(capacity_factor: float = 1.25):
    """(JAX config, port config, JAX params, port params): the reduced
    config in fp32 at ``capacity_factor``, the port's parameters converted
    from :func:`_params`. Made once a module; nothing writes into them."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32,
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=torch.float32,
                               capacity_factor=capacity_factor)
    jparams = _params()
    return jcfg, tcfg, jparams, T.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg)


def _jax_layer(jparams, cfg, i: int) -> dict:
    """Layer i's parameters in the JAX tree (``blocks/slot{j}[rep]``, or
    ``rest`` past the stacked periods: the reduced plan's NoPE layer)."""
    pi, reps, _ = T.find_period(cfg.layer_plan())
    if i < pi * reps:
        return jax.tree.map(lambda a: a[i // pi],
                            jparams["blocks"][f"slot{i % pi}"])
    return jparams["rest"][i - pi * reps]


def test_config_mirrors_jax_and_is_served():
    for jc, tc in [(jconfigs.get(ARCH), configs.get(ARCH)),
                   (jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH))]:
        for f in dataclasses.fields(tc):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.padded_vocab == jc.padded_vocab
        assert [s.key() for s in tc.layer_plan()] == \
            [s.key() for s in jc.layer_plan()]
        configs.check_supported(tc, "serve")
    assert ARCH in configs.ARCHS and ARCH not in configs.PENDING
    full, smoke = configs.get(ARCH), configs.get_smoke(ARCH)
    assert (full.chunk, smoke.chunk, full.dtype) == (8192, CHUNK,
                                                     torch.bfloat16)
    assert [(s.attn, s.rope) for s in smoke.layer_plan()] == \
        [("chunked", True)] * 3 + [("full", False)]
    for s in full.layer_plan():
        assert T.ring_cache_len(full, s) == (8192 if s.rope else None)
        assert T.ring_cache_len(full, s) == jtransformer.ring_cache_len(
            jconfigs.get(ARCH), s)
    assert configs.llama4_features(full) == [
        "chunked layers (ring caches)", "NoPE layers", "qk_norm"]


def test_training_and_a_model_tier_are_refused():
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(NotImplementedError, match="item 15"):
        configs.check_supported(cfg, "train")
    with pytest.raises(NotImplementedError, match="item 15"):
        T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # the model tier serves it (tests/test_torch_moe_tp.py); training on
    # one stays item 15; experts that m does not divide are refused
    check_tp(cfg, 2, "serve")
    with pytest.raises(NotImplementedError, match="item 15"):
        check_tp(cfg, 2, "train")
    with pytest.raises(NotImplementedError, match="n_experts 6"):
        check_tp(dataclasses.replace(cfg, n_experts=6), 4, "serve")

    class Tier:
        q, pl, m = 1, 2, 2
    assert ServeSpec(batch=2, cache_len=128).resolve(cfg, Tier()).m == 2


@pytest.mark.parametrize("S", [1, 80])
def test_moe_layer_matches_jax(S):
    """The reduced llama4's MoE MLP (sigmoid router, top-1 with no
    renormalisation, 8 experts, one shared expert) against the JAX
    ``moe_apply`` on the same input: a decode step (S = 1, capacity 1) and
    a prefill of 80 tokens (capacity 12 an expert: a 13th token routed to
    one is dropped); output and auxiliary loss within ``TOL``."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, jparams, tparams = _pair()
    assert (tcfg.router_act, tcfg.top_k, tcfg.router_norm_topk,
            tcfg.n_shared_experts) == ("sigmoid", 1, False, 1)
    x = np.random.default_rng(8).standard_normal(
        (3, S, tcfg.d_model)).astype(np.float32)
    with jax.set_mesh(_mesh()):
        want, waux = jax.jit(jmoe.moe_apply, static_argnums=2)(
            _jax_layer(jparams, tcfg, 0)["moe"], jnp.asarray(x), jcfg)
    w = {n: tparams[f"layers.0.{n}"] for n in tmoe.moe_shapes(tcfg)}
    got, aux = tmoe.moe_apply(w, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL["rtol"])


@pytest.mark.parametrize("layer", [0, 3], ids=["chunked", "nope"])
def test_attention_layer_matches_jax(layer):
    """``ln1``, the projections, qk-norm, RoPE (none on the NoPE layer)
    and flash attention with the layer's chunk (full causal on the NoPE
    layer), then ``o @ wo``: the port's layer against the JAX one on the
    same input, S = 150 (past two chunk boundaries)."""
    jcfg, tcfg, jparams, tparams = _pair()
    spec = tcfg.layer_plan()[layer]
    B, S, d = 2, 150, tcfg.d_model
    x = np.random.default_rng(3).standard_normal((B, S, d)).astype(
        np.float32)
    lp = _jax_layer(jparams, tcfg, layer)
    assert float(jnp.abs(lp["attn"]["q_norm"]["scale"]).max()) > 0
    h = jlayers.rmsnorm(lp["ln1"], jnp.asarray(x), jcfg.norm_eps)
    with jax.set_mesh(_mesh()):
        want, _ = jattention.attention(lp["attn"], h, jcfg, spec)
    w = {n: tparams[f"layers.{layer}.{n}"] for n in T.spec_params(tcfg, spec)}
    assert {"q_norm", "k_norm"} <= set(w)
    cos, sin = rope_angles(torch.arange(S)[None], tcfg.head_dim_,
                           tcfg.rope_theta)
    q, k, v = T.attn_qkv(torch.from_numpy(x), w, cos, sin, tcfg,
                         rope=spec.rope)
    meta = T.decode_meta(tcfg, spec)
    assert meta["chunk"] == (CHUNK if spec.rope else 0)
    assert meta["ring"] == spec.rope
    o = flash_ops.flash_attention(q, k, v, causal=True, chunk=meta["chunk"])
    got = o.reshape(B, S, -1) @ w["wo"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


FWD_STEPS = 6
FWD_S = (60, 80, 150)


@pytest.fixture(scope="module")
def full_forward():
    """(tokens (2, 156), the JAX full-sequence logits over them) at a
    capacity factor of 64, where no expert drops a token: a position's
    logits then depend on the tokens up to it alone, so every prefix's
    forward is this one's prefix."""
    jcfg, _, jparams, _ = _pair(64.0)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, max(FWD_S) + FWD_STEPS)).astype(np.int32)
    with jax.set_mesh(_mesh()):
        full, _, _ = jtransformer.forward(jparams, jcfg, jnp.asarray(tokens),
                                          mode="train")
    return tokens, np.asarray(full)


@pytest.mark.parametrize("S", FWD_S)
def test_forward_logits_match_jax(S, full_forward):
    """A prefill of S tokens into an (S + 8)-slot cache (the chunked
    layers' rings of 64 roll when S > 64) and six decode steps, each
    position's logits within ``FWD_TOL`` of the JAX full-sequence forward;
    S = 60 decodes across the chunk boundary at 64."""
    B, steps = 2, FWD_STEPS
    _, tcfg, _, tparams = _pair(64.0)
    model = T.Transformer(tcfg, tparams, "cpu")
    tokens, full = full_forward
    logits, cache = model(torch.from_numpy(tokens[:, :S]).long(),
                          mode="prefill", cache_len=S + steps + 2)
    assert cache["k_ring"].shape[:3] == (3, B, min(S + steps + 2, CHUNK))
    assert cache["k"].shape[:3] == (1, B, S + steps + 2)
    assert np.abs(logits.numpy() - full[:, S - 1:S]).max() < FWD_TOL
    for t in range(steps):
        logits, cache = model(torch.from_numpy(tokens[:, S + t:S + t + 1])
                              .long(), mode="decode", cache=cache)
        err = np.abs(logits.numpy() - full[:, S + t:S + t + 1]).max()
        assert err < FWD_TOL, f"decode step {t} (position {S + t}): {err}"


# a chunked ring of T = 16 slots (chunk 16) at positions in the first
# chunk, at a boundary and deep in later chunks; and one of T = 12 < chunk
# 16, whose positions stay below T (a cache shorter than the chunk)
RING_POSITIONS = {16: [[0, 5, 15], [16, 17, 31], [40, 47, 63], [70, 3, 95]],
                  12: [[0, 5, 11], [7, 11, 2]]}


@pytest.mark.parametrize("T_len", [16, 12])
def test_chunked_ring_decode_pair_matches_jax(T_len):
    """Both plain kernels and the pair on a whole chunked ring, per-row
    positions and one shared one, against the JAX ring functions; the
    kept slots are [0, min(pos mod chunk, T - 1)]."""
    B, KV, G, D, C = 3, 2, 5, 16, 16
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, T_len, KV, D), dtype=np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for rows in RING_POSITIONS[T_len]:
        for pos in (np.asarray(rows, np.int64), np.asarray(rows[1],
                                                           np.int64)):
            kw = dict(chunk=C, ring=True)
            js, jmask = jattention.decode_stats_scores(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), **kw)
            jm = jnp.max(js, axis=-1)
            jo, jl = jattention.decode_stats_accumulate(js, jmask, jm,
                                                        jnp.asarray(v))
            tp = torch.from_numpy(pos)
            s, mask = tattention.decode_stats_scores(tq, tk, tp, **kw)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
            np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
            s2, m = stats_ops.decode_scores(tq, tk, tp, **kw)
            assert torch.equal(s2, s)
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
            o, l = stats_ops.accumulate(s2, m, tv, pos=tp, **kw)
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
            np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
            out = tattention.decode_attention(tq, tk, tv, tp, **kw)
            want = jattention.decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(pos), **kw)
            np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
            rows_mask = mask.numpy().reshape(-1, T_len)
            for r, p_ in enumerate(np.broadcast_to(pos, (B,))[
                    :rows_mask.shape[0]]):
                want_kept = np.arange(T_len) <= min(p_ % C, T_len - 1)
                np.testing.assert_array_equal(rows_mask[r], want_kept)


# a 32-slot chunked ring (chunk 32) in four shards of 8; positions where a
# shard keeps all its slots, part of them or none (p mod 32 below its
# offset, after a chunk boundary)
SHARD_T, SHARD_N = 32, 4
SHARD_POSITIONS = [3, 12, 31, 32, 45, 70, 95]


@pytest.mark.parametrize("pos", SHARD_POSITIONS)
def test_chunked_ring_shards_match_jax(pos):
    """Every shard of a chunked ring split 4 ways, one position (a split
    cache's B = 1): the scores against the JAX function at the shard's
    ``slot_offset`` and ``total_len``, the shards put together equal to the
    whole ring's, and a shard that keeps no slot (NEG_INF, 0, 0); the
    accumulate against the JAX ``decode_stats_accumulate``."""
    B, KV, G, D, C = 1, 2, 5, 16, SHARD_T
    L = SHARD_T // SHARD_N
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, SHARD_T, KV, D), dtype=np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tp = torch.tensor(pos)
    whole, _ = stats_ops.decode_scores(tq, tk, tp, chunk=C, ring=True)
    states, parts = set(), []
    for i in range(SHARD_N):
        off = i * L
        kw = dict(slot_offset=off, total_len=SHARD_T, chunk=C, ring=True)
        js, jmask = jattention.decode_stats_scores(
            jnp.asarray(q), jnp.asarray(k[:, off:off + L]), jnp.asarray(pos),
            **kw)
        jm = jnp.max(js, axis=-1)
        jo, jl = jattention.decode_stats_accumulate(
            js, jmask, jm, jnp.asarray(v[:, off:off + L]))
        sk, sv = tk[:, off:off + L], tv[:, off:off + L]
        s, m = stats_ops.decode_scores(tq, sk, tp, **kw)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        o, l = stats_ops.accumulate(s, m, sv, pos=tp, **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
        kept = int(np.asarray(jmask).sum())
        assert kept == min(max(pos % C - off + 1, 0), L)
        states.add("none" if kept == 0 else "all" if kept == L else "part")
        if kept == 0:
            assert bool((m == stats_ops.NEG_INF).all())
            assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0
        parts.append(s)
    assert torch.equal(torch.cat(parts, -1), whole)
    if pos % C not in (L - 1, SHARD_T - 1):
        assert "part" in states


def test_check_ring_takes_chunked_rings():
    """A chunked ring of at most its chunk, and its shards, are taken; a
    ring longer than its chunk or its window, or with both, is refused."""
    for T_len, chunk in ((16, 16), (12, 16)):
        stats_ops.check_ring("t", T_len, 0, chunk, 0)
        stats_ops.check_ring("t", T_len // 4, 0, chunk, T_len // 2, T_len)
    stats_ops.check_ring("t", 16, 16, 0, 0)
    for L, window, chunk in ((32, 0, 16), (32, 16, 0), (16, 16, 16)):
        with pytest.raises(ValueError, match="not both"):
            stats_ops.check_ring("t", L, window, chunk, 0)


def test_engine_tokens_match_jax():
    """The port's engine against the JAX engine, batch 3 of 160 slots,
    fp32: tokens and rows equal for requests whose prefill rolls the
    chunked layers' 64-slot rings (80, 100 and 150 tokens) and whose decode
    crosses the ring's wrap and the chunk boundaries at 64 and 128."""
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, tcfg.vocab_size, n, dtype=np.int32), m)
               for n, m in PROMPTS]
    assert any(n <= CHUNK <= n + m - 2 for n, m in PROMPTS)
    assert any(n <= 2 * CHUNK <= n + m - 2 for n, m in PROMPTS)
    spec_kw = dict(batch=3, cache_len=ENGINE_CACHE)
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
    shapes = eng.model.cache_shapes(3, ENGINE_CACHE)
    assert shapes["k_ring"][0][:3] == (3, 3, CHUNK)
    assert shapes["k"][0][:3] == (1, 3, ENGINE_CACHE)


def test_launcher_cuts_the_depth(capsys):
    """``--layers 2`` serves the first two layers of the plan at the
    config's width."""
    from repro_torch.launch import serve as launch
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--layers",
                 "2", "--batch", "2", "--prompt-len", "70", "--max-new", "3",
                 "--cache-len", "80"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke on cpu: drained 2 requests (6 tokens)" in out
    with pytest.raises(SystemExit):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--layers", "5"])
