"""Decode attention's two kernels (plain versions) and the decode step of
the port against the JAX package, on the CPU.

* ``decode_scores`` (masked scores and row max) against the JAX
  ``decode_stats_scores`` and its max: fp32 caches within 1e-5; bf16 caches
  within one bf16 ulp of the largest |q.k| times D^-0.5 (both round q.k to
  bf16, after sums in another order); masked slots exactly NEG_INF.
* ``accumulate`` against ``decode_stats_accumulate_pallas`` in interpret
  mode for every head count and head dim the kernel takes, fp32, within
  1e-5.
* A decode step advances ``cache["pos"]`` in place and hands back the same
  cache.
* A sequence-parallel cache shard: ``decode_stats_scores`` with
  ``slot_offset`` and ``total_len`` against the JAX function for every
  shard of a 4-way split of a 48-slot cache (window, a chunk of 16 that
  the 12-slot shards' offsets 12 and 36 do not divide, cap), within 1e-5;
  the shards' scores put together equal the whole cache's; a shard that
  keeps no slot gives m = NEG_INF and o = l = 0; the cache write lands
  only in the shard that owns the slot.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_stats.stats import decode_stats_accumulate_pallas
from repro.models.attention import decode_stats_scores as jscores
from repro_torch import configs, kernels
from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.models import attention as tattention
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import Engine, Request, ServeSpec, StepClock

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = stats_ops.NEG_INF

# (G, D): every head count and head dim of the archs the port takes or
# queues (zamba2/qwen2-moe/whisper G = 1, danube G = 4 with D = 120,
# llama4-scout G = 5, internvl2 G = 6, yi-6b G = 8, gemma2 D = 256)
HEADS = [(1, 64), (4, 120), (5, 128), (6, 128), (8, 128), (2, 256)]

SCORE_CASES = [
    (np.int64(17), {}),                                  # lockstep position
    (np.array([0, 30, 44], np.int64), {}),               # one per row
    (np.array([5, 40, 12], np.int64), dict(window=16)),
    (np.array([3, 33, 47], np.int64), dict(chunk=16)),
    (np.int64(29), dict(cap=30.0)),
    (np.array([60, 9, 31], np.int64), dict(window=8, chunk=32, cap=20.0)),
]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,kw", SCORE_CASES)
def test_decode_scores_plain_matches_jax(pos, kw, dtype):
    B, H, KV, D, L = 3, 6, 2, 32, 45
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    k = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js, jmask = jscores(jnp.asarray(q, jd), jnp.asarray(k, jd),
                        jnp.asarray(pos), **kw)
    js = np.asarray(js)
    jm = js.max(-1)
    before = stats_ops.SCORES_LAUNCHES
    s, m = stats_ops.decode_scores(torch.from_numpy(q).to(td),
                                   torch.from_numpy(k).to(td),
                                   torch.from_numpy(np.asarray(pos)), **kw)
    assert stats_ops.SCORES_LAUNCHES == before       # the plain version ran
    assert s.dtype == m.dtype == torch.float32
    assert s.shape == (B, KV, H // KV, L) and m.shape == (B, KV, H // KV)
    jmask = np.asarray(jmask)
    mask = np.broadcast_to(jmask[None, None, None] if jmask.ndim == 1
                           else jmask[:, None, None, :], js.shape)
    assert np.all(s.numpy()[~mask] == NEG_INF) and np.all(js[~mask] == NEG_INF)
    if dtype == "float32":
        tol = TOL
    else:
        big = float(np.abs(np.einsum("bhd,bjkd->bj", q[:, 0], k)).max())
        tol = dict(atol=_bf16_ulp(big) * D ** -0.5, rtol=0)
    np.testing.assert_allclose(s.numpy(), js, **tol)
    np.testing.assert_allclose(m.numpy(), jm, **tol)


def test_decode_scores_of_a_row_past_its_window_are_all_masked():
    """A position past the cache with a window that ends past it keeps no
    slot: every score NEG_INF, the row max NEG_INF, as in the JAX package."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 20, 2, 16), dtype=np.float32)
    pos = np.array([5, 60], np.int64)
    js, _ = jscores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                    window=8)
    s, m = stats_ops.decode_scores(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(pos), window=8)
    assert np.all(np.asarray(js)[1] == NEG_INF)
    assert torch.all(s[1] == NEG_INF) and torch.all(m[1] == NEG_INF)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("G,D", HEADS)
def test_decode_stats_plain_matches_pallas_for_every_head_shape(G, D):
    # L = 75: not a multiple of the kernel's 32-slot pieces
    B, KV, L = 2, 2, 75
    rng = np.random.default_rng(G * 1000 + D)
    q = rng.standard_normal((B, 1, KV * G, D), dtype=np.float32)
    k = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    js, _ = jscores(jnp.asarray(q), jnp.asarray(k),
                    jnp.asarray(np.array([20, 74], np.int32)))
    s = np.array(js)
    s[1, 0] = NEG_INF                                   # a fully masked row
    m = s.max(-1)
    po, pl = decode_stats_accumulate_pallas(jnp.asarray(s), jnp.asarray(m),
                                            jnp.asarray(v), block_k=25,
                                            interpret=True)
    before = stats_ops.LAUNCHES
    o, l = stats_ops.accumulate(torch.from_numpy(s), torch.from_numpy(m),
                                torch.from_numpy(v))
    assert stats_ops.LAUNCHES == before
    assert o.shape == (B, 1, KV * G, D) and l.shape == (B, 1, KV * G)
    np.testing.assert_allclose(o.numpy(), np.asarray(po), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(pl), **TOL)
    assert float(o[1, 0, :G].abs().max()) == 0.0
    assert float(l[1, 0, :G].abs().max()) == 0.0


@pytest.mark.parametrize("G,D", HEADS + [(3, 128), (7, 8), (1, 256)])
def test_kernels_take_every_head_count_to_8_and_head_dim_multiple_of_8(G, D):
    stats_ops.check_heads(G, D)


@pytest.mark.parametrize("G,D,named", [(0, 64, "G = 0"), (9, 128, "G = 9"),
                                       (16, 64, "G = 16"),
                                       (2, 12, "D = 12"), (2, 264, "D = 264"),
                                       (1, 4, "D = 4"), (4, 126, "D = 126")])
def test_kernels_refuse_other_shapes_naming_them(G, D, named):
    with pytest.raises(ValueError, match=named):
        stats_ops.check_heads(G, D)


def test_launch_counts_read_and_advance_every_counter():
    counts = kernels.launch_counts()
    assert {"rmsnorm", "flash_attention", "decode_scores", "decode_stats",
            "dma_allgather", "ssd", "rmsnorm.plain", "rmsnorm.residual",
            "rmsnorm.gated", "rmsnorm_bwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv", "flash_attention_bwd_wgmma",
            "rmsnorm_bwd.plain", "rmsnorm_bwd.residual",
            "rmsnorm_bwd.gated", "ssd_bwd", "rmsnorm.gated_rowsq",
            "rmsnorm.gated_finish", "rmsnorm_bwd.gated_rowdot",
            "rmsnorm_bwd.gated_finish", "flash_attention_d120",
            "flash_attention_bwd_d120", "decode_scores_ring",
            "decode_stats_ring"} == set(counts)
    delta = {"decode_scores": 2, "decode_stats": 2, "rmsnorm": 5,
             "decode_scores_ring": 1, "flash_attention_d120": 2,
             "rmsnorm.plain": 3, "rmsnorm.residual": 2,
             "flash_attention_bwd_dq": 1, "rmsnorm_bwd.residual": 4,
             "flash_attention_bwd_d120": 2}
    kernels.add_launch_counts(delta, 3)
    after = kernels.launch_counts()
    assert after == {k: n + 3 * delta.get(k, 0) for k, n in counts.items()}
    kernels.add_launch_counts(delta, -3)
    assert kernels.launch_counts() == counts


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_decode_step_advances_pos_in_place(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=2,
                              dtype=torch.float32)
    model = Transformer(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu"), "cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (3, 6)))
    _, cache = model(toks, mode="prefill", cache_len=16)
    for vector in (False, True):
        if vector:
            cache["pos"] = torch.tensor([6, 6, 6])
        pos = cache["pos"]
        leaves = {name: t for name, t in cache.items()}
        before = pos.clone()
        logits, out = model(toks[:, -1:], mode="decode", cache=cache)
        assert out is cache and out["pos"] is pos
        assert all(out[name] is t for name, t in leaves.items())
        assert torch.equal(pos, before + 1)
        assert logits.shape == (3, 1, cfg.padded_vocab)


def test_scheduler_runs_the_cpu_decode_eagerly():
    cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), n_layers=1,
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    eng = Engine(cfg, params, ServeSpec(batch=2, cache_len=32), device="cpu",
                 clock=StepClock())
    assert eng.scheduler._graph is None
    pos = eng.scheduler._cache["pos"]
    rng = np.random.default_rng(8)
    for n in (5, 9):
        eng.submit(Request(tokens=rng.integers(0, cfg.vocab_size, n),
                           max_new=4))
    eng.step()
    assert eng.scheduler._cache["pos"] is pos
    assert pos.tolist() == [6, 10]
    out = eng.drain()
    assert [r.n_tokens for r in out.values()] == [4, 4]


# a 48-slot cache over 4 shards of 12: positions where every shard keeps all,
# part or none of its slots, lockstep and one per row
SHARD_L, SHARDS = 48, 4
SHARD_CASES = [
    (np.int64(5), {}),
    (np.int64(30), {}),
    (np.array([0, 13, 47], np.int64), {}),
    (np.array([40, 25, 11], np.int64), dict(window=16)),
    (np.array([47, 20, 35], np.int64), dict(chunk=16)),
    (np.int64(44), dict(chunk=16, cap=30.0)),
    (np.array([23, 38, 6], np.int64), dict(window=8, chunk=32, cap=20.0)),
]


@pytest.mark.parametrize("shard", range(SHARDS))
@pytest.mark.parametrize("pos,kw", SHARD_CASES)
def test_shard_scores_at_a_slot_offset_match_jax(pos, kw, shard):
    B, H, KV, D = 3, 6, 2, 32
    L_loc = SHARD_L // SHARDS
    off = shard * L_loc
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    k = rng.standard_normal((B, SHARD_L, KV, D), dtype=np.float32)
    k_loc = np.ascontiguousarray(k[:, off:off + L_loc])
    js, jmask = jscores(jnp.asarray(q), jnp.asarray(k_loc), jnp.asarray(pos),
                        slot_offset=off, total_len=SHARD_L, **kw)
    tq, tk, tp = (torch.from_numpy(q), torch.from_numpy(k_loc),
                  torch.from_numpy(np.asarray(pos)))
    s, mask = tattention.decode_stats_scores(tq, tk, tp, slot_offset=off,
                                             total_len=SHARD_L, **kw)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # the scores kernel's plain version at the offset: the same s, its max
    s2, m2 = stats_ops.decode_scores(tq, tk, tp, slot_offset=off, **kw)
    assert torch.equal(s2, s)
    assert torch.equal(m2, s.amax(-1))
    # the shard's slice of the whole cache's scores
    whole, _ = stats_ops.decode_scores(tq, torch.from_numpy(k), tp, **kw)
    assert torch.equal(s, whole[..., off:off + L_loc])


@pytest.mark.parametrize("shard", range(SHARDS))
def test_shard_that_keeps_no_slot_gives_zero_stats(shard):
    """At position 15 under a window of 4 only shard 1 (slots 12-23) keeps
    a slot: every other shard's max is NEG_INF and its o and l are 0."""
    B, KV, G, D = 2, 2, 3, 16
    L_loc = SHARD_L // SHARDS
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, D),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, L_loc, KV, D),
                                                 dtype=np.float32))
            for _ in range(2))
    pos = torch.tensor(15)
    kw = dict(slot_offset=shard * L_loc, window=4)
    s, m = stats_ops.decode_scores(q, k, pos, **kw)
    o, l = stats_ops.accumulate(s, m, v, pos=pos, **kw)
    if shard == 1:
        assert bool((m > NEG_INF).all()) and bool((l > 0).all())
    else:
        assert bool((s == NEG_INF).all()) and bool((m == NEG_INF).all())
        assert float(o.abs().max()) == 0.0 and float(l.abs().max()) == 0.0


def test_shard_scores_check_the_total_and_refuse_ring_caches():
    q, k = torch.zeros(1, 1, 4, 8), torch.zeros(1, 12, 2, 8)
    with pytest.raises(ValueError, match="exceeds"):
        tattention.decode_stats_scores(q, k, torch.tensor(3), slot_offset=40,
                                       total_len=48)
    # a ring split over ranks is taken (tests/test_torch_variants_grid.py);
    # refused are a ring shard past its ring's total, a ring longer than
    # its window and a ring with a chunk
    with pytest.raises(ValueError, match="exceeds the 48-slot"):
        tattention.decode_stats_scores(q, k, torch.tensor(3), ring=True,
                                       slot_offset=40, total_len=48)
    with pytest.raises(ValueError, match="exceeds the 12-slot ring"):
        tattention.decode_stats_scores(q, k, torch.tensor(3), ring=True,
                                       slot_offset=12)
    with pytest.raises(ValueError, match="window 16"):
        tattention.decode_stats_scores(q, k, torch.tensor(3), ring=True,
                                       total_len=48, window=16)
    with pytest.raises(ValueError, match="chunk 6"):
        tattention.decode_stats_scores(q, k, torch.tensor(3), ring=True,
                                       total_len=48, chunk=6)


@pytest.mark.parametrize("pos", [0, 11, 12, 30, 47])
def test_cache_write_lands_only_in_the_owning_shard(pos):
    L_loc = SHARD_L // SHARDS
    new = torch.arange(1, 1 + 2 * 3 * 4, dtype=torch.float32).reshape(
        2, 1, 3, 4)
    for shard in range(SHARDS):
        cache = torch.zeros(2, L_loc, 3, 4)
        tattention.write_cache(cache, new, torch.tensor(pos),
                               slot_offset=shard * L_loc)
        if pos // L_loc == shard:
            assert torch.equal(cache[:, pos % L_loc], new[:, 0])
            cache[:, pos % L_loc] = 0
        assert float(cache.abs().max()) == 0.0, shard
