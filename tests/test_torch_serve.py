"""The port's serving engine against the JAX package's, on the CPU.

Same parameters (the JAX ``init_params`` tree via ``params_from_jax``),
same requests, both on a ``StepClock``: the greedy tokens of every request
and the rows they were admitted to must be exactly equal. fp32 smoke
configurations: llama3.2-3b, and mamba2-780m with the JAX ``ssd_chunked``
made precise in this test process (the function the port's SSD kernel
computes; the unpatched JAX SSD runs a bf16 data path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeSpec as JServeSpec
from repro.serve import StepClock as JStepClock
from repro_torch import configs
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import (Engine, PagedKVCache, Request, ServeSpec,
                               StepClock)

PROMPTS = [(7, 5), (13, 9), (3, 4), (20, 6), (9, 12), (5, 1)]  # (len, max_new)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"), n_layers=2,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), n_layers=2,
                               dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, tcfg.vocab_size, n, dtype=np.int32), m)
               for n, m in PROMPTS]
    return jcfg, tcfg, jparams, tparams, prompts


def _jax_results(jcfg, jparams, prompts, spec_kw):
    # one device, as the ``tiny`` fixture of test_serve_scheduler.py; Auto
    # axes so the engine's sharding hints stay hints on every JAX version
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        eng = JEngine(jcfg, mesh, jparams, JServeSpec(**spec_kw),
                      clock=JStepClock())
        for toks, m in prompts:
            eng.submit(JRequest(tokens=toks, max_new=m))
        return eng.drain()


def test_engine_tokens_and_slots_match_jax(tiny):
    jcfg, tcfg, jparams, tparams, prompts = tiny
    spec_kw = dict(batch=4, cache_len=64)
    ref = _jax_results(jcfg, jparams, prompts, spec_kw)
    eng = Engine(tcfg, tparams, ServeSpec(**spec_kw), device="cpu",
                 clock=StepClock())
    rids = [eng.submit(Request(tokens=t, max_new=m)) for t, m in prompts]
    out = eng.drain()
    assert sorted(out) == sorted(ref) == rids
    for rid in rids:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens)
        assert out[rid].slot == ref[rid].slot
        assert out[rid].token_times_s == ref[rid].token_times_s
        assert out[rid].finish_reason == "length"
        assert out[rid].n_tokens == PROMPTS[rid][1]
    st = eng.stats()
    assert st["prefills"] == len(PROMPTS)
    assert st["prefill_tokens"] == sum(n for n, _ in PROMPTS)
    # every token but each request's first comes from a decode step
    assert st["decode_tokens"] == sum(m - 1 for _, m in PROMPTS)


def test_engine_step_result_and_cancel(tiny):
    _, tcfg, _, tparams, prompts = tiny
    eng = Engine(tcfg, tparams, ServeSpec(batch=2, cache_len=32),
                 device="cpu", clock=StepClock())
    a = eng.submit(Request(tokens=prompts[0][0], max_new=3))
    b = eng.submit(Request(tokens=prompts[1][0], max_new=8))
    c = eng.submit(Request(tokens=prompts[2][0], max_new=2))
    assert eng.step() == [] and eng.result(a) is None
    assert eng.cancel(c)                      # still queued: both rows busy
    assert eng.result(c).finish_reason == "evicted"
    done = eng.step()
    assert [r.rid for r in done] == [a]
    assert eng.cancel(b) and eng.result(b).finish_reason == "evicted"
    assert not eng.cancel(b)
    assert eng.drain().keys() == {a, b, c}
    assert eng.stats()["decode_steps"] == 2


def test_spec_validation():
    with pytest.raises(ValueError, match="auto"):
        ServeSpec(batch=1, cache_len=16, fused_stats="jnp").validate()
    with pytest.raises(ValueError):
        ServeSpec(batch=1, cache_len=16, combine="bogus").validate()
    # a pod's own ranks hold the cache: ("data",) is taken, others are not
    ServeSpec(batch=1, cache_len=16, seq_axes=("data",)).validate()
    ServeSpec(batch=1, cache_len=16, seq_axes="data").validate()
    with pytest.raises(ValueError, match="seq_axes"):
        ServeSpec(batch=1, cache_len=16, seq_axes=("model",)).validate()
    ServeSpec(batch=2, cache_len=16, combine="locality").validate()
    with pytest.raises(ValueError, match="auto"):
        Engine(None, {}, ServeSpec(batch=1, cache_len=16, fused_stats="jnp"),
               device="cpu")
    with pytest.raises(ValueError):
        Request(tokens=np.zeros((2, 3), np.int32), max_new=1)
    with pytest.raises(ValueError):
        Request(tokens=[1, 2], max_new=0)


def test_submit_rejects_oversized_request(tiny):
    _, tcfg, _, tparams, _ = tiny
    eng = Engine(tcfg, tparams, ServeSpec(batch=1, cache_len=16),
                 device="cpu")
    with pytest.raises(ValueError, match="never fit"):
        eng.submit(Request(tokens=np.ones(12, np.int32), max_new=8))


def test_paged_copy_keeps_invariants():
    paged = PagedKVCache(batch=3, cache_len=32, page_len=8)
    rows = [paged.reserve(rid, 10, 6) for rid in range(3)]
    assert sorted(rows) == [0, 1, 2] and paged.reserve(9, 1, 1) is None
    paged.check_invariants()
    assert paged.release(1) == rows[1] and paged.reserve(9, 1, 1) == rows[1]
    paged.check_invariants()


def test_mamba_engine_tokens_and_slots_match_jax(monkeypatch):
    from repro.models import ssm as jssm
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-780m"), n_layers=2,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("mamba2-780m"), n_layers=2,
                               dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    calls, ssd = [], jssm.ssd_chunked

    def precise(*a, **kw):
        calls.append(1)
        return ssd(*a, **{**kw, "precise": True})

    monkeypatch.setattr(jssm, "ssd_chunked", precise)
    rng = np.random.default_rng(1)
    # prompts of 2+ tokens: the JAX forward cannot prefill one token
    prompts = [(rng.integers(0, tcfg.vocab_size, n, dtype=np.int32), m)
               for n, m in [(7, 5), (40, 9), (3, 4), (20, 6), (64, 3),
                            (5, 1)]]
    spec_kw = dict(batch=3, cache_len=128)
    ref = _jax_results(jcfg, jparams, prompts, spec_kw)
    assert calls, "the JAX engine did not trace the patched ssd_chunked"
    eng = Engine(tcfg, tparams, ServeSpec(**spec_kw), device="cpu",
                 clock=StepClock())
    rids = [eng.submit(Request(tokens=t, max_new=m)) for t, m in prompts]
    out = eng.drain()
    assert sorted(out) == sorted(ref) == rids
    for rid in rids:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens)
        assert out[rid].slot == ref[rid].slot
        assert out[rid].token_times_s == ref[rid].token_times_s
        assert out[rid].n_tokens == prompts[rid][1]
    assert eng.stats()["prefills"] == len(prompts)


def test_moe_engine_tokens_and_slots_match_jax():
    """The reduced qwen2-moe-a2.7b (2 layers, 8 experts at top-4, 2 shared
    experts, an untied head, fp32): each prompt prefills at its own length,
    so its experts' capacity is the JAX engine's (S·K/E·1.25, at least K)
    and a decode step's is K; the tokens and rows equal the JAX engine's.
    A (pod, data) grid resolves (tests/test_torch_moe_grid.py serves it),
    and so does a model tier (tests/test_torch_moe_tp.py serves it)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen2-moe-a2.7b"),
                               n_layers=2, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("qwen2-moe-a2.7b"),
                               n_layers=2, dtype=torch.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    assert tuple(tparams["head"].shape) == (tcfg.d_model, tcfg.padded_vocab)
    rng = np.random.default_rng(2)
    prompts = [(rng.integers(0, tcfg.vocab_size, n, dtype=np.int32), m)
               for n, m in PROMPTS]
    spec_kw = dict(batch=4, cache_len=64)
    ref = _jax_results(jcfg, jparams, prompts, spec_kw)
    eng = Engine(tcfg, tparams, ServeSpec(**spec_kw), device="cpu",
                 clock=StepClock())
    rids = [eng.submit(Request(tokens=t, max_new=m)) for t, m in prompts]
    out = eng.drain()
    assert sorted(out) == sorted(ref) == rids
    for rid in rids:
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens)
        assert out[rid].slot == ref[rid].slot
        assert out[rid].token_times_s == ref[rid].token_times_s

    class Grid:
        q, pl, m = 2, 2, 1
    assert ServeSpec(batch=4, cache_len=64).resolve(tcfg, Grid()
                                                    ).batch_sharded
    Grid.m = 2
    assert ServeSpec(batch=4, cache_len=64).resolve(tcfg, Grid()).m == 2
