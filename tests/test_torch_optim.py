"""The port's optimizer, schedules, data pipeline and FSDP sharding rules
against the JAX package's, on the same numpy inputs (one process, JAX on the
CPU). Tolerances: fp32 optimizer state and schedules 1e-6 relative (the
same arithmetic op for op, compiled by XLA on one side); batches and
sharding specs exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fake_mesh
from repro import configs as jconfigs
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import host_shard as jax_host_shard
from repro.models import transformer as jtransformer
from repro.optim import AdamW as JaxAdamW
from repro.optim import TrainState as JaxTrainState
from repro.optim import global_norm as jax_global_norm
from repro.optim import schedules as jschedules
from repro.train import sharding as jsharding
from repro_torch import configs
from repro_torch.data import SyntheticLM, host_shard
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, TrainState, global_norm, schedules
from repro_torch.optim.adamw import leaves
from repro_torch.train import sharding

REL = 1e-6


def _tree(seed: int) -> dict:
    """A small parameter-shaped tree: a stacked matrix (decayed), a vector
    (not decayed) and a nested leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(3, 8, 5), "b": f(7), "blocks": {"scale": f(2, 6),
                                                   "v": f(4)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("kw", [dict(), dict(clip_norm=0.0),
                                dict(weight_decay=0.0, b2=0.99),
                                dict(lr=1e-2, clip_norm=0.5)], ids=str)
def test_adamw_matches_jax_over_three_steps(kw):
    params, grads = _tree(0), [_tree(s) for s in (1, 2, 3)]
    jopt, topt = JaxAdamW(**kw), AdamW(**kw)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, params))
    tstate = TrainState.create(_torch_tree(params))
    for g in grads:
        jstate, jm = jopt.apply(jstate, jax.tree.map(jnp.asarray, g))
        tstate, tm = topt.apply(tstate, _torch_tree(g))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=REL)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(tstate.step) == int(jstate.step) == 3
    for name in ("params", "mu", "nu"):
        want = jax.tree.leaves(getattr(jstate, name))
        got = leaves(getattr(tstate, name))
        assert len(want) == len(got)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL,
                                       atol=1e-7)


def test_adamw_updates_in_place_in_slices(monkeypatch):
    """The update writes into the state's own tensors, a slice at a time
    (a slice shorter than the leaf gives the same result)."""
    from repro_torch.optim import adamw
    params, g = _tree(4), _tree(5)
    whole = TrainState.create(_torch_tree(params))
    AdamW().apply(whole, _torch_tree(g))
    monkeypatch.setattr(adamw, "CHUNK", 7)
    state = TrainState.create(_torch_tree(params))
    ids = [id(t) for t in leaves(state.params)]
    AdamW().apply(state, _torch_tree(g))
    assert [id(t) for t in leaves(state.params)] == ids
    for a, b in zip(leaves(state.params), leaves(whole.params)):
        assert torch.equal(a, b)


def test_global_norm_matches_jax():
    tree = _tree(6)
    np.testing.assert_allclose(
        float(global_norm(_torch_tree(tree))),
        float(jax_global_norm(jax.tree.map(jnp.asarray, tree))), rtol=REL)


@pytest.mark.parametrize("steps", [[1, 2, 3], [1, 5, 10, 11, 50, 100, 150]])
def test_schedules_match_jax(steps):
    for step in steps:
        s = np.int32(step)
        assert float(schedules.constant(3e-4)(torch.tensor(s))) == \
            float(jschedules.constant(3e-4)(jnp.asarray(s)))
        for args in ((1e-3, 10, 100), (3e-4, 0, 50, 0.0)):
            np.testing.assert_allclose(
                float(schedules.cosine_warmup(*args)(torch.tensor(s))),
                float(jschedules.cosine_warmup(*args)(jnp.asarray(s))),
                rtol=REL)


@pytest.mark.parametrize("shape", [(512, 32, 8, 0), (128256, 64, 4, 3)])
def test_synthetic_lm_batches_are_bitwise_the_jax_ones(shape):
    V, S, B, seed = shape
    ours, ref = SyntheticLM(V, S, B, seed), JaxSyntheticLM(V, S, B, seed)
    for step in (0, 1, 7):
        a, b = ours.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for host in range(2):
            x, y = host_shard(a, host, 2), jax_host_shard(b, host, 2)
            assert all(np.array_equal(x[k], y[k]) for k in x)


def _jax_spec_pairs(cfg, shape) -> dict:
    mesh = fake_mesh(shape, ("pod", "data"))
    abstract = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                              jax.random.PRNGKey(0))
    specs = jsharding.param_specs(abstract, mesh, fsdp=True)
    dims = jax.tree.leaves(jsharding.fsdp_param_dims(specs))
    axes = jax.tree.leaves(jsharding.fsdp_param_axes(specs))
    paths = ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(abstract)[0]]
    return dict(zip(paths, zip(dims, axes)))


@pytest.mark.parametrize("arch", ["full", "smoke"])
@pytest.mark.parametrize("shape", [(2, 4), (3, 4), (4, 4)], ids=str)
def test_param_specs_match_jax(arch, shape):
    """(FSDP dim, axes) of every leaf of llama3.2-3b (published and
    reduced) on the JAX package's abstract meshes."""
    name = "llama3.2-3b"
    jcfg = (jconfigs.get(name) if arch == "full" else jconfigs.get_smoke(name))
    tcfg = configs.get(name) if arch == "full" else configs.get_smoke(name)
    want = _jax_spec_pairs(jcfg, shape)
    specs = sharding.param_specs(T.train_param_shapes(tcfg),
                                 {"pod": shape[0], "data": shape[1]},
                                 fsdp=True)
    shapes = T.train_param_shapes(tcfg)
    paths = sorted(want)
    assert len(leaves(shapes)) == len(paths)
    got = dict(zip(paths, zip(leaves(sharding.fsdp_param_dims(specs)),
                              leaves(sharding.fsdp_param_axes(specs)))))
    assert got == want
    # the block slice dims and the gather split, as the JAX helpers give
    jdims = {p: d for p, (d, _) in want.items()}
    assert sharding.block_slice_dims(jdims) == \
        jsharding.block_slice_dims(jdims)
    for ax in ("pod,data", "data", ""):
        assert sharding.gather_outer_local(ax) == \
            jsharding.gather_outer_local(ax)
    # without FSDP every leaf is replicated
    plain = sharding.param_specs(shapes, {"pod": shape[0],
                                          "data": shape[1]})
    assert set(leaves(sharding.fsdp_param_dims(plain))) == {-1}


def test_train_params_from_jax_and_init_share_the_tree():
    """The JAX init tree converts leaf for leaf; the port's own init has
    the same structure and shapes, and its values are the serving
    ``init_params``' for the same generator."""
    cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), n_layers=2)
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"), n_layers=2)
    tree = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    conv = T.train_params_from_jax(jax.tree.map(np.asarray, tree), cfg)
    flat = jax.tree.leaves(tree)
    assert [tuple(t.shape) for t in leaves(conv)] == [a.shape for a in flat]
    assert all(np.array_equal(t.numpy(), np.asarray(a))
               for t, a in zip(leaves(conv), flat))
    own = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [t.shape for t in leaves(own)] == [t.shape for t in leaves(conv)]
    serve = T.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(own["blocks"]["slot0"]["attn"]["wo"][1],
                       serve["layers.1.wo"])
    assert torch.equal(own["embed"], serve["embed"])
