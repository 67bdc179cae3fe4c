"""Training of the dense variants (gemma2-9b, h2o-danube-3-4b) in the port
against the JAX package, on the CPU, in fp32.

The models: gemma2's smoke config at 3 layers (head dim 32, window 64,
softcaps 50 / 30, sandwich norms, GeGLU, the scaled and tied embedding; its
plan window, full, window stacks ``blocks/slot0`` and ``blocks/slot1`` over
one period and keeps the third layer in ``rest``) and h2o-danube's with
``head_dim=120`` at 2 layers (every layer a window of 64, the untied head).
Sequences of 96 tokens, so the window bites.

- The plain capped backward (``attention_bwd_ref``) against ``jax.vjp`` of
  the JAX ``multihead_attention(..., window, cap)`` at D = 32, 120 and 256:
  2e-5 absolute and relative, the limit of ``tests/test_torch_backward.py``.
- One rank: ``forward_train``'s loss and every leaf's gradient against
  ``jax.value_and_grad`` of the JAX ``loss_fn`` on the same parameters and
  batch: the loss within 1e-5 relative, each gradient within 1e-5 of its
  largest element (fp32, other summation orders).
- The step: two steps of ``SyntheticLM(seed=0)`` batches of 8 x 96 tokens
  with ``AdamW()`` on 2 x 4 gloo ranks (``grad_sync="locality"``, FSDP, with
  and without ``prefetch_depth=1``) against one JAX subprocess with 8
  forced host devices running ``make_train_step(grad_sync="locality")`` on
  a (2, 4) ("pod", "data") mesh for both models in turn: losses and grad
  norms 1e-5 relative, parameters within 3e-5 and all but 1 in 10,000
  within 1e-5 (``tests/test_torch_train.py``'s limits; h2o-danube's
  parameters within 6e-5: one element of ``blocks/slot0/mlp/up``, whose
  first gradient, 1.08e-9, is below AdamW's eps of 1e-8, reads 4.73e-5
  from JAX's, 0.16 of an lr-sized update, where the 1e-10 by which fp32
  sums of its gradient differ move g / (|g| + eps) by that much; every
  other element is within 2e-5); the prefetch
  bitwise the eager step; every gather and reduce-scatter the JAX HLO's
  one shard-mapped gather, edge for edge, as many as the path implies.
- The tree: the JAX ``init_params`` tree converts leaf for leaf, the port's
  own init has its shapes and the serving init's values, and the FSDP
  specs are the JAX package's, ``rest`` and ``slot1`` included.
- The model tier takes them: ``make_train_step`` on a 2 x 2 x 2 grid
  builds the step of each variant (the steps themselves are held against
  the JAX (2, 2, 2) step in ``tests/test_torch_variants_tp.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as H
from conftest import fake_mesh
from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.train import sharding as jsharding
from repro.train.step import make_loss_fn
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import leaves
from repro_torch.train import sharding
from repro_torch.train.step import xent_loss

# the JAX step's subprocess starts with the module's first test and runs
# while the in-process tests do
pytestmark = pytest.mark.usefixtures("jax_proc")

REPO = Path(__file__).resolve().parents[1]
# name -> (arch, layers, the smoke config's fields replaced)
MODELS = {"gemma2": ("gemma2-9b", 3, {}),
          "danube": ("h2o-danube-3-4b", 2, {"head_dim": 120})}
B, S, STEPS = 8, 96, 2
REL = 1e-5
ATTN_TOL = 2e-5
PARAM_ATOL = {"gemma2": 3e-5, "danube": 6e-5}     # module docstring
PARAM_CLOSE, PARAM_FAR_SHARE = 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": {"fsdp": True},
                "prefetch": {"fsdp": True, "prefetch_depth": 1}}
# (B, S, H, KV, D, mask): S past the window, the caps of gemma2
ATTN_CASES = [(2, 96, 4, 2, 32, dict(causal=True, window=64, cap=50.0)),
              (1, 80, 4, 1, 120, dict(causal=True, window=32, cap=30.0)),
              (1, 70, 2, 1, 256, dict(causal=True, window=48, cap=50.0))]


def _cfgs(name: str):
    arch, n, kw = MODELS[name]
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=n,
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(configs.get_smoke(arch), n_layers=n,
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


def _flat(tree) -> dict:
    """{"a/b/c": numpy array} of a JAX or port tree."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = np.asarray(a.detach() if isinstance(a, torch.Tensor)
                              else a)
    return out


# ---------------------------------------------------------------------------
# the plain capped backward against jax.vjp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_capped_backward_plain_matches_jax_vjp(case):
    *dims, mask = case
    Bt, St, Hh, KV, D = dims
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = f(Bt, St, Hh, D), f(Bt, St, KV, D), f(Bt, St, KV, D), \
        f(Bt, St, Hh, D)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = flash_ops.flash_attention_lse(*t[:3], **mask)
    got = flash_ops.flash_attention_bwd(*t[:3], o, t[3], lse, **mask)
    jo, vjp = jax.vjp(lambda a, b, c: jattention.multihead_attention(
        a, b, c, **mask), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    for a, b in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# one rank against jax.value_and_grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MODELS))
def test_one_rank_loss_and_gradients_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, S), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (2, S), dtype=np.int32)
    loss_fn = make_loss_fn(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {"tokens": jnp.asarray(tokens),
                              "labels": jnp.asarray(labels)},
                          lambda x, _k: x), has_aux=True))(jparams)
    tree = T.train_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    for t in leaves(tree):
        t.requires_grad_(True)
    view = {"embed": tree["embed"],
            "final_norm": tree["final_norm"]["scale"],
            "layers": T.train_layers(tree, tcfg)}
    if not tcfg.tie_embeddings:
        view["head"] = tree["head"]
    logits, _ = T.forward_train(view, tcfg, torch.from_numpy(tokens).long())
    loss = xent_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL,
                               atol=0)
    got = dict(zip(H.tree_paths(tree), (t.grad for t in leaves(tree))))
    want = _flat(jgrads)
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path].numpy(), want[path]) < REL, path


# ---------------------------------------------------------------------------
# the parameter tree and its sharding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MODELS))
def test_the_tree_round_trips_and_inits_as_serving(name):
    """JAX -> port converts leaf for leaf, ``stack_tree`` inverts
    ``layer_leaves`` on every slot and ``rest`` layer, and the port's own
    init has the JAX shapes, contiguous leaves and the serving init's values
    for the same generator, layer i at its slot and rep or ``rest`` entry."""
    jcfg, tcfg = _cfgs(name)
    tree = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    conv = T.train_params_from_jax(jax.tree.map(np.asarray, tree), tcfg)
    want, got = _flat(tree), _flat(conv)
    assert list(got) == list(want)
    assert all(np.array_equal(got[p], want[p]) for p in want)
    plan = tcfg.layer_plan()
    for place, spec in T.train_slots(tcfg):
        node = conv[place[0]][place[1]]
        assert T.stack_tree(T.layer_leaves(node, tcfg), tcfg, spec) == node
    own = T.init_train_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [t.shape for t in leaves(own)] == [t.shape for t in leaves(conv)]
    assert all(t.is_contiguous() for t in leaves(own))
    shapes = T.train_param_shapes(tcfg)
    assert [t.shape for t in leaves(shapes)] == [t.shape for t in leaves(own)]
    serve = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    layers = T.train_layers(own, tcfg)
    assert len(layers) == len(plan) == tcfg.n_layers
    for i, lp in enumerate(layers):
        for n, t in lp.items():
            assert torch.equal(t, serve[f"layers.{i}.{n}"]), (i, n)
    assert torch.equal(own["embed"], serve["embed"])


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", [(2, 4), (3, 2)], ids=str)
def test_param_specs_match_jax(name, shape):
    """(FSDP dim, axes) of every leaf, ``slot1`` and ``rest`` included, on
    the JAX package's abstract meshes."""
    jcfg, tcfg = _cfgs(name)
    mesh = fake_mesh(shape, ("pod", "data"))
    abstract = jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg),
                              jax.random.PRNGKey(0))
    specs = jsharding.param_specs(abstract, mesh, fsdp=True)
    want = dict(zip(_flat(abstract), zip(
        jax.tree.leaves(jsharding.fsdp_param_dims(specs)),
        jax.tree.leaves(jsharding.fsdp_param_axes(specs)))))
    tspecs = sharding.param_specs(T.train_param_shapes(tcfg),
                                  {"pod": shape[0], "data": shape[1]},
                                  fsdp=True)
    got = dict(zip(H.tree_paths(tspecs), zip(
        leaves(sharding.fsdp_param_dims(tspecs)),
        leaves(sharding.fsdp_param_axes(tspecs)))))
    assert got == want


# ---------------------------------------------------------------------------
# the step on 2 x 4 gloo ranks against the JAX (2, 4) step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, both models in one subprocess, started first so
    that it runs while the in-process tests do."""
    tmp = tmp_path_factory.mktemp("jax_variants_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"models": {
        name: dict(arch=arch, n_layers=n, cfg_kw=kw, global_batch=B,
                   seq_len=S, steps=STEPS, variants=JAX_VARIANTS,
                   one_gather=[8 * 16, 4])
        for name, (arch, n, kw) in MODELS.items()}}))
    with open(tmp / "log.txt", "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", H.JAX_TRAIN_REFERENCE, str(tmp),
             str(tmp / "compile_cache"), str(plan)],
            env=env, stdout=fh, stderr=subprocess.STDOUT)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, tmp = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, (tmp / "log.txt").read_text()[-4000:]
    out = {}
    for name in MODELS:
        res = json.loads((tmp / name / "out.json").read_text())
        for variant in ["params0", *JAX_VARIANTS]:
            with np.load(tmp / name / f"{variant}.npz") as z:
                res.setdefault("params", {})[variant] = dict(z)
        out[name] = res
    return out


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, jax_out):
    """{model: {variant: per-rank results}} on 2 x 4."""
    out = {}
    for name, (arch, n, kw) in MODELS.items():
        params0 = jax_out[name]["params"]["params0"]
        out[name] = {variant: pool.run(H.task_train, 2, 4, params0, n, STEPS,
                                       B, S, vkw, arch, 1, kw)
                     for variant, vkw in JAX_VARIANTS.items()}
    return out


def _metrics(res):
    m = res[0]["metrics"]
    return (np.array([x["loss"] for x in m]),
            np.array([x["grad_norm"] for x in m]))


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
@pytest.mark.parametrize("name", list(MODELS))
def test_step_matches_jax_locality_on_2x4(trained, jax_out, name, variant):
    res = trained[name][variant]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    loss, gnorm = _metrics(res)
    ref = jax_out[name][variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    got, want = H.assemble(res, 4), jax_out[name]["params"][variant]
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL[name], err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


def _sharded_leaves(res) -> tuple[int, int]:
    """(sharded leaves of one layer, sharded leaves outside the layers)."""
    dims = res[0]["dims"]
    layer = sum(k >= 0 for p, k in dims.items()
                if p.startswith("blocks/slot0/"))
    other = sum(k >= 0 for p, k in dims.items()
                if not p.startswith(("blocks/", "rest/")))
    return layer, other


@pytest.mark.parametrize("name", list(MODELS))
def test_prefetch_is_bitwise_the_eager_step(trained, name):
    """Every layer gathers its 7 projections (slot or ``rest``), and the
    embedding (and the untied head): once a layer with the prefetch, twice
    under remat without it; one reduce-scatter each either way."""
    eager, pf = trained[name]["fsdp"], trained[name]["prefetch"]
    for a, b in zip(eager, pf):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path
    n = MODELS[name][1]
    layer, other = _sharded_leaves(eager)
    assert layer == 7 and other == (1 if name == "gemma2" else 2)
    assert pf[0]["meter"]["gathers"] == STEPS * (n * layer + other)
    assert eager[0]["meter"]["gathers"] == STEPS * (2 * n * layer + other)
    for res in (eager, pf):
        assert res[0]["meter"]["reduce_scatters"] == \
            STEPS * (n * layer + other)


def _summed(res, key) -> dict:
    out = {}
    for r in res:
        for k, v in r["meter"][key].items():
            out[k] = out.get(k, 0) + v
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_recorded_edges_against_the_jax_hlo(trained, jax_out, name):
    """Every parameter gather (and its reduce-scatter, the same edges
    reversed) against one shard-mapped JAX gather, edge for edge, times the
    path's calls; each rank's non-local messages the schedule oracle's."""
    one = jax_out[name]["one_gather"]
    oracle = TS.locality_bruck(8, 4).per_rank_stats(RegionMap(8, 4))
    assert one["permute_edges_nonlocal"] == sum(v[2] for v in oracle.values())
    for variant in JAX_VARIANTS:
        res = trained[name][variant]
        n_g = res[0]["meter"]["gathers"]
        n_rs = res[0]["meter"]["reduce_scatters"]
        for key, n in (("gather", n_g), ("reduce_scatter", n_rs)):
            got = _summed(res, key)
            for k in ("permute_edges_local", "permute_edges_nonlocal"):
                assert got[k] == n * one[k], (variant, key, k)
        per_rank = [r["meter"]["gather"]["permute_edges_nonlocal"]
                    for r in res]
        assert per_rank == [n_g * oracle[r][2] for r in range(8)]


def test_the_model_tier_refuses_the_variants(pool):
    """On a 2 x 2 x 2 grid ``make_train_step`` takes every variant's smoke
    config on every rank (gemma2's window, softcaps and sandwich norms,
    h2o-danube's windows and untied head, yi-6b's untied head): nothing is
    refused since the model tier's blocks run the variants' math."""
    for arch in ("gemma2-9b", "h2o-danube-3-4b", "yi-6b"):
        res = pool.run(H.task_variant_tier_refusal, 2, 2, 2, arch)
        assert res == [None] * 8, (arch, res)


def test_trainer_and_launcher_train_the_variants_on_one_rank(capsys):
    from repro_torch.launch import train as launch
    from repro_torch.train import Trainer, TrainerConfig
    cfg = _cfgs("gemma2")[1]
    tr = Trainer(cfg, None, TrainerConfig(steps=2, seq_len=S, global_batch=2,
                                          log_every=1), device="cpu")
    out = tr.run()
    assert out["steps"] == 2 and out["status"] == "complete"
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in tr.metrics_history)
    for arch, layers in (("gemma2-9b", "3"), ("h2o-danube-3-4b", "1")):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "1", "--layers", layers, "--seq-len", "16",
                     "--global-batch", "2"])
        assert f"[train] {arch}-smoke ({layers} layers) on cpu" in \
            capsys.readouterr().out
