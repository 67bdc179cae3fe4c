"""Tensor-parallel FSDP training of the port on a ("pod", "data", "model")
grid of spawned gloo ranks (CPU), against the JAX ``make_train_step`` on a
(2, 2, 2) mesh of forced host devices.

A reduced llama3.2-3b (2 layers, d_model 128, 4 q and 2 KV heads of 32,
d_ff 256, padded vocabulary 512, fp32) from the JAX ``init_params`` tree
(PRNGKey 0) trains two steps on ``SyntheticLM(seed=0)`` batches of 8 x 32
tokens with ``AdamW()``. One JAX subprocess with 8 forced host devices runs
the step on ``jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
axis_types=(AxisType.Auto,) * 3)`` under ``with mesh:`` (no
``jax.set_mesh``: with it the embedding gather raises ShardingTypeError on
jax 0.9.0, the recipe of ``tests/test_distributed.py``): locality + FSDP,
locality + FSDP + ``seq_shard``, locality without FSDP, and ``xla`` + FSDP.
The port runs the same steps on 2 x 2 x 2 gloo ranks (``RankGrid.build(2,
2, 2)``: Megatron-style column- and row-parallel projections, the
vocabulary-parallel embedding, head and cross-entropy over "model", FSDP
over each model lane).

Limits: losses and grad norms 1e-5 relative (``tests/test_torch_train.py``'s;
the largest reading 3.1e-7); parameters within 9e-5 absolute, three times
the largest reading (2.98e-5: one element of ``wq`` against JAX's xla
step, where FSDP alone read 9.8e-6; the model tier's sums in other orders
move an update whose gradient is near Adam's eps), and at most 1 in 10,000
elements beyond 1e-5 (read: 2 of 361,088). ``flat_psum`` and
``locality_rd`` (1.5e-10 and 0 apart) and one rank (1.9e-5) are held
against the port's ``locality`` at the same limits; ``prefetch_depth=1`` is
bitwise the eager step; a 1 x 2 x 4 grid, where 4 model ranks split 2 KV
heads (each rank gathers ``wk``/``wv`` over the tier and takes the head its
q head reads), against one rank (1.1e-5).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_helpers as H
from conftest import fake_mesh
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap

REPO = Path(__file__).resolve().parents[1]
N_LAYERS, B, S, STEPS = 2, 8, 32, 2
REL = 1e-5
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 9e-5, 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": dict(grad_sync="locality", fsdp=True),
                "seq_shard": dict(grad_sync="locality", fsdp=True,
                                  seq_shard=True),
                "replicated": dict(grad_sync="locality", fsdp=False),
                "xla": dict(grad_sync="xla", fsdp=True)}
PORT_VARIANTS = {**JAX_VARIANTS,
                 "prefetch": dict(fsdp=True, prefetch_depth=1),
                 "seq_prefetch": dict(fsdp=True, seq_shard=True,
                                      prefetch_depth=1),
                 "flat_psum": dict(grad_sync="flat_psum", fsdp=True),
                 "locality_rd": dict(grad_sync="locality_rd", fsdp=True)}


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs beside the ranks."""
    tmp = tmp_path_factory.mktemp("jax_tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(dict(n_layers=N_LAYERS, global_batch=B,
                                    seq_len=S, steps=STEPS,
                                    variants=JAX_VARIANTS)))
    with open(tmp / "log.txt", "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", H.JAX_TP_REFERENCE, str(tmp), str(plan)],
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
    out = json.loads((tmp / "out.json").read_text())
    for name in ["params0", *JAX_VARIANTS]:
        with np.load(tmp / f"{name}.npz") as z:
            out.setdefault("params", {})[name] = dict(z)
    return out


@pytest.fixture(scope="module")
def params0(jax_proc):
    """The JAX ``init_params`` tree (PRNGKey 0, jitted as ``init_state``
    jits it) by leaf path, drawn here so the ranks start while the
    reference runs (held equal to its ``init_state``'s in
    ``test_tp_step_matches_jax_on_2x2x2``)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer
    cfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"),
                              n_layers=N_LAYERS, dtype=jnp.float32)
    tree = jax.jit(lambda k: transformer.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, params0):
    """{variant: per-rank results} on 2 x 2 x 2; the 1 x 2 x 4 run and
    one rank's."""
    run = lambda q, pl, m, kw: pool.run(
        H.task_train, q, pl, params0, N_LAYERS, STEPS, B, S, kw,
        "llama3.2-3b", m)
    out = {name: run(2, 2, 2, kw) for name, kw in PORT_VARIANTS.items()}
    out["1x2x4"] = run(1, 2, 4, dict(fsdp=True))
    out["one"] = run(None, None, 1, {})
    return out


def _metrics(res) -> tuple[np.ndarray, np.ndarray]:
    m = res[0]["metrics"]
    return (np.array([x["loss"] for x in m]),
            np.array([x["grad_norm"] for x in m]))


def _close_params(got: dict, want: dict) -> None:
    """Every element within PARAM_ATOL, all but PARAM_FAR_SHARE of them
    within PARAM_CLOSE."""
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


def _same_metrics_everywhere(res) -> None:
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_tp_step_matches_jax_on_2x2x2(trained, jax_out, params0, variant):
    """Losses, grad norms and parameters after two steps equal the JAX
    (2, 2, 2) step's; every rank agrees."""
    for path, a in jax_out["params"]["params0"].items():
        assert np.array_equal(params0[path], a), path
    res = trained[variant]
    _same_metrics_everywhere(res)
    loss, gnorm = _metrics(res)
    ref = jax_out[variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    _close_params(H.assemble_tp(res, 2, 2), jax_out["params"][variant])


@pytest.mark.parametrize("eager, prefetched", [("fsdp", "prefetch"),
                                               ("seq_shard", "seq_prefetch")])
def test_tp_prefetch_is_bitwise_the_eager_step(trained, eager, prefetched):
    for a, b in zip(trained[eager], trained[prefetched]):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path


@pytest.mark.parametrize("variant", ["flat_psum", "locality_rd", "one"])
def test_tp_other_modes_match_the_locality_step(trained, variant):
    res, ref = trained[variant], trained["fsdp"]
    _same_metrics_everywhere(res)
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(ref)
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    got = res[0]["shards"] if len(res) == 1 else H.assemble_tp(res, 2, 2)
    _close_params(got, H.assemble_tp(ref, 2, 2))


def test_kv_heads_split_over_4_model_ranks_match_one_rank(trained):
    """1 x 2 x 4: 4 q heads, one a rank, and 2 KV heads. The JAX rule
    shards wk/wv's 64 columns over the tier all the same (16 a rank, half a
    head), so each rank gathers them and takes its KV head; the gather's
    reduce-scatter sums their gradients."""
    res = trained["1x2x4"]
    assert res[0]["mdims"]["blocks/slot0/attn/wk"] == 2
    assert res[0]["shards"]["blocks/slot0/attn/wk"].shape == (2, 64, 16)
    _same_metrics_everywhere(res)
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(trained["one"])
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    _close_params(H.assemble_tp(res, 2, 4), trained["one"][0]["shards"])


def test_grid_rank_order_is_the_jax_mesh_order(trained, jax_out, pool):
    """Grid rank (R·pl + l)·m + t is the device at [R, l, t] of the JAX
    mesh; ``launch.mesh.make_mesh`` builds the same grid, and the
    ("data", "model") grid of 4 x 2."""
    ids = np.array(jax_out["device_ids"])
    for g, r in enumerate(trained["fsdp"]):
        c = r["coords"]
        R, l = divmod(c["rank"], 2)
        assert ids[R, l, c["t"]] == c["grid_rank"] == g
    got = pool.run(H.task_mesh, (2, 2, 2), ("pod", "data", "model"))
    for g, c in enumerate(got):
        assert (c["q"], c["pl"], c["m"], c["grid_rank"]) == (2, 2, 2, g)
        assert ids[c["R"], c["l"], c["t"]] == g
        assert c["model"] == [g - c["t"], g - c["t"] + 1]
        assert c["lane"] == list(range(c["t"], 8, 2))
    got = pool.run(H.task_mesh, (4, 2), ("data", "model"))
    assert [(c["q"], c["pl"], c["m"]) for c in got] == [(1, 4, 2)] * 8
    from repro_torch.launch.mesh import grid_shape
    assert grid_shape((2, 16, 16), ("pod", "data", "model")) == (2, 16, 16)
    assert grid_shape((16, 16), ("data", "model")) == (1, 16, 16)
    with pytest.raises(ValueError, match="row-major"):
        grid_shape((2, 2), ("model", "data"))


def _jax_specs(cfg_name: str, full: bool, shape, fsdp: bool) -> dict:
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer
    from repro.train.sharding import param_specs
    cfg = (jconfigs.get if full else jconfigs.get_smoke)(cfg_name)
    abstract = jax.eval_shape(lambda k: transformer.init_params(k, cfg),
                              jax.random.PRNGKey(0))
    mesh = fake_mesh(shape, ("pod", "data", "model"))
    specs = param_specs(abstract, mesh, fsdp=fsdp)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(sp)
            for path, sp in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=is_p)[0]}


def _port_specs(cfg_name: str, full: bool, shape, fsdp: bool) -> dict:
    from repro_torch.models import transformer as T
    from repro_torch.train.sharding import param_specs
    cfg = (configs.get if full else configs.get_smoke)(cfg_name)
    specs = param_specs(T.train_param_shapes(cfg),
                        dict(zip(("pod", "data", "model"), shape)),
                        fsdp=fsdp)
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = tree
    walk(specs, ())
    return out


@pytest.mark.parametrize("full, shape", [(False, (2, 2, 2)),
                                         (True, (2, 2, 2)),
                                         (True, (2, 16, 16))])
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_equal_jax(full, shape, fsdp):
    """The port's ``param_specs`` is the JAX one for llama3.2-3b (reduced
    and full) on meshes without devices (``conftest.fake_mesh``)."""
    want = _jax_specs("llama3.2-3b", full, shape, fsdp)
    got = _port_specs("llama3.2-3b", full, shape, fsdp)
    norm = lambda sp: tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                            for e in sp)
    assert {k: norm(v) for k, v in got.items()} == \
        {k: norm(v) for k, v in want.items()}


def test_activation_kinds_are_the_jax_table():
    """The port's activation-kind table is the JAX hooks' one; a rank
    holds part of a "model" dim where m divides it, and with seq_shard
    the residual stream's sequence."""
    from repro.train import sharding as jsharding
    from repro_torch.train.sharding import ACT_RULES, act_spec
    assert ACT_RULES == jsharding._ACT_RULES
    axes = {"pod": 2, "data": 2, "model": 2}
    assert act_spec("act", (4, 32, 128), axes) == (None, None, None)
    assert act_spec("act", (4, 32, 128), axes, seq_shard=True) == \
        (None, "model", None)
    assert act_spec("act", (4, 33, 128), axes, seq_shard=True) == \
        (None, None, None)
    assert act_spec("act_heads", (4, 32, 3, 8), axes) == (None,) * 4
    assert act_spec("logits", (4, 32, 512), axes) == (None, None, "model")


def test_dp_messages_follow_the_oracle_and_the_tier_stays_local(trained):
    """Per rank and step, the parameter gathers' non-local messages over a
    model lane (2 x 2 ranks) are the locality-Bruck schedule's for that
    rank, times the gathers; the reduce-scatters' too, and the model
    tier's collectives send none across a pod."""
    oracle = TS.locality_bruck(4, 2).per_rank_stats(RegionMap(4, 2))
    for variant in ("fsdp", "seq_shard", "prefetch"):
        for r in trained[variant]:
            mt, lane_rank = r["meter"], r["coords"]["rank"]
            assert mt["gather"]["permute_edges_nonlocal"] == \
                mt["gathers"] * oracle[lane_rank][2]
            assert mt["reduce_scatter"]["permute_edges_nonlocal"] == \
                mt["reduce_scatters"] * oracle[lane_rank][2]
            assert mt["model_calls"] > 0
            assert mt["model"]["group_msgs_nonlocal"] == 0
            assert mt["model"]["group_msgs_local"] > 0
    assert trained["prefetch"][0]["meter"]["gathers"] == \
        STEPS * (N_LAYERS * 7 + 1)


def test_model_tier_refusals_name_their_items(pool):
    """On a model tier of 2, mamba2 with SSD heads that 2 does not divide
    is refused, training and serving, on every rank naming the heads,
    falling back to nothing (the ssm tier itself runs since item 13,
    tests/test_torch_ssm_tp.py); the MoE step is taken (item 14,
    tests/test_torch_moe_tp.py); the dense family serves on one (item 11's serving half,
    tests/test_torch_serve_tp.py)."""
    for msgs in pool.run(H.task_tp_refusals, 2, 2, 2):
        assert len(msgs) == 4
        assert "SSD heads 3" in msgs[0]
        assert "SSD heads 3" in msgs[1]
        assert msgs[2] is None
        assert msgs[3] is None
