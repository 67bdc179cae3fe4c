"""Training of the dense variants on a ("pod", "data", "model") grid of
spawned gloo ranks (CPU), against the JAX ``make_train_step`` on a (2, 2, 2)
mesh of forced host devices.

The models, fp32: gemma2's smoke config at 3 layers (4 q and 2 KV heads of
32, window 64, softcaps 50 / 30, sandwich norms, GeGLU, the scaled and
tied embedding; its plan window, full, window stacks ``blocks/slot0`` and
``blocks/slot1`` over one period and keeps the third layer in ``rest``)
and h2o-danube's with ``head_dim=120`` at 2 layers (every layer a window
of 64, the untied head), from the JAX ``init_params`` tree (PRNGKey 0,
jitted); sequences of 96 tokens, so the window bites. One JAX subprocess
with 8 forced host devices runs both models in turn
(``torch_helpers.JAX_TP_REFERENCE`` with ``replace``), started first, on
``jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=
(AxisType.Auto,) * 3)`` under ``with mesh:``: two steps of
``SyntheticLM(seed=0)`` batches of 8 x 96 tokens with ``AdamW()``,
locality + FSDP, locality + FSDP + ``seq_shard`` and xla + FSDP. The port
runs the same steps on 2 x 2 x 2 gloo ranks: a model rank holds its q
heads and their KV heads, its MLP columns and its vocabulary rows (of an
untied head its vocabulary columns), runs flash attention over its heads
with the layer's window and the softcap, and norms the tier's sums with
the post-norms (``transformer.block_train`` with ``tp``).

Limits (``tests/test_torch_tp.py``'s): losses and grad norms 1e-5
relative, parameters within 9e-5 absolute and at most 1 in 10,000
elements beyond 1e-5. ``prefetch_depth=1`` is bitwise the eager step. A
1 x 2 x 4 grid (one q head a rank; the 2 KV heads each read by two ranks,
``wk``/``wv`` gathered over the tier) against the port's one rank at the
same limits. yi-6b's smoke config (4 layers, the untied head) on 2 x 2 x
2 against one rank for one step, its head's shards the rank's vocabulary
columns. The launcher's ``--mesh 2x2x2 --arch gemma2-9b --smoke`` trains
on the module's ranks. The
norm scales' gradients (AdamW's first moments after the steps) equal one
rank's under ``seq_shard``, where each model rank norms S/m positions and
the step sums them over the tier, and without it, where every rank norms
them all and nothing is summed.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_helpers as H
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap

REPO = Path(__file__).resolve().parents[1]
# name -> (arch, layers, the smoke config's fields replaced)
MODELS = {"gemma2": ("gemma2-9b", 3, {}),
          "danube": ("h2o-danube-3-4b", 2, {"head_dim": 120})}
YI = ("yi-6b", 4, {})
B, S, STEPS = 8, 96, 2
YI_STEPS = 1
REL = 1e-5
# the norm scales' first moments: within MU_REL of the leaf's largest
# element (read: 1.1e-5, one element of gemma2's blocks/slot1/ln2/scale,
# fp32 sums in other orders over two steps); a missing tier sum leaves a
# rank's share of it, a sum where none belongs doubles it
MU_REL = 1e-4
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 9e-5, 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": dict(grad_sync="locality", fsdp=True),
                "seq_shard": dict(grad_sync="locality", fsdp=True,
                                  seq_shard=True),
                "xla": dict(grad_sync="xla", fsdp=True)}
PORT_VARIANTS = {**JAX_VARIANTS,
                 "prefetch": dict(fsdp=True, prefetch_depth=1)}
# the runs whose AdamW moments come back (the norm scales' gradients)
MOMENTS = ("fsdp", "seq_shard", "one")


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, both models in one subprocess, started first so
    that it runs beside the ranks."""
    tmp = tmp_path_factory.mktemp("jax_variants_tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"models": {
        name: dict(arch=arch, n_layers=n, replace=kw, global_batch=B,
                   seq_len=S, steps=STEPS, variants=JAX_VARIANTS)
        for name, (arch, n, kw) in MODELS.items()}}))
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
    out = {}
    for name in MODELS:
        res = json.loads((tmp / name / "out.json").read_text())
        for variant in ["params0", *JAX_VARIANTS]:
            with np.load(tmp / name / f"{variant}.npz") as z:
                res.setdefault("params", {})[variant] = dict(z)
        out[name] = res
    return out


def _flat(tree) -> dict:
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def params0(jax_proc):
    """Each model's JAX ``init_params`` tree (PRNGKey 0, jitted as
    ``init_state`` jits it) by leaf path, drawn here so the ranks start
    while the reference runs (held equal to its ``init_state``'s in
    ``test_variant_tp_step_matches_jax_on_2x2x2``); and yi-6b's, the port's
    own init from seed 0."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as T
    out = {}
    for name, (arch, n, kw) in MODELS.items():
        cfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=n,
                                  dtype=jnp.float32, **kw)
        out[name] = _flat(jax.jit(lambda k: jtransformer.init_params(
            k, cfg))(jax.random.PRNGKey(0)))
    arch, n, _ = YI
    cfg = H._small_cfg(arch, n)
    tree = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out["yi"] = _flat(tree)
    return out


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, params0):
    """{model: {run: per-rank results}}: each of ``PORT_VARIANTS`` on 2 x 2
    x 2, 1 x 2 x 4 and one rank; yi-6b on 2 x 2 x 2 and one rank for
    ``YI_STEPS``, and its initial shards."""
    out = {}
    for name, (arch, n, kw) in [*MODELS.items(), ("yi", YI)]:
        steps = STEPS if name in MODELS else YI_STEPS

        def run(q, pl, m, vkw, run_name, steps=steps):
            return pool.run(H.task_train, q, pl, params0[name], n, steps, B,
                            S, vkw, arch, m, kw, run_name in MOMENTS)
        variants = PORT_VARIANTS if name in MODELS else {
            "fsdp": PORT_VARIANTS["fsdp"]}
        out[name] = {v: run(2, 2, 2, vkw, v) for v, vkw in variants.items()}
        if name in MODELS:
            out[name]["1x2x4"] = run(1, 2, 4, dict(fsdp=True), "1x2x4")
        else:
            out[name]["init"] = run(2, 2, 2, dict(fsdp=True), "init", 0)
        out[name]["one"] = run(None, None, 1, {}, "one")
    return out


def _metrics(res) -> tuple[np.ndarray, np.ndarray]:
    m = res[0]["metrics"]
    return (np.array([x["loss"] for x in m]),
            np.array([x["grad_norm"] for x in m]))


def _same_metrics_everywhere(res) -> None:
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]


def _close_params(got: dict, want: dict) -> None:
    """Every element within PARAM_ATOL, all but PARAM_FAR_SHARE of them
    within PARAM_CLOSE."""
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


def _against_one_rank(res, one, pl: int, m: int) -> None:
    _same_metrics_everywhere(res)
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(one)
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    _close_params(H.assemble_tp(res, pl, m), one[0]["shards"])


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
@pytest.mark.parametrize("name", list(MODELS))
def test_variant_tp_step_matches_jax_on_2x2x2(trained, jax_out, params0,
                                              name, variant):
    """Losses, grad norms and parameters after two steps equal the JAX
    (2, 2, 2) step's; every rank agrees; gemma2's tree keeps its two slots
    and its ``rest`` layer."""
    for path, a in jax_out[name]["params"]["params0"].items():
        assert np.array_equal(params0[name][path], a), path
    res = trained[name][variant]
    _same_metrics_everywhere(res)
    loss, gnorm = _metrics(res)
    ref = jax_out[name][variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    got = H.assemble_tp(res, 2, 2)
    if name == "gemma2":
        assert {p.split("/")[1] for p in got if p.startswith("blocks/")} \
            == {"slot0", "slot1"}
        assert "rest/0/post_ln2/scale" in got
    _close_params(got, jax_out[name]["params"][variant])


@pytest.mark.parametrize("name", list(MODELS))
def test_variant_tp_prefetch_is_bitwise_the_eager_step(trained, name):
    """Each layer's gathers (a slot's rep or a ``rest`` layer) started one
    layer ahead: bitwise the eager step, every layer gathered once."""
    eager, pf = trained[name]["fsdp"], trained[name]["prefetch"]
    for a, b in zip(eager, pf):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path
    n = MODELS[name][1]
    other = 1 if name == "gemma2" else 2          # embed (and the head)
    assert pf[0]["meter"]["gathers"] == STEPS * (n * 7 + other)
    assert eager[0]["meter"]["gathers"] == STEPS * (2 * n * 7 + other)


@pytest.mark.parametrize("name", list(MODELS))
def test_variant_kv_heads_split_over_4_model_ranks_match_one_rank(trained,
                                                                 name):
    """1 x 2 x 4: one q head a rank and 2 KV heads; each rank gathers
    wk/wv over the tier and takes the KV head its q head reads, whose
    gradient the gather's reduce-scatter sums."""
    res = trained[name]["1x2x4"]
    D = 120 if name == "danube" else 32
    assert res[0]["mdims"]["blocks/slot0/attn/wk"] == 2
    assert res[0]["shards"]["blocks/slot0/attn/wk"].shape[-1] == 2 * D // 4
    _against_one_rank(res, trained[name]["one"], 2, 4)


def test_untied_head_splits_by_vocabulary_columns(trained, params0):
    """yi-6b on 2 x 2 x 2: ``head`` (d, Vpad) is cut into the model
    ranks' vocabulary columns, then over the lane's FSDP rows; the step
    equals one rank's."""
    init = trained["yi"]["init"]
    head = params0["yi"]["head"]
    d, V = head.shape
    for r in init:
        assert (r["mdims"]["head"], r["dims"]["head"]) == (1, 0)
        t, lane = r["coords"]["t"], r["coords"]["rank"]
        want = head[lane * d // 4:(lane + 1) * d // 4,
                    t * V // 2:(t + 1) * V // 2]
        assert np.array_equal(r["shards"]["head"], want)
    _against_one_rank(trained["yi"]["fsdp"], trained["yi"]["one"], 2, 2)


@pytest.mark.parametrize("variant", ["fsdp", "seq_shard"])
@pytest.mark.parametrize("name", list(MODELS))
def test_norm_scale_gradients_take_the_tier_sum_under_seq_shard_only(
        trained, name, variant):
    """AdamW's first moment of every norm scale (gemma2's post-norms,
    ``blocks/slot{j}/post_ln{1,2}/scale`` and ``rest/0/...``, among them)
    equals one rank's on every rank of the tier: under ``seq_shard`` each
    rank's gradient covers S/m positions and the step sums them over the
    tier; without it every rank's is whole already, and a sum would double
    it."""
    res, one = trained[name][variant], trained[name]["one"][0]["mu"]
    scales = [p for p in one if p.endswith("/scale")]
    post = [p for p in scales if "/post_ln" in p]
    if name == "gemma2":
        assert len(post) == 6 and any(p.startswith("rest/") for p in post)
    for r in res:
        assert r["mdims"]["final_norm/scale"] < 0
        for path in scales:
            got, want = r["mu"][path], one[path]
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=MU_REL * scale, err_msg=path)


@pytest.mark.parametrize("name", list(MODELS))
def test_variant_tp_messages_follow_the_oracle(trained, name):
    """Per rank and step, the parameter gathers' and reduce-scatters'
    non-local messages over a model lane (2 x 2 ranks) are the
    locality-Bruck schedule's for that rank, times the calls; the model
    tier's collectives send none across a pod."""
    oracle = TS.locality_bruck(4, 2).per_rank_stats(RegionMap(4, 2))
    for variant in ("fsdp", "seq_shard", "prefetch"):
        for r in trained[name][variant]:
            mt, lane_rank = r["meter"], r["coords"]["rank"]
            assert mt["gather"]["permute_edges_nonlocal"] == \
                mt["gathers"] * oracle[lane_rank][2]
            assert mt["reduce_scatter"]["permute_edges_nonlocal"] == \
                mt["reduce_scatters"] * oracle[lane_rank][2]
            assert mt["model_calls"] > 0
            assert mt["model"]["group_msgs_nonlocal"] == 0
            assert mt["model"]["group_msgs_local"] > 0


def test_launcher_trains_gemma2_on_2x2x2(pool, monkeypatch, capsys):
    """``launch.train --mesh 2x2x2 --arch gemma2-9b --smoke --device cpu
    --fsdp`` on the module's 8 ranks (its ``run_ranks`` given the pool):
    the step's losses finite and equal on every rank, the tier's calls
    inside each pod."""
    from repro_torch.launch import serve, train as launch

    def on_pool(world, fn, args, **_):
        assert (world, fn) == (8, launch._train_rank)
        return pool.run(H.task_launch_train, args)
    monkeypatch.setattr(serve, "run_ranks", on_pool)
    launch.main(["--mesh", "2x2x2", "--arch", "gemma2-9b", "--smoke",
                 "--device", "cpu", "--fsdp", "--steps", "1", "--layers",
                 "3", "--seq-len", "16", "--global-batch", "4"])
    out = capsys.readouterr().out
    assert ("[train] gemma2-9b-smoke (3 layers) on 8 ranks (2x2x2 over "
            "pod,data,model, cpu), grad_sync locality, fsdp True") in out
    losses = json.loads(out.split("losses ")[1].split(" in ")[0])
    assert len(losses) == 1 and np.isfinite(losses[0])
    tier = re.findall(r"model-tier calls (\d+) \(non-local msgs (\d+)\)",
                      out)
    assert len(tier) == 8
    assert all(int(calls) > 0 and far == "0" for calls, far in tier)
