"""FSDP training of the port on spawned gloo ranks (CPU), against the JAX
``make_train_step`` on forced host devices.

A reduced llama3.2-3b (2 layers, d_model 128, fp32) from the JAX
``init_params`` tree (PRNGKey 0, the JAX ``init_state``'s parameters)
trains two steps on ``SyntheticLM(seed=0)`` batches of 8 x 32 tokens with
``AdamW()``. One JAX subprocess with 8 forced host devices runs
``make_train_step(grad_sync="locality")`` on a (2, 4) ("pod", "data") mesh
with FSDP, with FSDP and ``prefetch_depth=1``, and without FSDP, and
returns the losses, grad norms, parameters and the compiled steps'
``collective_stats``, plus those of one shard-mapped parameter gather.

The port runs the same steps on 2 x 4 gloo ranks. Tolerances: losses and
grad norms 1e-5 relative (fp32, other summation orders); parameters
within 3e-5 absolute, and all but 1 in 10,000 elements within 1e-5 (the
largest difference on the CPU is 9.8e-6, FSDP against JAX; the port's
modes against each other differ by at most 5.4e-6). The card against the
CPU has its own limit, in ``chip_smoke.py`` phase 8b.
``locality_rd``, ``flat_psum``, ``xla`` and ``grad_accum=2`` are held
against the port's ``locality`` at the same tolerances, bf16 compression
of the sync at 1e-3; ``prefetch_depth=1`` is bitwise the eager step; a
3 x 2 grid, where d_model 128 does not divide over 6 ranks and every leaf
shards over "data" only (the pod allreduce), and one rank agree with it.
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
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap

REPO = Path(__file__).resolve().parents[1]
N_LAYERS, B, S, STEPS = 2, 8, 32, 2
REL = 1e-5
# parameters: every element within 3e-5 (three times the largest reading),
# and at most 1 in 10,000 beyond 1e-5
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 3e-5, 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": {"fsdp": True},
                "prefetch": {"fsdp": True, "prefetch_depth": 1},
                "replicated": {"fsdp": False}}
PORT_VARIANTS = {**JAX_VARIANTS,
                 "locality_rd": {"fsdp": True, "grad_sync": "locality_rd"},
                 "flat_psum": {"fsdp": True, "grad_sync": "flat_psum"},
                 "xla": {"fsdp": True, "grad_sync": "xla"},
                 "grad_accum": {"fsdp": True, "grad_accum": 2},
                 "compress": {"fsdp": False, "compress": True}}
# two microbatches need two rows a rank: grad_accum runs 16 rows, against
# one rank on the same 16
BATCH = {"grad_accum": 16}

JAX_REFERENCE = H.JAX_TRAIN_REFERENCE


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    tmp = tmp_path_factory.mktemp("jax_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(dict(arch="llama3.2-3b", n_layers=N_LAYERS,
                                    global_batch=B, seq_len=S, steps=STEPS,
                                    variants=JAX_VARIANTS,
                                    one_gather=[8 * 16, 4])))
    with open(tmp / "log.txt", "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(tmp),
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
    out = json.loads((tmp / "out.json").read_text())
    for name in ["params0", *JAX_VARIANTS]:
        with np.load(tmp / f"{name}.npz") as z:
            out.setdefault("params", {})[name] = dict(z)
    return out


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, jax_out):
    """{variant: per-rank results} on 2 x 4, and the one-rank run."""
    params0 = jax_out["params"]["params0"]
    run = lambda q, pl, kw, batch=B: pool.run(
        H.task_train, q, pl, params0, N_LAYERS, STEPS, batch, S, kw)
    out = {name: run(2, 4, kw, BATCH.get(name, B))
           for name, kw in PORT_VARIANTS.items()}
    out["one"] = run(None, None, {})
    out["one_12"] = run(None, None, {}, 12)
    out["one_16"] = run(None, None, {}, 16)
    out["3x2"] = run(3, 2, {"fsdp": True}, 12)
    return out


def _metrics(res) -> tuple[np.ndarray, np.ndarray]:
    m = res[0]["metrics"]
    return (np.array([x["loss"] for x in m]),
            np.array([x["grad_norm"] for x in m]))


def _close_params(got: dict, want: dict, atol: float) -> None:
    """Every element within ``atol``; with the default tolerance, also all
    but PARAM_FAR_SHARE of them within PARAM_CLOSE."""
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol,
                                   err_msg=path)
    if atol == PARAM_ATOL:
        diff = np.concatenate([np.abs(got[p] - want[p]).ravel()
                               for p in want])
        assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_step_matches_jax_locality_on_2x4(trained, jax_out, variant):
    """The port's losses, grad norms and parameters after two steps equal
    the JAX step's on the same (2, 4) layout; every rank agrees."""
    res = trained[variant]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    loss, gnorm = _metrics(res)
    ref = jax_out[variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    _close_params(H.assemble(res, 4), jax_out["params"][variant], PARAM_ATOL)


def test_prefetch_is_bitwise_the_eager_step(trained):
    eager, pf = trained["fsdp"], trained["prefetch"]
    for a, b in zip(eager, pf):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path
    assert pf[0]["meter"]["gathers"] == STEPS * (N_LAYERS * 7 + 1)
    assert eager[0]["meter"]["gathers"] == STEPS * (2 * N_LAYERS * 7 + 1)


@pytest.mark.parametrize("variant", ["locality_rd", "flat_psum", "xla",
                                     "grad_accum", "replicated", "one"])
def test_other_modes_match_the_locality_step(trained, variant):
    ref = trained["one_16" if variant == "grad_accum" else "fsdp"]
    res = trained[variant]
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(ref)
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    whole = lambda r: r[0]["shards"] if len(r) == 1 else H.assemble(r, 4)
    _close_params(whole(res), whole(ref), PARAM_ATOL)


def test_compressed_sync_stays_close(trained):
    """bf16 on the wire: the first loss is the same computation; after one
    update the loss and the parameters move by bf16 rounding (1e-3)."""
    loss, _ = _metrics(trained["compress"])
    want, _ = _metrics(trained["replicated"])
    assert loss[0] == want[0]
    np.testing.assert_allclose(loss, want, rtol=1e-3)
    _close_params(H.assemble(trained["compress"], 4),
                  H.assemble(trained["replicated"], 4), 1e-3)


def test_data_only_leaves_on_3x2_match_one_rank(trained):
    """d_model 128 does not divide over 6 ranks: every sharded leaf shards
    over "data" (the pod's 2 ranks), reduce-scatters there and adds the
    allreduce over its lane; the result is one rank's."""
    res = [r for r in trained["3x2"] if r is not None]
    assert len(res) == 6
    axes = res[0]["axes"]
    assert {a for a in axes.values()} == {"", "data"}
    assert axes["blocks/slot0/mlp/gate"] == "data"
    assert res[0]["meter"]["sync"]["permute_edges_nonlocal"] > 0
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(trained["one_12"])
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    _close_params(H.assemble(res, 2), trained["one_12"][0]["shards"],
                  PARAM_ATOL)


def _summed(res, key) -> dict:
    out = {}
    for r in res:
        for k, v in r["meter"][key].items():
            out[k] = out.get(k, 0) + v
    return out


def test_recorded_edges_against_the_jax_hlo(trained, jax_out):
    """Where the programs correspond one to one the port's messages are the
    JAX HLO's: the replicated step's gradient sync (one fp32 bucket through
    the locality allreduce), and each FSDP parameter gather (and its
    reduce-scatter, the same edges reversed) against one shard-mapped JAX
    gather of a leaf, edge for edge; the port repeats it per layer where the
    JAX step gathers the stacked leaves (ROADMAP.md Queue 3), so its totals
    are that gather's times the path's calls."""
    sync = _summed(trained["replicated"], "sync")
    hlo = jax_out["replicated"]["hlo"]
    for k in ("permute_edges_local", "permute_edges_nonlocal",
              "permute_bytes_local", "permute_bytes_nonlocal"):
        assert sync[k] / STEPS == hlo[k], k
    one = jax_out["one_gather"]
    oracle = TS.locality_bruck(8, 4).per_rank_stats(RegionMap(8, 4))
    assert one["permute_edges_nonlocal"] == sum(v[2] for v in oracle.values())
    for variant in ("fsdp", "prefetch"):
        res = trained[variant]
        n_g = res[0]["meter"]["gathers"]
        n_rs = res[0]["meter"]["reduce_scatters"]
        for key, n in (("gather", n_g), ("reduce_scatter", n_rs)):
            got = _summed(res, key)
            for k in ("permute_edges_local", "permute_edges_nonlocal"):
                assert got[k] == n * one[k], (variant, key, k)
        per_rank = [r["meter"]["gather"]["permute_edges_nonlocal"]
                    for r in res]
        assert per_rank == [n_g * oracle[r][2] for r in range(8)]


def test_refusals_name_their_items():
    from repro_torch.train import make_train_step
    from repro_torch.train.sharding import param_specs
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    from repro_torch.models.tp import check_tp
    for kw, item in ((dict(grad_sync="auto"), "item 8"),
                     (dict(prefetch_depth="auto"), "item 8"),
                     (dict(moe_dispatch="auto"), "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(cfg, None, device="cpu", **kw)
    assert make_train_step(H._small_cfg("mamba2-780m", 2), None,
                           device="cpu").step_fn is not None
    # the model tier (item 11's training half) is taken: seq_shard is a
    # no-op without one, the specs shard over "model"; so is the ssm
    # family's (item 13), but for SSD heads that m does not divide, and the
    # MoE family's (item 14), but for experts that m does not divide
    assert make_train_step(cfg, None, device="cpu",
                           seq_shard=True).step_fn is not None
    assert param_specs({"embed": torch.empty(4, 4)},
                       {"pod": 2, "data": 2, "model": 2}, fsdp=True) == \
        {"embed": ("model", ("pod", "data"))}
    check_tp(H._small_cfg("mamba2-780m", 2), 2)
    with pytest.raises(NotImplementedError, match="SSD heads 16"):
        check_tp(H._small_cfg("mamba2-780m", 2), 3)
    check_tp(H._small_cfg("qwen2-moe-a2.7b", 2), 2)
    with pytest.raises(NotImplementedError, match="n_experts 6"):
        check_tp(dataclasses.replace(H._small_cfg("qwen2-moe-a2.7b", 2),
                                     n_experts=6), 4)
    with pytest.raises(ValueError, match="prefetch_depth"):
        make_train_step(cfg, None, device="cpu", prefetch_depth=1)


def test_trainer_and_launcher_on_one_rank(capsys):
    """``Trainer`` (data, step, history) and the launcher's one-rank path
    on the CPU; a config asking for checkpoints is refused (item 8)."""
    from repro_torch.launch import train as launch
    from repro_torch.train import Trainer, TrainerConfig
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    tr = Trainer(cfg, None, TrainerConfig(steps=2, seq_len=S, global_batch=4,
                                          log_every=1), device="cpu")
    out = tr.run()
    assert out["steps"] == 2 and out["status"] == "complete"
    assert [h["step"] for h in tr.metrics_history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in tr.metrics_history)
    with pytest.raises(NotImplementedError, match="item 8"):
        Trainer(cfg, None, TrainerConfig(ckpt_dir="ckpt"), device="cpu")
    launch.main(["--smoke", "--device", "cpu", "--steps", "1", "--layers",
                 "1", "--seq-len", "16", "--global-batch", "2"])
    assert "[train] llama3.2-3b-smoke (1 layers) on cpu" in \
        capsys.readouterr().out
    assert configs.get_smoke("llama3.2-3b").n_layers == 4
