"""Expert-parallel MoE training of the port on spawned gloo ranks (CPU),
against the JAX ``make_train_step`` on forced host devices.

A reduced qwen2-moe-a2.7b (2 layers, d_model 128, 8 experts at top-4, 2
shared experts, an untied head, fp32) from the JAX ``init_state``'s
parameters trains two steps on ``SyntheticLM(seed=0)`` batches of 8 x 32
tokens with ``AdamW()``. The JAX package defines its expert-parallel step
to equal the one with ``moe_dispatch="none"`` (``tests/test_moe_dispatch
.py``), and its EP step raises on this box's jax 0.9.0 (ROADMAP.md Queue
3), so one JAX subprocess of 8 forced host devices runs the "none" step on
a (2, 4) ("pod", "data") Auto-axes mesh, with FSDP and without, and for a
second configuration at top-1 with a capacity factor of 1 (where the
locality dispatch takes the slots transport), and on a (3, 2) mesh with
``n_experts=12`` (grad_sync "flat_psum": the JAX locality allreduce's
reduce-scatter raises on three pods there).

The port runs the EP step on the same layouts: ``moe_dispatch="locality"``
(the tokens transport at top-4, two pods < K·cf = 5; slots at top-1),
``"xla"`` (slots) and ``"none"``, and the top-1 configuration without
FSDP as well (held against the JAX top-1 run with FSDP: the JAX "none"
step is the same function either way). Tolerances, those of
``tests/test_torch_train.py``: losses, auxiliary losses and grad norms
1e-5 relative, parameters after two steps within 3e-5. The transports
give the same first loss bit for bit (the forward delivers the same slot
values); the two slots transports are bitwise the same step. Each rank's
all-to-all record equals the oracle ``schedules.locality_all_to_all``
(``xla_all_to_all``) times its calls. On a model tier (E/m experts a
model rank, or expert parallelism over each model lane) the family trains
in ``tests/test_torch_moe_tp.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_helpers as H
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap

REPO = Path(__file__).resolve().parents[1]
N_LAYERS, S, STEPS = 2, 32, 2
REL, PARAM_ATOL = 1e-5, 3e-5
TOP1 = {"top_k": 1, "capacity_factor": 1.0}
RUNS = {"fsdp": dict(mesh=[2, 4], global_batch=8, cfg={},
                     kw={"fsdp": True}),
        "replicated": dict(mesh=[2, 4], global_batch=8, cfg={},
                           kw={"fsdp": False}),
        "top1": dict(mesh=[2, 4], global_batch=8, cfg=TOP1,
                     kw={"fsdp": True}),
        "3x2": dict(mesh=[3, 2], global_batch=6, cfg={"n_experts": 12},
                    kw={"fsdp": True, "grad_sync": "flat_psum"})}
# the port's runs without a JAX run of their own: held against the JAX run
# named (the JAX "none" step is the same function with FSDP and without)
PORT_ONLY = {"top1_replicated": dict(RUNS["top1"], kw={"fsdp": False},
                                     ref="top1",
                                     dispatches=("locality", "xla"))}
DISPATCHES = ("locality", "xla", "none")
CASES = [(run, md) for run, spec in (RUNS | PORT_ONLY).items()
         for md in spec.get("dispatches", DISPATCHES)]


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_moe_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(dict(n_layers=N_LAYERS, seq_len=S,
                                    steps=STEPS, runs=RUNS)))
    with open(tmp / "log.txt", "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", H.JAX_MOE_TRAIN_REFERENCE, str(tmp),
             str(plan)], env=env, stdout=fh, stderr=subprocess.STDOUT)
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
    for name in RUNS:
        for key in (f"params0_{name}", name):
            with np.load(tmp / f"{key}.npz") as z:
                out.setdefault("params", {})[key] = dict(z)
    return out


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, jax_out):
    """{(run, dispatch): per-rank results in grid order}."""
    out = {}
    for name, md in CASES:
        run = (RUNS | PORT_ONLY)[name]
        q, pl = run["mesh"]
        kw = dict(run["kw"], moe_dispatch=md,
                  global_batch=run["global_batch"])
        params0 = jax_out["params"][f"params0_{run.get('ref', name)}"]
        res = pool.run(H.task_train, q, pl, params0, N_LAYERS, STEPS,
                       run["global_batch"], S, kw, "qwen2-moe-a2.7b", 1,
                       run["cfg"])
        out[name, md] = [r for r in res if r is not None]
    return out


def _series(res, key) -> np.ndarray:
    return np.array([m[key] for m in res[0]["metrics"]])


@pytest.mark.parametrize("run,dispatch", CASES,
                         ids=[f"{r}-{d}" for r, d in CASES])
def test_ep_step_matches_jax(trained, jax_out, run, dispatch):
    """Losses, auxiliary losses, grad norms and parameters after two steps
    equal the JAX step's; every rank agrees; the routed experts shard over
    every rank under EP and are whole without it."""
    res = trained[run, dispatch]
    spec = (RUNS | PORT_ONLY)[run]
    q, pl = spec["mesh"]
    assert len(res) == q * pl
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    ref_name = spec.get("ref", run)
    ref = jax_out[ref_name]
    for key, want in (("loss", "losses"), ("moe_aux", "moe_aux"),
                      ("grad_norm", "grad_norms")):
        np.testing.assert_allclose(_series(res, key), ref[want], rtol=REL,
                                   atol=0, err_msg=key)
    got = H.assemble(res, pl)
    want = jax_out["params"][ref_name]
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    axes = res[0]["axes"]["blocks/slot0/moe/gate"]
    assert axes == ("pod,data" if dispatch != "none" else
                    "" if not spec["kw"]["fsdp"] else
                    "pod,data" if run != "3x2" else "data")
    alg, transport, source = res[0]["moe"]
    if dispatch == "none":
        assert (alg, transport, source) == ("none", "", "n/a")
    else:
        assert (alg, source) == (dispatch, "explicit")
        assert transport == ("tokens" if dispatch == "locality"
                             and spec["cfg"] != TOP1 else "slots")


def test_transports_agree(trained):
    """The forward delivers the same slot values under every transport: the
    first loss is bitwise the same; the two slots transports (top-1) are
    bitwise the same step, every parameter."""
    for run in ("fsdp", "replicated", "3x2"):
        first = {md: trained[run, md][0]["metrics"][0]["loss"]
                 for md in DISPATCHES}
        assert first["locality"] == first["xla"] == first["none"], first
    for run in ("top1", "top1_replicated"):
        a, b = trained[run, "locality"], trained[run, "xla"]
        assert a[0]["moe"][1] == b[0]["moe"][1] == "slots"
        for x, y in zip(a, b):
            assert x["metrics"] == y["metrics"]
            for path in x["shards"]:
                assert np.array_equal(x["shards"][path],
                                      y["shards"][path]), (run, path)


@pytest.mark.parametrize("run", ["fsdp", "top1", "3x2"])
def test_all_to_all_record_is_the_oracle_times_the_calls(trained, run):
    """Each rank's non-local messages and bytes of the dispatch's
    all-to-alls (forward, remat's recomputation, backward) are the oracle's
    per call: messages times the calls, bytes its blocks times the summed
    block bytes; the tokens transport adds its gathers and sends the
    slot tables alone through the all-to-all."""
    q, pl = RUNS[run]["mesh"]
    p = q * pl
    region = RegionMap(p, pl)
    for md in ("locality", "xla"):
        res = trained[run, md]
        oracle = TS.ALL_TO_ALL_SCHEDULES[md](p, pl).per_rank_stats(region)
        for r, out in enumerate(res):
            m = out["meter"]
            calls, block = m["a2a_calls"], m["a2a_bytes"] / p
            st = m["a2a"]
            assert calls > 0
            _, _, n_nl, s_nl = oracle[r]
            assert st["permute_edges_nonlocal"] + \
                st["group_msgs_nonlocal"] == calls * n_nl, (md, r)
            assert st["permute_bytes_nonlocal"] + \
                st["group_bytes_nonlocal"] == pytest.approx(s_nl * block)
            tokens = out["moe"][1] == "tokens"
            assert (m["moe_gathers"] > 0) == tokens


def test_ineligible_layouts_resolve_to_none():
    """The JAX eligibility: grad_sync "xla", experts the ranks do not
    divide, a batch they do not divide, one rank."""
    from repro_torch import configs
    from repro_torch.train.step import resolve_moe_dispatch
    import dataclasses
    cfg = configs.get_smoke("qwen2-moe-a2.7b")

    class Grid:
        def __init__(self, q, pl):
            self.q, self.pl, self.p = q, pl, q * pl
    none = ("none", "", "n/a")
    assert resolve_moe_dispatch(cfg, Grid(2, 4), "xla", "locality") == none
    assert resolve_moe_dispatch(cfg, Grid(3, 2), "locality",
                                "locality") == none
    assert resolve_moe_dispatch(cfg, Grid(2, 4), "locality", "locality",
                                global_batch=12) == none
    assert resolve_moe_dispatch(cfg, None, "locality", "locality") == none
    assert resolve_moe_dispatch(cfg, Grid(2, 4), "locality", "xla") == \
        ("xla", "slots", "explicit")
    # one pod: the span is the ranks (4 < K·cf = 5: tokens); eight: slots
    assert resolve_moe_dispatch(cfg, Grid(1, 4), "locality",
                                "locality")[1] == "tokens"
    assert resolve_moe_dispatch(cfg, Grid(1, 8), "locality",
                                "locality")[1] == "slots"
    dense = dataclasses.replace(cfg, family="dense", n_experts=0, top_k=0)
    assert resolve_moe_dispatch(dense, Grid(2, 4), "locality",
                                "locality") == none
