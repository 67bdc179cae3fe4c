"""The ssm family on a ("pod", "data", "model") grid of spawned gloo ranks
(CPU): mamba2 split by SSD heads over the model tier, trained and served,
against the JAX step and engine on (2, 2, 2) meshes of forced host devices.

A reduced mamba2-780m (2 layers, d_model 128, 16 SSD heads of 16, N = 16,
G = 1, padded vocabulary 512, fp32) from the JAX ``init_params`` tree
(PRNGKey 0, jitted). Rank t of m holds heads [t·16/m, (t+1)·16/m): their z,
x and dt columns of ``in_proj``, their conv channels, ``dt_bias``,
``A_log``, ``D``, gated-norm scale and ``out_proj`` rows; B and C whole
(``models/tp.py``). Two JAX subprocesses run beside the ranks, on
``jax.make_mesh(shape, ("pod", "data", "model"), axis_types=(AxisType.Auto,)
* 3)`` under ``with mesh:`` (the recipe that runs on this JAX, ROADMAP.md
Queue 3), the mixer's ``ssd_chunked`` made precise (the function the port's
kernel computes):

* training, ``torch_helpers.JAX_TP_REFERENCE``: the (2, 2, 2) step on 8 x
  32 tokens of ``SyntheticLM(seed=0)`` with ``AdamW()``, 2 steps, locality
  + FSDP, locality + FSDP + ``seq_shard`` and xla + FSDP. The port runs the
  same steps on 2 x 2 x 2 ranks. Limits (``tests/test_torch_tp.py``'s):
  losses and grad norms 1e-5 relative (largest reading 1.9e-7), parameters
  within 9e-5 absolute (largest reading 8.5e-6) and at most 1 in 10,000
  elements beyond 1e-5 (read: 0). A 1 x 2 x 4 grid (4 heads a rank) is held
  against the port's one rank at the same limits (read: 2.6e-7 relative,
  parameters 1.7e-5, in ``in_proj``);
* serving, ``JAX_SERVE_REFERENCE`` below: the engine on (2, 2, 2)
  batch-sharded (B = 8, a 32-slot cache, 12 requests homed mostly in pod
  1, so that some migrate) with ``migrate="locality_bruck"`` and ``"xla"``,
  on (1, 2, 4) batch-sharded (B = 4), and on (2, 2, 2) with B = 1 (every
  lane holds the whole state, its heads on "model") with ``combine``
  ``"auto"`` and ``"locality"``: every request's tokens equal the JAX
  engine's and the port's one-rank engine's.

Also here: the split gated RMSNorm's plain versions over m column slices
with the tier's sum emulated, against the unsplit ones (fp32: 2e-6
relative, bf16 inputs one bf16 ulp); the tier layout of the training tree
and its inverse; the sharding specs of that tree; the refusal of SSD heads
or groups that m does not divide.
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
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap

REPO = Path(__file__).resolve().parents[1]
ARCH = "mamba2-780m"
N_LAYERS, B, S, STEPS = 2, 8, 32, 2
REL = 1e-5
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 9e-5, 1e-5, 1e-4
VARIANTS = {"fsdp": dict(grad_sync="locality", fsdp=True),
            "seq_shard": dict(grad_sync="locality", fsdp=True,
                              seq_shard=True),
            "xla": dict(grad_sync="xla", fsdp=True)}
PAGE, CACHE = 8, 32
# (key, mesh shape, ServeSpec keywords); the requests are ``trace``'s
SERVE_CASES = (
    ("batch|locality_bruck", (2, 2, 2),
     dict(batch=8, cache_len=CACHE, page_len=PAGE, migrate="locality_bruck")),
    ("batch|xla", (2, 2, 2),
     dict(batch=8, cache_len=CACHE, page_len=PAGE, migrate="xla")),
    ("batch|1x2x4", (1, 2, 4), dict(batch=4, cache_len=CACHE, page_len=PAGE)),
    ("one_row|auto", (2, 2, 2), dict(batch=1, cache_len=CACHE, page_len=PAGE)),
    ("one_row|locality", (2, 2, 2),
     dict(batch=1, cache_len=CACHE, page_len=PAGE, combine="locality")),
)

# The JAX engine on each case's mesh (``python -c JAX_SERVE_REFERENCE
# out.json plan.json``, plan {n_layers, cases: [key, shape, ServeSpec
# keywords, requests: [[prompt, max_new, home_pod]]]}): the tokens of every
# request by rid, and the migrations.
JAX_SERVE_REFERENCE = r"""
import dataclasses, functools, json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
warnings.simplefilter("ignore", DeprecationWarning)
from repro import configs
from repro.models import ssm, transformer
from repro.serve.engine import Engine
from repro.serve.scheduler import StepClock
from repro.serve.spec import Request, ServeSpec

ssm.ssd_chunked = functools.partial(ssm.ssd_chunked, precise=True)
plan = json.loads(open(sys.argv[2]).read())
cfg = dataclasses.replace(configs.get_smoke("mamba2-780m"),
                          n_layers=plan["n_layers"], dtype=jnp.float32)
params = jax.jit(lambda k: transformer.init_params(k, cfg))(
    jax.random.PRNGKey(0))
out = {}
for key, shape, spec_kw, reqs in plan["cases"]:
    mesh = jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    eng = Engine(cfg, mesh, params, ServeSpec(**spec_kw), clock=StepClock())
    for toks, m, home in reqs:
        eng.submit(Request(tokens=np.asarray(toks, np.int32), max_new=m,
                           home_pod=home, arrival_s=0.0))
    with mesh:
        res = eng.drain()
    out[key] = {"tokens": {str(rid): [int(t) for t in r.tokens]
                           for rid, r in res.items()},
                "migrations": eng.scheduler.stats().get("migrations", 0)}
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def trace(vocab: int, n: int = 12):
    """(prompt, max_new, home_pod): prompts of 5 and 11 tokens, homes
    mostly pod 1, so that its rows fill first and later requests migrate
    (``tests/test_torch_serve_tp.py``'s trace)."""
    rng = np.random.default_rng(0)
    homes = [1, 1, None, 1, 0, 1]
    news = [4, 7, 3, 6, 2, 5]
    return [(rng.integers(0, vocab, (5, 11)[i % 2]).astype(np.int32),
             news[i % 6], homes[i % 6]) for i in range(n)]


def _requests(shape, spec_kw: dict, vocab: int):
    """The trace, its home pods dropped where nothing migrates: one pod, or
    a batch of one row (every lane serves it)."""
    keep = shape[0] > 1 and spec_kw["batch"] > 1
    return [(t, m, home if keep else None) for t, m, home in trace(vocab)]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def jax_procs(tmp_path_factory):
    """The two JAX references, started first so they run beside the
    ranks."""
    tmp = tmp_path_factory.mktemp("jax_ssm_tp")
    (tmp / "train").mkdir()
    (tmp / "train_plan.json").write_text(json.dumps(dict(
        arch=ARCH, precise_ssd=True, n_layers=N_LAYERS, global_batch=B,
        seq_len=S, steps=STEPS, variants=VARIANTS)))
    vocab = H._small_cfg(ARCH, N_LAYERS).vocab_size
    (tmp / "serve_plan.json").write_text(json.dumps(dict(
        n_layers=N_LAYERS,
        cases=[(key, shape, kw, [[t.tolist(), m, h] for t, m, h
                                 in _requests(shape, kw, vocab)])
               for key, shape, kw in SERVE_CASES])))
    procs = {}
    for name, args in (
            ("train", [H.JAX_TP_REFERENCE, str(tmp / "train"),
                       str(tmp / "train_plan.json")]),
            ("serve", [JAX_SERVE_REFERENCE, str(tmp / "serve.json"),
                       str(tmp / "serve_plan.json")])):
        fh = open(tmp / f"{name}_log.txt", "w")
        procs[name] = (subprocess.Popen([sys.executable, "-c", *args],
                                        env=_env(), stdout=fh,
                                        stderr=subprocess.STDOUT), fh)
    yield procs, tmp
    for proc, fh in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fh.close()


def _wait(jax_procs, name: str) -> Path:
    procs, tmp = jax_procs
    proc, _ = procs[name]
    rc = proc.wait(timeout=600)
    assert rc == 0, (tmp / f"{name}_log.txt").read_text()[-4000:]
    return tmp


@pytest.fixture(scope="module")
def jax_train(jax_procs):
    tmp = _wait(jax_procs, "train") / "train"
    out = json.loads((tmp / "out.json").read_text())
    for name in ["params0", *VARIANTS]:
        with np.load(tmp / f"{name}.npz") as z:
            out.setdefault("params", {})[name] = dict(z)
    return out


@pytest.fixture(scope="module")
def jax_serve(jax_procs):
    return json.loads((_wait(jax_procs, "serve") / "serve.json").read_text())


@pytest.fixture(scope="module")
def jax_tree(jax_procs):
    """The JAX ``init_params`` tree (PRNGKey 0, jitted as ``init_state``
    jits it), drawn here so the ranks start while the references run."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), n_layers=N_LAYERS,
                              dtype=jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: transformer.init_params(k, cfg))(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params0(jax_tree):
    """The tree by leaf path (the training runs' input)."""
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}


@pytest.fixture(scope="module")
def pool(jax_procs):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def trained(pool, params0):
    """{variant: per-rank results} on 2 x 2 x 2; the 1 x 2 x 4 run and
    one rank's."""
    run = lambda q, pl, m, kw: pool.run(
        H.task_train, q, pl, params0, N_LAYERS, STEPS, B, S, kw, ARCH, m)
    out = {name: run(2, 2, 2, kw) for name, kw in VARIANTS.items()}
    out["1x2x4"] = run(1, 2, 4, dict(fsdp=True))
    out["one"] = run(None, None, 1, {})
    return out


@pytest.fixture(scope="module")
def served(pool, jax_tree):
    """{case: per-rank results on the case's grid}, {case: the one-rank
    engine's}."""
    from repro_torch.models.transformer import params_from_jax
    cfg = H._small_cfg(ARCH, N_LAYERS)
    params = {k: v.numpy() for k, v in params_from_jax(jax_tree, cfg).items()}
    out, one = {}, {}
    for key, shape, kw in SERVE_CASES:
        reqs = _requests(shape, kw, cfg.vocab_size)
        out[key] = pool.run(H.task_serve_batch, shape[0], shape[1], ARCH,
                            params, N_LAYERS, kw, reqs,
                            shape[2])[:int(np.prod(shape))]
        one_kw = {k: v for k, v in kw.items()
                  if k not in ("combine", "migrate")}
        one[key] = pool.run(H.task_serve_batch, 1, 1, ARCH, params,
                            N_LAYERS, one_kw, reqs)[0]
    return out, one


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


def _whole(res, pl: int, m: int) -> dict:
    """The ranks' shards as the JAX tree's leaves."""
    return H.jax_layout(H.assemble_tp(res, pl, m), ARCH, m, N_LAYERS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ssm_tp_step_matches_jax_on_2x2x2(trained, jax_train, params0,
                                          variant):
    """Losses, grad norms and parameters after two steps equal the JAX
    (2, 2, 2) step's; every rank agrees."""
    for path, a in jax_train["params"]["params0"].items():
        assert np.array_equal(params0[path], a), path
    res = trained[variant]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    loss, gnorm = _metrics(res)
    ref = jax_train[variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    _close_params(_whole(res, 2, 2), jax_train["params"][variant])


def test_ssm_tp_4_model_ranks_match_one_rank(trained):
    """1 x 2 x 4: 4 SSD heads a rank, B and C whole on each."""
    res = trained["1x2x4"]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    assert res[0]["mdims"]["blocks/slot0/mamba/in_proj"] == 2
    assert res[0]["mdims"]["blocks/slot0/mamba/in_proj_bc"] == -1
    # [z, x, dt] of 4 heads of 16 (rows sharded over the lane's 2 ranks)
    assert res[0]["shards"]["blocks/slot0/mamba/in_proj"].shape == \
        (2, 64, 2 * 64 + 4)
    loss, gnorm = _metrics(res)
    want_loss, want_gnorm = _metrics(trained["one"])
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    _close_params(_whole(res, 2, 4), trained["one"][0]["shards"])


def test_ssm_tp_dp_messages_follow_the_oracle(trained):
    """Per rank and step, the parameter gathers' and reduce-scatters'
    non-local messages over a model lane are the locality-Bruck schedule's
    for the rank's lane rank times the calls (``in_proj``, ``in_proj_bc``
    and ``out_proj`` a layer, twice with remat, and the embedding); the
    model tier sends nothing across a pod."""
    oracle = TS.locality_bruck(4, 2).per_rank_stats(RegionMap(4, 2))
    for variant in ("fsdp", "seq_shard"):
        for r in trained[variant]:
            mt, lane_rank = r["meter"], r["coords"]["rank"]
            assert mt["gathers"] == STEPS * (2 * 3 * N_LAYERS + 1)
            assert mt["gather"]["permute_edges_nonlocal"] == \
                mt["gathers"] * oracle[lane_rank][2]
            assert mt["reduce_scatter"]["permute_edges_nonlocal"] == \
                mt["reduce_scatters"] * oracle[lane_rank][2]
            assert mt["model"]["group_msgs_nonlocal"] == 0
            assert mt["model"]["group_msgs_local"] > 0


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_ssm_tp_serving_matches_jax_and_one_rank(served, jax_serve, case):
    """Every request's tokens equal the JAX engine's on the same mesh and
    the port's one-rank engine's; every rank returns the same results; the
    tier's collectives stay in their pod."""
    res, one = served[0][case], served[1][case]
    for r in res[1:]:
        assert r["results"] == res[0]["results"]
    toks = {str(rid): f["tokens"] for rid, f in res[0]["results"].items()}
    assert toks == jax_serve[case]["tokens"]
    assert toks == {str(rid): f["tokens"]
                    for rid, f in one["results"].items()}
    st = res[0]["stats"]
    assert st.get("migrations", 0) == jax_serve[case]["migrations"]
    assert st["tier_calls"] > 0 and st["tier_nonlocal_msgs"] == 0
    if case.startswith("batch|") and case != "batch|1x2x4":
        assert st["migrations"] > 0


def test_ssm_whole_batch_lanes_with_different_clocks_admit_together(
        pool, jax_tree, served):
    """B = 2 on 2 x 2 x 2, which 4 lane ranks do not divide: every lane
    holds the whole batch, yet the tier's collectives pair its ranks, so
    admission is agreed over all 8 ranks from grid rank 0. Lane 1's clock
    runs 1.5 steps ahead of lane 0's; every rank admits every request at
    the same step of its own count, and the tokens are one rank's (each
    rank's stamps are its own clock's: every lane holds every result)."""
    from repro_torch.models.transformer import params_from_jax
    cfg = H._small_cfg(ARCH, N_LAYERS)
    params = {k: v.numpy() for k, v in params_from_jax(jax_tree, cfg).items()}
    reqs = [(t, m, None, 3.0 * i)
            for i, (t, m, _) in enumerate(trace(cfg.vocab_size))]
    spec = dict(batch=2, cache_len=CACHE, page_len=PAGE)
    res = pool.run(H.task_serve_batch, 2, 2, ARCH, params, N_LAYERS, spec,
                   reqs, 2, [0.0, 1.5])
    logs = [x["admitted"] for x in res]
    assert len(logs[0]) == len(reqs)
    assert all(log == logs[0] for log in logs)
    assert any(t > 0 for _, t in logs[0])
    toks = lambda x: {rid: v["tokens"] for rid, v in x["results"].items()}
    one = served[1]["one_row|auto"]
    assert all(toks(x) == toks(one) for x in res)


def test_ssm_tp_cache_holds_the_rank_heads(served):
    """A rank's state holds its heads and its conv window its x channels
    and B, C whole; a decode step sums 2 a layer over the tier (the gated
    norm's statistic and ``out_proj``), the embedding and the greedy
    token."""
    from repro_torch.models.ssm import mamba_cache_shapes
    cfg = H._small_cfg(ARCH, N_LAYERS)
    (conv, _), (h, _) = (mamba_cache_shapes(cfg, 1, 2)[k]
                         for k in ("conv", "h"))
    assert h == (1, 8, 16, 16) and conv == (1, 3, 128 + 32)
    st = served[0]["one_row|auto"][0]["stats"]
    steps, prefills = st["decode_steps"], st["prefills"]
    assert st["tier_calls"] == (2 * N_LAYERS + 2) * (steps + prefills)


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_gated_forms_equal_the_unsplit_ones(m, dtype):
    """The split gated RMSNorm's plain versions over m column slices, the
    tier's sums emulated by summing the slices' row partials, against the
    unsplit forward and backward: fp32 within 2e-6 relative of the largest
    |value|; bf16 inputs, the outputs within one bf16 ulp of it."""
    from repro_torch.kernels.rmsnorm.ref import (
        rmsnorm_gated_bwd_ref, rmsnorm_gated_finish_ref, rmsnorm_gated_ref,
        rmsnorm_gated_rowdot_ref, rmsnorm_gated_rowsq_ref)
    g = torch.Generator().manual_seed(m)
    dt = getattr(torch, dtype)
    rows, d = 12, 64
    y = torch.randn(3, rows // 3, d, generator=g)
    z = torch.randn(3, rows // 3, 2 * d, generator=g).to(dt)[..., :d]
    scale = (0.1 * torch.randn(d, generator=g)).to(dt)
    dout = torch.randn(3, rows // 3, d, generator=g).to(dt)
    cols = [slice(t * d // m, (t + 1) * d // m) for t in range(m)]
    ss = sum(rmsnorm_gated_rowsq_ref(y[..., c], z[..., c]) for c in cols)
    out = torch.cat([rmsnorm_gated_finish_ref(y[..., c], z[..., c],
                                              scale[c], ss, d_norm=d)
                     for c in cols], -1)
    dot = sum(rmsnorm_gated_rowdot_ref(y[..., c], z[..., c], scale[c],
                                       dout[..., c]) for c in cols)
    parts = [rmsnorm_gated_bwd_ref(y[..., c], z[..., c], scale[c],
                                   dout[..., c], row_ss=ss, row_dot=dot,
                                   d_norm=d) for c in cols]
    got = [out] + [torch.cat([p[i] for p in parts], -1) for i in range(3)]
    want = [rmsnorm_gated_ref(y, z, scale),
            *rmsnorm_gated_bwd_ref(y, z, scale, dout)]
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (err, a.dtype)


def test_tier_layout_round_trips_and_chunks_are_the_rank_parts():
    """``ssm_tier_tree`` then ``ssm_jax_tree`` is the identity; rank t's
    chunk of the tier's ``in_proj`` (dim 1) and ``conv_w`` are the z, x
    and dt columns and x channels of its heads, the serving part's
    (``TensorParallel._ssm_part``) without B and C."""
    from repro_torch.models import transformer as T
    from repro_torch.models.tp import (TensorParallel, ssm_jax_tree,
                                       ssm_tier_tree)
    cfg = H._small_cfg(ARCH, N_LAYERS)
    tree = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m, GN = 4, 2 * cfg.ssm_state
    tier = ssm_tier_tree(tree, cfg, m)
    back = ssm_jax_tree(tier, cfg, m)
    for p in H.tree_paths(tree):
        assert torch.equal(H._at(back, p), H._at(tree, p)), p
    mam, full = tier["blocks"]["slot0"]["mamba"], \
        tree["blocks"]["slot0"]["mamba"]
    for t in range(m):
        tp = TensorParallel(cfg, type("Tier", (), {"m": m, "t": t})())
        part = tp._ssm_part("in_proj", full["in_proj"][0])
        dl = 256 // m
        want = torch.cat([part[:, :2 * dl], part[:, 2 * dl + GN:]], 1)
        assert torch.equal(mam["in_proj"][0].chunk(m, 1)[t], want)
        assert torch.equal(mam["in_proj_bc"][0], part[:, 2 * dl:2 * dl + GN])
        cw = tp._ssm_part("conv_w", full["conv_w"][0])
        assert torch.equal(mam["conv_w"][0].chunk(m, 1)[t], cw[:, :dl])
        assert torch.equal(mam["conv_w_bc"][0], cw[:, dl:])


def test_tier_tree_specs():
    """The tier's tree shards ``in_proj`` (its [z, x, dt] columns) and
    ``conv_w`` (its x channels) over "model" with ``out_proj``'s rows,
    FSDP-shards ``in_proj``, ``in_proj_bc`` and ``out_proj`` over the
    lane, and holds the rest whole on the tier."""
    from repro_torch.models import transformer as T
    from repro_torch.train.sharding import param_specs
    cfg = H._small_cfg(ARCH, N_LAYERS)
    specs = param_specs(T.train_param_shapes(cfg, 2),
                        {"pod": 2, "data": 2, "model": 2}, fsdp=True)
    mam = specs["blocks"]["slot0"]["mamba"]
    lane = ("pod", "data")
    assert mam["in_proj"] == (None, lane, "model")
    assert mam["in_proj_bc"] == (None, lane, None)
    assert mam["conv_w"] == (None, None, "model")
    assert mam["conv_w_bc"] == (None, None, None)
    assert mam["out_proj"] == (None, "model", lane)
    for leaf in ("conv_b", "dt_bias", "A_log", "D"):
        assert mam[leaf] == (None, None), leaf
    assert mam["norm"]["scale"] == (None, None)


def test_check_tp_names_what_does_not_divide():
    from repro_torch.models.tp import check_tp
    cfg = H._small_cfg(ARCH, N_LAYERS)
    for m in (2, 4, 8):
        check_tp(cfg, m)
    with pytest.raises(NotImplementedError, match="SSD heads 16"):
        check_tp(cfg, 3)
    # 4 groups of 4 heads over 8 ranks of 2: each rank's heads lie in one
    # group; 2 groups of 3 heads over 3 ranks of 2 would give a rank the
    # heads of two groups' parts
    check_tp(dataclasses.replace(cfg, ssm_ngroups=4), 8)
    odd = dataclasses.replace(cfg, d_model=48, ssm_ngroups=2,
                              vocab_size=510)
    with pytest.raises(NotImplementedError, match="ssm_ngroups 2"):
        check_tp(odd, 3)
