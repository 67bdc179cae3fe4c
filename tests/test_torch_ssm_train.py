"""Mamba2 training of the port against the JAX package, on the CPU.

The kernels' plain versions: ``ssd_bwd_ref`` (autograd of the fp32
chunked scan) against ``jax.vjp`` of the JAX ``ssd_chunked(precise=True)``
at 1e-5 relative (max |err| / max |ref| per gradient, fp32 summed in
another order; dA at ``DA_REL``, 1e-4: a sum of terms of both signs over
every token of the batch, it cancels, so the same roundings are a larger
share of it; 1.2e-5 measured here), and the mixed-precision
``ssd_chunked`` differentiated by torch against ``jax.vjp`` of the JAX one
at 2e-2 (both round the same tensors to bf16, a few bf16 roundings); ``rmsnorm_gated_bwd_ref`` against
``jax.vjp`` of the JAX ``rmsnorm(norm, y * silu(z))`` at 1e-5. The mixer's
training branch (``mamba_apply``, cache None) against ``jax.grad`` of the
JAX ``mamba_apply`` with its ``ssd_chunked`` made precise in this process
(the port's kernel computes the precise function): every parameter's and
the input's gradient at 1e-5 relative.

The step: a reduced mamba2-780m (the smoke config at 2 layers, fp32) from
the JAX ``init_params`` tree trains two steps on ``SyntheticLM(seed=0)``
batches of 8 x 32 tokens with ``AdamW()`` on 2 x 4 gloo ranks with
``grad_sync="locality"`` (FSDP, FSDP with ``prefetch_depth=1``,
replicated), against one JAX subprocess with 8 forced host devices running
``make_train_step(grad_sync="locality")`` on a (2, 4) ("pod", "data")
mesh, its ``ssd_chunked`` made precise. Losses and grad norms 1e-5
relative; parameters within ``PARAM_ATOL``, all but 1 in 10,000 within
1e-5, the limits of ``tests/test_torch_train.py``. The prefetch is bitwise
the eager step; the recorded messages of the gathers and of the
replicated step's sync are the JAX HLO's. The kernels' own chunk length
(64 tokens) differs from the config's (32 here); the chunked scan is exact
algebra, so the plain versions' chunking is the JAX package's and the
kernels' tolerance is on the card (``tests/test_torch_cuda.py``).
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
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.layers import rmsnorm as jrmsnorm
from repro.train import sharding as jsharding
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_bwd_ref, ssd_chunked, ssd_ref
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import leaves
from repro_torch.train import sharding

# the JAX step's subprocess starts with the module's first test and runs
# while the in-process tests do
pytestmark = pytest.mark.usefixtures("jax_proc")

REPO = Path(__file__).resolve().parents[1]
ARCH = "mamba2-780m"
N_LAYERS, B, S, STEPS = 2, 8, 32, 2
REL = 1e-5
DA_REL = 1e-4
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 3e-5, 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": {"fsdp": True},
                "prefetch": {"fsdp": True, "prefetch_depth": 1},
                "replicated": {"fsdp": False}}
# (Bt, S, H, P, G, N) and the chunk length: G = 1 and G = 2
SSD_DIMS = [((2, 128, 4, 16, 1, 32), 32), ((1, 96, 6, 16, 2, 16), 32)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


def _ssd_inputs(seed, Bt, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(size=H)).astype(np.float32)
    Bm = (rng.standard_normal((Bt, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((Bt, S, G, N)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((Bt, S, H, P), dtype=np.float32)
    return (x, dt, A, Bm, Cm), dy


def _jax_ssd_vjp(ins, dy, Q, precise):
    f = lambda *a: jssm.ssd_chunked(*a, Q, precise=precise)[0]
    return jax.jit(lambda ins, dy: jax.vjp(f, *ins)[1](dy))(
        tuple(map(jnp.asarray, ins)), jnp.asarray(dy))


@pytest.mark.parametrize("dims,Q", SSD_DIMS)
def test_ssd_bwd_ref_matches_jax_vjp(dims, Q):
    ins, dy = _ssd_inputs(0, *dims)
    want = _jax_ssd_vjp(ins, dy, Q, precise=True)
    got = ssd_bwd_ref(*map(_t, ins), _t(dy), Q=Q)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a.numpy(), b) < (DA_REL if name == "dA" else REL), name


@pytest.mark.parametrize("dims,Q", SSD_DIMS)
def test_mixed_precision_ssd_gradient_matches_jax_vjp(dims, Q):
    ins, dy = _ssd_inputs(1, *dims)
    want = _jax_ssd_vjp(ins, dy, Q, precise=False)
    leaves_ = [_t(a).requires_grad_(True) for a in ins]
    y, _ = ssd_chunked(*leaves_, Q, precise=False)
    got = torch.autograd.grad(y, leaves_, _t(dy))
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert _rel(a.numpy(), b) < 2e-2, name


def test_ssd_train_on_the_cpu_is_autograd_of_the_plain_version():
    """``ssd_train``'s backward is ``ssd_bwd``'s CPU route, the plain
    version: the gradients autograd gives through ``ssd_ref``, bitwise;
    the final state takes no gradient; nothing is counted."""
    ins, dy = _ssd_inputs(2, 1, 80, 2, 16, 1, 16)
    counts = (ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES)
    a = [_t(t).requires_grad_(True) for t in ins]
    y, h = ssd_ops.ssd_train(*a, Q=32)
    assert not h.requires_grad
    got = torch.autograd.grad(y, a, _t(dy))
    b = [_t(t).requires_grad_(True) for t in ins]
    want = torch.autograd.grad(ssd_ref(*b, Q=32)[0], b, _t(dy))
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert (ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES) == counts


def _gated_inputs(seed, rows, d, width):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((rows, d), dtype=np.float32) * 2
    proj = rng.standard_normal((rows, width), dtype=np.float32) * 2
    scale = (rng.standard_normal(d) * 0.2).astype(np.float32)
    dout = rng.standard_normal((rows, d), dtype=np.float32)
    return y, proj, scale, dout


def test_rmsnorm_gated_bwd_ref_matches_jax_vjp():
    y, proj, scale, dout = _gated_inputs(3, 24, 64, 150)
    z = proj[:, 10:74]
    f = lambda y, z, s: jrmsnorm({"scale": s}, y * jax.nn.silu(z), 1e-5)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (y, z, scale)))
    want = vjp(jnp.asarray(dout))
    got = rms_ops.rmsnorm_gated_bwd_ref(_t(y), _t(proj)[:, 10:74], _t(scale),
                                        _t(dout))
    for name, a, b in zip(("dy", "dz", "dscale"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a.numpy(), b) < REL, name


def test_rmsnorm_gated_train_puts_dz_into_the_wider_tensor():
    """``rmsnorm_gated_train`` on a column slice of ``proj``: its gradient
    lands in those columns of proj's, the others zero, the values
    autograd gives through the plain forward; nothing is counted."""
    y, proj, scale, dout = _gated_inputs(4, 6, 32, 80)
    counts = (rms_ops.BWD_LAUNCHES, dict(rms_ops.FORM_BWD_LAUNCHES))
    runs = []
    for fn in (rms_ops.rmsnorm_gated_train, rms_ops.rmsnorm_gated_ref):
        ts = [_t(a).requires_grad_(True) for a in (y, proj, scale)]
        out = fn(ts[0], ts[1][:, 16:48], ts[2], eps=1e-5)
        (out * _t(dout)).sum().backward()
        runs.append([t.grad for t in ts])
    got, want = runs
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(got[1][:, :16]) == 0
    assert torch.count_nonzero(got[1][:, 48:]) == 0
    assert (rms_ops.BWD_LAUNCHES, rms_ops.FORM_BWD_LAUNCHES) == counts


# ---------------------------------------------------------------------------
# the mixer's training branch against jax.grad
# ---------------------------------------------------------------------------
@pytest.fixture
def precise_jax(monkeypatch):
    """The JAX mixer with ``ssd_chunked(precise=True)`` (this process)."""
    orig = jssm.ssd_chunked
    monkeypatch.setattr(jssm, "ssd_chunked",
                        lambda *a, **kw: orig(*a, **{**kw, "precise": True}))


def test_mamba_apply_gradients_match_jax_grad(precise_jax):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=torch.float32)
    jp = jax.tree.map(np.asarray, jssm.mamba_init(jax.random.PRNGKey(0),
                                                  jcfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, jcfg.d_model), dtype=np.float32)
    w = rng.standard_normal((2, 64, jcfg.d_model), dtype=np.float32)

    def jloss(p, x):
        out, _ = jssm.mamba_apply(p, x, jcfg)
        return jnp.sum(out * w)

    jg, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = {n: _t(jp["norm"]["scale"] if n == "norm" else jp[n])
          .requires_grad_(True) for n in ssm.MAMBA_PARAMS}
    tx = _t(x).requires_grad_(True)
    out, cache = ssm.mamba_apply(tp, tx, tcfg)
    assert cache is None
    (out * _t(w)).sum().backward()
    assert _rel(tx.grad.numpy(), jdx) < REL
    for n in ssm.MAMBA_PARAMS:
        want = jg["norm"]["scale"] if n == "norm" else jg[n]
        assert _rel(tp[n].grad.numpy(), want) < REL, n


# ---------------------------------------------------------------------------
# the parameter tree and its sharding
# ---------------------------------------------------------------------------
def test_train_params_from_jax_and_init_share_the_tree():
    """The JAX Mamba2 tree converts leaf for leaf (``blocks/slot0/{ln,
    mamba}``, ``norm/scale`` three deep); the port's own init has its
    shapes, and its values are the serving ``init_params``' for the same
    generator (``mamba_init``'s order of draws)."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), n_layers=2)
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), n_layers=2)
    tree = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    conv = T.train_params_from_jax(jax.tree.map(np.asarray, tree), cfg)
    flat = jax.tree.leaves(tree)
    assert [tuple(t.shape) for t in leaves(conv)] == [a.shape for a in flat]
    assert all(np.array_equal(t.numpy(), np.asarray(a))
               for t, a in zip(leaves(conv), flat))
    assert set(conv["blocks"]["slot0"]) == {"ln", "mamba"}
    assert T.layer_params(cfg) == T.MAMBA_LAYER_PARAMS
    own = T.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [t.shape for t in leaves(own)] == [t.shape for t in leaves(conv)]
    serve = T.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator().manual_seed(0), "cpu")
    m = own["blocks"]["slot0"]["mamba"]
    for n in ("in_proj", "conv_w", "dt_bias", "A_log", "out_proj"):
        assert torch.equal(m[n][1], serve[f"layers.1.{n}"]), n
    assert torch.equal(own["embed"], serve["embed"])


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
@pytest.mark.parametrize("shape", [(2, 4), (3, 2)], ids=str)
def test_param_specs_match_jax(arch, shape):
    """(FSDP dim, axes) of every Mamba2 leaf on the JAX package's abstract
    meshes: in_proj, out_proj and embed sharded, the rest replicated."""
    jcfg = jconfigs.get(ARCH) if arch == "full" else jconfigs.get_smoke(ARCH)
    tcfg = configs.get(ARCH) if arch == "full" else configs.get_smoke(ARCH)
    want = _jax_spec_pairs(jcfg, shape)
    shapes = T.train_param_shapes(tcfg)
    specs = sharding.param_specs(shapes, {"pod": shape[0], "data": shape[1]},
                                 fsdp=True)
    paths = sorted(want)
    assert len(leaves(shapes)) == len(paths)
    got = dict(zip(paths, zip(leaves(sharding.fsdp_param_dims(specs)),
                              leaves(sharding.fsdp_param_axes(specs)))))
    assert got == want
    sharded = {p for p, (k, _) in got.items() if k >= 0}
    assert sharded == {"embed", "blocks/slot0/mamba/in_proj",
                       "blocks/slot0/mamba/out_proj"}


# ---------------------------------------------------------------------------
# the step on 2 x 4 gloo ranks against the JAX (2, 4) step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start;
    its one gather is a layer of in_proj, 16 of its 128 rows a rank."""
    tmp = tmp_path_factory.mktemp("jax_ssm_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    cfg = configs.get_smoke(ARCH)
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(dict(
        arch=ARCH, n_layers=N_LAYERS, global_batch=B, seq_len=S, steps=STEPS,
        variants=JAX_VARIANTS, precise_ssd=True,
        one_gather=list(ssm.mamba_shapes(cfg)["in_proj"]))))
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
    out = json.loads((tmp / "out.json").read_text())
    for name in ["params0", *JAX_VARIANTS]:
        with np.load(tmp / f"{name}.npz") as z:
            out.setdefault("params", {})[name] = dict(z)
    return out


@pytest.fixture(scope="module")
def trained(jax_proc, jax_out):
    """{variant: per-rank results} on 2 x 4, and the one-rank run."""
    pool = H.RankPool(8)
    try:
        params0 = jax_out["params"]["params0"]
        run = lambda q, pl, kw: pool.run(H.task_train, q, pl, params0,
                                         N_LAYERS, STEPS, B, S, kw, ARCH)
        out = {name: run(2, 4, kw) for name, kw in JAX_VARIANTS.items()}
        out["one"] = run(None, None, {})
    finally:
        pool.close()
    return out


def _metrics(res):
    m = res[0]["metrics"]
    return (np.array([x["loss"] for x in m]),
            np.array([x["grad_norm"] for x in m]))


def _close_params(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_step_matches_jax_locality_on_2x4(trained, jax_out, variant):
    res = trained[variant]
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    loss, gnorm = _metrics(res)
    ref = jax_out[variant]
    np.testing.assert_allclose(loss, ref["losses"], rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, ref["grad_norms"], rtol=REL, atol=0)
    _close_params(H.assemble(res, 4), jax_out["params"][variant])


def test_one_rank_matches_the_ranks(trained):
    loss, gnorm = _metrics(trained["one"])
    want_loss, want_gnorm = _metrics(trained["fsdp"])
    np.testing.assert_allclose(loss, want_loss, rtol=REL, atol=0)
    np.testing.assert_allclose(gnorm, want_gnorm, rtol=REL, atol=0)
    _close_params(trained["one"][0]["shards"], H.assemble(trained["fsdp"], 4))


def test_prefetch_is_bitwise_the_eager_step(trained):
    """Two leaves a layer gather (in_proj, out_proj), and the embedding:
    once a layer with the prefetch, twice under remat without it."""
    eager, pf = trained["fsdp"], trained["prefetch"]
    for a, b in zip(eager, pf):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path
    assert pf[0]["meter"]["gathers"] == STEPS * (N_LAYERS * 2 + 1)
    assert eager[0]["meter"]["gathers"] == STEPS * (2 * N_LAYERS * 2 + 1)
    assert {a for a in eager[0]["axes"].values()} == {"", "pod,data"}


def _summed(res, key) -> dict:
    out = {}
    for r in res:
        for k, v in r["meter"][key].items():
            out[k] = out.get(k, 0) + v
    return out


def test_recorded_edges_against_the_jax_hlo(trained, jax_out):
    """The replicated step's gradient sync (the Mamba leaves in one fp32
    bucket through the locality allreduce) against the compiled JAX step's
    HLO, and every FSDP gather and reduce-scatter against one shard-mapped
    JAX gather of a layer of in_proj, edge for edge; each rank's non-local
    messages are the schedule oracle's."""
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
        assert n_rs == STEPS * (N_LAYERS * 2 + 1)
        for key, n in (("gather", n_g), ("reduce_scatter", n_rs)):
            got = _summed(res, key)
            for k in ("permute_edges_local", "permute_edges_nonlocal"):
                assert got[k] == n * one[k], (variant, key, k)
        per_rank = [r["meter"]["gather"]["permute_edges_nonlocal"]
                    for r in res]
        assert per_rank == [n_g * oracle[r][2] for r in range(8)]


def test_trainer_and_launcher_train_mamba_on_one_rank(capsys):
    from repro_torch.launch import train as launch
    from repro_torch.train import Trainer, TrainerConfig
    cfg = H._small_cfg(ARCH, 1)
    tr = Trainer(cfg, None, TrainerConfig(steps=2, seq_len=S, global_batch=2,
                                          log_every=1), device="cpu")
    out = tr.run()
    assert out["steps"] == 2 and out["status"] == "complete"
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in tr.metrics_history)
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "1", "--layers", "1", "--seq-len", "16", "--global-batch",
                 "2"])
    assert f"[train] {ARCH}-smoke (1 layers) on cpu" in capsys.readouterr().out
