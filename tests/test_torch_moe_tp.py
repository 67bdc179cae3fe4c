"""The MoE family on a ("pod", "data", "model") grid of spawned gloo ranks
(CPU): the routed experts' E split over "model", served and trained,
against the JAX package on forced host devices.

A model rank t of m holds the routed experts [t·E/m, (t+1)·E/m), its
columns of the shared experts' ``gate``/``up`` and rows of their ``down``,
its q heads and their KV heads, its vocabulary rows; the router is whole.
Every rank routes the whole row alike and runs its experts' slots; the
routed and shared partial sums leave the tier as one sum a layer
(``models/tp.moe_tp``).

The models, fp32 from the JAX ``init_params`` tree (PRNGKey 0,
``params_from_jax``): the reduced qwen2-moe-a2.7b (2 layers, 8 experts at
softmax top-4, 2 shared, an untied head) and the reduced
llama4-scout-17b-a16e (4 layers: three chunked-local layers of chunk 64 and
a NoPE layer, qk-norm, 8 experts at sigmoid top-1, one shared). Three
JAX subprocesses with 8 forced host devices each, one serving each model
and one training, started first at a lower priority so that they run
while the ranks work (whose collectives wait on the slowest rank), on
``jax.make_mesh(shape, ("pod", "data", "model"), axis_types=
(AxisType.Auto,) * 3)``, no ``jax.set_mesh``, every call under ``with
mesh:`` (ROADMAP.md Queue 3's recipe), give:

* the serving specs ``param_specs(..., fsdp=False)`` of a reduced MoE
  layer on (1, 1, m), m = 2 and 4: ``tp.part``'s parts of every leaf put
  back together along the spec's "model" dim rebuild the whole leaf (the
  shared experts' ``gate`` by columns, the routed stacks by experts);
* the JAX engine on (2, 2, 2), with ``tests/test_torch_moe_grid.py``'s
  traces and 128-slot cache: batch-sharded (``batch=8``, 12 requests
  homed in pod 0, ``migrate="locality_bruck"``) and one B = 1 split cache
  (``combine="locality"``, a decode crossing llama4's chunk boundary);
* ``make_train_step(moe_dispatch="none")`` of the reduced qwen2-moe on
  (2, 2, 2), 2 steps of ``SyntheticLM(seed=0)`` batches of 8 x 32 tokens
  with ``AdamW()``, in locality + FSDP, locality + FSDP + ``seq_shard``
  and xla + FSDP.

Limits. The layer: the sum over t of rank t's share of ``moe_apply``
within 1e-5 of the largest |output| of the JAX ``moe_apply`` (read: 3e-7;
the shares add each token's slots in another order than the JAX
scatter-add), the aux loss bitwise equal on every t. Serving: tokens,
rows, pods, migrated flags, StepClock stamps and migration counts equal;
the tier sums the partial outputs in another order than one rank, which
moves fp32 logits by ~1e-7 of their size, inside the greedy margins of
these traces. Training (``tests/test_torch_variants_tp.py``'s): losses,
aux losses and grad norms 1e-5 relative, every parameter within 9e-5 and
at most 1 in 10,000 elements beyond 1e-5 (fp32 sums in other orders over
two AdamW steps); ``prefetch_depth=1`` bitwise the eager step. The port's
expert-parallel steps on the tier (``moe_dispatch="locality"`` and
``"xla"``, and "locality" with ``seq_shard``) are held against the same
JAX "none" step: the JAX EP step raises on this JAX
(``tests/test_torch_moe_train.py``), and its package defines it to equal
the "none" one. One departure: the JAX engine on (2, 2, 2) gives
llama4's first split request (a 70-token prompt that rolls the 64-slot
rings, split in four) other tokens than the JAX engine on (2, 2, 1), (1,
2, 2) and (1, 1, 2), which agree with each other and with the port on
every grid (``JAX_MESH_FAULT``, ROADMAP.md Queue 3); that request's tokens
are held to the port's one rank, which ``tests/test_torch_moe_grid.py``
holds to the JAX (2, 2, 1) engine, and its other fields to the JAX (2, 2,
2) engine. 1 x 2 x 4 (2 experts, 16 shared columns and one q head a
rank, the 2 KV heads each read by two ranks) is held against the port's
one rank: serving token for token, training with the two lanes' rows as
two microbatches (the aux loss is each DP rank's rows').
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers as H
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models.moe import moe_apply as jax_moe_apply
from repro_torch.models import transformer as T
from repro_torch.models.moe import capacity, dispatch_tables, moe_apply
from repro_torch.models.tp import TensorParallel
from test_torch_moe_grid import BATCH, CACHE, LAYERS, PAGE, trace

REPO = Path(__file__).resolve().parents[1]
ARCHS = tuple(LAYERS)
MOE = "qwen2-moe-a2.7b"
SHAPE = (2, 2, 2)
SERVE_CASES = (("b222|locality_bruck",
                dict(batch=BATCH, cache_len=CACHE, page_len=PAGE,
                     migrate="locality_bruck"), "batch"),
               ("s222|pod|locality",
                dict(batch=1, cache_len=CACHE, page_len=PAGE,
                     combine="locality"), "seq"))
SERVE_KEYS = [key for key, _, _ in SERVE_CASES]
# 1 x 2 x 4: batch-sharded over the 2 lanes, and one split cache
WIDE_CASES = (("b124", dict(batch=BATCH, cache_len=CACHE, page_len=PAGE),
               "batch"),
              ("s124", dict(batch=1, cache_len=CACHE, page_len=PAGE,
                            combine="locality"), "seq"))
N_LAYERS, B, S, STEPS = 2, 8, 32, 2
REL, LAYER_REL = 1e-5, 1e-5
PARAM_ATOL, PARAM_CLOSE, PARAM_FAR_SHARE = 9e-5, 1e-5, 1e-4
JAX_VARIANTS = {"fsdp": dict(grad_sync="locality", fsdp=True),
                "seq_shard": dict(grad_sync="locality", fsdp=True,
                                  seq_shard=True),
                "xla": dict(grad_sync="xla", fsdp=True)}
# the port's runs on 2 x 2 x 2: name -> (keywords, the JAX run it equals)
PORT_VARIANTS = {
    **{v: (kw, v) for v, kw in JAX_VARIANTS.items()},
    "prefetch": (dict(fsdp=True, prefetch_depth=1), "fsdp"),
    "ep_locality": (dict(fsdp=True, moe_dispatch="locality",
                         global_batch=B), "fsdp"),
    "ep_xla": (dict(fsdp=True, moe_dispatch="xla", global_batch=B), "fsdp"),
    "ep_locality_seq": (dict(fsdp=True, moe_dispatch="locality",
                             global_batch=B, seq_shard=True), "seq_shard")}
MS = (2, 4)
# requests whose tokens the JAX engine on (2, 2, 2) gives otherwise than the
# JAX engine on (2, 2, 1), (1, 2, 2) and (1, 1, 2) (ROADMAP.md Queue 3):
# llama4's 70-token prompt, which rolls its 64-slot rings, split in four
# with two model ranks. The port gives one rank's tokens on every grid.
JAX_MESH_FAULT = {("llama4-scout-17b-a16e", "s222|pod|locality"): {0}}

JAX_REFERENCE = r"""
import dataclasses, json, os, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
warnings.simplefilter("ignore")
jax.config.update("jax_compilation_cache_dir", sys.argv[3])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
from repro import configs
from repro.data import SyntheticLM
from repro.models import transformer
from repro.serve.engine import Engine
from repro.serve.scheduler import StepClock
from repro.serve.spec import Request, ServeSpec
from repro.train.sharding import param_specs
from repro.train.step import custom_batch_specs, init_state, make_train_step

out_dir = sys.argv[1]
plan = json.loads(open(sys.argv[2]).read())
AXES = ("pod", "data", "model")
FIELDS = ("tokens", "slot", "home_pod", "migrated", "started_s",
          "finished_s", "token_times_s", "finish_reason")
path_of = lambda path: "/".join(
    str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
mesh_of = lambda shape: jax.make_mesh(
    tuple(shape), AXES, devices=jax.devices()[:int(np.prod(shape))],
    axis_types=(AxisType.Auto,) * 3)
cfg_of = lambda arch, n: dataclasses.replace(
    configs.get_smoke(arch), n_layers=n, dtype=jnp.float32)
out = {"specs": {}, "serve": {}}

part = int(sys.argv[4])           # this process's share of the work
# the serving specs of every leaf, its "model" dim (-1: whole)
for arch, n in plan["archs"].items() if part == 0 else ():
    cfg = cfg_of(arch, n)
    abstract = jax.eval_shape(lambda k: transformer.init_params(k, cfg),
                              jax.random.PRNGKey(0))
    for m in plan["ms"]:
        specs = param_specs(abstract, mesh_of((1, 1, m)), fsdp=False)
        out["specs"][f"{arch}|{m}"] = {
            path_of(p): next((i for i, s in enumerate(spec)
                              if s == "model"), -1)
            for p, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}

# the engine on (2, 2, 2)
for arch, n in plan["archs"].items():
    cases = [c for c in plan["serve"][arch] if c[3] == part]
    if not cases:
        continue
    cfg = cfg_of(arch, n)
    params = jax.jit(lambda k: transformer.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    mesh = mesh_of(plan["serve_shape"])
    for key, kw, reqs, _ in cases:
        eng = Engine(cfg, mesh, params, ServeSpec(**kw), clock=StepClock())
        for toks, new, home in reqs:
            eng.submit(Request(tokens=np.asarray(toks, np.int32),
                               max_new=new, home_pod=home, arrival_s=0.0))
        with mesh:
            res = eng.drain()
        got = {}
        for rid, r in res.items():
            d = {f: getattr(r, f) for f in FIELDS}
            d["tokens"] = [int(t) for t in r.tokens]
            d["token_times_s"] = [float(t) for t in r.token_times_s]
            got[str(rid)] = d
        out["serve"][f"{arch}|{key}"] = {
            "results": got, "combine": dataclasses.asdict(eng.combine),
            "migrations": eng.scheduler.stats().get("migrations", 0)}

# the training step on (2, 2, 2)
out["train"] = {}
tr = plan["train"]
cfg = cfg_of(tr["arch"], tr["n_layers"])
Bt, St = tr["global_batch"], tr["seq_len"]
data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=St, global_batch=Bt,
                   seed=0)
save = lambda name, tree: np.savez(f"{out_dir}/{name}.npz", **{
    path_of(p): np.asarray(v)
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
mesh = mesh_of((2, 2, 2))
with mesh:
    for i, (name, kw) in enumerate(tr["variants"].items()
                                   if part == plan["parts"] - 1 else ()):
        art = make_train_step(cfg, mesh, shape=custom_batch_specs(cfg, Bt, St),
                              donate=False, moe_dispatch="none", **kw)
        state = init_state(cfg, mesh, art)
        if i == 0:
            save("params0", state.params)
        rec = {"losses": [], "moe_aux": [], "grad_norms": []}
        for step in range(tr["steps"]):
            batch = {k: jax.device_put(v, art.batch_shardings[k])
                     for k, v in data.batch(step).items()}
            state, m = art.step_fn(state, batch)
            rec["losses"].append(float(m["loss"]))
            rec["moe_aux"].append(float(m["moe_aux"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
        save(name, state.params)
        out["train"][name] = rec
with open(f"{out_dir}/out{part}.json", "w") as fh:
    json.dump(out, fh)
"""


#: the JAX processes: one serves each model (the first also reads the
#: specs), the last trains (each 35-45 s alone)
JAX_PARTS = len(ARCHS) + 1


def _vocab(arch: str) -> int:
    return H._small_cfg(arch, 1).vocab_size


def _requests(arch: str, kind: str) -> list:
    return trace(kind, _vocab(arch))


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX references in ``JAX_PARTS`` subprocesses, started first so
    that they run beside the ranks."""
    tmp = tmp_path_factory.mktemp("jax_moe_tp")
    plan = tmp / "plan.json"
    plan.write_text(json.dumps(dict(
        archs=LAYERS, ms=MS, serve_shape=SHAPE, parts=JAX_PARTS,
        serve={arch: [(key, kw, [[t.tolist(), new, home] for t, new, home
                                  in _requests(arch, kind)], i)
                      for key, kw, kind in SERVE_CASES]
               for i, arch in enumerate(ARCHS)},
        train=dict(arch=MOE, n_layers=N_LAYERS, global_batch=B, seq_len=S,
                   steps=STEPS, variants=JAX_VARIANTS))))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"log{part}.txt", "w") for part in range(JAX_PARTS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_REFERENCE, str(tmp), str(plan),
         str(tmp / f"cache{part}"), str(part)], env=env, stdout=log,
        stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10))
        for part, log in enumerate(logs)]
    yield procs, tmp
    for proc, log in zip(procs, logs):
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    """The processes' results: ``specs``, ``serve`` and ``train`` (with
    ``params``, the initial and trained parameters by leaf path)."""
    procs, tmp = jax_proc
    out = {"specs": {}, "serve": {}, "train": {}}
    for part, proc in enumerate(procs):
        rc = proc.wait(timeout=600)
        assert rc == 0, (tmp / f"log{part}.txt").read_text()[-4000:]
        for k, v in json.loads((tmp / f"out{part}.json").read_text()
                               ).items():
            out[k].update(v)
    out["params"] = {}
    for name in ["params0", *JAX_VARIANTS]:
        with np.load(tmp / f"{name}.npz") as z:
            out["params"][name] = dict(z)
    return out


@pytest.fixture(scope="module")
def trees(jax_proc, pool):
    """{arch: (its JAX config, its JAX ``init_params`` tree (jitted,
    numpy leaves), the tree's leaves by path)}, drawn here while the
    references run and the ranks start."""
    out = {}
    for arch, n in LAYERS.items():
        cfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=n,
                                  dtype=jnp.float32)
        tree = jax.jit(lambda k: jtransformer.init_params(k, cfg))(
            jax.random.PRNGKey(0))
        flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
        out[arch] = (cfg, jax.tree.map(np.asarray, tree), flat)
    return out


@pytest.fixture(scope="module")
def layer_ref(trees):
    """{arch: (x, the JAX ``moe_apply`` of layer 0 on x: out, aux)}: 2
    rows of 64 tokens."""
    out = {}
    for arch, (jcfg, tree, _) in trees.items():
        x = np.random.default_rng(3).standard_normal(
            (2, 64, jcfg.d_model)).astype(np.float32)
        jp = jax.tree.map(lambda a: a[0], tree["blocks"]["slot0"]["moe"])
        ref = jax.jit(lambda p, x: jax_moe_apply(p, x, jcfg))(jp, x)
        out[arch] = (x, *(np.asarray(a) for a in ref))
    return out


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def served(pool, trees):
    """{(arch, key): per-rank results}: 2 x 2 x 2 (``SERVE_KEYS``), 1 x 2
    x 4 (``WIDE_CASES``) and the one-rank engine ("one|batch",
    "one|seq")."""
    out = {}
    for arch, n in LAYERS.items():
        params = {k: v.numpy() for k, v in params_from_jax_of(
            trees[arch][1], arch, n).items()}
        for key, kw, kind in SERVE_CASES:
            out[arch, key] = pool.run(H.task_serve_variant, *SHAPE, arch,
                                      params, n, kw, _requests(arch, kind))
        for key, kw, kind in WIDE_CASES:
            reqs = _requests(arch, kind)
            out[arch, key] = pool.run(H.task_serve_variant, 1, 2, 4, arch,
                                      params, n, kw, reqs)
            plain = {k: v for k, v in kw.items() if k != "combine"}
            out[arch, f"one|{kind}"] = pool.run(
                H.task_serve_variant, 1, 1, 1, arch, params, n, plain,
                reqs)[:1]
    return out


def params_from_jax_of(tree, arch: str, n: int) -> dict:
    return T.params_from_jax(tree, H._small_cfg(arch, n))


@pytest.fixture(scope="module")
def trained(pool, trees):
    """{run: per-rank results}: ``PORT_VARIANTS`` on 2 x 2 x 2, locality +
    FSDP on 1 x 2 x 4, and one rank with the 2 lanes' rows as 2
    microbatches."""
    flat = trees[MOE][2]

    def run(q, pl, m, kw):
        res = pool.run(H.task_train, q, pl, flat, N_LAYERS, STEPS, B, S, kw,
                       MOE, m)
        return [r for r in res if r is not None]
    out = {v: run(*SHAPE, kw) for v, (kw, _) in PORT_VARIANTS.items()}
    out["1x2x4"] = run(1, 2, 4, dict(fsdp=True))
    out["one"] = run(None, None, 1, dict(grad_accum=2))[:1]
    return out


# ---------------------------------------------------------------------------
# the layer, no ranks
# ---------------------------------------------------------------------------
def _layer0(params: dict) -> dict:
    return {n.split(".", 2)[2]: t for n, t in params.items()
            if n.startswith("layers.0.")}


@pytest.mark.parametrize("m", MS)
def test_check_tp_takes_the_family_and_names_what_m_does_not_divide(m):
    """qwen2-moe-a2.7b serves and trains on a tier of m, llama4-scout
    serves (its training is item 15); an expert count or a shared-expert
    width that m does not divide is refused, naming it."""
    from repro_torch import configs
    from repro_torch.models.tp import check_tp
    qwen, llama4 = configs.get(MOE), configs.get(ARCHS[1])
    for use in ("serve", "train"):
        check_tp(qwen, m, use)
    check_tp(llama4, m, "serve")
    with pytest.raises(NotImplementedError, match="item 15"):
        check_tp(llama4, m, "train")
    for field, n in (("n_experts", 65), ("d_shared_expert", 5633)):
        with pytest.raises(NotImplementedError, match=f"{field} {n}"):
            check_tp(dataclasses.replace(qwen, **{field: n}), m, "serve")


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_shares_sum_to_the_jax_moe_layer(trees, layer_ref, arch, m):
    """Rank t's share of ``moe_apply`` (its experts' slots, its shared
    columns), summed over t, against the JAX ``moe_apply`` of the whole
    layer on 2 rows of 64 tokens, where capacity drops assignments; the
    aux loss is the same on every t, the JAX one within fp32 rounding."""
    cfg = H._small_cfg(arch, LAYERS[arch])
    w = _layer0(params_from_jax_of(trees[arch][1], arch, LAYERS[arch]))
    x, want, want_aux = layer_ref[arch]
    xt = torch.from_numpy(x)
    # capacity bites: some assignments drop
    idx = torch.topk(torch.softmax(xt @ w["router"], -1) if
                     cfg.router_act == "softmax" else
                     torch.sigmoid(xt @ w["router"]), cfg.top_k, -1)[1]
    E, C = cfg.n_experts, capacity(cfg, 64)
    slot_of = dispatch_tables(idx, torch.ones(idx.shape), E, C)[2]
    assert int((slot_of == E * C).sum()) > 0
    total, auxes = 0, []
    for t in range(m):
        tp = TensorParallel(cfg, types.SimpleNamespace(m=m, t=t))
        part = {n: tp.part(f"layers.0.{n}", v) for n, v in w.items()}
        assert part["gate"].shape[0] == E // m
        y, aux = moe_apply(part, xt, cfg, experts=tp.experts())
        total = total + y
        auxes.append(aux)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(total.numpy(), want, rtol=0,
                               atol=LAYER_REL * scale)
    assert all(torch.equal(a, auxes[0]) for a in auxes)
    np.testing.assert_allclose(float(auxes[0]), float(want_aux), rtol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _tokens(res) -> dict:
    return {rid: v["tokens"] for rid, v in res["results"].items()}


@pytest.mark.parametrize("key", SERVE_KEYS + [k for k, _, _ in WIDE_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_experts_and_sums_twice_a_layer(served, arch,
                                                            key):
    """Each rank holds E/m routed experts and d_shared/m shared columns,
    the router whole; each forward (a prefill or a decode step) makes 2 L
    + 2 tier calls (``wo`` and the MoE a layer, the embedding, the greedy
    token), none across a pod."""
    cfg = H._small_cfg(arch, LAYERS[arch])
    m = 4 if key.endswith("124") else 2
    for x in served[arch, key]:
        shapes, st = x["layer0"], x["stats"]
        assert shapes["gate"] == (cfg.n_experts // m, cfg.d_model, 64)
        assert shapes["down"] == (cfg.n_experts // m, 64, cfg.d_model)
        assert shapes["shared_gate"] == (cfg.d_model, 64 // m)
        assert shapes["shared_down"] == (64 // m, cfg.d_model)
        assert shapes["router"] == (cfg.d_model, cfg.n_experts)
        forwards = st["prefills"] + st["decode_steps"]
        assert forwards > 0
        assert st["tier_calls"] == (2 * LAYERS[arch] + 2) * forwards
        assert st["tier_nonlocal_msgs"] == 0


@pytest.mark.parametrize("kind", ["batch", "seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_1x2x4_equals_one_rank(served, arch, kind):
    """Four model ranks (2 experts a rank, one q head, the 2 KV heads each
    read by two ranks): every rank's tokens equal the one-rank engine's."""
    key = "b124" if kind == "batch" else "s124"
    one = served[arch, f"one|{kind}"][0]
    for x in served[arch, key]:
        assert _tokens(x) == _tokens(one)
        assert x["results"] == served[arch, key][0]["results"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _series(res, key) -> np.ndarray:
    return np.array([m[key] for m in res[0]["metrics"]])


def _close_params(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert np.mean(diff > PARAM_CLOSE) <= PARAM_FAR_SHARE


def _same_metrics_everywhere(res) -> None:
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]


def test_training_on_1x2x4_matches_one_rank(trained):
    """Four model ranks, 2 experts and 16 shared columns a rank: losses,
    aux losses and grad norms, and every parameter after two steps, equal
    the port's one rank with the lanes' rows as two microbatches."""
    res, one = trained["1x2x4"], trained["one"]
    _same_metrics_everywhere(res)
    for key in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(_series(res, key), _series(one, key),
                                   rtol=REL, atol=0, err_msg=key)
    assert res[0]["shards"]["blocks/slot0/moe/gate"].shape[1] == 2
    assert res[0]["shards"]["blocks/slot0/moe/shared/gate"].shape[-1] == 16
    _close_params(H.assemble_tp(res, 2, 4), one[0]["shards"])


def test_prefetch_is_bitwise_the_eager_step(trained):
    """Each layer's gathers, the expert stacks' among them, started one
    layer ahead: bitwise the eager step."""
    eager, pf = trained["fsdp"], trained["prefetch"]
    for a, b in zip(eager, pf):
        assert a["metrics"] == b["metrics"]
        for path in a["shards"]:
            assert np.array_equal(a["shards"][path], b["shards"][path]), path
    assert pf[0]["meter"]["gathers"] < eager[0]["meter"]["gathers"]


@pytest.mark.parametrize("variant", ["fsdp", "ep_locality"])
def test_tier_stays_in_its_pod(trained, variant):
    """The tier's collectives run on every rank, none across a pod."""
    for r in trained[variant]:
        mt = r["meter"]
        assert mt["model_calls"] > 0
        assert mt["model"]["group_msgs_nonlocal"] == 0
        assert mt["model"]["group_msgs_local"] > 0


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_launchers_serve_and_train_moe_on_a_tier(pool, monkeypatch,
                                                 capsys):
    """``launch.serve --mesh 2x2x2 --arch qwen2-moe-a2.7b --smoke`` and
    ``launch.train --ranks 8 --pods 2 --model 2 --moe-dispatch locality``
    on the module's 8 ranks: the same tokens on every rank; finite losses
    equal on every rank, the expert-parallel dispatch resolved on each
    lane, the tier inside each pod."""
    from repro_torch.launch import serve, train

    def on_pool(world, fn, args, **_):
        assert world == 8
        task = (H.task_launch_serve if fn is serve._serve_rank
                else H.task_launch_train)
        return pool.run(task, args)
    monkeypatch.setattr(serve, "run_ranks", on_pool)
    serve.main(["--mesh", "2x2x2", "--arch", MOE, "--smoke", "--device",
                "cpu", "--batch", "4", "--prompt-len", "12", "--max-new",
                "3", "--home-pod", "0"])
    out = capsys.readouterr().out
    assert f"[serve] {MOE} on 8 ranks (2 x 2 x 2 (pod, data, model)" in out
    calls = re.findall(r"tier_calls (\d+), tier_nonlocal_msgs (\d+)", out)
    assert len(calls) == 8 and all(int(c) > 0 and n == "0"
                                   for c, n in calls)
    train.main(["--arch", MOE, "--smoke", "--device", "cpu", "--ranks",
                "8", "--pods", "2", "--model", "2", "--fsdp",
                "--moe-dispatch", "locality", "--steps", "1", "--layers",
                "1", "--seq-len", "16", "--global-batch", "4"])
    out = capsys.readouterr().out
    assert "moe dispatch locality/tokens" in out
    losses = json.loads(out.split("losses ")[1].split(" in ")[0])
    assert len(losses) == 1 and np.isfinite(losses[0])
    tier = re.findall(r"model-tier calls (\d+) \(non-local msgs (\d+)\)",
                      out)
    assert len(tier) == 8
    assert all(int(calls) > 0 and far == "0" for calls, far in tier)


# ---------------------------------------------------------------------------
# against the JAX references (last: the ranks' work above runs meanwhile)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ARCHS)
def test_parts_rebuild_every_leaf_along_the_jax_spec(trees, jax_out,
                                                     arch, m):
    """Every leaf of a MoE layer, the embedding, the head and the final
    norm, cut by ``tp.part`` for each t and put back together along the
    "model" dim of the JAX serving spec on (1, 1, m), is the whole leaf
    (a leaf the spec keeps whole is whole on every t); ``wk``/``wv``
    where m does not divide the KV heads are the heads the rank's q heads
    read instead (``tests/test_torch_serve_tp.py``)."""
    cfg = H._small_cfg(arch, LAYERS[arch])
    params = params_from_jax_of(trees[arch][1], arch, LAYERS[arch])
    specs = jax_out["specs"][f"{arch}|{m}"]
    paths = T.spec_leaf_paths(cfg, cfg.layer_plan()[0])
    names = {f"layers.0.{n}": "blocks/slot0/" + "/".join(p)
             for n, p in paths.items()}
    names |= {"embed": "embed", "head": "head",
              "final_norm": "final_norm/scale"}
    tps = [TensorParallel(cfg, types.SimpleNamespace(m=m, t=t))
           for t in range(m)]
    checked = set()
    for name, path in names.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("wk", "wv") and not tps[0].kv_local:
            continue
        full = params[name]
        parts = [tp.part(name, full) for tp in tps]
        dim = specs[path] - (1 if path.startswith("blocks/") else 0)
        if dim < 0:
            assert all(torch.equal(p, full) for p in parts), name
        else:
            assert torch.equal(torch.cat(parts, dim), full), name
            assert parts[0].shape[dim] * m == full.shape[dim]
        checked.add(leaf)
    # the shared experts split by columns (JAX: P(None, "model")), the
    # routed stacks by experts, the router whole
    assert specs["blocks/slot0/moe/shared/gate"] == 2
    assert specs["blocks/slot0/moe/gate"] == 1
    assert specs["blocks/slot0/moe/router"] == -1
    assert {"router", "gate", "up", "down", "shared_gate", "shared_up",
            "shared_down"} <= checked


@pytest.mark.parametrize("key", SERVE_KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_2x2x2_equals_the_jax_engine(served, jax_out, arch,
                                                key):
    """Every request's tokens, row, home pod, migrated flag and StepClock
    stamps, the migration count and the ``CombineChoice`` equal the JAX
    (2, 2, 2) engine's; every rank's results are alike and equal the
    one-rank engine's tokens. The tokens of ``JAX_MESH_FAULT``'s requests
    are held to the one-rank engine alone (module docstring)."""
    res = served[arch, key]
    ref = jax_out["serve"][f"{arch}|{key}"]
    got = res[0]
    one = served[arch, "one|batch" if key[0] == "b" else "one|seq"][0]
    assert sorted(got["results"]) == sorted(int(r) for r in ref["results"])
    fault = JAX_MESH_FAULT.get((arch, key), set())
    for rid, want in ref["results"].items():
        rid = int(rid)
        if rid in fault:
            want = dict(want, tokens=one["results"][rid]["tokens"])
        assert got["results"][rid] == want, f"request {rid}"
    assert _tokens(got) == _tokens(one)
    assert got["stats"]["migrations"] == ref["migrations"]
    assert got["combine"] == ref["combine"]
    for r, x in enumerate(res):
        assert x["results"] == got["results"], f"rank {r}"
        assert x["coords"][2] == r
    if key.startswith("b"):
        assert ref["migrations"] > 0
        assert any(v["migrated"] for v in got["results"].values())
    else:
        assert got["combine"]["algorithm"] == "locality"
        st = got["stats"]
        assert st["combine_layers"] == st["decode_steps"] * LAYERS[arch]


@pytest.mark.parametrize("variant", [v for v in PORT_VARIANTS
                                     if v != "prefetch"])
def test_training_on_2x2x2_matches_the_jax_step(trained, jax_out, trees,
                                                variant):
    """Losses, aux losses and grad norms at each step and every parameter
    after two steps (router, routed and shared experts included) equal
    the JAX (2, 2, 2) "none" step's; every rank agrees; the routed
    experts hold E/m a rank over "model" (FSDP over the lane), or E/p
    over the lane under expert parallelism, whole on the tier."""
    for path, a in jax_out["params"]["params0"].items():
        assert np.array_equal(trees[MOE][2][path], a), path
    res = trained[variant]
    kw, ref_name = PORT_VARIANTS[variant]
    _same_metrics_everywhere(res)
    ref = jax_out["train"][ref_name]
    for key, want in (("loss", "losses"), ("moe_aux", "moe_aux"),
                      ("grad_norm", "grad_norms")):
        np.testing.assert_allclose(_series(res, key), ref[want], rtol=REL,
                                   atol=0, err_msg=key)
    _close_params(H.assemble_tp(res, 2, 2), jax_out["params"][ref_name])
    ep = "moe_dispatch" in kw
    gate = "blocks/slot0/moe/gate"
    assert res[0]["mdims"][gate] == (-1 if ep else 1)
    assert res[0]["shards"][gate].shape[1:3] == ((2, 128) if ep else (4, 32))
    assert res[0]["mdims"]["blocks/slot0/moe/shared/gate"] == 2
    assert res[0]["mdims"]["blocks/slot0/moe/router"] == -1
    alg, transport, _ = res[0]["moe"]
    assert alg == kw.get("moe_dispatch", "none")
    if ep:
        assert transport == ("tokens" if alg == "locality" else "slots")
        assert res[0]["meter"]["a2a_calls"] > 0


def test_aux_differs_with_the_dp_count_as_in_jax(trained, jax_out):
    """The aux loss is the mean over DP ranks of each one's rows' aux:
    1 x 2 x 4 (2 DP ranks) differs from 2 x 2 x 2 (4), and equals one
    rank running the 2 lanes' rows as microbatches, at the limits
    above."""
    wide, one = trained["1x2x4"], trained["one"]
    assert not np.allclose(_series(wide, "moe_aux"),
                           jax_out["train"]["fsdp"]["moe_aux"], rtol=1e-3)
    np.testing.assert_allclose(_series(wide, "moe_aux"),
                               _series(one, "moe_aux"), rtol=REL, atol=0)
