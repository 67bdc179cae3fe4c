"""Serving of the port on a ("pod", "data", "model") grid of spawned gloo
ranks (CPU), against the JAX engine on forced host devices.

A reduced llama3.2-3b (2 layers, d_model 128, 4 q and 2 KV heads of 32,
padded vocabulary 512, fp32) from the JAX ``init_params`` tree (PRNGKey 0,
``params_from_jax``) serves on 8 gloo ranks as ``RankGrid.build(q, pl,
m)``: each rank holds its q heads, the KV heads they read (its cache's),
its MLP columns and vocabulary rows, and each model lane of q·pl ranks
serves as a grid of its own. One JAX subprocess with 8 forced host devices
runs the JAX engine on ``jax.make_mesh(shape, ("pod", "data", "model"),
axis_types=(AxisType.Auto,) * 3)``, no ``jax.set_mesh``, ``drain()`` and
``generate()`` under ``with mesh:`` (the recipe that runs on this JAX,
ROADMAP.md Queue 3). Cases:

* (2, 2, 2) batch-sharded, ``ServeSpec(batch=8, cache_len=32, page_len=8,
  migrate=alg)`` for ``locality_bruck`` and ``xla``, 12 requests homed
  mostly in pod 1 so that some migrate: every request's tokens, slot, home
  pod, migrated flag and stamps equal the JAX engine's (StepClock); each
  migration's messages and bytes, summed over the 8 ranks, equal the HLO
  ``collective_stats`` of the JAX ``cache_migrate`` on one donor K or V
  leaf sharded as ``cache_shardings`` shards it (sequence over ("pod",
  "data"), KV heads over "model"), times two leaves; each rank's non-local
  messages equal the schedule oracle's for its lane rank; the donor move
  per lane;
* (2, 2, 2) B = 1 (a 48-slot cache split over each lane's 4 ranks) with
  ``combine="locality"`` and ``"xla"``: the results equal, and
  ``CombineChoice`` equal to the JAX engine's field for field (its payload
  priced at H / m heads);
* (1, 2, 4), where 4 model ranks split 2 KV heads (the JAX cache shards
  the head dim; each port rank holds the KV head its q head reads): B = 1
  with ``combine="locality"``, which resolves to the JAX engine's "xla":
  the results equal;
* the legacy ``Engine.generate`` batch-sharded on (2, 2, 2);
* the trace of ``chip_smoke.py``'s phase 9a (the first 8 requests of
  phase 7's, homed in pod 0, B = 8, a 2,048-slot cache) at the reduced
  size on (2, 2, 2): the migration count the JAX engine and the port both
  give is the one phase 9a must see;
* lanes whose clocks disagree (``torch_helpers.OffsetClock``) admit every
  request at the same step on every rank (admission agreed over all 8
  ranks from grid rank 0), and serve the tokens of one rank.

Every rank of a grid returns the same results, the tokens equal the
port's one-rank engine's, and the tier's collectives stay inside a pod.
Tokens must be equal; the grid computes the row-parallel sums in another
order than one rank, which moves fp32 logits by ~1e-6 of their size, far
inside the greedy margins of these traces, so no logit tolerance is needed
beyond token equality. ``CombineChoice`` and the paged accounting are also
held against the JAX functions in this process on stand-in meshes.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_helpers as H
from conftest import fake_mesh
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap
from repro_torch.models.transformer import params_from_jax

REPO = Path(__file__).resolve().parents[1]
N_LAYERS, PAGE = 2, 8
GRID = (2, 2, 2)
ALGS = ("locality_bruck", "xla")
BATCH, BATCH_CACHE = 8, 32
SEQ_CACHE = 48
SEQ_REQUESTS = [(5, 6), (17, 5), (30, 8)]          # (prompt, max_new)
COMBINES = ("locality", "xla")
HEAD_DIM_GRID = (1, 2, 4)                          # 2 KV heads over 4
GEN_BATCH, GEN_LEN, GEN_NEW, GEN_CACHE = 4, 7, 5, 32


def trace(vocab: int, n: int = 12):
    """(prompt, max_new, home_pod): prompts of 5 and 11 tokens, homes mostly
    pod 1, so that its rows fill first and later requests migrate."""
    rng = np.random.default_rng(0)
    homes = [1, 1, None, 1, 0, 1]
    news = [4, 7, 3, 6, 2, 5]
    return [(rng.integers(0, vocab, (5, 11)[i % 2]).astype(np.int32),
             news[i % 6], homes[i % 6]) for i in range(n)]


def seq_trace(vocab: int):
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, n).astype(np.int32), m, None)
            for n, m in SEQ_REQUESTS]


def gen_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, vocab, (GEN_BATCH, GEN_LEN)).astype(np.int32)


JAX_REFERENCE = r"""
import dataclasses, json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
warnings.simplefilter("ignore", DeprecationWarning)
jax.config.update("jax_compilation_cache_dir", sys.argv[2])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
from repro import configs
from repro.core import collectives as C
from repro.core.hlo_analysis import collective_stats
from repro.core.topology import device_pod_map
from repro.models import transformer
from repro.serve.engine import Engine
from repro.serve.scheduler import StepClock
from repro.serve.spec import Request, ServeSpec

plan = json.loads(open(sys.argv[3]).read())
FIELDS = ("tokens", "slot", "home_pod", "migrated", "started_s",
          "finished_s", "token_times_s", "finish_reason")
cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                          n_layers=plan["n_layers"], dtype=jnp.float32)
params = jax.jit(lambda k: transformer.init_params(k, cfg))(
    jax.random.PRNGKey(0))

def mesh_of(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                         devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)

def serve(shape, spec_kw, reqs):
    mesh = mesh_of(shape)
    eng = Engine(cfg, mesh, params, ServeSpec(**spec_kw), clock=StepClock())
    for toks, m, home in reqs:
        eng.submit(Request(tokens=np.asarray(toks, np.int32), max_new=m,
                           home_pod=home, arrival_s=0.0))
    with mesh:
        res = eng.drain()
    out = {}
    for rid, r in res.items():
        d = {f: getattr(r, f) for f in FIELDS}
        d["tokens"] = [int(t) for t in r.tokens]
        d["token_times_s"] = [float(t) for t in r.token_times_s]
        out[str(rid)] = d
    return {"results": out, "combine": dataclasses.asdict(eng.combine),
            "migrations": eng.scheduler.stats().get("migrations", 0)}

def migrate_hlo(shape, L, alg):
    # one donor K (or V) leaf of a B = 1 cache: the sequence over
    # ("pod", "data"), the KV heads over "model" (cache_shardings), through
    # the collective as make_migrate_insert_fn's gather_leaf runs it
    mesh = mesh_of(shape)
    spec = P(None, None, ("pod", "data"), "model", None)
    leaf = (cfg.n_layers, 1, L, cfg.n_kv_heads, cfg.head_dim_)

    def region(x):
        y = jnp.moveaxis(x, 2, 0)
        g = C.cache_migrate(y.reshape(-1), ("pod",), ("data",),
                            algorithm=alg, tiled=True)
        return jnp.moveaxis(g.reshape((-1,) + y.shape[1:]), 0, 2)

    f = jax.jit(jax.shard_map(region, mesh=mesh, in_specs=spec,
                              out_specs=P(None, None, None, "model", None),
                              check_vma=False))
    a = jax.ShapeDtypeStruct(leaf, jnp.float32,
                             sharding=NamedSharding(mesh, spec))
    st = collective_stats(f.lower(a).compile().as_text(),
                          device_pod_map(mesh, ("pod",)))
    return {k: getattr(st, k) for k in (
        "permute_edges_local", "permute_edges_nonlocal",
        "permute_bytes_local", "permute_bytes_nonlocal", "group_msgs_local",
        "group_msgs_nonlocal", "group_bytes_local", "group_bytes_nonlocal")}

out = {"serve": {}, "hlo": {}}
for key, shape, spec_kw, reqs in plan["cases"]:
    out["serve"][key] = serve(shape, spec_kw, reqs)
for alg in plan["algs"]:
    out["hlo"][alg] = migrate_hlo(plan["grid"], plan["batch_cache"], alg)
gen = plan["generate"]
mesh = mesh_of(plan["grid"])
eng = Engine(cfg, mesh, params, ServeSpec(batch=gen["batch"],
                                          cache_len=gen["cache_len"]))
with mesh:
    out["generate"] = eng.generate(np.asarray(gen["prompts"], np.int32),
                                   gen["max_new"]).tolist()
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(vocab: int) -> list:
    """(key, mesh shape, ServeSpec keywords, requests), as both sides run
    them."""
    plain = lambda reqs: [[t.tolist(), m, h] for t, m, h in reqs]
    cs = _chip_smoke()
    cases = [(f"batch|{alg}", GRID, dict(batch=BATCH, cache_len=BATCH_CACHE,
                                         page_len=PAGE, migrate=alg),
              plain(trace(vocab))) for alg in ALGS]
    cases += [(f"seq|{c}", GRID, dict(batch=1, cache_len=SEQ_CACHE,
                                      page_len=PAGE, combine=c),
               plain(seq_trace(vocab))) for c in COMBINES]
    cases += [("head_dim|seq", HEAD_DIM_GRID,
               dict(batch=1, cache_len=SEQ_CACHE, page_len=PAGE,
                    combine="locality"), plain(seq_trace(vocab))),
              ("phase9a|locality_bruck", cs.TIER_GRID,
               dict(batch=cs.BATCH_ROWS, cache_len=cs.BATCH_CACHE,
                    page_len=cs.BATCH_PAGE, migrate="locality_bruck"),
               plain([(t, m, cs.BATCH_HOME_POD)
                      for t, m in cs.tier_batch_requests(vocab)]))]
    return cases


def _vocab() -> int:
    return configs.get_smoke("llama3.2-3b").vocab_size


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    tmp = tmp_path_factory.mktemp("jax_serve_tp")
    out, log, plan = tmp / "out.json", tmp / "log.txt", tmp / "plan.json"
    plan.write_text(json.dumps(dict(
        cases=_cases(_vocab()), algs=ALGS, grid=GRID, n_layers=N_LAYERS,
        batch_cache=BATCH_CACHE,
        generate=dict(batch=GEN_BATCH, cache_len=GEN_CACHE, max_new=GEN_NEW,
                      prompts=gen_prompts(_vocab()).tolist()))))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(out),
             str(tmp / "compile_cache"), str(plan)],
            env=env, stdout=fh, stderr=subprocess.STDOUT)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"),
                               n_layers=N_LAYERS, dtype=jnp.float32)
    tree = jax.jit(lambda k: jtransformer.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, tree),
        H._small_cfg("llama3.2-3b", N_LAYERS)).items()}


def _requests(reqs):
    return [(np.asarray(t, np.int32), m, h) for t, m, h in reqs]


@pytest.fixture(scope="module")
def served(pool, params):
    """{case: per-rank results on the case's grid} and {case: the one-rank
    engine's}."""
    out, one = {}, {}
    for key, shape, spec_kw, reqs in _cases(_vocab()):
        reqs = _requests(reqs)
        out[key] = pool.run(H.task_serve_batch, shape[0], shape[1],
                            "llama3.2-3b", params, N_LAYERS, spec_kw, reqs,
                            shape[2])[:int(np.prod(shape))]
        kw = {k: v for k, v in spec_kw.items()
              if k not in ("combine", "migrate")}
        one[key] = pool.run(H.task_serve_batch, 1, 1, "llama3.2-3b", params,
                            N_LAYERS, kw, reqs)[0]
    return out, one


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out, log = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, log.read_text()[-4000:]
    return json.loads(out.read_text())


SHAPES = {c[0]: c[1] for c in _cases(512)}
KEYS = list(SHAPES)


@pytest.mark.parametrize("key", KEYS)
def test_results_equal_the_jax_engine(served, jax_out, key):
    got = served[0][key][0]["results"]
    ref = jax_out["serve"][key]
    assert sorted(got) == sorted(int(r) for r in ref["results"])
    for rid, want in ref["results"].items():
        assert got[int(rid)] == want, f"request {rid}"
    assert served[0][key][0]["stats"]["migrations"] == ref["migrations"]


@pytest.mark.parametrize("key", KEYS)
def test_every_rank_alike_and_equal_to_one_rank(served, key):
    res, one = served[0][key], served[1][key]
    for r, x in enumerate(res):
        assert x["results"] == res[0]["results"], f"rank {r}"
        assert x["stats"]["decode_steps"] == res[0]["stats"]["decode_steps"]
        assert x["coords"][2] == r               # grid rank = spawned rank
    assert {rid: v["tokens"] for rid, v in res[0]["results"].items()} == \
        {rid: v["tokens"] for rid, v in one["results"].items()}


@pytest.mark.parametrize("key", KEYS)
def test_the_tier_stays_in_its_pod_and_decodes_eagerly(served, key):
    """Every rank ran tier collectives, none crossing a pod; the cache holds
    the rank's KV heads (KV / m, or the one its q head reads); a tier
    decodes eagerly by the stated rule."""
    res = served[0][key]
    m = SHAPES[key][2]
    for x in res:
        st = x["stats"]
        assert st["tier_calls"] > 0 and st["tier_msgs"] > 0
        assert st["tier_nonlocal_msgs"] == 0
        assert not st["decode_graph"]
        assert "model tier" in st["decode_graph_rule"]
        assert x["resolved"] == dict(m=m, kv_own=m == 2)
        assert x["cache_shape"][3] == 1          # 2 KV heads: one a rank


@pytest.mark.parametrize("alg", ALGS)
def test_migrations_equal_the_jax_hlo_and_the_oracle(served, jax_out, alg):
    res = served[0][f"batch|{alg}"]
    n, p, pl = len(res), GRID[0] * GRID[1], GRID[1]
    mig = res[0]["stats"]["migrations"]
    assert mig > 0
    total = {k: sum(x["collective"][k] for x in res)
             for k in res[0]["collective"]}
    want = {k: 2 * v for k, v in jax_out["hlo"][alg].items()}
    assert {k: v / mig for k, v in total.items()} == want
    oracle = TS.ALGORITHMS[alg](p, pl).per_rank_stats(RegionMap(p, pl)) \
        if alg != "xla" else None
    for r, x in enumerate(res):
        st = x["stats"]
        lane_rank = x["coords"][0]
        if oracle is not None:
            assert st["migrate_nonlocal_msgs"] / mig == \
                2 * oracle[lane_rank][2], f"rank {r}"
        assert st["migrate_bytes"] == sum(x["collective"][k] for k in (
            "permute_bytes_local", "permute_bytes_nonlocal",
            "group_bytes_local", "group_bytes_nonlocal"))
    # each lane's donor move: its ranks outside the home pod get their K
    # and V shards (the rank's one KV head) from the home-pod rank of their
    # DP lane, and the owner [pos, token]
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    shard = N_LAYERS * (BATCH_CACHE // p) * 1 * cfg.head_dim_ * 4
    donor = lambda k: sum(x["stats"][k] for x in res) / mig
    lanes = GRID[2]
    assert donor("donor_nonlocal_msgs") == lanes * (2 * (p - pl) + 1)
    assert donor("donor_bytes") == donor("donor_nonlocal_bytes") == \
        lanes * (2 * (p - pl) * shard + 16)


@pytest.mark.parametrize("key", ["seq|locality", "seq|xla", "head_dim|seq"])
def test_combine_choice_equals_the_jax_engine(served, jax_out, key):
    want = jax_out["serve"][key]["combine"]
    for x in served[0][key]:
        assert x["combine"] == want
        assert x["stats"]["combine_steps"] == x["stats"]["decode_steps"] > 0
    assert want["algorithm"] == ("xla" if key != "seq|locality"
                                 else "locality")


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (2, 1, 2), (1, 4, 2),
                                   (2, 2, 1)])
@pytest.mark.parametrize("combine", COMBINES)
def test_resolve_cache_combine_field_for_field(shape, combine):
    """The port's ``resolve_cache_combine`` against the JAX one, and the
    engine's choice (``ServeSpec.resolve``) against the JAX engine's rule
    (``_combine_eligible``), on stand-in meshes."""
    from repro.serve.engine import (_cache_layout, _combine_eligible,
                                    resolve_cache_combine as jax_resolve)
    from repro_torch.serve import ServeSpec
    from repro_torch.serve.spec import resolve_cache_combine
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"),
                               n_layers=N_LAYERS)
    tcfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    mesh = fake_mesh(shape, ("pod", "data", "model"))
    grid = types.SimpleNamespace(q=shape[0], pl=shape[1], m=shape[2])
    want = jax_resolve(jcfg, mesh, 1, SEQ_CACHE, override=combine)
    got = resolve_cache_combine(tcfg, grid, 1, SEQ_CACHE, override=combine)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if want.algorithm == "locality" and not _combine_eligible(
            jcfg, mesh, SEQ_CACHE, _cache_layout(mesh, 1)[1]):
        want = dataclasses.replace(want, algorithm="xla")
    res = ServeSpec(batch=1, cache_len=SEQ_CACHE, combine=combine).resolve(
        tcfg, grid)
    assert dataclasses.asdict(res.combine) == dataclasses.asdict(want)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (2, 4, 2)])
def test_paged_accounting_per_row_alike_on_every_tier_rank(shape):
    """The paged accounting is per batch row: the spec resolves the same
    pods and rows whatever the tier, and a row's pod is the JAX
    accounting's on the same mesh."""
    from repro.serve.paged import PagedKVCache as JaxPaged
    from repro.serve.spec import ServeSpec as JaxSpec
    from repro_torch.serve import PagedKVCache, ServeSpec
    q, pl, m = shape
    batch = 2 * q * pl
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"),
                               n_layers=N_LAYERS)
    jres = JaxSpec(batch=batch, cache_len=32).resolve(
        jcfg, fake_mesh(shape, ("pod", "data", "model")))
    for t in range(m):
        grid = types.SimpleNamespace(q=q, pl=pl, m=m, t=t)
        res = ServeSpec(batch=batch, cache_len=32).resolve(cfg, grid)
        assert (res.batch_sharded, res.n_pods, res.p_local, res.m) == \
            (jres.batch_sharded, jres.n_pods, jres.p_local, m)
        paged = PagedKVCache(batch, 32, PAGE, n_pods=res.n_pods)
        ref = JaxPaged(batch, 32, PAGE, n_pods=jres.n_pods)
        assert [paged.pod_of_row(r) for r in range(batch)] == \
            [ref.pod_of_row(r) for r in range(batch)] == \
            [jres.pod_of_row(r) for r in range(batch)]


def test_chip_smoke_phase9a_trace_migrations(served, jax_out):
    """Phase 9a's trace at the reduced size: the JAX (2, 2, 2) engine and
    the port decide the migration count phase 9a must see on the card."""
    cs = _chip_smoke()
    key = "phase9a|locality_bruck"
    assert jax_out["serve"][key]["migrations"] == cs.TIER_MIGRATIONS
    for x in served[0][key]:
        assert x["stats"]["migrations"] == cs.TIER_MIGRATIONS


def test_generate_equals_jax(pool, params, jax_out):
    res = pool.run(H.task_generate, GRID[0], GRID[1], params, N_LAYERS,
                   GEN_BATCH, GEN_CACHE, gen_prompts(_vocab()), GEN_NEW,
                   GRID[2])
    for x in res:
        assert x["tokens"] == jax_out["generate"]
        assert x["warned"]


def test_lanes_with_different_clocks_admit_together(pool, params, served):
    """Lane 1's clock runs 1.5 steps ahead of lane 0's, so it sees each
    request arrive earlier; admission is agreed over all 8 ranks from grid
    rank 0, so every rank admits every request at the same step (of its
    own step count), and the tokens are one rank's."""
    reqs = [(t, m, h, 2.0 * (i // 3)) for i, (t, m, h) in
            enumerate(trace(_vocab()))]
    spec = dict(batch=BATCH, cache_len=BATCH_CACHE, page_len=PAGE)
    res = pool.run(H.task_serve_batch, *GRID[:2], "llama3.2-3b", params,
                   N_LAYERS, spec, reqs, GRID[2], [0.0, 1.5])
    logs = [x["admitted"] for x in res]
    assert len(logs[0]) == len(reqs)
    assert all(log == logs[0] for log in logs)
    assert any(t > 0 for _, t in logs[0])        # some waited for arrival
    for x in res:
        assert x["results"] == res[0]["results"]
    one = served[1]["batch|xla"]
    assert {rid: v["tokens"] for rid, v in res[0]["results"].items()} == \
        {rid: v["tokens"] for rid, v in one["results"].items()}
