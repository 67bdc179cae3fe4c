"""Batch-sharded serving of the port on spawned gloo ranks (CPU), against the
JAX engine on forced host devices.

A reduced llama3.2-3b (2 layers, fp32) with the JAX ``init_params`` tree
(``params_from_jax``) serves 12 requests, all arriving at 0, on a StepClock,
with ``ServeSpec(batch=B, cache_len=L, page_len=8, migrate=alg)`` on q x pl
ranks, B divisible by q·pl: 2 x 2 (B = 8, two rows a rank), 3 x 2 (B = 6)
and 2 x 4 (B = 8) with a 32- or 48-slot cache, whose donor layout shards K
and V over ("pod", "data"), and 3 x 2 with 40 slots, which divide over a
pod's 2 ranks but not over 6, so the donor span narrows to ("data",); for
each of ``locality_bruck``, ``multilane`` and ``xla``. Most requests are
homed in the last pod, one in pod 0 and two nowhere, so the last pod's rows
fill first and later requests migrate. One JAX subprocess with 8 forced
host devices runs the JAX engine on the same meshes and traces (``AxisType
.Auto`` axes, no ``jax.set_mesh``, ``drain()`` under ``with mesh:``: the
recipe that runs on this JAX, ROADMAP.md Queue 3), plus:

* the HLO ``collective_stats`` of the JAX ``cache_migrate`` on one donor
  K or V leaf, shard-mapped as ``make_migrate_insert_fn`` does;
* a reduced mamba2-780m (2 layers, fp32, the JAX ``ssd_chunked`` made
  precise there, as ``tests/test_torch_serve.py`` does) on 2 x 2, whose
  SSM state has no sequence and moves whole;
* the legacy ``Engine.generate`` on one device and batch-sharded on 2 x 2.

The port must give, for every request, the JAX engine's tokens, slot, home
pod, migrated flag and stamps, and its migration count; its one-rank
engine's tokens; the same results on every rank; no byte sent for a request
that did not migrate; the JAX HLO's messages and bytes for each migration's
collective (summed over the ranks), and the schedule oracle's non-local
messages on each rank. The trace of ``chip_smoke.py``'s phase 7 (16
requests homed in pod 0, B = 8 on 2 x 2, a 2,048-slot cache) is run here at
the reduced size too, by the JAX engine and the port: the migration count
both give is the one phase 7 must see.
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
import torch

import torch_helpers as H
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.core import schedules as TS
from repro_torch.core.topology import RegionMap
from repro_torch.models.transformer import params_from_jax

REPO = Path(__file__).resolve().parents[1]
ALGS = ("locality_bruck", "multilane", "xla")
# (name, q, pl, batch, cache_len)
CASES = [("2x2", 2, 2, 8, 32), ("3x2", 3, 2, 6, 48),
         ("3x2_data", 3, 2, 6, 40), ("2x4", 2, 4, 8, 32)]
PAGE = 8
N_LAYERS = 2
MAMBA = ("mamba_2x2", 2, 2, 4, 32)
GEN_BATCH, GEN_LEN, GEN_NEW, GEN_CACHE = 4, 7, 5, 32


def trace(vocab: int, q: int, n: int = 12):
    """(prompt, max_new, home_pod): prompts of 5 and 11 tokens (two prefill
    shapes for the JAX engine to compile), homes mostly the last pod."""
    rng = np.random.default_rng(0)
    homes = [q - 1, q - 1, None, q - 1, 0, q - 1]
    news = [4, 7, 3, 6, 2, 5]
    return [(rng.integers(0, vocab, (5, 11)[i % 2]).astype(np.int32),
             news[i % 6], homes[i % 6]) for i in range(n)]


def gen_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(
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
from repro.models import ssm, transformer
from repro.serve.engine import Engine
from repro.serve.scheduler import StepClock
from repro.serve.spec import Request, ServeSpec

plan = json.loads(open(sys.argv[3]).read())
FIELDS = ("tokens", "slot", "home_pod", "migrated", "started_s",
          "finished_s", "token_times_s", "finish_reason")

def small(arch):
    return dataclasses.replace(configs.get_smoke(arch),
                               n_layers=plan["n_layers"], dtype=jnp.float32)

def mesh_of(q, pl):
    return jax.make_mesh((q, pl), ("pod", "data"),
                         devices=jax.devices()[:q * pl],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

def serve(cfg, params, q, pl, batch, L, alg, reqs, page=plan["page"]):
    mesh = mesh_of(q, pl)
    eng = Engine(cfg, mesh, params, ServeSpec(
        batch=batch, cache_len=L, page_len=page, migrate=alg),
        clock=StepClock())
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
    return {"results": out,
            "migrations": eng.scheduler.stats()["migrations"]}

def migrate_hlo(cfg, q, pl, L, alg):
    # one donor K (or V) leaf of a B = 1 cache through the collective, as
    # make_migrate_insert_fn's gather_leaf runs it
    mesh = mesh_of(q, pl)
    span = ("pod", "data") if L % (q * pl) == 0 else ("data",)
    outer, local = (("pod",), ("data",)) if "pod" in span else (span, ())
    spec = P(None, None, span if len(span) > 1 else span[0], None, None)
    shape = (cfg.n_layers, 1, L, cfg.n_kv_heads, cfg.head_dim_)

    def region(x):
        y = jnp.moveaxis(x, 2, 0)
        g = C.cache_migrate(y.reshape(-1), outer, local, algorithm=alg,
                            tiled=True)
        return jnp.moveaxis(g.reshape((-1,) + y.shape[1:]), 0, 2)

    f = jax.jit(jax.shard_map(region, mesh=mesh, in_specs=spec,
                              out_specs=P(), check_vma=False))
    a = jax.ShapeDtypeStruct(shape, jnp.float32,
                             sharding=NamedSharding(mesh, spec))
    st = collective_stats(f.lower(a).compile().as_text(),
                          device_pod_map(mesh, ("pod",)))
    return {k: getattr(st, k) for k in (
        "permute_edges_local", "permute_edges_nonlocal",
        "permute_bytes_local", "permute_bytes_nonlocal", "group_msgs_local",
        "group_msgs_nonlocal", "group_bytes_local", "group_bytes_nonlocal")}

out = {"serve": {}, "hlo": {}, "generate": {}}
cfg = small("llama3.2-3b")
params = transformer.init_params(jax.random.PRNGKey(0), cfg)
for name, q, pl, batch, L in plan["cases"]:
    for alg in plan["algs"]:
        key = f"{name}|{alg}"
        out["serve"][key] = serve(cfg, params, q, pl, batch, L, alg,
                                  plan["traces"][name])
        out["hlo"][key] = migrate_hlo(cfg, q, pl, L, alg)
ph7 = plan["phase7"]
out["phase7"] = serve(cfg, params, 2, 2, ph7["batch"], ph7["cache_len"],
                      "locality_bruck", ph7["requests"], ph7["page"])
gen = plan["generate"]
for key, (q, pl) in (("one", (1, 1)), ("2x2", (2, 2))):
    mesh = mesh_of(q, pl)
    eng = Engine(cfg, mesh, params, ServeSpec(batch=gen["batch"],
                                              cache_len=gen["cache_len"]))
    with mesh:
        out["generate"][key] = eng.generate(
            np.asarray(gen["prompts"], np.int32), gen["max_new"]).tolist()
ssd = ssm.ssd_chunked
ssm.ssd_chunked = lambda *a, **kw: ssd(*a, **{**kw, "precise": True})
mcfg = small("mamba2-780m")
mparams = transformer.init_params(jax.random.PRNGKey(1), mcfg)
name, q, pl, batch, L = plan["mamba"]
out["serve"][name] = serve(mcfg, mparams, q, pl, batch, L, "locality_bruck",
                           plan["traces"][name])
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def _plan() -> dict:
    """The cases and traces, as the JAX subprocess reads them."""
    vocab = configs.get_smoke("llama3.2-3b").vocab_size
    mvocab = configs.get_smoke("mamba2-780m").vocab_size
    plain = lambda reqs: [[t.tolist(), m, h] for t, m, h in reqs]
    traces = {c[0]: plain(trace(vocab, c[1])) for c in CASES}
    traces[MAMBA[0]] = plain(trace(mvocab, MAMBA[1], 8))
    cs = _chip_smoke()
    phase7 = dict(batch=cs.BATCH_ROWS, cache_len=cs.BATCH_CACHE,
                  page=cs.BATCH_PAGE, requests=[
                      [t.tolist(), m, cs.BATCH_HOME_POD]
                      for t, m in cs.batch_requests(vocab)])
    return dict(cases=CASES, algs=ALGS, page=PAGE, n_layers=N_LAYERS,
                traces=traces, mamba=MAMBA, phase7=phase7,
                generate=dict(batch=GEN_BATCH, cache_len=GEN_CACHE,
                              max_new=GEN_NEW,
                              prompts=gen_prompts(vocab).tolist()))


def _params(arch: str, seed: int) -> dict:
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=N_LAYERS,
                               dtype=jnp.float32)
    tcfg = H._small_cfg(arch, N_LAYERS)
    tree = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, tree), tcfg).items()}


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    tmp = tmp_path_factory.mktemp("jax_serve_batch")
    out = tmp / "out.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    log, plan = tmp / "log.txt", tmp / "plan.json"
    plan.write_text(json.dumps(_plan()))
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
    return {"llama3.2-3b": _params("llama3.2-3b", 0),
            "mamba2-780m": _params("mamba2-780m", 1)}


@pytest.fixture(scope="module")
def served(pool, params):
    """{case|alg: per-rank results}, {case: the one-rank engine's} and the
    mamba case's."""
    vocab = configs.get_smoke("llama3.2-3b").vocab_size
    out, one = {}, {}
    p = params["llama3.2-3b"]
    for name, q, pl, batch, L in CASES:
        reqs = trace(vocab, q)
        kw = dict(batch=batch, cache_len=L, page_len=PAGE)
        one[name] = pool.run(H.task_serve_batch, 1, 1, "llama3.2-3b", p,
                             N_LAYERS, kw, reqs)[0]
        for alg in ALGS:
            out[f"{name}|{alg}"] = pool.run(
                H.task_serve_batch, q, pl, "llama3.2-3b", p, N_LAYERS,
                dict(kw, migrate=alg), reqs)
    name, q, pl, batch, L = MAMBA
    mvocab = configs.get_smoke("mamba2-780m").vocab_size
    out[name] = pool.run(H.task_serve_batch, q, pl, "mamba2-780m",
                         params["mamba2-780m"], N_LAYERS,
                         dict(batch=batch, cache_len=L, page_len=PAGE),
                         trace(mvocab, q, 8))
    return out, one


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out, log = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, log.read_text()[-4000:]
    return json.loads(out.read_text())


def _ranks(case: str) -> int:
    q, pl = next((c[1], c[2]) for c in CASES + [MAMBA]
                 if c[0] == case.split("|")[0])
    return q * pl


KEYS = [f"{c[0]}|{alg}" for c in CASES for alg in ALGS]


@pytest.mark.parametrize("key", KEYS)
def test_results_equal_the_jax_engine(served, jax_out, key):
    res = served[0][key]
    ref = jax_out["serve"][key]
    got = res[0]["results"]
    assert sorted(got) == sorted(int(r) for r in ref["results"])
    for rid, want in ref["results"].items():
        assert got[int(rid)] == want, f"request {rid}"
    assert res[0]["stats"]["migrations"] == ref["migrations"]


@pytest.mark.parametrize("key", KEYS)
def test_tokens_equal_one_rank_and_every_rank_alike(served, key):
    res, one = served[0][key], served[1][key.split("|")[0]]
    for r in range(1, _ranks(key)):
        assert res[r]["results"] == res[0]["results"], f"rank {r}"
        assert res[r]["stats"]["migrations"] == \
            res[0]["stats"]["migrations"]
    assert {rid: v["tokens"] for rid, v in res[0]["results"].items()} == \
        {rid: v["tokens"] for rid, v in one["results"].items()}
    # rank i holds rows [i * B_loc, (i + 1) * B_loc)
    batch = next(c[3] for c in CASES if c[0] == key.split("|")[0])
    b_loc = batch // _ranks(key)
    assert [res[r]["rows"] for r in range(_ranks(key))] == [
        (r * b_loc, b_loc) for r in range(_ranks(key))]


@pytest.mark.parametrize("key", KEYS)
def test_only_migrations_send(served, key):
    res = served[0][key]
    n = _ranks(key)
    results = res[0]["results"]
    migrated = {rid for rid, v in results.items() if v["migrated"]}
    assert res[0]["stats"]["migrations"] == len(migrated) > 0
    for rid in results:
        sent = sum(res[r]["sent"].get(rid, 0) for r in range(n))
        assert (sent > 0) == (rid in migrated), f"request {rid}: {sent} B"
    # a request is prefilled by the ranks of its pod alone: its home pod,
    # else its row's
    q = next(c[1] for c in CASES if c[0] == key.split("|")[0])
    pl = n // q
    for r in range(n):
        pod = r // pl
        want = sum(1 for v in results.values()
                   if (v["home_pod"] if v["migrated"] else
                       v["slot"] * q // (n * res[0]["rows"][1])) == pod)
        assert res[r]["stats"]["prefills"] == want, f"rank {r}"


@pytest.mark.parametrize("key", KEYS)
def test_migrate_records_equal_the_jax_hlo_and_the_oracle(served, jax_out,
                                                          key):
    res = served[0][key]
    n = _ranks(key)
    migrations = res[0]["stats"]["migrations"]
    total = {k: sum(res[r]["collective"][k] for r in range(n))
             for k in res[0]["collective"]}
    # two leaves (K and V) a migration, each the HLO's collective
    want = {k: 2 * v for k, v in jax_out["hlo"][key].items()}
    assert {k: v / migrations for k, v in total.items()} == want
    name, q, pl, _, _ = next(c for c in CASES if c[0] == key.split("|")[0])
    alg = key.split("|")[1]
    span = res[0]["span"]
    assert span == (("data",) if name == "3x2_data" else ("pod", "data"))
    for r in range(n):
        st = res[r]["stats"]
        per = st["migrate_nonlocal_msgs"] / migrations
        if span == ("data",):
            assert per == 0                  # the pods migrate apart
        elif alg != "xla":
            oracle = TS.ALGORITHMS[alg](n, pl).per_rank_stats(
                RegionMap(n, pl))
            assert per == 2 * oracle[r][2], f"rank {r}"
        assert st["migrate_bytes"] == sum(res[r]["collective"][k] for k in (
            "permute_bytes_local", "permute_bytes_nonlocal",
            "group_bytes_local", "group_bytes_nonlocal"))
        assert st["migrate_host_s"] == pytest.approx(
            st["migrate_donor_s"] + st["migrate_collective_s"]
            + st["migrate_insert_s"])
    # the donor move: each rank outside the home pod gets its K and V
    # shards from the home-pod rank of its lane, and the owner [pos, token]
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    L = next(c[4] for c in CASES if c[0] == name)
    shard = (N_LAYERS * (L // (pl if span == ("data",) else n))
             * cfg.n_kv_heads * cfg.head_dim_ * 4)
    donor = lambda k: sum(res[r]["stats"][k] for r in range(n)) / migrations
    assert donor("donor_nonlocal_msgs") == 2 * (n - pl) + 1
    assert donor("donor_bytes") == donor("donor_nonlocal_bytes") == \
        2 * (n - pl) * shard + 16


def test_mamba_state_moves_whole(served, jax_out):
    name = MAMBA[0]
    res = served[0][name]
    ref = jax_out["serve"][name]
    for rid, want in ref["results"].items():
        for r in range(4):
            assert res[r]["results"][int(rid)] == want, f"rank {r}, {rid}"
    migrations = res[0]["stats"]["migrations"]
    assert migrations == ref["migrations"] > 0
    cfg = H._small_cfg("mamba2-780m", N_LAYERS)
    from repro_torch.models.ssm import mamba_cache_shapes
    whole = sum(int(np.prod(shape)) * dtype.itemsize * N_LAYERS
                for shape, dtype in mamba_cache_shapes(cfg, 1).values())
    for r in range(4):
        st = res[r]["stats"]
        assert st["migrate_bytes"] == 0
        assert not any(res[r]["collective"].values())
    # the conv and h leaves and [pos, token] go whole, once a migration
    assert sum(res[r]["stats"]["donor_bytes"] for r in range(4)) == \
        migrations * (whole + 2 * 8)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["one", "2x2"])
def test_generate_equals_jax(pool, params, jax_out, grid):
    vocab = configs.get_smoke("llama3.2-3b").vocab_size
    res = pool.run(H.task_generate, *grid, params["llama3.2-3b"], N_LAYERS,
                   GEN_BATCH, GEN_CACHE, gen_prompts(vocab), GEN_NEW)
    want = jax_out["generate"]["one" if grid == (1, 1) else "2x2"]
    n = grid[0] * grid[1]
    for r in range(n):
        assert res[r]["tokens"] == want
        assert res[r]["warned"]
    assert jax_out["generate"]["one"] == jax_out["generate"]["2x2"]


def test_spec_errors(pool):
    res = pool.run(H.task_batch_spec_errors, 2, 2)
    for r in range(4):
        err = res[r]
        assert err["auto"][0] == "NotImplementedError"
        assert "item 8" in err["auto"][1] and "cache_migrate" in err["auto"][1]
        assert err["unknown"][0] == "ValueError"
        assert "gspmd" in err["unknown"][1]
        assert err["home_pod"][0] == "ValueError"
        assert err["one_pod_auto"] is None     # nothing to migrate on 1 pod
        assert err["sequence_auto"] is None


@pytest.mark.parametrize("q,pl,batch", [(2, 2, 8), (3, 2, 6), (2, 4, 8)])
def test_pod_of_row(q, pl, batch):
    """Rows lie over the ranks in contiguous blocks, pod-major: the paged
    accounting the scheduler builds for a batch-sharded layout puts every
    row in the pod of the rank that holds it, as the JAX accounting does;
    a sequence layout is built with one pod."""
    from repro.serve.paged import PagedKVCache as JaxPaged
    from repro_torch.serve import PagedKVCache, ServeSpec
    grid = types.SimpleNamespace(q=q, pl=pl)
    cfg = H._small_cfg("llama3.2-3b", N_LAYERS)
    res = ServeSpec(batch=batch, cache_len=32).resolve(cfg, grid)
    assert res.batch_sharded and res.n_pods == q
    paged = PagedKVCache(batch, 32, PAGE, n_pods=res.n_pods)
    ref = JaxPaged(batch, 32, PAGE, n_pods=q)
    b_loc = batch // (q * pl)
    assert [paged.pod_of_row(r) for r in range(batch)] == \
        [ref.pod_of_row(r) for r in range(batch)] == \
        [r // b_loc // pl for r in range(batch)]
    seq = ServeSpec(batch=1, cache_len=48, combine="locality").resolve(
        cfg, grid)
    assert not seq.batch_sharded


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase7_trace_migrations(pool, params, jax_out):
    """The phase 7 trace at the reduced size: the JAX engine on 2 x 2 and
    the port both decide the migration count phase 7 must see on the card;
    the port's results equal the JAX engine's, every rank's are alike and
    its tokens equal one rank's."""
    cs = _chip_smoke()
    vocab = configs.get_smoke("llama3.2-3b").vocab_size
    reqs = [(t, m, cs.BATCH_HOME_POD) for t, m in
            cs.batch_requests(vocab)]
    kw = dict(batch=cs.BATCH_ROWS, cache_len=cs.BATCH_CACHE,
              page_len=cs.BATCH_PAGE)
    p = params["llama3.2-3b"]
    res = pool.run(H.task_serve_batch, 2, 2, "llama3.2-3b", p, N_LAYERS,
                   dict(kw, migrate="locality_bruck"), reqs)
    one = pool.run(H.task_serve_batch, 1, 1, "llama3.2-3b", p, N_LAYERS, kw,
                   reqs)[0]
    ref = jax_out["phase7"]
    assert ref["migrations"] == cs.BATCH_MIGRATIONS
    assert res[0]["stats"]["migrations"] == cs.BATCH_MIGRATIONS
    got = res[0]["results"]
    assert sorted(got) == sorted(int(r) for r in ref["results"])
    for rid, want in ref["results"].items():
        assert got[int(rid)] == want, f"request {rid}"
    for r in range(4):
        assert res[r]["results"] == res[0]["results"]
    assert {k: v["tokens"] for k, v in res[0]["results"].items()} == \
        {k: v["tokens"] for k, v in one["results"].items()}
