"""The MoE family served on (pod, data) grids of spawned gloo ranks (CPU),
against the JAX engine on forced host devices.

qwen2-moe-a2.7b (2 layers: 8 experts at softmax top-4, 2 shared) and
llama4-scout-17b-a16e (4 layers: three chunked-local layers with the
reduced chunk of 64 and a NoPE layer, qk-norm, 8 experts at sigmoid top-1
with one shared expert), smoke configs in fp32 from the JAX
``init_params`` tree (PRNGKey 0, ``params_from_jax``), serve with a
128-slot cache: llama4's full-length stack (its NoPE layer) holds 128
slots, its chunked rings 64. Every rank holds every expert, as the JAX
engine holds them over its DP axes; routing is per batch row, so no
collective is added. On a ("pod", "data", "model") grid, where each model
rank holds E/m experts, the family is served in
``tests/test_torch_moe_tp.py``. One JAX subprocess with 8 forced host
devices runs the JAX engine on ``jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
axis_types=(AxisType.Auto,) * 3)``, no ``jax.set_mesh``, ``drain()``
under ``with mesh:`` (the recipe of ``tests/test_torch_serve_batch.py``).
Layouts:

* batch-sharded (``batch=8``, 2 rows a rank), 12 requests of 70 and 60
  tokens homed in pod 0, so that pod 0's rows fill first and later
  requests migrate to pod 1 (``locality_bruck``): every request's tokens,
  row, home pod, migrated flag and stamps (StepClock) equal the JAX
  engine's, and so does the count of migrations;
* one B = 1 split cache over ("pod", "data") with ``combine="locality"``
  and ``"xla"``, two requests, one whose decode crosses llama4's chunk
  boundary at 64: the results and the ``CombineChoice`` equal the JAX
  engine's, and every decode step combines in every layer of a split
  stack (llama4's rings in 16-slot shards, a shard keeping none of its
  slots after the boundary).

Every rank of a grid returns the same results, equal to the port's
one-rank engine's. Tokens must be equal; the grid sums the combine's
partial stats in another order than one rank, which moves fp32 logits by
~1e-6 of their size, far inside the greedy margins of these traces.
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

import torch_helpers as H
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models.transformer import params_from_jax

REPO = Path(__file__).resolve().parents[1]
LAYERS = {"qwen2-moe-a2.7b": 2, "llama4-scout-17b-a16e": 4}
ARCHS = tuple(LAYERS)
PAGE, CACHE, BATCH, SHAPE = 8, 128, 8, (2, 2, 1)
CASES = (("b221|locality_bruck",
          dict(batch=BATCH, cache_len=CACHE, page_len=PAGE,
               migrate="locality_bruck"), "batch"),
         ("s221|pod|locality",
          dict(batch=1, cache_len=CACHE, page_len=PAGE, combine="locality"),
          "seq"),
         ("s221|pod|xla",
          dict(batch=1, cache_len=CACHE, page_len=PAGE, combine="xla"),
          "seq"))
KEYS = [key for key, _, _ in CASES]
SEQ_KEYS = [key for key in KEYS if key[0] == "s"]


def trace(kind: str, vocab: int) -> list:
    """(prompt, max_new, home_pod): "batch", 12 requests of 70 and 60
    tokens homed in pod 0; "seq", two served one at a time. A 70-token
    prompt rolls llama4's 64-slot rings at prefill; a 60-token one with 6
    or more new tokens crosses its chunk boundary while decoding."""
    rng = np.random.default_rng(0 if kind == "batch" else 1)
    if kind == "seq":
        return [(rng.integers(0, vocab, n).astype(np.int32), m, None)
                for n, m in ((70, 5), (60, 8))]
    news = [4, 7, 3, 6, 2, 5]
    return [(rng.integers(0, vocab, (70, 60)[i % 2]).astype(np.int32),
             news[i % 6], 0) for i in range(12)]


JAX_REFERENCE = r"""
import dataclasses, json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
warnings.simplefilter("ignore", DeprecationWarning)
jax.config.update("jax_compilation_cache_dir", sys.argv[2])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
from repro import configs
from repro.models import transformer
from repro.serve.engine import Engine
from repro.serve.scheduler import StepClock
from repro.serve.spec import Request, ServeSpec

plan = json.loads(open(sys.argv[3]).read())
FIELDS = ("tokens", "slot", "home_pod", "migrated", "started_s",
          "finished_s", "token_times_s", "finish_reason")

def serve(cfg, params, shape, spec_kw, reqs):
    mesh = jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
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

out = {}
for arch, spec in plan["archs"].items():
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              n_layers=spec["n_layers"], dtype=jnp.float32)
    params = jax.jit(lambda k: transformer.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    out[arch] = {key: serve(cfg, params, shape, kw, reqs)
                 for key, shape, kw, reqs in spec["cases"]}
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def _vocab(arch: str) -> int:
    return configs.get_smoke(arch).vocab_size


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so that it runs while the ranks
    serve."""
    tmp = tmp_path_factory.mktemp("jax_moe_grid")
    out, log, plan = tmp / "out.json", tmp / "log.txt", tmp / "plan.json"
    archs = {arch: {"n_layers": n, "cases": [
        (key, SHAPE, kw, [[t.tolist(), m, h]
                          for t, m, h in trace(kind, _vocab(arch))])
        for key, kw, kind in CASES]} for arch, n in LAYERS.items()}
    plan.write_text(json.dumps(dict(archs=archs)))
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
    p = H.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def served(pool):
    """{(arch, case): per-rank results on the 2 x 2 grid} and {(arch,
    trace): the one-rank engine's}."""
    out, one = {}, {}
    for arch, n in LAYERS.items():
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=n,
                                   dtype=jnp.float32)
        tree = jax.jit(lambda k: jtransformer.init_params(k, jcfg))(
            jax.random.PRNGKey(0))
        params = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, tree), H._small_cfg(arch, n)).items()}
        for key, kw, kind in CASES:
            reqs = trace(kind, _vocab(arch))
            out[arch, key] = pool.run(H.task_serve_variant, *SHAPE, arch,
                                      params, n, kw, reqs)
            if (arch, kind) not in one:
                plain = {k: v for k, v in kw.items()
                         if k not in ("combine", "migrate")}
                one[arch, kind] = pool.run(H.task_serve_variant, 1, 1, 1,
                                           arch, params, n, plain, reqs)[0]
    return out, one


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out, log = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, log.read_text()[-4000:]
    return json.loads(out.read_text())


def _kind(key: str) -> str:
    return next(kind for k, _, kind in CASES if k == key)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_results_equal_the_jax_engine(served, jax_out, arch, key):
    got = served[0][arch, key][0]
    ref = jax_out[arch][key]
    assert sorted(got["results"]) == sorted(int(r) for r in ref["results"])
    for rid, want in ref["results"].items():
        assert got["results"][int(rid)] == want, f"request {rid}"
    assert got["stats"]["migrations"] == ref["migrations"]
    if key.startswith("b"):
        assert ref["migrations"] > 0
        assert any(v["migrated"] for v in got["results"].values())


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_alike_and_equal_to_one_rank(served, arch, key):
    res = served[0][arch, key]
    one = served[1][arch, _kind(key)]
    for r, x in enumerate(res):
        assert x["results"] == res[0]["results"], f"rank {r}"
        assert x["coords"][2] == r               # grid rank = spawned rank
    assert {rid: v["tokens"] for rid, v in res[0]["results"].items()} == \
        {rid: v["tokens"] for rid, v in one["results"].items()}
    if key.startswith("b"):                      # each rank its own rows
        assert {x["stats"]["prefills"] for x in res[:2]} == {12}
        assert {x["stats"]["prefills"] for x in res[2:]} == {0}


@pytest.mark.parametrize("key", SEQ_KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_cache_combines_every_layer(served, jax_out, arch, key):
    """The combine choice field for field; each stack split in four by
    its own length (llama4's 64-slot rings in 16-slot shards, its NoPE
    layer's 128 slots in 32), and every decode step combining in every
    attention layer, the chunk in the chunked layers' meta."""
    n = LAYERS[arch]
    plan = configs.get_smoke(arch).layer_plan()[:n]
    chunked = sum(s.attn == "chunked" for s in plan)
    want_shards = {"k/v": (32, CACHE)}
    if chunked:
        want_shards["k_ring/v_ring"] = (16, 64)
    for i, x in enumerate(served[0][arch, key]):
        assert x["combine"] == jax_out[arch][key]["combine"]
        assert x["combine"]["algorithm"] == key.split("|")[2]
        assert {names: (length, total) for names, (off, length, total)
                in x["shards"].items()} == want_shards
        assert all(off == i * length for off, length, _
                   in x["shards"].values())
        st = x["stats"]
        assert st["combine_steps"] == st["decode_steps"] > 0
        assert st["combine_layers"] == st["decode_steps"] * n
