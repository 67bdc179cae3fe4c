"""The dense variants served on grids of spawned gloo ranks (CPU), against
the JAX engine on forced host devices.

gemma2-9b and h2o-danube-3-4b, smoke configs at 2 layers in fp32 (a 64-slot
window: gemma2's plan is one window layer and one full layer, h2o-danube's
two window layers), from the JAX ``init_params`` tree (PRNGKey 0,
``params_from_jax``), serve with a 128-slot cache, so that each full-length
K/V stack holds 128 slots and each ring 64. Prompts of 70 tokens roll the
ring at prefill; prompts of 60 tokens cross its wrap while decoding. Each
rank of the port's grid holds a shard of each stack split by the stack's
own length (``ServeSpec.resolve``'s ``spans``, the JAX ``cache_shardings``
leaf by leaf). One JAX subprocess with 8 forced host devices runs the JAX
engine on ``jax.make_mesh(shape, ("pod", "data", "model"),
axis_types=(AxisType.Auto,) * 3)``, no ``jax.set_mesh``, ``drain()`` under
``with mesh:`` (the recipe of ``tests/test_torch_serve_tp.py``). Layouts:

* (2, 2, 1) batch-sharded (``batch=8``, 2 rows a rank), 12 requests homed
  mostly in pod 1 so that some migrate, with ``locality_bruck`` and
  ``xla``: every request's tokens, row, home pod, migrated flag and stamps
  equal the JAX engine's (StepClock), and each migration's messages and
  bytes, summed over the ranks, equal the HLO ``collective_stats`` of the
  JAX ``cache_migrate`` summed over the donor layout's leaves, each
  sharded as ``cache_shardings`` shards it at B = 1 (the rings by their
  own 64 slots);
* (2, 2, 1) B = 1, the cache split over ("pod", "data") and over
  ("data",), with ``combine="locality"`` and ``"xla"``: the results equal,
  the ``CombineChoice`` equals the JAX engine's field for field, every
  decode step combines in every layer of a split stack, and the combine's
  messages are those of one combine alone on the stack's grid, per layer;
* (2, 2, 2), both layouts (``locality_bruck``, ``locality``), the model
  tier splitting the heads, the MLP columns and the vocabulary (gemma2's
  tied, h2o-danube's untied head), its post-norms whole on every rank;
* (3, 2, 1) B = 1 with a 96-slot cache, the port alone (the JAX engine's
  locality combine raises on a three-pod mesh in this JAX version, ROADMAP
  Queue 3): the full-length stack splits over all 6 ranks (16 slots), the
  64-slot ring, which 6 does not divide, over each pod's 2 ranks (32
  slots), combining over the pod's grid; the tokens equal one rank's.

Every rank of a grid returns the same results, equal to the port's one-rank
engine's. Unit cases on the plain versions: the decode scores and stats of
every shard of a ring against the JAX ``decode_stats_scores(slot_offset=,
total_len=, ring=True)`` and ``decode_stats_accumulate`` before, at and
after the wrap (fp32, within 1e-5), the ring-shard cache write, a prefilled
shard equal to the slice of the whole (rolled) cache, and the stacks'
spans equal to the JAX ``cache_shardings``'s on stand-in meshes. Tokens
must be equal; the grid sums the combine's partial stats and the tier's
row-parallel products in another order than one rank, which moves fp32
logits by ~1e-6 of their size, far inside the greedy margins of these
traces.
"""
import dataclasses
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
from conftest import fake_mesh
from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels.decode_stats import ops as stats_ops
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as T
from repro_torch.models.transformer import params_from_jax

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-9b", "h2o-danube-3-4b")
N_LAYERS, PAGE, CACHE, BATCH = 2, 8, 128, 8
ALGS = ("locality_bruck", "xla")
# (key, (pod, data, model), ServeSpec keywords, trace); the keys starting
# with "p" are the port's alone
CASES = (
    [(f"b221|{alg}", (2, 2, 1), dict(batch=BATCH, cache_len=CACHE,
                                     page_len=PAGE, migrate=alg), "batch")
     for alg in ALGS]
    + [(f"s221|{ax}|{c}", (2, 2, 1),
        dict(batch=1, cache_len=CACHE, page_len=PAGE, combine=c,
             **({} if ax == "pod" else dict(seq_axes=("data",)))), "seq")
       for ax in ("pod", "data") for c in ("locality", "xla")]
    + [("b222|locality_bruck", (2, 2, 2),
        dict(batch=BATCH, cache_len=CACHE, page_len=PAGE,
             migrate="locality_bruck"), "batch"),
       ("s222|pod|locality", (2, 2, 2),
        dict(batch=1, cache_len=CACHE, page_len=PAGE, combine="locality"),
        "seq"),
       ("p321|pod|locality", (3, 2, 1),
        dict(batch=1, cache_len=96, page_len=PAGE, combine="locality"),
        "seq")])
SHAPES = {key: shape for key, shape, _, _ in CASES}
JAX_KEYS = [key for key, *_ in CASES if not key.startswith("p")]
SEQ_KEYS = [key for key, *_ in CASES if "|" in key and key[0] in "sp"]
BATCH_KEYS = [key for key, *_ in CASES if key[0] == "b"]


def trace(kind: str, vocab: int) -> list:
    """(prompt, max_new, home_pod): "batch", 12 requests of 70 and 60
    tokens homed mostly in pod 1, so that its rows fill first and later
    requests migrate; "seq", two requests served one at a time."""
    rng = np.random.default_rng(0 if kind == "batch" else 1)
    if kind == "seq":
        return [(rng.integers(0, vocab, n).astype(np.int32), m, None)
                for n, m in ((70, 5), (60, 8))]
    homes = [1, 1, None, 1, 0, 1]
    news = [4, 7, 3, 6, 2, 5]
    return [(rng.integers(0, vocab, (70, 60)[i % 2]).astype(np.int32),
             news[i % 6], homes[i % 6]) for i in range(12)]


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
from repro.serve.engine import Engine, cache_shardings
from repro.serve.scheduler import StepClock, _seq_axes_of_spec
from repro.serve.spec import Request, ServeSpec

plan = json.loads(open(sys.argv[3]).read())
FIELDS = ("tokens", "slot", "home_pod", "migrated", "started_s",
          "finished_s", "token_times_s", "finish_reason")
KEYS = ("permute_edges_local", "permute_edges_nonlocal",
        "permute_bytes_local", "permute_bytes_nonlocal", "group_msgs_local",
        "group_msgs_nonlocal", "group_bytes_local", "group_bytes_nonlocal")

def mesh_of(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                         devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)

def serve(cfg, params, shape, spec_kw, reqs):
    mesh = mesh_of(shape)
    spec_kw = dict(spec_kw)
    if "seq_axes" in spec_kw:
        spec_kw["seq_axes"] = tuple(spec_kw["seq_axes"])
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

def migrate_hlo(cfg, shape, L, alg):
    # every donor leaf of a B = 1 cache, sharded as cache_shardings shards
    # it, through the collective as make_migrate_insert_fn's gather_leaf
    # runs it; the leaves' collective_stats summed
    mesh = mesh_of(shape)
    specs = jax.tree_util.tree_leaves(
        cache_shardings(cfg, mesh, 1, L),
        is_leaf=lambda x: isinstance(x, P))
    leaves = jax.tree_util.tree_leaves(transformer.cache_specs(cfg, 1, L))
    total = {k: 0 for k in KEYS}
    for leaf, spec in zip(leaves, specs):
        sharded = _seq_axes_of_spec(spec)
        if sharded is None:
            continue
        dim, axes = sharded
        outer = ("pod",) if "pod" in axes else axes
        local = tuple(a for a in axes if a != "pod") if "pod" in axes else ()
        out_spec = P(*[None if d == dim else e for d, e in enumerate(spec)])

        def region(x, dim=dim, outer=outer, local=local):
            y = jnp.moveaxis(x, dim, 0)
            g = C.cache_migrate(y.reshape(-1), outer, local, algorithm=alg,
                                tiled=True)
            return jnp.moveaxis(g.reshape((-1,) + y.shape[1:]), 0, dim)

        f = jax.jit(jax.shard_map(region, mesh=mesh, in_specs=spec,
                                  out_specs=out_spec, check_vma=False))
        a = jax.ShapeDtypeStruct(leaf.shape, leaf.dtype,
                                 sharding=NamedSharding(mesh, spec))
        st = collective_stats(f.lower(a).compile().as_text(),
                              device_pod_map(mesh, ("pod",)))
        for k in KEYS:
            total[k] += getattr(st, k)
    return total

out = {}
for arch, cases in plan["archs"].items():
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              n_layers=plan["n_layers"], dtype=jnp.float32)
    params = jax.jit(lambda k: transformer.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    got = out[arch] = {"serve": {}, "hlo": {}}
    for key, shape, spec_kw, reqs in cases:
        got["serve"][key] = serve(cfg, params, shape, spec_kw, reqs)
        if spec_kw.get("migrate"):
            got["hlo"][key] = migrate_hlo(cfg, shape, spec_kw["cache_len"],
                                          spec_kw["migrate"])
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def _vocab(arch: str) -> int:
    return configs.get_smoke(arch).vocab_size


def _plain(reqs) -> list:
    return [[t.tolist(), m, h] for t, m, h in reqs]


def _requests(reqs) -> list:
    return [(np.asarray(t, np.int32), m, h) for t, m, h in reqs]


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so that it runs while the ranks
    serve."""
    tmp = tmp_path_factory.mktemp("jax_variants_grid")
    out, log, plan = tmp / "out.json", tmp / "log.txt", tmp / "plan.json"
    archs = {arch: [(key, shape, kw, _plain(trace(kind, _vocab(arch))))
                    for key, shape, kw, kind in CASES if key in JAX_KEYS]
             for arch in ARCHS}
    plan.write_text(json.dumps(dict(archs=archs, n_layers=N_LAYERS)))
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


def _jax_pair(arch: str):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), n_layers=N_LAYERS,
                               dtype=jnp.float32)
    tree = jax.jit(lambda k: jtransformer.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, tree


@pytest.fixture(scope="module")
def served(pool):
    """{(arch, case): per-rank results on the case's grid} and {(arch,
    trace): the one-rank engine's}."""
    out, one = {}, {}
    for arch in ARCHS:
        _, tree = _jax_pair(arch)
        params = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, tree),
            H._small_cfg(arch, N_LAYERS)).items()}
        for key, shape, kw, kind in CASES:
            reqs = trace(kind, _vocab(arch))
            out[arch, key] = pool.run(
                H.task_serve_variant, *shape, arch, params, N_LAYERS, kw,
                reqs)[:int(np.prod(shape))]
            ref = (arch, kind, kw["cache_len"])
            if ref not in one:
                plain = {k: v for k, v in kw.items()
                         if k not in ("combine", "migrate", "seq_axes")}
                one[ref] = pool.run(H.task_serve_variant, 1, 1, 1, arch,
                                    params, N_LAYERS, plain, reqs)[0]
    return out, one


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out, log = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, log.read_text()[-4000:]
    return json.loads(out.read_text())


def _kind(key: str) -> str:
    return next(kind for k, _, _, kind in CASES if k == key)


def _kw(key: str) -> dict:
    return next(kw for k, _, kw, _ in CASES if k == key)


@pytest.mark.parametrize("key", JAX_KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_results_equal_the_jax_engine(served, jax_out, arch, key):
    got = served[0][arch, key][0]
    ref = jax_out[arch]["serve"][key]
    assert sorted(got["results"]) == sorted(int(r) for r in ref["results"])
    for rid, want in ref["results"].items():
        assert got["results"][int(rid)] == want, f"request {rid}"
    assert got["stats"]["migrations"] == ref["migrations"]
    if key.startswith("b"):
        assert ref["migrations"] > 0
        assert any(v["migrated"] for v in got["results"].values())


@pytest.mark.parametrize("key", [k for k, *_ in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_alike_and_equal_to_one_rank(served, arch, key):
    res = served[0][arch, key]
    one = served[1][arch, _kind(key), _kw(key)["cache_len"]]
    for r, x in enumerate(res):
        assert x["results"] == res[0]["results"], f"rank {r}"
        assert x["coords"][2] == r               # grid rank = spawned rank
    assert {rid: v["tokens"] for rid, v in res[0]["results"].items()} == \
        {rid: v["tokens"] for rid, v in one["results"].items()}
    m = SHAPES[key][2]
    for x in res:
        st = x["stats"]
        if m > 1:
            assert st["tier_calls"] > 0 and st["tier_nonlocal_msgs"] == 0
        else:
            assert "tier_calls" not in st


@pytest.mark.parametrize("key", SEQ_KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_stack_splits_by_its_own_length(served, arch, key):
    """Rank i of a stack's span holds its slots [i * L_loc, (i + 1) *
    L_loc), L_loc its own length over the span's ranks: the full-length
    stack's 128 (96) slots and the ring's 64, pod-major over ("pod",
    "data"), by lane over ("data",)."""
    q, pl, m = SHAPES[key]
    cache = _kw(key)["cache_len"]
    ring = configs.get_smoke(arch).window
    totals = {"k/v": cache, "k_ring/v_ring": min(cache, ring)}
    for r, x in enumerate(served[0][arch, key]):
        lane = x["coords"][0]
        assert set(x["shards"]) == {n for n, s in x["spans"].items() if s}
        for names, (off, n, total) in x["shards"].items():
            span = tuple(x["spans"][names])
            ranks = q * pl if span == ("pod", "data") else pl
            index = lane if span == ("pod", "data") else lane % pl
            assert (off, n, total) == (index * totals[names] // ranks,
                                       totals[names] // ranks,
                                       totals[names]), (r, names)
    spans = served[0][arch, key][0]["spans"]
    if key.startswith("p321"):       # 6 ranks split 96 slots; the ring's 64
        assert spans.get("k/v", ("pod", "data")) == ("pod", "data")
        assert spans["k_ring/v_ring"] == ("data",)


@pytest.mark.parametrize("key", [k for k in SEQ_KEYS if k in JAX_KEYS])
@pytest.mark.parametrize("arch", ARCHS)
def test_combine_equals_the_jax_engine(served, jax_out, arch, key):
    """The choice field for field; every decode step combines in every
    layer of a split stack, each layer sending what one combine of its
    payload sends on the stack's grid alone."""
    want = jax_out[arch]["serve"][key]["combine"]
    plan = configs.get_smoke(arch).layer_plan()[:N_LAYERS]
    split = {"k/v": sum(s.attn != "window" for s in plan),
             "k_ring/v_ring": sum(s.attn == "window" for s in plan)}
    for x in served[0][arch, key]:
        assert x["combine"] == want
        st = x["stats"]
        steps = st["decode_steps"]
        assert st["combine_steps"] == steps > 0
        assert st["combine_layers"] == steps * sum(
            split[n] for n in x["shards"])
        assert st["nonlocal_msgs"] == steps * sum(
            split[n] * (one["permute_edges_nonlocal"]
                        + one["group_msgs_nonlocal"])
            for n, one in x["one_combine"].items())
        if "data|" in key:
            assert st["nonlocal_msgs"] == st["nonlocal_bytes"] == 0
    assert want["algorithm"] == key.split("|")[2]


@pytest.mark.parametrize("key", BATCH_KEYS)
@pytest.mark.parametrize("arch", ARCHS)
def test_migrations_equal_the_jax_hlo(served, jax_out, arch, key):
    """Each migration's messages and bytes, summed over the ranks, equal
    the JAX collective's on every donor leaf, the rings at their own
    span."""
    res = served[0][arch, key]
    mig = res[0]["stats"]["migrations"]
    assert mig > 0
    total = {k: sum(x["collective"][k] for x in res)
             for k in res[0]["collective"]}
    assert {k: v / mig for k, v in total.items()} == \
        jax_out[arch]["hlo"][key]
    for x in res:
        assert x["stats"]["migrate_bytes"] == sum(x["collective"][k] for k in (
            "permute_bytes_local", "permute_bytes_nonlocal",
            "group_bytes_local", "group_bytes_nonlocal"))


# ---------------------------------------------------------------------------
# the ring shard's pieces, on the plain versions
# ---------------------------------------------------------------------------
RING_T, RING_SHARDS = 16, 4          # a 16-slot ring over 4 shards of 4


@pytest.mark.parametrize("shard", range(RING_SHARDS))
@pytest.mark.parametrize("pos", [6, 15, 27])       # before, at, past the wrap
def test_ring_shard_scores_and_stats_match_jax(pos, shard):
    rng = np.random.default_rng(pos * 10 + shard)
    B, KV, G, D, Lloc = 2, 2, 2, 8, RING_T // RING_SHARDS
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Lloc, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Lloc, KV, D)).astype(np.float32)
    kw = dict(slot_offset=shard * Lloc, total_len=RING_T, window=RING_T,
              cap=5.0, ring=True)
    js, jmask = jattention.decode_stats_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), **kw)
    jm = jnp.max(js, axis=-1)
    jo, jl = jattention.decode_stats_accumulate(js, jmask, jm, jnp.asarray(v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tp = torch.tensor(pos)
    s, mask = tattention.decode_stats_scores(tq, tk, tp, **kw)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    s2, m2 = stats_ops.decode_scores(tq, tk, tp, **kw)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm), atol=1e-5)
    o, l = stats_ops.accumulate(s2, m2, tv, pos=tp, **{
        n: kw[n] for n in ("slot_offset", "total_len", "window", "ring")})
    kept = int(np.asarray(jmask).sum())
    if kept:
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5)
    else:            # a shard that keeps no slot: (NEG_INF, 0, 0) exactly
        assert bool((m2 == stats_ops.NEG_INF).all())
        assert float(o.abs().max()) == float(l.abs().max()) == 0.0
    # the kept local slots are [0, min(pos - offset, Lloc - 1)]
    want = min(max(pos - shard * Lloc + 1, 0), Lloc) if pos < RING_T \
        else Lloc
    assert kept == want


@pytest.mark.parametrize("pos", [3, 15, 16, 30])
def test_ring_shard_write_lands_in_the_owner(pos):
    """Slot pos % T of the ring is written on the shard that owns it, and
    every other shard is left as it was."""
    Lloc = RING_T // RING_SHARDS
    new = torch.arange(1, 1 + 2 * 3 * 4, dtype=torch.float32).reshape(
        2, 1, 3, 4)
    slot = pos % RING_T
    for shard in range(RING_SHARDS):
        cache = torch.zeros(2, Lloc, 3, 4)
        tattention.write_cache(cache, new, torch.tensor(pos),
                               slot_offset=shard * Lloc, total_len=RING_T,
                               ring=True)
        if slot // Lloc == shard:
            assert torch.equal(cache[:, slot % Lloc], new[:, 0])
            cache[:, slot % Lloc] = 0
        assert float(cache.abs().max()) == 0.0, shard
    with pytest.raises(ValueError, match="total_len"):
        tattention.write_cache(torch.zeros(2, Lloc, 3, 4), new,
                               torch.tensor(pos), slot_offset=0, ring=True)


@pytest.mark.parametrize("S", [40, 64, 100])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefilled_shards_are_slices_of_the_whole_cache(arch, S):
    """A prefill that keeps shard i of each stack (the full-length cache's
    32 of 128 slots, the ring's 16 of 64) holds exactly slice i of the
    whole prefill's cache, the ring rolled (token t at slot t % 64) where
    the prompt overflows it."""
    cfg = H._small_cfg(arch, N_LAYERS)
    model = T.Transformer(cfg, T.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), "cpu")
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, cfg.vocab_size, (1, S)))
    logits, whole = model(toks, mode="prefill", cache_len=CACHE)
    lens = model.stack_lens(CACHE)
    assert lens.get(T.RING_LEAVES) == cfg.window
    for i in range(4):
        shards = {names: (i * L // 4, L // 4) for names, L in lens.items()}
        lg, part = model(toks, mode="prefill", cache_len=CACHE,
                         shards=shards)
        assert torch.equal(lg, logits)
        assert int(part["pos"]) == S
        for names, (off, n) in shards.items():
            for name in names:
                assert torch.equal(part[name], whole[name][:, :, off:off + n])


@pytest.mark.parametrize("seq_axes", ["auto", ("data",)])
@pytest.mark.parametrize("cache_len", [128, 96, 48])
@pytest.mark.parametrize("shape", [(2, 2, 1), (3, 2, 1), (2, 2, 2)])
def test_stack_spans_equal_jax_cache_shardings(shape, cache_len, seq_axes):
    """Each stack's span (``ResolvedServeSpec.spans``) is the sequence
    axes the JAX ``cache_shardings`` gives its leaves at B = 1, and the
    combine choice the JAX engine's rule (``_combine_eligible``)."""
    from jax.sharding import PartitionSpec as P
    from repro.serve.engine import (_cache_layout, _combine_eligible,
                                    cache_shardings, resolve_cache_combine)
    from repro.serve.scheduler import _seq_axes_of_spec
    from repro_torch.serve import ServeSpec
    mesh = fake_mesh(shape, ("pod", "data", "model"))
    grid = types.SimpleNamespace(q=shape[0], pl=shape[1], m=shape[2])
    for arch in ARCHS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   n_layers=N_LAYERS)
        specs = cache_shardings(jcfg, mesh, 1, cache_len, seq_axes)
        want = {}
        for j, slot in specs["blocks"].items():
            spec = jcfg.layer_plan()[int(j[4:])]
            names = "k_ring/v_ring" if spec.attn == "window" else "k/v"
            sharded = _seq_axes_of_spec(slot["k"])
            want[names] = None if sharded is None else sharded[1]
        assert isinstance(specs["pos"], P)
        res = ServeSpec(batch=1, cache_len=cache_len, combine="locality",
                        seq_axes=seq_axes).resolve(H._small_cfg(
                            arch, N_LAYERS), grid)
        assert {"/".join(n): s for n, s in res.spans.items()} == want
        choice = resolve_cache_combine(jcfg, mesh, 1, cache_len,
                                       override="locality",
                                       seq_axes=seq_axes)
        if choice.algorithm == "locality" and not _combine_eligible(
                jcfg, mesh, cache_len, _cache_layout(mesh, 1, seq_axes)[1]):
            choice = dataclasses.replace(choice, algorithm="xla")
        assert dataclasses.asdict(res.combine) == dataclasses.asdict(choice)
