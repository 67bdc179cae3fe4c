"""Sequence-parallel serving of the port on spawned gloo ranks (CPU), against
the JAX engine on forced host devices.

A reduced llama3.2-3b (2 layers, fp32) with the JAX ``init_params`` tree
(``params_from_jax``) serves three requests, submitted together, with
``ServeSpec(batch=1, cache_len=48)`` on q x pl ranks: ``("pod", "data")``
layouts ("locality" and "xla") on 2 x 2 and 3 x 2 ranks (shards of 12 and
8 slots, every prompt and decode crossing shards), and
``seq_axes=("data",)`` on both (each pod holds the whole cache in 2 shards
of 24). One JAX subprocess with 8 forced
host devices runs ``Engine.generate`` on the same mesh shapes, layouts and
parameters, one request at a time.

* The port's greedy tokens equal the JAX engine's exactly, and its own
  ``"xla"`` and one-rank engines'. On 3 x 2, the JAX locality engine raises
  in this JAX version (a reference fault, ROADMAP.md Queue 3): there the
  port's locality tokens are held against the JAX "xla" engine of the same
  mesh.
* Every rank gives the same tokens, and the requests are served one at a
  time (each starts when the one before has finished).
* The combine's counters: every decode step combines in every layer, and
  the engine's messages and bytes are those of one combine alone times
  its layers, whatever other engines sent on the grid before; a ("data",)
  cache sends nothing across pods.
* Spec errors: batch > 1 on a sequence layout, ``combine="auto"`` there
  (naming ROADMAP item 8), ``migrate="auto"`` on a batch sharded over the
  ranks (item 8) and an unknown migration schedule; the batch-sharded
  engine itself builds (``tests/test_torch_serve_batch.py`` serves it).
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
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.spec import (_cache_layout, _seq_axes_for,
                                    resolve_cache_combine)

REPO = Path(__file__).resolve().parents[1]
CACHE_LEN = 48
# (prompt length, max_new): 5 + 6, 17 + 5 and 30 + 8 tokens of 48 slots
REQUESTS = [(5, 6), (17, 5), (30, 8)]
GRIDS = [(2, 2), (3, 2)]
LAYOUTS = [("pod_loc", dict(combine="locality")),
           ("pod_xla", dict(combine="xla")),
           ("data_loc", dict(combine="locality", seq_axes=("data",)))]
# (grid, port layout) -> the JAX layout it is held against
JAX_OF = {((3, 2), "pod_loc"): "pod_xla"}

JAX_REFERENCE = r"""
import dataclasses, json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import transformer
from repro.serve.engine import Engine
from repro.serve.spec import ServeSpec
warnings.simplefilter("ignore", DeprecationWarning)
cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), n_layers=2,
                          dtype=jnp.float32)
params = transformer.init_params(jax.random.PRNGKey(0), cfg)
prompts = [np.asarray(p, np.int32) for p in json.loads(sys.argv[2])]
budgets = json.loads(sys.argv[3])
out = {}
for q, pl in json.loads(sys.argv[4]):
    mesh = jax.make_mesh((q, pl), ("pod", "data"),
                         devices=jax.devices()[:q * pl],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for name, kw in json.loads(sys.argv[5]):
        if (q, pl, name) == (3, 2, "pod_loc"):
            continue                   # raises in this JAX (ROADMAP Queue 3)
        if "seq_axes" in kw:
            kw["seq_axes"] = tuple(kw["seq_axes"])
        with jax.set_mesh(mesh):
            eng = Engine(cfg, mesh, params,
                         ServeSpec(batch=1, cache_len=int(sys.argv[6]), **kw))
            out[f"{q}x{pl}|{name}"] = [
                eng.generate(p[None], m)[0].tolist()
                for p, m in zip(prompts, budgets)]
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
"""


def _cfgs():
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"), n_layers=2,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"), n_layers=2,
                               dtype=torch.float32)
    return jcfg, tcfg


def _requests(vocab: int):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, n).astype(np.int32), m)
            for n, m in REQUESTS]


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    out = tmp_path_factory.mktemp("jax_serve_seq") / "tokens.json"
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    log = out.with_name("log.txt")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(out),
             json.dumps([t.tolist() for t, _ in reqs]),
             json.dumps([m for _, m in reqs]), json.dumps(GRIDS),
             json.dumps(LAYOUTS), str(CACHE_LEN)],
            env=env, stdout=fh, stderr=subprocess.STDOUT)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(6)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs()
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg).items()}


@pytest.fixture(scope="module")
def served(pool, params):
    """{grid: per-rank results of every layout} and the one-rank engine's."""
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size)
    out = {grid: pool.run(H.task_serve_seq, *grid, params, 2, CACHE_LEN,
                          reqs, LAYOUTS) for grid in GRIDS}
    out["one"] = pool.run(H.task_serve_seq, 1, 1, params, 2, CACHE_LEN, reqs,
                          [("one", {})])[0]["one"]
    return out


@pytest.fixture(scope="module")
def jax_tokens(jax_proc):
    proc, out, log = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, log.read_text()[-4000:]
    return json.loads(out.read_text())


def _tokens(res: dict) -> list[list[int]]:
    return [res["tokens"][rid] for rid in sorted(res["tokens"])]


@pytest.mark.parametrize("layout", [name for name, _ in LAYOUTS])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_tokens_match_the_jax_engine_and_one_rank(served, jax_tokens, grid,
                                                  layout):
    q, pl = grid
    ref = jax_tokens[f"{q}x{pl}|{JAX_OF.get((grid, layout), layout)}"]
    res = served[grid][0][layout]
    assert _tokens(res) == ref
    assert _tokens(res) == _tokens(served["one"])
    assert _tokens(res) == _tokens(served[grid][0]["pod_xla"])
    assert [len(t) for t in ref] == [m for _, m in REQUESTS]


@pytest.mark.parametrize("layout", [name for name, _ in LAYOUTS])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_rank_serves_alike_one_request_at_a_time(served, grid, layout):
    q, pl = grid
    ranks = [served[grid][r][layout] for r in range(q * pl)]
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"]
        assert r["started"] == ranks[0]["started"]
    # a StepClock: a prefill and each decode step advance it by 1, so a
    # request starts 1 after the previous one's last decode step
    started = [ranks[0]["started"][rid] for rid in sorted(ranks[0]["started"])]
    for i in range(1, len(started)):
        assert started[i] == started[i - 1] + REQUESTS[i - 1][1] - 1 + 1
    # the shards tile the cache: pod-major over ("pod", "data"), per pod
    # over ("data",)
    n = q * pl if layout != "data_loc" else pl
    L_loc = CACHE_LEN // n
    for rank, r in enumerate(ranks):
        shard = rank if layout != "data_loc" else rank % pl
        assert (r["cache_len"], r["cache_offset"]) == (L_loc, shard * L_loc)
        assert r["combine"]["p"] == n


@pytest.mark.parametrize("layout", [name for name, _ in LAYOUTS])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_combine_counters(served, grid, layout):
    q, pl = grid
    decode_steps = sum(m - 1 for _, m in REQUESTS)
    for r in range(q * pl):
        st = served[grid][r][layout]["stats"]
        assert st["decode_steps"] == st["combine_steps"] == decode_steps
        assert st["combine_layers"] == 2 * decode_steps
        assert st["staging_bytes"] == 0          # CPU tensors, gloo grid
        # every layer's combine sent what one combine sends alone, and the
        # engines built before it on the same grid do not count
        one = served[grid][r][layout]["one_combine"]
        n = st["combine_layers"]
        assert st["nonlocal_msgs"] == n * (one["permute_edges_nonlocal"]
                                           + one["group_msgs_nonlocal"])
        # the ring model's bytes are fractions (b / n), summed in another
        # order
        assert st["nonlocal_bytes"] == pytest.approx(
            n * (one["permute_bytes_nonlocal"] + one["group_bytes_nonlocal"]))
        assert st["combine_bytes"] == pytest.approx(n * sum(
            one[k] for k in ("permute_bytes_local", "permute_bytes_nonlocal",
                             "group_bytes_local", "group_bytes_nonlocal")))
        assert st["combine_bytes"] > 0
        if layout == "data_loc":
            assert st["nonlocal_msgs"] == st["nonlocal_bytes"] == 0
    assert max(served[grid][r][layout]["stats"]["nonlocal_msgs"]
               for r in range(q * pl)) > (0 if layout != "data_loc" else -1)
    one = served["one"]["stats"]
    assert one["combine_steps"] == one["combine_layers"] == 0


def test_spec_errors_on_a_sequence_layout(pool):
    res = pool.run(H.task_spec_errors, 2, 2)
    for r in range(4):
        err = res[r]
        assert err["batch"][0] == "ValueError"
        assert "batch must be 1" in err["batch"][1]
        assert err["auto"][0] == "NotImplementedError"
        assert "item 8" in err["auto"][1]
        # a batch sharded over the ranks now builds (item 3 is done); its
        # migration schedule must be named, "auto" waits for item 8
        assert err["batch_sharded"] is None
        assert err["migrate_auto"][0] == "NotImplementedError"
        assert "item 8" in err["migrate_auto"][1]
        assert err["migrate_unknown"][0] == "ValueError"
        assert "ring" in err["migrate_unknown"][1]


@pytest.mark.parametrize("L,seq_axes,want", [
    (32, "auto", ("pod", "data")), (12, "auto", ("data",)), (10, "auto", None),
    (32, ("data",), ("data",)), (32, "data", ("data",)), (6, ("data",), None)])
def test_seq_axes_resolution(L, seq_axes, want):
    """The JAX ``_seq_axes_for`` rules on a 2 x 4 grid
    (tests/test_multipod.py::test_seq_axes_resolution)."""
    grid = types.SimpleNamespace(q=2, pl=4)
    batch_sharded, cand = _cache_layout(grid, 1, seq_axes)
    assert not batch_sharded
    assert _seq_axes_for(grid, L, cand) == want
    assert _cache_layout(grid, 8, seq_axes)[0]


def test_combine_choice_geometry():
    _, tcfg = _cfgs()
    grid = types.SimpleNamespace(q=2, pl=2)
    pod = resolve_cache_combine(tcfg, grid, 1, 48, "locality")
    assert (pod.algorithm, pod.p, pod.p_local) == ("locality", 4, 2)
    assert pod.nbytes == tcfg.n_heads * (tcfg.head_dim_ + 1) * 4
    data = resolve_cache_combine(tcfg, grid, 1, 48, "xla",
                                 seq_axes=("data",))
    assert (data.algorithm, data.p, data.p_local) == ("xla", 2, 2)
    for g, batch in ((None, 1), (grid, 4)):        # one rank; batch-sharded
        assert resolve_cache_combine(tcfg, g, batch, 48).algorithm == "none"
    with pytest.raises(ValueError, match="override"):
        resolve_cache_combine(tcfg, grid, 1, 48, "ring")
