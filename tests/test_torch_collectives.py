"""The port's collectives on 16 spawned gloo ranks (CPU), against numpy, the
paper's counts, and the JAX package.

One pool of 16 ranks serves the module (``torch_helpers.RankPool``); a grid
of q pods x pl lanes runs on its first q·pl ranks. Inputs are
integer-valued, so fp32 and bf16 sums are exact in any order and every
comparison is exact:

* every algorithm's gather, reduce-scatter, allreduce and cache migration
  equal the numpy truth on every grid, and start/finish equals eager;
* per rank, the recorder's non-local messages and bytes equal the schedule
  oracle's (``schedules.per_rank_stats``), and their maxima the paper's
  Eq. 3 (Bruck: ceil(log2 p)) and Eq. 4 (locality: ceil(log_pl q));
* the all-to-all (``locality`` and ``xla``) equals the numpy permutation,
  start/finish and the ``collective`` entry point equal eager, its
  gradient is the exchange of the cotangent, and each rank's non-local
  messages and bytes equal the oracle ``schedules.locality_all_to_all``
  (``xla_all_to_all`` for the library's);
* on (4, 4) and (3, 4), one JAX subprocess with 16 forced host devices runs
  ``repro.core.collectives`` on the same inputs: each rank's output equals
  the JAX device's, and the recorder's local and non-local edge, message
  and byte counts, summed over the ranks, equal ``collective_stats`` of the
  compiled HLO. That includes the serve scheduler's migration over a
  ("data",) donor span, ``cache_migrate(x, ("data",), ())``, which the JAX
  function runs as ``bruck`` for an empty local tier: the port runs
  ``cache_migrate`` on each pod's own grid (``RankGrid.pod_grid``). The
  ring's rounds are one ``lax.scan`` body, which the HLO
  counts once, so for the ring the port counts p-1 times the HLO.
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
from repro_torch.core.topology import RegionMap, ceil_log

GRIDS = [(4, 4), (2, 4), (3, 4), (5, 2), (6, 2)]
JAX_GRIDS = [(4, 4), (3, 4)]
ALGS = ["bruck", "ring", "hierarchical", "multilane", "locality_bruck", "xla"]
ALLREDUCES = [("locality", "rhd"), ("locality", "rd"), ("locality", "psum"),
              ("xla", "rhd")]
SHARD = (2, 3)
A2A_ALGS = ["locality", "xla"]
A2A_GRIDS = [(2, 4), (3, 2), (3, 4), (4, 4), (5, 2), (1, 4), (4, 1)]

REPO = Path(__file__).resolve().parents[1]

JAX_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
from repro.core.hlo_analysis import collective_stats
from repro.core.topology import device_pod_map
sys.path.insert(0, sys.argv[2])
from torch_helpers import ints

programs = json.loads(sys.argv[3])
arrays, stats = {}, {}
for q, pl in json.loads(sys.argv[4]):
    p = q * pl
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:p]).reshape(q, pl),
                             ("pod", "local"))
    pods = device_pod_map(mesh, ("pod",))
    spec = P(("pod", "local"))
    inputs = {"allgather": ints(0, (p, 2, 3)),
              "reduce_scatter": ints(1, (p, p * 2, 3)),
              "allreduce": ints(2, (p, 5, 3)),
              "cache_migrate_pod": ints(3, (p, 2, 3)),
              "all_to_all": ints(8, (p, p * 2, 3))}
    for kind, alg, outer, op in programs:
        if kind == "all_to_all":
            fn = lambda s, a=alg: C.all_to_all(s, "pod", "local",
                                               algorithm=a)
        elif kind == "allgather":
            fn = lambda s, a=alg: C.allgather(s, "pod", "local", algorithm=a,
                                              tiled=True)
        elif kind == "reduce_scatter":
            fn = lambda s, a=alg: C.reduce_scatter(s, "pod", "local",
                                                   algorithm=a)
        elif kind == "allreduce":
            fn = lambda s, a=alg, o=outer, r=op: C.allreduce(
                s, "pod", "local", algorithm=a, outer_algorithm=o, op=r)
        if kind == "cache_migrate_pod":
            # the serve scheduler's call on a ("data",) donor span: the pods
            # replicate the slab, each gathers its pod's shards, local=()
            x = inputs[kind][:pl]
            f = jax.jit(jax.shard_map(
                lambda s, a=alg: C.cache_migrate(s, "local", (), algorithm=a,
                                                 tiled=True),
                mesh=mesh, in_specs=P("local"), out_specs=P(),
                check_vma=False))
        else:
            x = inputs[kind]
            f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                      out_specs=spec))
        xg = jnp.asarray(x.reshape((-1,) + x.shape[2:]))
        out = np.asarray(f(xg))
        key = f"{kind}|{q}x{pl}|{alg}|{outer}|{op}"
        if kind == "cache_migrate_pod":       # every device holds all of it
            arrays[key] = np.broadcast_to(out, (p,) + out.shape)
        else:
            arrays[key] = out.reshape((p, -1) + out.shape[1:])
        st = collective_stats(f.lower(xg).compile().as_text(), pods)
        stats[key] = {k: getattr(st, k) for k in (
            "permute_edges_local", "permute_edges_nonlocal",
            "permute_bytes_local", "permute_bytes_nonlocal",
            "group_msgs_local", "group_msgs_nonlocal",
            "group_bytes_local", "group_bytes_nonlocal")}
np.savez(sys.argv[1] + "/outputs.npz", **arrays)
with open(sys.argv[1] + "/stats.json", "w") as fh:
    json.dump(stats, fh)
"""

JAX_PROGRAMS = ([("allgather", a, "-", "-") for a in ALGS]
                + [("reduce_scatter", a, "-", "-") for a in ALGS]
                + [("allreduce", a, o, op) for a, o in ALLREDUCES
                   for op in ("sum", "max", "min")
                   if op == "sum" or o == "rhd"]
                + [("cache_migrate_pod", a, "-", "-")
                   for a in ("locality_bruck", "multilane", "xla")]
                + [("all_to_all", a, "-", "-") for a in A2A_ALGS])


def _key(kind, q, pl, alg, outer, op):
    return f"{kind}|{q}x{pl}|{alg}|{outer}|{op}"


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    out = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(out / "log.txt", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(out),
             str(REPO / "tests"), json.dumps(JAX_PROGRAMS),
             json.dumps(JAX_GRIDS)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def pool(jax_proc):
    p = H.RankPool(H.WORLD)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, out = jax_proc
    rc = proc.wait(timeout=600)
    assert rc == 0, (out / "log.txt").read_text()[-4000:]
    return (dict(np.load(out / "outputs.npz")),
            json.loads((out / "stats.json").read_text()))


def _sum_stats(res, p) -> dict:
    return {k: sum(res[r]["stats"][k] for r in range(p))
            for k in res[0]["stats"]}


# ---------------------------------------------------------------------------
# against the numpy truth, every grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("algorithm", ALGS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_allgather_every_algorithm(pool, grid, algorithm, dtype):
    q, pl = grid
    p = q * pl
    x = H.ints(0, (p,) + SHARD)
    res = pool.run(H.task_allgather, q, pl, algorithm, dtype, SHARD, 0)
    for r in range(p):
        np.testing.assert_array_equal(res[r]["tiled"], x.reshape(p * 2, 3))
        np.testing.assert_array_equal(res[r]["stacked"], x)
        assert res[r]["split_equal"], f"rank {r}: start/finish != eager"
    assert all(v is None for v in res[p:])


@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("algorithm", ALGS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_reduce_scatter_every_algorithm(pool, grid, algorithm, dtype):
    q, pl = grid
    p = q * pl
    y = H.ints(1, (p, p * 2, 3))
    truth = y.sum(0).reshape((p,) + SHARD)
    res = pool.run(H.task_reduce_scatter, q, pl, algorithm, dtype, SHARD, 1)
    for r in range(p):
        np.testing.assert_array_equal(res[r]["out"], truth[r])


@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_allreduce_every_structure(pool, grid, op, dtype):
    q, pl = grid
    p = q * pl
    z = H.ints(2, (p, 5, 3))
    truth = {"sum": z.sum(0), "max": z.max(0), "min": z.min(0)}[op]
    for algorithm, outer in ALLREDUCES:
        res = pool.run(H.task_allreduce, q, pl, algorithm, outer, op, dtype,
                       (5, 3), 2)
        for r in range(p):
            np.testing.assert_array_equal(res[r]["out"], truth,
                                          err_msg=f"{algorithm}/{outer}")
            assert res[r]["split_equal"]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cache_migrate_every_algorithm(pool, grid):
    q, pl = grid
    p = q * pl
    x = H.ints(3, (p, 3, 2))
    res = pool.run(H.task_cache_migrate, q, pl, "bfloat16", 3)
    for r in range(p):
        assert sorted(res[r]) == ["locality_bruck", "multilane", "xla"]
        for alg, out in res[r].items():
            np.testing.assert_array_equal(out, x.reshape(p * 3, 2),
                                          err_msg=alg)


@pytest.mark.parametrize("algorithm", ["bruck", "locality_bruck", "xla"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_allgather_gradient_is_the_reduce_scatter(pool, grid, algorithm):
    """d/dx sum(allgather(x)²) = 2·p·x (tests/test_distributed.py:46-51)."""
    q, pl = grid
    p = q * pl
    res = pool.run(H.task_grad, q, pl, algorithm, 4)
    for r in range(p):
        np.testing.assert_array_equal(res[r]["grad"], 2 * p * res[r]["x"])


@pytest.mark.parametrize("algorithm", ["bruck", "locality_bruck", "xla"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_split_gather_gradient_is_the_reduce_scatter(pool, grid,
                                                     algorithm):
    """finish(start(x)) with a gradient: forward bitwise the eager gather,
    backward bitwise its reduce-scatter (the gradient of sum(w * gather(x))
    is rank i's tile of w summed over the ranks), the same messages both
    ways; a staged pair (``stage=True``, a no-op move on the CPU) is the
    same gather; the ring has no gradient and is refused."""
    q, pl = grid
    p = q * pl
    res = pool.run(H.task_split_grad, q, pl, algorithm, 6)
    w = H.ints(7, (p * 2, 3))
    for r in range(p):
        assert res[r]["forward_equal"] and res[r]["stats_equal"]
        assert res[r]["staged_equal"]
        np.testing.assert_array_equal(res[r]["split_grad"], res[r]["grad"])
        np.testing.assert_array_equal(res[r]["grad"],
                                      p * w[2 * r:2 * r + 2])
        assert "differentiable" in res[r]["ring_error"]


@pytest.mark.parametrize("grid", [(4, 4), (3, 4), (6, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_collective_vocabulary_and_unported_kinds(pool, grid):
    q, pl = grid
    res = pool.run(H.task_vocabulary, q, pl, 5)
    for r in range(q * pl):
        assert all(res[r]["same"].values()), res[r]["same"]
        err = res[r]["errors"]
        # the combine kind runs (held against the JAX package in
        # tests/test_torch_combine.py), and so does all_to_all (equal to
        # the eager exchange above); every "auto" still raises
        assert err["a2a_indivisible"][0] == "ValueError", err
        for name in ("auto", "auto_default_migrate", "auto_allreduce",
                     "auto_combine", "auto_all_to_all"):
            assert err[name][0] == "NotImplementedError"
            assert "tuning slice" in err[name][1]
        assert err["rs_start"][0] == "NotImplementedError"
        for name in ("unknown_kind", "unknown_alg", "grad_ring",
                     "meta_tensor"):
            assert err[name][0] == "ValueError", (name, err[name])
        assert "gloo" in err["meta_tensor"][1]


@pytest.mark.parametrize("dtype", H.DTYPES)
@pytest.mark.parametrize("algorithm", A2A_ALGS)
@pytest.mark.parametrize("grid", A2A_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_all_to_all_every_algorithm(pool, grid, algorithm, dtype):
    """Block j of rank i's input is block i of rank j's output, eager,
    split and through ``collective``; the gradient of sum(w ·
    all_to_all(x)) is the exchange of w, the same for the split pair; each
    rank's non-local messages and bytes are the oracle's."""
    q, pl = grid
    p = q * pl
    x = H.ints(8, (p, p, 2, 3))
    w = H.ints(9, (p, p, 2, 3))
    truth = x.transpose(1, 0, 2, 3).reshape(p, p * 2, 3)
    grad = w.transpose(1, 0, 2, 3).reshape(p, p * 2, 3)
    res = pool.run(H.task_all_to_all, q, pl, algorithm, dtype, 8)
    oracle = TS.ALL_TO_ALL_SCHEDULES[algorithm](p, pl).per_rank_stats(
        RegionMap(p, pl))
    block = 2 * 3 * (4 if dtype == "float32" else 2)
    for r in range(p):
        np.testing.assert_array_equal(res[r]["out"], truth[r])
        assert res[r]["split_equal"] and res[r]["entry_equal"]
        assert res[r]["split_stats_equal"]
        np.testing.assert_array_equal(res[r]["grad"], grad[r])
        np.testing.assert_array_equal(res[r]["split_grad"], grad[r])
        st = res[r]["stats"]
        _, _, n_nl, s_nl = oracle[r]
        assert (st["permute_edges_nonlocal"] + st["group_msgs_nonlocal"],
                st["permute_bytes_nonlocal"] + st["group_bytes_nonlocal"]) \
            == (n_nl, s_nl * block), f"rank {r}"
    if algorithm == "locality" and q > 1:
        # one aggregated message a pod for each other pod: q - 1 a pod,
        # against the flat exchange's pl²(q - 1)
        assert sum(oracle[r][2] for r in range(p)) == q * (q - 1)


# ---------------------------------------------------------------------------
# against the schedule oracle and the paper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algorithm",
                         ["bruck", "ring", "multilane", "locality_bruck"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_nonlocal_counts_match_oracle_and_paper(pool, grid, algorithm):
    q, pl = grid
    p = q * pl
    region = RegionMap(p, pl)
    oracle = TS.ALGORITHMS[algorithm](p, pl).per_rank_stats(region)
    res = pool.run(H.task_paper_counts, q, pl, algorithm)
    block = 3 * 4                        # a (3,) fp32 shard
    for r in range(p):
        _, _, n_nl, s_nl = oracle[r]
        assert (res[r]["nonlocal_msgs"], res[r]["nonlocal_bytes"]) == \
            (n_nl, s_nl * block), f"rank {r}"
    worst = max(res[r]["nonlocal_msgs"] for r in range(p))
    if algorithm == "locality_bruck":
        assert worst == ceil_log(pl, q)            # paper Eq. 4
    if algorithm == "bruck":
        assert worst == ceil_log(2, p)             # paper Eq. 3


# ---------------------------------------------------------------------------
# against the JAX package (outputs and HLO collective stats)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("program", JAX_PROGRAMS,
                         ids=lambda t: "-".join(v for v in t if v != "-"))
@pytest.mark.parametrize("grid", JAX_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_outputs_and_records_equal_jax(pool, jax_ref, grid, program):
    arrays, stats = jax_ref
    q, pl = grid
    p = q * pl
    kind, alg, outer, op = program
    if kind == "allgather":
        res = pool.run(H.task_allgather, q, pl, alg, "float32", SHARD, 0)
        outs = [res[r]["tiled"] for r in range(p)]
    elif kind == "reduce_scatter":
        res = pool.run(H.task_reduce_scatter, q, pl, alg, "float32", SHARD,
                       1)
        outs = [res[r]["out"] for r in range(p)]
    elif kind == "allreduce":
        res = pool.run(H.task_allreduce, q, pl, alg, outer, op, "float32",
                       (5, 3), 2)
        outs = [res[r]["out"] for r in range(p)]
    elif kind == "all_to_all":
        res = pool.run(H.task_all_to_all, q, pl, alg, "float32", 8)
        outs = [res[r]["out"] for r in range(p)]
    else:
        res = pool.run(H.task_cache_migrate_pod, q, pl, alg, SHARD, 3)
        outs = [res[r]["out"] for r in range(p)]
    key = _key(kind, q, pl, alg, outer, op)
    for r in range(p):
        np.testing.assert_array_equal(outs[r], arrays[key][r],
                                      err_msg=f"rank {r}")
    want = stats[key]
    if alg == "ring":                  # the HLO counts the scan body once
        want = {k: v * (p - 1) for k, v in want.items()}
    assert _sum_stats(res, p) == want
    nonlocal_msgs = (want["permute_edges_nonlocal"]
                     + want["group_msgs_nonlocal"])
    if kind == "cache_migrate_pod":       # every message stays in its pod
        assert nonlocal_msgs == 0
        assert want["permute_edges_local"] + want["group_msgs_local"] > 0
    else:
        assert nonlocal_msgs > 0
