"""The port's decode logsumexp combine on spawned gloo ranks (CPU), against
numpy and the JAX package.

One pool of 16 ranks serves the module (``torch_helpers.RankPool``); a grid
of q pods x pl lanes runs on its first q·pl ranks. Each rank holds the
partial softmax stats (o, m, l) of its slice of the cache, fp32, from
``torch_helpers.combine_inputs``: two ranks hold a fully masked slice
(m = NEG_INF, o = l = 0) and rank 0 one masked head.

* ``logsumexp_combine`` eager equals its start/finish halves,
  ``collective("combine")`` with ``finish`` and the ``Collective`` class,
  bitwise, on every rank;
* the result equals the numpy combine, and one JAX subprocess with 16
  forced host devices runs ``repro.core.collectives.logsumexp_combine``
  inside ``shard_map`` on the same inputs: every rank's (o, l) is within
  1e-6 relative of the JAX device's, on (2, 4), (3, 4) and (4, 4), for
  "locality" and "xla";
* per rank, the recorder's non-local messages and bytes of the combine
  equal those of its two parts run alone: the max-allreduce (recursive
  doubling) of m and the sum-allreduce (recursive halving) of the packed
  [o, l].
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_helpers as H

GRIDS = [(2, 4), (3, 4), (4, 4)]
ALGORITHMS = ["locality", "xla"]
SEED = 11
REL = 1e-6

REPO = Path(__file__).resolve().parents[1]

JAX_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
sys.path.insert(0, sys.argv[2])
from torch_helpers import combine_inputs

arrays = {}
for q, pl in json.loads(sys.argv[3]):
    p = q * pl
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:p]).reshape(q, pl),
                             ("pod", "local"))
    spec = P(("pod", "local"))
    o, m, l = combine_inputs(p, int(sys.argv[5]))
    flat = lambda a: jnp.asarray(a.reshape((-1,) + a.shape[2:]))
    for alg in json.loads(sys.argv[4]):
        fn = lambda o_, m_, l_, a=alg: C.logsumexp_combine(
            o_, m_, l_, "pod", "local", algorithm=a)
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                  out_specs=(spec, spec)))
        ot, lt = f(flat(o), flat(m), flat(l))
        arrays[f"o|{q}x{pl}|{alg}"] = np.asarray(ot).reshape(o.shape)
        arrays[f"l|{q}x{pl}|{alg}"] = np.asarray(lt).reshape(l.shape)
np.savez(sys.argv[1] + "/outputs.npz", **arrays)
"""


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX reference, started first so it runs while the ranks start."""
    out = tmp_path_factory.mktemp("jax_combine")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(out / "log.txt", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_REFERENCE, str(out),
             str(REPO / "tests"), json.dumps(GRIDS), json.dumps(ALGORITHMS),
             str(SEED)],
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
    return dict(np.load(out / "outputs.npz"))


@pytest.fixture(scope="module")
def results(pool):
    return {(grid, alg): pool.run(H.task_combine, *grid, alg, SEED)
            for grid in GRIDS for alg in ALGORITHMS}


def _numpy_combine(p: int):
    o, m, l = H.combine_inputs(p, SEED)
    M = m.max(0)
    scale = np.exp(m.astype(np.float64) - M)
    return ((o * scale[..., None]).sum(0), (l * scale).sum(0))


def _rel_close(out, ref, what):
    np.testing.assert_allclose(out, ref, rtol=REL,
                               atol=REL * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_combine_forms_agree_and_match_numpy(results, grid, algorithm):
    p = grid[0] * grid[1]
    res = results[grid, algorithm]
    o_ref, l_ref = _numpy_combine(p)
    for r in range(p):
        assert res[r]["same"], r
        _rel_close(res[r]["o"], o_ref, f"rank {r} o")
        _rel_close(res[r]["l"], l_ref, f"rank {r} l")
    # every rank holds the same total, the masked ranks too
    for r in range(1, p):
        np.testing.assert_array_equal(res[r]["l"], res[0]["l"])


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_combine_matches_jax(results, jax_ref, grid, algorithm):
    q, pl = grid
    res = results[grid, algorithm]
    for r in range(q * pl):
        _rel_close(res[r]["o"], jax_ref[f"o|{q}x{pl}|{algorithm}"][r],
                   f"rank {r} o")
        _rel_close(res[r]["l"], jax_ref[f"l|{q}x{pl}|{algorithm}"][r],
                   f"rank {r} l")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_combine_sends_what_its_two_allreduces_send(results, grid,
                                                    algorithm):
    q, pl = grid
    res = results[grid, algorithm]
    for r in range(q * pl):
        assert res[r]["stats"] == res[r]["parts"], r
    if algorithm == "locality":
        assert max(res[r]["stats"]["permute_edges_nonlocal"]
                   for r in range(q * pl)) > 0
