"""The port's framework-free core against the JAX package's, on the CPU, and
the DMA allgather's plain version: every comparison exact.

* every generator of ``schedules.ALGORITHMS`` and ``ALL_TO_ALL_SCHEDULES``
  gives the same rounds, sends, phases and buffers (grids of
  ``tests/test_schedules.py``);
* every model of ``cost_model`` gives the same floats on every machine of
  ``MACHINES``, and ``autotune`` the same picks (``tests/test_cost_model.py``);
* ``compile_schedule`` / ``locality_bruck_raw`` give the same table, sizes,
  perm and capacity (``tests/test_dma_schedule.py``), and the port's check
  that no round writes what it reads holds on all of them;
* the DMA allgather's plain version equals the shards broadcast to every
  rank, and its origin ids equal ``execute_table`` of the JAX package.
"""
import dataclasses

import jax  # noqa: F401  (tests import both frameworks; the port never does)
import numpy as np
import pytest
import torch

from repro.core import autotune as JAT
from repro.core import cost_model as JCM
from repro.core import schedules as JS
from repro.core.topology import RegionMap as JRegionMap
from repro.kernels.dma_allgather import schedule_compile as JSC
from repro_torch.core import autotune as TAT
from repro_torch.core import cost_model as TCM
from repro_torch.core import schedules as TS
from repro_torch.core import topology as TT
from repro_torch.kernels.dma_allgather import ops as dma_ops
from repro_torch.kernels.dma_allgather import schedule_compile as TSC

# (p, p_local): test_schedules.py's region cases (pl in {2,4,8,16} x 1..5
# regions), its Eq. 4 cases (r = pl^k, p <= 256: the generators are O(p²))
# and its non-power list
GRIDS = sorted({(pl * k, pl) for pl in (2, 4, 8, 16) for k in range(1, 6)}
               | {(pl ** (k + 1), pl) for pl, k in
                  [(2, 1), (2, 2), (2, 3), (4, 1), (4, 2), (8, 1),
                   (16, 1)]}
               | {(q * pl, pl) for q, pl in
                  [(3, 2), (3, 4), (5, 2), (5, 3), (5, 4), (6, 2), (6, 4),
                   (10, 4), (7, 3)]})
ALGS = ["bruck", "ring", "hierarchical", "multilane", "locality_bruck"]
BLOCKS = [4.0, 1000.0, 8192.0, 65536.0, float(1 << 20)]


def _sched_tuple(s):
    region = None if s.region is None else (s.region.p, s.region.p_local)
    rounds = [(r.phase, [(x.src, x.dst, x.blocks) for x in r.sends])
              for r in s.rounds]
    return s.p, s.algorithm, region, rounds, s.buffers


def _ids(g):
    return f"p{g[0]}-pl{g[1]}"


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_allgather_schedules_equal_jax(grid):
    p, pl = grid
    for alg in ALGS:
        assert _sched_tuple(TS.ALGORITHMS[alg](p, pl)) == \
            _sched_tuple(JS.ALGORITHMS[alg](p, pl)), alg
    for alg in ("bruck", "ring"):              # flat: no region map
        assert _sched_tuple(TS.ALGORITHMS[alg](p)) == \
            _sched_tuple(JS.ALGORITHMS[alg](p)), alg
    loc = TS.ALGORITHMS["locality_bruck"](p, pl)
    loc.validate()
    region = TT.RegionMap(p, pl)
    assert loc.per_rank_stats(region) == \
        JS.ALGORITHMS["locality_bruck"](p, pl).per_rank_stats(
            JRegionMap(p, pl))
    assert loc.max_nonlocal_msgs(region) == TT.ceil_log(pl, p // pl)


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] <= 64], ids=_ids)
def test_all_to_all_schedules_equal_jax(grid):
    p, pl = grid
    for alg in TS.ALL_TO_ALL_SCHEDULES:
        ts = TS.ALL_TO_ALL_SCHEDULES[alg](p, pl)
        TS.validate_all_to_all(ts)
        assert _sched_tuple(ts) == \
            _sched_tuple(JS.ALL_TO_ALL_SCHEDULES[alg](p, pl)), alg
    assert tuple(TS.ALL_TO_ALL_SCHEDULES) == tuple(JS.ALL_TO_ALL_SCHEDULES)


def test_topology_helpers_equal_jax():
    from repro.core import topology as JT
    for n in range(0, 70):
        assert TT.rd_rounds(n) == JT.rd_rounds(n)
        for base in (2, 3, 4, 8):
            assert TT.ceil_log(base, n) == JT.ceil_log(base, n)
            assert TT.is_power_of(base, n) == JT.is_power_of(base, n)
    with pytest.raises(ValueError):
        TT.RegionMap(10, 4)


# ---------------------------------------------------------------------------
# cost models and autotune
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("machine", sorted(JCM.MACHINES))
def test_cost_models_equal_jax(machine):
    assert sorted(TCM.MACHINES) == sorted(JCM.MACHINES)
    assert tuple(TCM.MODELS) == tuple(JCM.MODELS)
    tm, jm = TCM.MACHINES[machine], JCM.MACHINES[machine]
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for p, pl in GRIDS:
        for bb in BLOCKS:
            for name in TCM.MODELS:
                assert TCM.MODELS[name](p, pl, bb, tm) == \
                    JCM.MODELS[name](p, pl, bb, jm), (name, p, pl, bb)
            for alg in ("locality_bruck", "multilane", "xla"):
                assert TCM.cache_migrate_model(alg, p, pl, bb, machine) == \
                    JCM.cache_migrate_model(alg, p, pl, bb, machine)
            for alg in ("locality", "xla"):
                assert TCM.all_to_all_model(alg, p, pl, bb, machine) == \
                    JCM.all_to_all_model(alg, p, pl, bb, machine)
            for st in ("locality", "flat"):
                assert TCM.max_allreduce_model(p, pl, bb, tm, structure=st) \
                    == JCM.max_allreduce_model(p, pl, bb, jm, structure=st)
            assert TCM.locality_bruck_phase_split(p, pl, bb, tm) == \
                JCM.locality_bruck_phase_split(p, pl, bb, jm)
            t = TCM.overlap_model(p, pl, bb, 1e9, tm, peak_flops=1e12)
            j = JCM.overlap_model(p, pl, bb, 1e9, jm, peak_flops=1e12)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.exposed_prefetch, t.hidden) == (j.exposed_prefetch,
                                                      j.hidden)
            q = p // pl
            assert TCM.checkpoint_replication_model(q, bb, machine) == \
                JCM.checkpoint_replication_model(q, bb, machine)
            assert TCM.choose_replication(q, bb, machine, budget_s=1e-4) \
                == JCM.choose_replication(q, bb, machine, budget_s=1e-4)


@pytest.mark.parametrize("machine", sorted(JCM.MACHINES))
def test_schedule_cost_equal_jax(machine):
    tm, jm = TCM.MACHINES[machine], JCM.MACHINES[machine]
    for p, pl in [g for g in GRIDS if g[0] <= 64]:
        for alg in ALGS:
            ts, js = TS.ALGORITHMS[alg](p, pl), JS.ALGORITHMS[alg](p, pl)
            for mode in ("postal", "round"):
                for bb in (4.0, 65536.0):
                    assert TCM.schedule_cost(ts, tm, bb, mode=mode) == \
                        JCM.schedule_cost(js, jm, bb, mode=mode), \
                        (alg, p, pl, mode)


@pytest.mark.parametrize("machine", sorted(JCM.MACHINES))
def test_autotune_picks_equal_jax(machine):
    for p, pl in GRIDS:
        for nbytes in (4.0, 256.0, 8192.0, 1 << 16, 1 << 22):
            assert TAT.pick_allgather(p, pl, nbytes, machine) == \
                JAT.pick_allgather(p, pl, nbytes, machine, use_table=False)
            assert TAT.model_costs(p, pl, nbytes, machine) == \
                JAT.model_costs(p, pl, nbytes, machine)


# ---------------------------------------------------------------------------
# DMA tables
# ---------------------------------------------------------------------------
# test_dma_schedule.py's grids: p = pl·pl·k, its power-of-pl cases and its
# non-power region counts, plus the chip smoke's (p, pl)
DMA_GRIDS = sorted({(pl * pl * k, pl) for pl in (2, 4, 8) for k in (1, 2, 3, 5)}
                   | {(pl ** (k + 1), pl) for pl, k in
                      [(2, 1), (2, 2), (2, 3), (4, 1), (4, 2), (8, 1),
                       (16, 1)]}
                   | {(24, 4), (40, 4), (48, 8), (12, 2), (12, 4), (64, 8),
                      (10, 2), (15, 3)})


def _dma_equal(t, j):
    assert t.p == j.p and t.capacity == j.capacity and t.sizes == j.sizes
    np.testing.assert_array_equal(t.table, j.table)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert t.table.dtype == j.table.dtype == np.int32


@pytest.mark.parametrize("grid", DMA_GRIDS, ids=_ids)
def test_dma_tables_equal_jax(grid):
    p, pl = grid
    t = TSC.compile_schedule(TSC.locality_bruck_raw(p, pl))
    j = JSC.compile_schedule(JSC.locality_bruck_raw(p, pl))
    _dma_equal(t, j)
    assert _sched_tuple(TSC.locality_bruck_raw(p, pl)) == \
        _sched_tuple(JSC.locality_bruck_raw(p, pl))
    assert t.nonlocal_stats(TT.RegionMap(p, pl)) == \
        j.nonlocal_stats(JRegionMap(p, pl))
    assert (TSC.execute_table(t) == np.arange(p)[None]).all()
    for alg in ("bruck", "ring", "multilane"):
        if alg == "ring" and p > 128:
            continue                  # O(p³) in the slice search
        _dma_equal(TSC.compile_schedule(TS.ALGORITHMS[alg](p, pl)),
                   JSC.compile_schedule(JS.ALGORITHMS[alg](p, pl)))


def test_dma_compile_refuses_a_round_that_reads_what_it_writes():
    row = np.zeros((2, 5), np.int32)
    row[0] = (1, 0, 1, 1, 0)          # rank 0 writes blocks [1, 3) of rank 1
    row[1] = (0, 2, 5, 1, 1)          # rank 1 reads its blocks [2, 4)
    with pytest.raises(ValueError, match="reads"):
        TSC.check_no_overlap(row, 2, 0)
    row[1, 1] = 3                     # reads [3, 5): disjoint
    TSC.check_no_overlap(row, 2, 0)


def test_dma_build_schedule_rejects_hierarchical():
    with pytest.raises(NotImplementedError):
        dma_ops.build_schedule("hierarchical", 16, 4)


# ---------------------------------------------------------------------------
# the DMA allgather's plain version (the CPU path of the op)
# ---------------------------------------------------------------------------
DMA_CASES = [  # (q, pl, shard, dtype): fp32 and bf16, odd byte widths
    (4, 4, (2, 3), torch.float32),
    (4, 4, (5,), torch.bfloat16),          # 10-byte blocks
    (3, 4, (3,), torch.bfloat16),          # 6-byte blocks, non-power q
    (3, 4, (2, 7), torch.float32),
    (8, 8, (4,), torch.float32),
    (6, 2, (1,), torch.bfloat16),          # 2-byte blocks
    (5, 3, (3, 3), torch.float32),
]


@pytest.mark.parametrize("algorithm",
                         ["bruck", "ring", "multilane", "locality_bruck"])
@pytest.mark.parametrize("case", DMA_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}-{c[3]}")
def test_dma_plain_version_broadcasts_every_shard(case, algorithm):
    q, pl, shard, dtype = case
    p = q * pl
    rng = np.random.default_rng(p)
    xs = rng.standard_normal((p,) + shard).astype(np.float32)
    x = torch.from_numpy(xs).to(dtype)
    before = dma_ops.LAUNCHES
    out = dma_ops.dma_locality_allgather(x, q, pl, algorithm=algorithm)
    assert dma_ops.LAUNCHES == before            # the CPU path counts none
    assert out.dtype == dtype and out.shape == (p, p) + shard
    want = np.broadcast_to(x.float().numpy()[None], (p, p) + shard)
    np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("algorithm",
                         ["bruck", "ring", "multilane", "locality_bruck"])
@pytest.mark.parametrize("grid", [(16, 4), (12, 4), (64, 8), (12, 2),
                                  (15, 3), (10, 2)], ids=_ids)
def test_dma_plain_origins_equal_jax_execute_table(grid, algorithm):
    p, pl = grid
    t = dma_ops.build_schedule(algorithm, p,
                               None if algorithm in ("bruck", "ring") else pl)
    if algorithm == "locality_bruck":
        j = JSC.compile_schedule(JSC.locality_bruck_raw(p, pl))
    else:
        j = JSC.compile_schedule(
            JS.ALGORITHMS[algorithm](p, pl) if algorithm == "multilane"
            else JS.ALGORITHMS[algorithm](p))
    origins = dma_ops.dma_allgather(torch.arange(p), t)
    np.testing.assert_array_equal(origins.numpy(), JSC.execute_table(j))


def _raw_messages(t):
    """Per round, {sending rank: origins of its raw slice}, by executing
    the unfolded table's appends."""
    bufs = [[i] for i in range(t.p)]
    out = []
    for r, size in enumerate(t.sizes):
        sent = {i: tuple(bufs[i][t.table[i, r, 1]:t.table[i, r, 1] + size])
                for i in range(t.p) if t.table[i, r, 3]}
        for i, blocks in sent.items():
            tgt, roff = int(t.table[i, r, 0]), int(t.table[i, r, 2])
            assert len(bufs[tgt]) == roff
            bufs[tgt].extend(blocks)
        out.append(sent)
    return out, bufs


def _jax_table(algorithm, p, pl):
    if algorithm == "locality_bruck":
        return JSC.compile_schedule(JSC.locality_bruck_raw(p, pl))
    if algorithm == "multilane":
        return JSC.compile_schedule(JS.ALGORITHMS[algorithm](p, pl))
    return JSC.compile_schedule(JS.ALGORITHMS[algorithm](p))


@pytest.mark.parametrize("algorithm",
                         ["bruck", "ring", "multilane", "locality_bruck"])
@pytest.mark.parametrize("q", [2, 3, 5, 6])
@pytest.mark.parametrize("pl", [2, 3, 4, 8])
def test_dma_folded_table_moves_the_raw_messages(algorithm, q, pl):
    p = q * pl
    t = dma_ops.build_schedule(algorithm, p,
                               None if algorithm in ("bruck", "ring") else pl)
    origins, messages = TSC.execute_folded(t)
    np.testing.assert_array_equal(origins, TSC.execute_table(t))
    np.testing.assert_array_equal(
        origins, JSC.execute_table(_jax_table(algorithm, p, pl)))
    raw, bufs = _raw_messages(t)
    assert messages == raw                 # the same blocks in every message
    # the same (source, target, blocks) per round, so nonlocal_stats holds
    region = TT.RegionMap(p, pl)
    msgs, blocks = np.zeros(p, int), np.zeros(p, int)
    for r, size in enumerate(t.sizes):
        senders = np.flatnonzero(t.folded[r, :, 0] >= 0)
        assert {(int(i), int(t.folded[r, i, 0]), size) for i in senders} == \
            {(i, int(t.table[i, r, 0]), size) for i in range(p)
             if t.table[i, r, 3]}
        for i in senders:
            if not region.is_local(int(i), int(t.folded[r, i, 0])):
                msgs[i] += 1
                blocks[i] += size
    assert (int(msgs.max()), int(blocks.max())) == t.nonlocal_stats(region)
    # a rank spills exactly the blocks it receives a second time
    spilled = t.folded[..., 3::3]
    for i in range(p):
        into_i = spilled[t.folded[..., 0] == i]
        assert int((into_i >= p).sum()) == len(bufs[i]) - p <= t.spill
    TSC.check_folded(t.folded, t.sizes, p)


def test_dma_check_folded_refuses_a_slot_read_and_written():
    folded = -np.ones((1, 2, 4), np.int32)
    folded[0, 0] = (1, 0, 0, 0)        # rank 0 sends origin 0 to rank 1's slot 0
    folded[0, 1] = (0, 1, 0, 0)        # rank 1 reads its slot 0 and sends it
    with pytest.raises(ValueError, match="read and written"):
        TSC.check_folded(folded, (1,), 2)
    folded[0, 1] = (0, 1, 1, 1)        # rank 1 reads slot 1: disjoint
    TSC.check_folded(folded, (1,), 2)
    folded[0, 1] = (1, 1, 1, 0)        # both write rank 1's slot 0
    with pytest.raises(ValueError, match="written twice"):
        TSC.check_folded(folded, (1,), 2)


def test_dma_wrapper_checks_its_input():
    sched = dma_ops.build_schedule("locality_bruck", 16, 4)
    with pytest.raises(ValueError, match="16 ranks"):
        dma_ops.dma_allgather(torch.zeros(12, 3), sched)
    with pytest.raises(ValueError, match="meta"):
        dma_ops.dma_allgather(torch.zeros(16, 3, device="meta"), sched)
    assert dma_ops._vec_bytes(12_583_680, 0, 256, 512) == 16
    assert dma_ops._vec_bytes(6, 0, 256, 512) == 2
    assert dma_ops._vec_bytes(1024, 0, 4, 8) == 4
    assert dma_ops._vec_bytes(7, 0, 256, 512) == 1
