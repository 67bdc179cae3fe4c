"""A pool of spawned gloo ranks for the port's collectives tests.

``RankPool(world)`` starts ``world`` processes that join one gloo group
over ``tcp://localhost`` and then run tasks: ``pool.run(fn, *args)`` calls
``fn(ctx, *args)`` on every rank and returns the per-rank results in rank
order. ``fn`` is a module-level function (it is pickled by name) and
``ctx.grid(q, pl)`` gives the rank's ``RankGrid`` over the first q·pl ranks
(None outside it), built once per shape in the same order on every rank.
This module imports no JAX, so the ranks start with torch alone.

The task functions below are the collectives tests' bodies; inputs are
integer-valued, made by numpy from a seed on every rank, so any summation
order gives the same sums in fp32 and bf16.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import traceback
from datetime import timedelta

import numpy as np

WORLD = 16
DTYPES = ("float32", "bfloat16")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankContext:
    """What a task sees on its rank: the rank, and the grids built so far."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self._grids: dict = {}

    def grid(self, q: int, pl: int, m: int = 1):
        from repro_torch.core.topology import RankGrid
        if (q, pl, m) not in self._grids:
            self._grids[q, pl, m] = RankGrid.build(q, pl, m)
        grid = self._grids[q, pl, m]
        if grid is not None:
            grid.recorder.reset()
        return grid


def _worker(rank: int, world: int, port: int, tasks, results) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    ctx = RankContext(rank, world)
    try:
        while (item := tasks.get()) is not None:
            fn, args = item
            try:
                results.put((rank, True, fn(ctx, *args)))
            except Exception:              # reported to the test, then on
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks; started at construction, stopped by close()."""

    def __init__(self, world: int = WORLD, timeout: float = 120.0):
        self.world, self.timeout = world, timeout
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.tasks = [ctx.Queue() for _ in range(self.world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, port, self.tasks[r],
                                        self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        """``fn(ctx, *args)`` on every rank; per-rank results. A failure on
        any rank raises and restarts the pool (its ranks may be stuck)."""
        if self.procs is None:
            self._start()
        for q in self.tasks:
            q.put((fn, args))
        out, errors = [None] * self.world, []
        try:
            for _ in range(self.world):
                rank, ok, val = self.results.get(timeout=self.timeout)
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
        except queue.Empty:
            errors.append(f"no answer within {self.timeout} s")
        if errors:
            self._stop(force=True)
            raise AssertionError(f"{fn.__name__}{args} failed:\n"
                                 + "\n".join(errors[:3]))
        return out

    def _stop(self, force: bool = False) -> None:
        if self.procs is None:
            return
        if not force:
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = None

    def close(self) -> None:
        self._stop()


# ---------------------------------------------------------------------------
# inputs, made alike on every rank and in the tests
# ---------------------------------------------------------------------------
def ints(seed: int, shape, lo: int = -8, hi: int = 9) -> np.ndarray:
    """Integer-valued fp32 data: exact in bf16 and in any summation order
    of up to 16 terms."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def _torch(a: np.ndarray, dtype: str):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    import torch
    return t.detach().to(torch.float32).numpy()


def _stats(grid) -> dict:
    return grid.recorder.reset().edge_counts()


# ---------------------------------------------------------------------------
# task bodies (run on every rank; None outside the grid)
# ---------------------------------------------------------------------------
def task_allgather(ctx, q, pl, algorithm, dtype, shard, seed):
    """Eager tiled and stacked gathers, start/finish, and the record of the
    tiled gather."""
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p,) + tuple(shard))[grid.rank], dtype)
    tiled = C.allgather(x, grid, algorithm=algorithm, tiled=True)
    stats = _stats(grid)
    stacked = C.allgather(x, grid, algorithm=algorithm)
    split = C.allgather_finish(C.allgather_start(x, grid,
                                                 algorithm=algorithm,
                                                 tiled=True))
    return dict(tiled=_np(tiled), stacked=_np(stacked),
                split_equal=bool(split.dtype == tiled.dtype
                                 and (split == tiled).all()),
                stats=stats)


def task_reduce_scatter(ctx, q, pl, algorithm, dtype, shard, seed):
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    y = ints(seed, (grid.p, grid.p * shard[0]) + tuple(shard[1:]))
    out = C.reduce_scatter(_torch(y[grid.rank], dtype), grid,
                           algorithm=algorithm)
    return dict(out=_np(out), stats=_stats(grid))


def task_allreduce(ctx, q, pl, algorithm, outer, op, dtype, shape, seed):
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p,) + tuple(shape))[grid.rank], dtype)
    out = C.allreduce(x, grid, algorithm=algorithm, outer_algorithm=outer,
                      op=op)
    stats = _stats(grid)
    split = C.allreduce_finish(C.allreduce_start(
        x, grid, algorithm=algorithm, outer_algorithm=outer, op=op))
    return dict(out=_np(out), stats=stats,
                split_equal=bool((split == out).all()))


def task_cache_migrate(ctx, q, pl, dtype, seed):
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p, 3, 2))[grid.rank], dtype)
    return {alg: _np(C.cache_migrate(x, grid, algorithm=alg))
            for alg in C.MIGRATE_ALGORITHMS}


def task_grad(ctx, q, pl, algorithm, seed):
    """d/dx sum(allgather(x)**2) on every rank."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p, 2, 3))[grid.rank], "float32")
    x.requires_grad_(True)
    g = C.allgather(x, grid, algorithm=algorithm, tiled=True)
    (g ** 2).sum().backward()
    return dict(x=_np(x), grad=_np(x.grad))


def task_split_grad(ctx, q, pl, algorithm, seed):
    """The split gather with a gradient: finish(start(x)) against the eager
    differentiable gather, forward and backward, under a weighted sum; and
    the split's refusal of a schedule that has no gradient."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p, 2, 3))[grid.rank], "float32")
    w = _torch(ints(seed + 1, (grid.p * 2, 3)), "float32")
    xe, xs = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    eager = C.allgather(xe, grid, algorithm=algorithm, tiled=True)
    (eager * w).sum().backward()
    eager_stats = _stats(grid)
    split = C.allgather_finish(C.allgather_start(xs, grid,
                                                 algorithm=algorithm,
                                                 tiled=True))
    (split * w).sum().backward()
    split_stats = _stats(grid)
    staged = C.allgather_finish(C.allgather_start(
        xs.detach(), grid, algorithm=algorithm, tiled=True, stage=True))
    try:
        C.allgather_start(x.clone().requires_grad_(True), grid,
                          algorithm="ring")
        ring_error = None
    except ValueError as e:
        ring_error = str(e)
    return dict(forward_equal=bool(torch.equal(eager, split)),
                grad=_np(xe.grad), split_grad=_np(xs.grad),
                stats_equal=eager_stats == split_stats,
                staged_equal=bool(torch.equal(eager, staged)),
                ring_error=ring_error)


def task_all_to_all(ctx, q, pl, algorithm, dtype, seed):
    """The eager exchange and its record, start/finish against it, the
    ``collective`` entry point, and the gradient of a weighted sum (which
    is the exchange of the weights)."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    p = grid.p
    x = _torch(ints(seed, (p, p * 2, 3))[grid.rank], dtype)
    out = C.all_to_all(x, grid, algorithm=algorithm)
    stats = _stats(grid)
    split = C.all_to_all_finish(C.all_to_all_start(x, grid,
                                                   algorithm=algorithm))
    split_stats = _stats(grid)
    entry = C.finish(C.collective("all_to_all", x, grid=grid,
                                  algorithm=algorithm, start=True))
    w = _torch(ints(seed + 1, (p, p * 2, 3))[grid.rank], "float32")
    xg = x.float().clone().requires_grad_(True)
    (C.all_to_all(xg, grid, algorithm=algorithm) * w).sum().backward()
    xs = x.float().clone().requires_grad_(True)
    (C.all_to_all_finish(C.all_to_all_start(xs, grid, algorithm=algorithm))
     * w).sum().backward()
    return dict(out=_np(out), stats=stats,
                split_equal=bool(split.dtype == out.dtype
                                 and torch.equal(split, out)),
                split_stats_equal=split_stats == stats,
                entry_equal=bool(torch.equal(entry, out)),
                grad=_np(xg.grad), split_grad=_np(xs.grad))


def task_vocabulary(ctx, q, pl, seed):
    """collective()/Collective dispatch against the family functions, and
    the errors of what is not ported."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p, 4, 2))[grid.rank], "float32")
    o, m, l = x[..., None].repeat(1, 1, 3), x, x.abs() + 1
    eager = C.logsumexp_combine(o, m, l, grid)
    same = {
        "combine": all(map(torch.equal, C.collective(
            "combine", o, m, l, grid=grid), eager)),
        "combine_split": all(map(torch.equal, C.finish(C.collective(
            "logsumexp_combine", m, grid=grid, start=True), o, l), eager)),
        "allgather": torch.equal(
            C.collective("allgather", x, grid=grid, tiled=True),
            C.allgather(x, grid, tiled=True)),
        "allgather_split": torch.equal(
            C.finish(C.collective("allgather", x, grid=grid, start=True)),
            C.allgather(x, grid)),
        "class": torch.equal(
            C.Collective("allgather", grid, "bruck")(x),
            C.allgather(x, grid, algorithm="bruck")),
        "class_split": torch.equal(
            C.Collective.finish(C.Collective("allreduce", grid).start(x)),
            C.allreduce(x, grid)),
        "allreduce": torch.equal(
            C.collective("allreduce", x, grid=grid, op="max"),
            C.allreduce(x, grid, op="max")),
        "reduce_scatter": torch.equal(
            C.collective("reduce_scatter", x.repeat(grid.p, 1), grid=grid,
                         algorithm="multilane"),
            C.reduce_scatter(x.repeat(grid.p, 1), grid,
                             algorithm="multilane")),
        "cache_migrate": torch.equal(
            C.collective("cache_migrate", x, grid=grid,
                         algorithm="multilane"),
            C.cache_migrate(x, grid, algorithm="multilane")),
        "all_to_all": torch.equal(
            C.collective("all_to_all", x.repeat(grid.p, 1), grid=grid),
            C.all_to_all(x.repeat(grid.p, 1), grid)),
        "all_to_all_class": torch.equal(
            C.Collective("all_to_all", grid, "xla")(x.repeat(grid.p, 1)),
            C.all_to_all(x.repeat(grid.p, 1), grid, algorithm="xla")),
    }
    errors = {}
    calls = {
        "auto_all_to_all": lambda: C.collective(
            "all_to_all", x.repeat(grid.p, 1), grid=grid, algorithm="auto"),
        "a2a_indivisible": lambda: C.all_to_all(x[:1], grid),
        "auto_combine": lambda: C.collective("combine", o, m, l, grid=grid,
                                             algorithm="auto"),
        "auto": lambda: C.allgather(x, grid, algorithm="auto"),
        "auto_default_migrate": lambda: C.collective("cache_migrate", x,
                                                     grid=grid),
        "auto_allreduce": lambda: C.allreduce(x, grid, algorithm="auto"),
        "rs_start": lambda: C.collective("reduce_scatter", x, grid=grid,
                                         start=True),
        "unknown_kind": lambda: C.collective("gather", x, grid=grid),
        "unknown_alg": lambda: C.collective("allgather", x, grid=grid,
                                            algorithm="tree"),
        "grad_ring": lambda: C.allgather(x.clone().requires_grad_(True),
                                         grid, algorithm="ring"),
        "meta_tensor": lambda: C.allgather(torch.zeros(2, device="meta"),
                                           grid),
    }
    for name, call in calls.items():
        try:
            call()
            errors[name] = None
        except (NotImplementedError, ValueError) as e:
            errors[name] = (type(e).__name__, str(e))
    return dict(same=same, errors=errors)


def task_paper_counts(ctx, q, pl, algorithm):
    """Per-rank non-local messages of one gather (paper Eqs. 3 and 4)."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    C.allgather(torch.zeros(3), grid, algorithm=algorithm)
    st = grid.recorder.reset()
    return dict(nonlocal_msgs=st.permute_edges_nonlocal,
                nonlocal_bytes=st.permute_bytes_nonlocal)


# ---------------------------------------------------------------------------
# sequence-parallel serving (tests/test_torch_serve_seq.py)
# ---------------------------------------------------------------------------
def task_serve_seq(ctx, q, pl, params, n_layers, cache_len, requests,
                   layouts):
    """The port's engine on the grid, one per layout ``(name, spec
    keywords)``: the same ``requests`` ((prompt, max_new), submitted
    together) drained on a StepClock. Per layout: the tokens and start
    stamps by request id, the engine's stats and its combine choice."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import collectives as C
    from repro_torch.serve import Engine, Request, ServeSpec, StepClock
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    cfg = dataclasses.replace(configs.get_smoke("llama3.2-3b"),
                              n_layers=n_layers, dtype=torch.float32)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    out = {}
    for name, kw in layouts:
        eng = Engine(cfg, tparams, ServeSpec(batch=1, cache_len=cache_len,
                                             **kw),
                     grid=grid, device="cpu", clock=StepClock())
        rids = [eng.submit(Request(tokens=t, max_new=m)) for t, m in requests]
        res = eng.drain()
        # what one combine of this engine's payload sends, alone
        full = eng.shards.get(("k", "v"))
        cgrid = full.grid if full else None
        one = None
        if cgrid is not None:
            before = cgrid.recorder.reset()
            z = torch.zeros(1, 1, cfg.n_heads, cfg.head_dim_)
            C.logsumexp_combine(z, z[..., 0], z[..., 0], cgrid,
                                algorithm=eng.combine.algorithm)
            one = cgrid.recorder.reset().edge_counts()
            cgrid.recorder.stats = before
        out[name] = dict(one_combine=one,
            tokens={rid: res[rid].tokens.tolist() for rid in rids},
            started={rid: res[rid].started_s for rid in rids},
            stats=eng.stats(), combine=dataclasses.asdict(eng.combine),
            cache_len=eng.cache_len, cache_offset=eng.cache_offset)
    return out


# ---------------------------------------------------------------------------
# the decode logsumexp combine (tests/test_torch_combine.py)
# ---------------------------------------------------------------------------
NEG_INF = -2.0 ** 30
COMBINE_SHAPE = (2, 1, 3, 4)          # (B, 1, H, D) of o; m and l (B, 1, H)


def combine_inputs(p: int, seed: int) -> tuple[np.ndarray, ...]:
    """Per-rank partial softmax stats (o, m, l), stacked over p ranks, fp32:
    rank 1 and the last rank hold a fully masked slice (m = NEG_INF,
    o = l = 0), rank 0 one masked head."""
    rng = np.random.default_rng(seed)
    B, _, H, D = COMBINE_SHAPE
    o = rng.standard_normal((p,) + COMBINE_SHAPE).astype(np.float32)
    m = (rng.standard_normal((p, B, 1, H)) * 3).astype(np.float32)
    l = rng.uniform(1.0, 10.0, (p, B, 1, H)).astype(np.float32)
    for r, head in ((1, slice(None)), (p - 1, slice(None)), (0, 0)):
        m[r, :, :, head] = NEG_INF
        o[r, :, :, head] = 0.0
        l[r, :, :, head] = 0.0
    return o, m, l


def task_combine(ctx, q, pl, algorithm, seed):
    """The combine eager, split, through collective()/finish and the
    Collective class on this rank's slice; the recorder's counts of the
    eager combine and of the max (rd) and sum (rhd) allreduces it is made
    of, run alone on the same payloads."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    o, m, l = (torch.from_numpy(a[grid.rank])
               for a in combine_inputs(grid.p, seed))
    eager = C.logsumexp_combine(o, m, l, grid, algorithm=algorithm)
    stats = _stats(grid)
    split = C.logsumexp_combine_finish(
        o, l, C.logsumexp_combine_start(m, grid, algorithm=algorithm))
    via = C.finish(C.collective("combine", m, grid=grid, algorithm=algorithm,
                                start=True), o, l)
    whole = C.collective("logsumexp_combine", o, m, l, grid=grid,
                         algorithm=algorithm)
    cls = C.Collective("combine", grid, algorithm)
    obj = cls.finish(cls.start(m), o, l)
    grid.recorder.reset()
    C.allreduce(m, grid, algorithm=algorithm, outer_algorithm="rd", op="max")
    C.allreduce(torch.cat([o.reshape(-1), l.reshape(-1)]), grid,
                algorithm=algorithm, outer_algorithm="rhd", op="sum")
    parts = _stats(grid)
    same = all(torch.equal(a, b) for other in (split, via, whole, obj)
               for a, b in zip(eager, other))
    return dict(o=_np(eager[0]), l=_np(eager[1]), same=same, stats=stats,
                parts=parts)


def task_spec_errors(ctx, q, pl):
    """The engine's refusals on a grid: (exception type, message) each."""
    import dataclasses as dc

    import torch as T
    from repro_torch import configs as C
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, ServeSpec
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    cfg = dc.replace(C.get_smoke("llama3.2-3b"), n_layers=1,
                     dtype=T.float32)
    params = init_params(cfg, T.Generator().manual_seed(0), "cpu")
    out = {}
    for name, spec in (
            ("batch", ServeSpec(batch=3, cache_len=48, combine="locality")),
            ("auto", ServeSpec(batch=1, cache_len=48)),
            ("batch_sharded", ServeSpec(batch=4, cache_len=48)),
            ("migrate_auto", ServeSpec(batch=4, cache_len=48,
                                       migrate="auto")),
            ("migrate_unknown", ServeSpec(batch=4, cache_len=48,
                                          migrate="ring"))):
        try:
            Engine(cfg, params, spec, grid=grid, device="cpu")
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# ---------------------------------------------------------------------------
# batch-sharded serving (tests/test_torch_serve_batch.py)
# ---------------------------------------------------------------------------
def _small_cfg(arch: str, n_layers: int):
    import dataclasses

    import torch
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch), n_layers=n_layers,
                               dtype=torch.float32)


def result_fields(res) -> dict:
    """A RequestResult as plain data, every field the tests compare."""
    return dict(tokens=[int(t) for t in res.tokens], slot=res.slot,
                home_pod=res.home_pod, migrated=res.migrated,
                started_s=res.started_s, finished_s=res.finished_s,
                token_times_s=list(res.token_times_s),
                finish_reason=res.finish_reason)


class OffsetClock:
    """A StepClock read ``offset`` ahead: ``now()`` is the step count plus
    ``offset``, so ranks given different offsets disagree on which
    requests have arrived (as wall clocks of two hosts may)."""

    def __init__(self, offset: float = 0.0):
        from repro_torch.serve import StepClock
        self.steps, self.offset = StepClock(), offset

    def now(self) -> float:
        return self.steps.now() + self.offset

    def advance(self, kind: str) -> None:
        self.steps.advance(kind)

    def idle_until(self, t: float) -> None:
        self.steps.idle_until(t - self.offset)


def task_serve_batch(ctx, q, pl, arch, params, n_layers, spec_kw, requests,
                     m=1, offsets=None):
    """The port's engine on a q x pl (x m) grid (one rank for 1 x 1),
    drained on a StepClock: ``requests`` are (prompt, max_new, home_pod)
    or (prompt, max_new, home_pod, arrival_s), arriving at 0 by default.
    ``offsets`` (by model lane t) runs each rank on an ``OffsetClock``.
    Returns every result's fields by rid, the engine's stats, the bytes
    each request sent from this rank, the migration's recorder counts
    (collective and donor move, summed over the migrations), the combine
    and layout resolved, the rank's coordinates and, per admission, the
    request and the step count it was admitted at on this rank."""
    import dataclasses

    import torch
    from repro_torch.serve import Engine, Request, ServeSpec, StepClock
    grid = ctx.grid(q, pl, m)
    if grid is None:
        return None
    cfg = _small_cfg(arch, n_layers)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    clock = StepClock() if offsets is None else OffsetClock(offsets[grid.t])
    eng = Engine(cfg, tparams, ServeSpec(**spec_kw),
                 grid=grid if grid.p * grid.m > 1 else None, device="cpu",
                 clock=clock)
    sched, admitted = eng.scheduler, []
    start = sched._start

    def logged(req, row):
        admitted.append((req.rid, clock.now() - (offsets or [0] * m)[grid.t]))
        return start(req, row)

    sched._start = logged
    for t, n, home, *arrival in requests:
        eng.submit(Request(tokens=t, max_new=n, home_pod=home,
                           arrival_s=arrival[0] if arrival else 0.0))
    res = eng.drain()
    mig = sched.migrate
    return dict(
        results={rid: result_fields(r) for rid, r in res.items()},
        stats=eng.stats(), rows=(eng.rows_lo, eng.local_batch),
        sent={} if mig is None else dict(mig.sent_by_request),
        collective={} if mig is None else dict(mig.collective),
        donor={} if mig is None else dict(mig.donor),
        span=None if mig is None else mig.span,
        combine=dataclasses.asdict(eng.combine),
        resolved=dict(m=eng.resolved.m, kv_own=eng.resolved.kv_own),
        cache_shape=tuple(eng.model.cache_shapes(1, 8).get(
            "k", ((),))[0]),
        coords=(grid.rank, grid.t, grid.grid_rank), admitted=admitted)


def task_serve_variant(ctx, q, pl, m, arch, params, n_layers, spec_kw,
                       requests):
    """A dense variant's engine on a q x pl x m grid (one rank for 1 x 1 x
    1), drained on a StepClock (tests/test_torch_variants_grid.py):
    ``requests`` are (prompt, max_new, home_pod), arriving at 0. Returns
    every result's fields by rid, the engine's stats, the migration's
    collective record (summed over the migrations), the combine and the
    spans resolved, this rank's shard of each split K/V stack (offset,
    length, total), the rank's coordinates and, per split stack, what one
    combine of its layers' payload sends over its grid alone."""
    import dataclasses

    import torch
    from repro_torch.core import collectives as C
    from repro_torch.serve import Engine, Request, ServeSpec, StepClock
    grid = ctx.grid(q, pl, m)
    if grid is None:
        return None
    cfg = _small_cfg(arch, n_layers)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    eng = Engine(cfg, tparams, ServeSpec(**spec_kw),
                 grid=grid if grid.p * grid.m > 1 else None, device="cpu",
                 clock=StepClock())
    for t, n, home in requests:
        eng.submit(Request(tokens=t, max_new=n, home_pod=home,
                           arrival_s=0.0))
    res = eng.drain()
    mig = eng.scheduler.migrate
    one = {}
    H = cfg.n_heads // (grid.m if eng.resolved.kv_own else 1)
    for names, sh in eng.shards.items():
        before = sh.grid.recorder.reset()
        z = torch.zeros(1, 1, H, cfg.head_dim_)
        C.logsumexp_combine(z, z[..., 0], z[..., 0], sh.grid,
                            algorithm=eng.combine.algorithm)
        one["/".join(names)] = sh.grid.recorder.reset().edge_counts()
        sh.grid.recorder.stats = before
    return dict(
        results={rid: result_fields(r) for rid, r in res.items()},
        stats=eng.stats(),
        collective={} if mig is None else dict(mig.collective),
        combine=dataclasses.asdict(eng.combine),
        spans={"/".join(n): s for n, s in eng.resolved.spans.items()},
        shards={"/".join(n): (s.offset, s.length, s.total)
                for n, s in eng.shards.items()},
        one_combine=one, coords=(grid.rank, grid.t, grid.grid_rank),
        layer0={n: tuple(t.shape)
                for n, t in eng.model.layers[0].named_parameters()})


def task_generate(ctx, q, pl, params, n_layers, batch, cache_len, prompts,
                  max_new, m=1):
    """The legacy ``Engine.generate`` on a q x pl (x m) grid (one rank for
    1 x 1): the (B, max_new) tokens and whether it warned."""
    import warnings

    import torch
    from repro_torch.serve import Engine, ServeSpec
    grid = ctx.grid(q, pl, m)
    if grid is None:
        return None
    cfg = _small_cfg("llama3.2-3b", n_layers)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    eng = Engine(cfg, tparams, ServeSpec(batch=batch, cache_len=cache_len),
                 grid=grid if grid.p * grid.m > 1 else None, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks = eng.generate(prompts, max_new)
    return dict(tokens=toks.tolist(), rows=(eng.rows_lo, eng.local_batch),
                warned=any(issubclass(w.category, DeprecationWarning)
                           for w in caught))


def task_cache_migrate_pod(ctx, q, pl, algorithm, shard, seed):
    """``cache_migrate`` over this rank's pod (``RankGrid.pod_grid``), on a
    slab every pod holds alike, sharded over the pod's ranks: the serve
    scheduler's migration of a ("data",) donor span. The output and the
    pod grid's record."""
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    pod = grid.pod_grid()
    x = _torch(ints(seed, (grid.p,) + tuple(shard))[grid.l], "float32")
    out = C.cache_migrate(x, pod, algorithm=algorithm, tiled=True)
    return dict(out=_np(out), stats=_stats(pod))


def task_batch_spec_errors(ctx, q, pl):
    """The engine's refusals of a batch-sharded spec on a grid: (exception
    type, message) each, None where it builds."""
    import dataclasses as dc

    import numpy as np
    import torch as T
    from repro_torch import configs as C
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    cfg = dc.replace(C.get_smoke("llama3.2-3b"), n_layers=1,
                     dtype=T.float32)
    params = init_params(cfg, T.Generator().manual_seed(0), "cpu")
    one_pod = ctx.grid(1, q * pl)
    calls = {
        "auto": lambda: Engine(cfg, params, ServeSpec(
            batch=4, cache_len=32, migrate="auto"), grid=grid, device="cpu"),
        "unknown": lambda: ServeSpec(batch=4, cache_len=32,
                                     migrate="gspmd").validate(),
        "home_pod": lambda: Engine(cfg, params, ServeSpec(
            batch=4, cache_len=32), grid=grid, device="cpu").submit(
                Request(tokens=np.ones(3, np.int32), max_new=1,
                        home_pod=q)),
        "one_pod_auto": lambda: Engine(cfg, params, ServeSpec(
            batch=4, cache_len=32, migrate="auto"), grid=one_pod,
            device="cpu"),
        "sequence_auto": lambda: Engine(cfg, params, ServeSpec(
            batch=1, cache_len=32, combine="locality", migrate="auto"),
            grid=grid, device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# ---------------------------------------------------------------------------
# FSDP training (tests/test_torch_train.py, tests/test_torch_ssm_train.py)
# ---------------------------------------------------------------------------
# The JAX reference of the training tests, run in a subprocess with 8 forced
# host devices: ``python -c JAX_TRAIN_REFERENCE out_dir cache_dir plan.json``
# with plan {arch, n_layers, global_batch, seq_len, steps, variants (name ->
# make_train_step keywords), one_gather (the shape of one shard-mapped
# parameter gather), precise_ssd (the mixer's ssd_chunked made precise),
# cfg_kw (the smoke config's fields replaced)}, or {models: {sub-directory:
# such a plan}}, each run in turn. It writes out.json (losses, grad norms,
# the compiled steps' and the one gather's collective_stats) and an .npz of
# parameters per variant (and params0, the initial state's).
JAX_TRAIN_REFERENCE = r"""
import dataclasses, json, os, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
warnings.simplefilter("ignore")
jax.config.update("jax_compilation_cache_dir", sys.argv[2])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
from repro import configs
from repro.core import collectives as C
from repro.core.hlo_analysis import collective_stats
from repro.core.topology import device_pod_map
from repro.data import SyntheticLM
from repro.train.step import custom_batch_specs, init_state, make_train_step


def run(plan, out_dir):
    if plan.get("precise_ssd"):
        # the port's SSD kernel computes the precise function: the mixer's
        # ssd_chunked made precise in this process only
        import functools
        from repro.models import ssm
        ssm.ssd_chunked = functools.partial(ssm.ssd_chunked, precise=True)
    cfg = dataclasses.replace(configs.get_smoke(plan["arch"]),
                              n_layers=plan["n_layers"], dtype=jnp.float32,
                              **plan.get("cfg_kw", {}))
    B, S = plan["global_batch"], plan["seq_len"]
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    jax.set_mesh(mesh)
    pods = device_pod_map(mesh, ("pod",))
    EDGES = ("permute_edges_local", "permute_edges_nonlocal",
             "permute_bytes_local", "permute_bytes_nonlocal")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                       seed=0)
    path_of = lambda path: "/".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    save = lambda name, tree: np.savez(f"{out_dir}/{name}.npz", **{
        path_of(p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
    res = {}
    for name, kw in plan["variants"].items():
        art = make_train_step(cfg, mesh, grad_sync="locality",
                              shape=custom_batch_specs(cfg, B, S),
                              donate=False, **kw)
        state = init_state(cfg, mesh, art)
        if name == "fsdp":
            save("params0", state.params)
        put = lambda b: {k: jax.device_put(v, art.batch_shardings[k])
                         for k, v in b.items()}
        compiled = art.step_fn.lower(state, put(data.batch(0))).compile()
        st = collective_stats(compiled.as_text(), pods)
        losses, norms = [], []
        for step in range(plan["steps"]):
            state, m = compiled(state, put(data.batch(step)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        save(name, state.params)
        res[name] = {"losses": losses, "grad_norms": norms,
                     "hlo": {k: getattr(st, k) for k in EDGES},
                     "permutes": st.counts.get("collective-permute", 0)}

    # one leaf's parameter gather, shard-mapped: the unit the port repeats
    f = jax.jit(jax.shard_map(
        lambda x: C.allgather(x, ("pod",), ("data",),
                              algorithm="locality_bruck", tiled=True,
                              assume_varying=True),
        mesh=mesh, in_specs=P(("pod", "data")), out_specs=P(),
        check_vma=False))
    a = jax.ShapeDtypeStruct(tuple(plan["one_gather"]), jnp.float32,
                             sharding=NamedSharding(mesh, P(("pod", "data"))))
    st = collective_stats(f.lower(a).compile().as_text(), pods)
    res["one_gather"] = {k: getattr(st, k) for k in EDGES}
    with open(f"{out_dir}/out.json", "w") as fh:
        json.dump(res, fh)


plan = json.loads(open(sys.argv[3]).read())
# several models in one process: plan["models"] maps a sub-directory of
# out_dir to a plan of its own (cfg_kw: the smoke config's fields replaced)
for sub, one in (plan["models"].items() if "models" in plan
                 else [("", plan)]):
    os.makedirs(f"{sys.argv[1]}/{sub}", exist_ok=True)
    run(one, f"{sys.argv[1]}/{sub}")
"""
# The JAX (2, 2, 2) ("pod", "data", "model") step for tests/test_torch_tp.py,
# tests/test_torch_ssm_tp.py and tests/test_torch_variants_tp.py: ``python
# -c JAX_TP_REFERENCE out_dir plan.json`` with plan {n_layers, global_batch,
# seq_len, steps, variants (name -> make_train_step keywords, "grad_sync"
# among them), and optionally arch (the smoke config's, llama3.2-3b by
# default), replace (fields of that config replaced, e.g. head_dim) and
# precise_ssd (the mixer's ssd_chunked made precise, the function the
# port's kernel computes)}, or {"models": {sub-directory: such a plan},
# precise_ssd} for several models in one process. On jax 0.9.0 the mesh
# needs Auto axes, no jax.set_mesh, and the steps under ``with mesh:``
# (with ``jax.set_mesh``, or Explicit axes, the embedding gather raises
# ShardingTypeError). Writes out.json (losses, grad norms, the mesh's
# device ids) and an .npz of parameters per variant (and params0, the
# initial state's) into out_dir, or into each model's sub-directory.
JAX_TP_REFERENCE = r"""
import dataclasses, json, os, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
warnings.simplefilter("ignore")
from repro import configs
from repro.data import SyntheticLM
from repro.train.step import custom_batch_specs, init_state, make_train_step

path_of = lambda path: "/".join(
    str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def run(plan, out_dir):
    cfg = dataclasses.replace(
        configs.get_smoke(plan.get("arch", "llama3.2-3b")),
        n_layers=plan["n_layers"], dtype=jnp.float32,
        **plan.get("replace", {}))
    B, S = plan["global_batch"], plan["seq_len"]
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                       seed=0)
    save = lambda name, tree: np.savez(f"{out_dir}/{name}.npz", **{
        path_of(p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
    res = {"device_ids": np.vectorize(lambda d: d.id)(mesh.devices).tolist()}
    with mesh:
        for i, (name, kw) in enumerate(plan["variants"].items()):
            art = make_train_step(cfg, mesh,
                                  shape=custom_batch_specs(cfg, B, S),
                                  donate=False, **kw)
            state = init_state(cfg, mesh, art)
            if i == 0:
                save("params0", state.params)
            losses, norms = [], []
            for step in range(plan["steps"]):
                batch = {k: jax.device_put(v, art.batch_shardings[k])
                         for k, v in data.batch(step).items()}
                state, m = art.step_fn(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            save(name, state.params)
            res[name] = {"losses": losses, "grad_norms": norms}
    with open(f"{out_dir}/out.json", "w") as fh:
        json.dump(res, fh)


plan = json.loads(open(sys.argv[2]).read())
if plan.get("precise_ssd"):
    import functools
    from repro.models import ssm
    ssm.ssd_chunked = functools.partial(ssm.ssd_chunked, precise=True)
for sub, one in (plan["models"].items() if "models" in plan
                 else [("", plan)]):
    os.makedirs(f"{sys.argv[1]}/{sub}", exist_ok=True)
    run(one, f"{sys.argv[1]}/{sub}")
"""

# The JAX MoE steps for tests/test_torch_moe_train.py: ``python -c
# JAX_MOE_TRAIN_REFERENCE out_dir plan.json`` with plan {n_layers, seq_len,
# steps, runs: name -> {mesh: [q, pl], global_batch, cfg (fields of the
# reduced qwen2-moe replaced), kw (make_train_step keywords)}}. Each run is
# the step (grad_sync "locality" unless kw names another) on its (pod,
# data) mesh of the first q·pl devices,
# on jax 0.9.0's recipe (Auto axes, no jax.set_mesh, the step under
# ``with mesh:``); its expert-parallel dispatch raises there, so the runs
# take moe_dispatch="none", the step the EP step is defined to equal.
# Writes out.json (losses, aux losses, grad norms) and per run two .npz of
# parameters, params0_<name> (the initial state's) and <name>.
JAX_MOE_TRAIN_REFERENCE = r"""
import dataclasses, json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
warnings.simplefilter("ignore")
from repro import configs
from repro.data import SyntheticLM
from repro.train.step import custom_batch_specs, init_state, make_train_step

out_dir = sys.argv[1]
plan = json.loads(open(sys.argv[2]).read())
path_of = lambda path: "/".join(
    str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
save = lambda name, tree: np.savez(f"{out_dir}/{name}.npz", **{
    path_of(p): np.asarray(v)
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
res = {}
for name, run in plan["runs"].items():
    cfg = dataclasses.replace(configs.get_smoke("qwen2-moe-a2.7b"),
                              n_layers=plan["n_layers"], dtype=jnp.float32,
                              **run["cfg"])
    q, pl = run["mesh"]
    B, S = run["global_batch"], plan["seq_len"]
    mesh = jax.make_mesh((q, pl), ("pod", "data"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:q * pl])
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                       seed=0)
    kw = dict(run["kw"])
    with mesh:
        art = make_train_step(cfg, mesh,
                              grad_sync=kw.pop("grad_sync", "locality"),
                              shape=custom_batch_specs(cfg, B, S),
                              donate=False, moe_dispatch="none", **kw)
        state = init_state(cfg, mesh, art)
        save(f"params0_{name}", state.params)
        losses, auxs, norms = [], [], []
        for step in range(plan["steps"]):
            batch = {k: jax.device_put(v, art.batch_shardings[k])
                     for k, v in data.batch(step).items()}
            state, m = art.step_fn(state, batch)
            losses.append(float(m["loss"]))
            auxs.append(float(m["moe_aux"]))
            norms.append(float(m["grad_norm"]))
    save(name, state.params)
    res[name] = {"losses": losses, "moe_aux": auxs, "grad_norms": norms}
with open(f"{out_dir}/out.json", "w") as fh:
    json.dump(res, fh)
"""


def train_tree(flat: dict):
    """A parameter tree from {"a/b/c": array} (the JAX tree's leaf paths;
    ``rest/<r>/...`` the list of the remainder's layers)."""
    import torch
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(a, dtype=np.float32))
    rest = tree.get("rest", {})
    tree["rest"] = [rest[str(r)] for r in range(len(rest))]
    return tree


def task_train(ctx, q, pl, flat_params, n_layers, steps, global_batch,
               seq_len, kw, arch="llama3.2-3b", m=1, cfg_kw=None,
               moments=False):
    """``make_train_step(**kw)`` on a q x pl (x m) grid (q None: one
    process, every rank runs it alone) from the given parameters, on the
    CPU, for ``steps`` steps of ``SyntheticLM(seed=0)`` (this rank's rows),
    for ``arch``'s smoke config at ``n_layers`` in fp32 (with ``cfg_kw``'s
    fields replaced). Returns the metrics of every step, this rank's
    parameter shards (by leaf path) with their FSDP dim and axes and model
    dim, the step meter of the run and the resolved MoE dispatch; with
    ``moments``, AdamW's first moments by leaf path ("mu": after one step,
    (1 - b1) times the clipped gradient)."""
    import dataclasses
    from repro_torch.data import SyntheticLM, host_shard
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.sharding import (fsdp_param_axes, fsdp_param_dims,
                                            model_param_dims)
    grid = None if q is None else ctx.grid(q, pl, m)
    if q is not None and grid is None:
        return None
    cfg = dataclasses.replace(_small_cfg(arch, n_layers), **(cfg_kw or {}))
    art = make_train_step(cfg, grid, device="cpu", **kw)
    state = init_state(cfg, art, params=train_tree(flat_params))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=0)
    metrics = []
    for step in range(steps):
        batch = data.batch(step)
        if grid is not None:
            batch = host_shard(batch, grid.rank, grid.p)
        state, m = art.step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    meter = art.meter.take()
    paths = tree_paths(state.params)   # the flattening order of leaves()
    return dict(
        metrics=metrics,
        shards={p: t.numpy().copy() for p, t in
                zip(paths, leaves(state.params))},
        dims=dict(zip(paths, leaves(fsdp_param_dims(art.pspecs)))),
        axes=dict(zip(paths, leaves(fsdp_param_axes(art.pspecs)))),
        mdims=dict(zip(paths, leaves(model_param_dims(art.pspecs)))),
        coords=None if grid is None else dict(
            rank=grid.rank, t=grid.t, grid_rank=grid.grid_rank),
        meter=dict(gathers=meter.gathers,
                   reduce_scatters=meter.reduce_scatters,
                   gather=meter.gather_stats.edge_counts(),
                   reduce_scatter=meter.reduce_scatter_stats.edge_counts(),
                   sync=meter.sync_stats.edge_counts(),
                   model_calls=meter.model_calls,
                   model=meter.model_stats.edge_counts(),
                   a2a_calls=meter.a2a_calls, a2a_bytes=meter.a2a_bytes,
                   a2a=meter.a2a_stats.edge_counts(),
                   moe_gathers=meter.moe_gathers,
                   moe_gather=meter.moe_gather_stats.edge_counts()),
        moe=(art.moe_dispatch, art.moe_transport, art.moe_dispatch_source),
        mu={p: t.numpy().copy() for p, t in zip(paths, leaves(state.mu))}
        if moments else None)


def tree_paths(tree, path=()) -> list[str]:
    """The "/"-joined leaf paths of a tree in ``optim.adamw.leaves``'s
    order (sorted keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [p for i, x in enumerate(tree)
                for p in tree_paths(x, path + (str(i),))]
    return ["/".join(path)]


def jax_layout(flat: dict, cfg_or_arch, m: int, n_layers: int = 2) -> dict:
    """{path: array} of a step's whole tree on a model tier of m (as
    :func:`assemble_tp` gives it) in the JAX tree's layout: the ssm
    family's ``in_proj`` and ``conv_w`` put back whole
    (``models/tp.ssm_jax_tree``); the other families' as they are."""
    from repro_torch.models.tp import ssm_jax_tree
    cfg = (_small_cfg(cfg_or_arch, n_layers) if isinstance(cfg_or_arch, str)
           else cfg_or_arch)
    if m == 1 or cfg.family != "ssm":
        return dict(flat)
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    tree = ssm_jax_tree(tree, cfg, m)
    return {p: _at(tree, p) for p in tree_paths(tree)}


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def assemble_tp(results: list, pl: int, m: int) -> dict:
    """Every leaf whole again from the shards of a grid with a model tier
    (``results`` in grid-rank order): each model lane's parts assembled
    over FSDP, then the lanes' concatenated along the leaf's model dim (the
    tier holds a leaf without one whole: lane 0's)."""
    lanes = [assemble(results[t::m], pl) for t in range(m)]
    mdims = results[0]["mdims"]
    return {path: (lanes[0][path] if mdims[path] < 0 else np.concatenate(
        [lane[path] for lane in lanes], mdims[path])) for path in lanes[0]}


def odd_heads_mamba():
    """The reduced mamba2 with 3 SSD heads (d_model 96, heads of 64): a
    head count that a model tier of 2 does not divide."""
    import dataclasses
    return dataclasses.replace(_small_cfg("mamba2-780m", 2), d_model=96,
                               ssm_headdim=64)


def task_tp_refusals(ctx, q, pl, m):
    """On a q x pl x m grid: the mamba2 step and mamba2 serving refuse SSD
    heads that m does not divide, the MoE step and dense serving resolve;
    returns the messages (None where nothing was refused)."""
    from repro_torch.serve.spec import ServeSpec
    from repro_torch.train import make_train_step
    grid = ctx.grid(q, pl, m)
    out = []
    for call in (lambda: make_train_step(odd_heads_mamba(), grid,
                                         device="cpu"),
                 lambda: ServeSpec(batch=1, cache_len=16).resolve(
                     odd_heads_mamba(), grid),
                 lambda: make_train_step(_small_cfg("qwen2-moe-a2.7b", 2),
                                         grid, device="cpu"),
                 lambda: ServeSpec(batch=1, cache_len=16,
                                   combine="locality").resolve(
                     _small_cfg("llama3.2-3b", 2), grid)):
        try:
            call()
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return out


def task_variant_tier_refusal(ctx, q, pl, m, arch):
    """``make_train_step`` of ``arch``'s smoke config on a q x pl x m grid:
    the message it refuses with (None where it takes it)."""
    from repro_torch.train import make_train_step
    try:
        make_train_step(_small_cfg(arch, 2), ctx.grid(q, pl, m),
                        device="cpu")
    except NotImplementedError as e:
        return str(e)
    return None


def task_launch_train(ctx, args):
    """The training launcher's rank function (``launch.train._train_rank``)
    on this rank, with the launcher's parsed ``args``."""
    from repro_torch.launch import train as launch
    return launch._train_rank(ctx.rank, ctx.world, args)


def task_launch_serve(ctx, args):
    """The serving launcher's rank function (``launch.serve._serve_rank``)
    on this rank, with the launcher's parsed ``args``."""
    from repro_torch.launch import serve as launch
    return launch._serve_rank(ctx.rank, ctx.world, args)


def task_mesh(ctx, shape, axes):
    """``launch.mesh.make_mesh`` on every rank: this rank's coordinates."""
    from repro_torch.launch.mesh import make_mesh
    grid = make_mesh(shape, axes)
    return None if grid is None else dict(
        q=grid.q, pl=grid.pl, m=grid.m, R=grid.R, l=grid.l, t=grid.t,
        grid_rank=grid.grid_rank, model=list(grid.model.members),
        lane=list(grid.ranks))


def assemble(results: list, pl: int) -> dict:
    """Every leaf whole again from the ranks' shards: ("pod","data") leaves
    from all ranks in grid order, "data" leaves from pod 0's, replicated
    leaves from rank 0."""
    first = results[0]
    out = {}
    for path, k in first["dims"].items():
        ax = first["axes"][path]
        if k < 0:
            out[path] = first["shards"][path]
            continue
        ranks = [r for r in results if r is not None]
        if "pod" not in ax:
            ranks = ranks[:pl]
        out[path] = np.concatenate([r["shards"][path] for r in ranks], k)
    return out
