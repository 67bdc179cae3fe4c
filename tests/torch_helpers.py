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

    def grid(self, q: int, pl: int):
        from repro_torch.core.topology import RankGrid
        if (q, pl) not in self._grids:
            self._grids[q, pl] = RankGrid.build(q, pl)
        grid = self._grids[q, pl]
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


def task_vocabulary(ctx, q, pl, seed):
    """collective()/Collective dispatch against the family functions, and
    the errors of what is not ported."""
    import torch
    from repro_torch.core import collectives as C
    grid = ctx.grid(q, pl)
    if grid is None:
        return None
    x = _torch(ints(seed, (grid.p, 4, 2))[grid.rank], "float32")
    same = {
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
    }
    errors = {}
    calls = {
        "all_to_all": lambda: C.collective("all_to_all", x, grid=grid),
        "combine": lambda: C.collective("combine", x, x, x, grid=grid),
        "logsumexp_combine": lambda: C.collective("logsumexp_combine", x,
                                                  grid=grid),
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
