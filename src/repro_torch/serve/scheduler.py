"""Continuous-batching scheduler of the port.

The loop of ``repro.serve.scheduler.Scheduler``: requests are
admitted FCFS into free cache rows between decode steps (against the paged
accounting of :mod:`.paged`), each admitted request is prefilled at B=1,
its cache row is copied into the live batch cache and its first token
taken, then every step decodes the whole batch once with per-row (B,)
positions and harvests the rows whose budget is spent.

On a CUDA device the decode step is one CUDA graph (:class:`DecodeGraph`),
captured at construction at the fixed batch and cache length and replayed
every step: the port's counterpart of the JAX scheduler's decode step,
compiled once by ``jax.jit`` with the cache donated. On the CPU every step
runs the forward eagerly.

Sequential mode (the engine's cache is split over ranks, a combine other
than "none"): as in the JAX scheduler, one request at a time at B = 1; its
prefill's cache (this rank's slots, a 0-d ``pos``) is the serving cache,
and every decode step runs eagerly through the engine's combine hook (a
host-side exchange per layer cannot be captured in a CUDA graph). The
ranks must take every scheduling decision alike, or the combine deadlocks:
rank 0 decides each admission and broadcasts the request id (or -1: wait)
to the grid, and the others follow.

Clocks are injectable: :class:`WallClock` for real latency numbers,
:class:`StepClock` for deterministic replay.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from .paged import PagedKVCache
from .spec import Request, RequestResult


class WallClock:
    """Real time; ``idle_until`` naps toward the next arrival."""

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, kind: str) -> None:   # wall time advances itself
        pass

    def idle_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(min(dt, 0.05))


class StepClock:
    """Deterministic virtual clock: each decode step / prefill advances time
    by a fixed cost, so stamps are exact functions of trace and schedule."""

    def __init__(self, decode_cost: float = 1.0, prefill_cost: float = 1.0):
        self.t = 0.0
        self.decode_cost = decode_cost
        self.prefill_cost = prefill_cost

    def now(self) -> float:
        return self.t

    def advance(self, kind: str) -> None:
        self.t += self.prefill_cost if kind == "prefill" else self.decode_cost

    def idle_until(self, t: float) -> None:
        self.t = max(self.t, t)


def _leaf_batch_dim(name: str, leaf: torch.Tensor) -> int | None:
    """Batch dim of a cache leaf (stacked leaves carry a leading layer
    dim), the rule of the JAX scheduler; None for the pos leaf."""
    if name in ("k", "v", "h"):
        return leaf.ndim - 4
    if name == "conv":
        return leaf.ndim - 3
    if name == "pos":
        return None
    raise ValueError(f"unknown cache leaf {name!r}")


class DecodeGraph:
    """``model``'s decode forward over ``cache`` and the token buffer
    ``tok``, captured in a CUDA graph; :meth:`replay` runs one step.

    The forward updates the cache in place (``pos`` included), so the graph
    reads and writes the caller's tensors at fixed addresses. Two eager
    warm-up steps first build the kernels and the libraries' handles (no
    build may happen inside the capture); they write the cache, which is
    zeroed again before the capture, so the first replay sees what the
    first eager step would. A capture that fails raises. Launch counts: the
    wrappers count the launches they record into the graph; those are taken
    off again, and each replay adds them.
    """

    def __init__(self, model, cache: dict[str, torch.Tensor],
                 tok: torch.Tensor):
        device = tok.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                model(tok, mode="decode", cache=cache)
        torch.cuda.current_stream(device).wait_stream(side)
        for leaf in cache.values():
            leaf.zero_()
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model(tok, mode="decode", cache=cache)
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        kernels.add_launch_counts(self.launches, -1)   # recorded, not run

    def replay(self) -> torch.Tensor:
        """One decode step; the logits (B,1,Vpad), overwritten by the next."""
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return self.logits


@dataclasses.dataclass
class _Active:
    req: Request
    row: int
    started_s: float
    tokens: list = dataclasses.field(default_factory=list)
    times: list = dataclasses.field(default_factory=list)


class Scheduler:
    """Continuous-batching loop over an Engine's model and batch cache.

    Use through ``Engine.submit / step / drain``. ``step()``: admit (FCFS
    while a row is free and the queue head has arrived) -> one decode step
    over the batch -> harvest finished rows.
    """

    def __init__(self, engine, *, clock=None):
        self.engine = engine
        self.model = engine.model
        self.cfg = engine.cfg
        self.spec = engine.spec
        self.clock = clock or WallClock()
        self.sequential = engine.combine.algorithm != "none"
        if self.sequential and self.spec.batch != 1:
            raise ValueError(
                "sequence-sharded layouts schedule one request at a time: "
                f"batch must be 1, got {self.spec.batch}")
        self.paged = PagedKVCache(self.spec.batch, self.spec.cache_len,
                                  self.spec.page_len, n_pods=1)
        self.queue: list[Request] = []       # sorted by (arrival_s, rid)
        self.active: dict[int, _Active] = {}
        self.results: dict[int, RequestResult] = {}
        self._next_rid = 0
        self._tok = np.zeros((self.spec.batch, 1), np.int64)
        self._tok_dev = torch.zeros((self.spec.batch, 1), dtype=torch.long,
                                    device=self.model.device)
        # sequential mode: each request's prefill makes the serving cache
        self._cache = None if self.sequential else self.model.empty_cache(
            self.spec.batch, self.spec.cache_len, vector_pos=True)
        self._graph = (DecodeGraph(self.model, self._cache, self._tok_dev)
                       if self.model.device.type == "cuda"
                       and not self.sequential else None)
        self.counts = {"decode_steps": 0, "prefills": 0, "prefill_tokens": 0,
                       "decode_tokens": 0}

    # -- public API -----------------------------------------------------
    def submit(self, req: Request) -> int:
        """Enqueue; returns the request id (the handle)."""
        if not self.paged.fits(req.tokens.size, req.max_new):
            raise ValueError(
                f"request of {req.tokens.size}+{req.max_new} tokens can "
                f"never fit a {self.spec.cache_len}-slot row")
        rid = self._next_rid
        self._next_rid += 1
        arrival = req.arrival_s if req.arrival_s is not None \
            else self.clock.now()
        req = dataclasses.replace(req, rid=rid, arrival_s=arrival)
        bisect.insort(self.queue, req, key=lambda r: (r.arrival_s, r.rid))
        return rid

    def cancel(self, rid: int) -> bool:
        """Evict a queued or running request (finish_reason "evicted")."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                self._finish_meta(rid, req, None, "evicted")
                return True
        st = self.active.pop(rid, None)
        if st is not None:
            self.paged.release(rid)
            self._finish_meta(rid, st.req, st, "evicted")
            return True
        return False

    def step(self) -> list[RequestResult]:
        """Admit what fits, run one decode step, harvest finished rows."""
        self._admit()
        if not self.active:
            if self.queue:
                self.clock.idle_until(self.queue[0].arrival_s)
                self._admit()
            if not self.active:
                return []
        nxt = self._next_token(self._decode())
        self.clock.advance("decode")
        self.counts["decode_steps"] += 1
        return self._harvest(nxt)

    def drain(self) -> dict[int, RequestResult]:
        """Run until queue and batch are empty; all results by rid."""
        while self.queue or self.active:
            self.step()
        return dict(self.results)

    def result(self, rid: int) -> RequestResult | None:
        return self.results.get(rid)

    def stats(self) -> dict:
        return {**self.counts, "active": len(self.active),
                "queued": len(self.queue), "finished": len(self.results)}

    # -- internals ------------------------------------------------------
    def _decode(self) -> torch.Tensor:
        """One decode step over the whole batch (the cache updated in
        place); the logits (B,1,Vpad)."""
        self._tok_dev.copy_(torch.from_numpy(self._tok))
        if self._graph is not None:
            return self._graph.replay()
        logits, _ = self.model(self._tok_dev, mode="decode",
                               cache=self._cache,
                               decode_combine=self.engine.hook)
        return logits

    def _next_token(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy rule of the JAX engine: argmax of the last position,
        clamped below the padded-vocab ids; (B,1) int64 on the host."""
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return torch.clamp(tok, max=self.cfg.vocab_size - 1).cpu().numpy()

    def _agreed(self, rid: int) -> int:
        """Rank 0's admission decision (a request id, or -1: wait), on
        every rank of the engine's grid."""
        grid = self.engine.grid
        t = torch.tensor([rid], dtype=torch.long, device=grid.device)
        dist.broadcast(t, src=grid.global_rank(0), group=grid.group)
        return int(t[0])

    def _admit(self) -> None:
        now = self.clock.now()
        while self.queue:
            if self.sequential and self.active:
                break                      # one request at a time
            req = self.queue[0]
            arrived = req.arrival_s <= now
            if self.sequential:
                rid = self._agreed(req.rid if arrived else -1)
                if rid not in (-1, req.rid):
                    raise RuntimeError(
                        f"rank 0 admits request {rid}, this rank's queue "
                        f"starts at {req.rid}: the ranks' queues differ")
                arrived = rid == req.rid
            if not arrived:
                break                      # not arrived yet
            row = self.paged.reserve(req.rid, req.tokens.size, req.max_new)
            if row is None:
                break                      # FCFS: the head waits, nobody
            self.queue.pop(0)              # overtakes (starvation-free)
            self._start(req, row)
            now = self.clock.now()

    def _start(self, req: Request, row: int) -> None:
        S = int(req.tokens.size)
        toks = torch.from_numpy(req.tokens.astype(np.int64))[None].to(
            self.model.device)
        if self.sequential:
            self._cache = None             # the last request's, freed first
            logits, self._cache = self.model(
                toks, mode="prefill", cache_len=self.engine.cache_len,
                slot_offset=self.engine.cache_offset)
        else:
            logits, req_cache = self.model(toks, mode="prefill",
                                           cache_len=self.spec.cache_len)
        tok0 = self._next_token(logits)
        self.clock.advance("prefill")
        self.counts["prefills"] += 1
        self.counts["prefill_tokens"] += S
        if not self.sequential:
            # insert the request's row into the live batch cache, every leaf
            for name, leaf in self._cache.items():
                b = _leaf_batch_dim(name, leaf)
                if b is None:
                    leaf[row] = S
                else:
                    leaf.select(b, row).copy_(req_cache[name].select(b, 0))
        t = self.clock.now()
        st = _Active(req=req, row=row, started_s=t)
        st.tokens.append(int(tok0[0, 0]))
        st.times.append(t)
        self._tok[row, 0] = st.tokens[-1]
        self.active[req.rid] = st
        if len(st.tokens) >= req.max_new:
            self._finish(req.rid, "length")

    def _harvest(self, nxt: np.ndarray) -> list[RequestResult]:
        t = self.clock.now()
        done = []
        for rid in list(self.active):
            st = self.active[rid]
            st.tokens.append(int(nxt[st.row, 0]))
            st.times.append(t)
            self.counts["decode_tokens"] += 1
            self._tok[st.row, 0] = st.tokens[-1]
            if len(st.tokens) >= st.req.max_new:
                done.append(self._finish(rid, "length"))
        return done

    def _finish(self, rid: int, reason: str) -> RequestResult:
        st = self.active.pop(rid)
        self.paged.release(rid)
        return self._finish_meta(rid, st.req, st, reason)

    def _finish_meta(self, rid: int, req: Request, st, reason: str
                     ) -> RequestResult:
        res = RequestResult(
            rid=rid,
            tokens=np.asarray(st.tokens if st else [], np.int32),
            finish_reason=reason,
            arrival_s=req.arrival_s or 0.0,
            started_s=st.started_s if st else self.clock.now(),
            finished_s=self.clock.now(),
            token_times_s=list(st.times) if st else [],
            slot=st.row if st else -1)
        self.results[rid] = res
        return res
