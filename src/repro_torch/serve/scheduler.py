"""Continuous-batching scheduler of the port.

The loop of ``repro.serve.scheduler.Scheduler``: requests are
admitted FCFS into free cache rows between decode steps (against the paged
accounting of :mod:`.paged`), each admitted request is prefilled at B=1,
its cache row is copied into the live batch cache and its first token
taken, then every step decodes the whole batch once with per-row (B,)
positions and harvests the rows whose budget is spent.

On a CUDA device the decode step is one CUDA graph (:class:`DecodeGraph`),
captured at construction at the fixed batch and cache length and replayed
every step (each layer's meta fixed in the capture: its window, softcap and
ring, the ring's write slot ``pos % L`` computed on the card): the port's counterpart of the JAX scheduler's decode step,
compiled once by ``jax.jit`` with the cache donated. On the CPU every step
runs the forward eagerly, and so does a split cache (below) and a grid
with a model tier, by rule: the tier's allreduces run on the host's side
of the card (a gloo tier stages each through the host), which a graph
cannot capture (``Engine.stats()["decode_graph_rule"]``).

Sequential mode (the engine's cache is split over ranks, a combine other
than "none"): as in the JAX scheduler, one request at a time at B = 1; its
prefill's cache (this rank's slots, a 0-d ``pos``) is the serving cache,
and every decode step runs eagerly through the engine's combine hook (a
host-side exchange per layer cannot be captured in a CUDA graph). The
ranks must take every scheduling decision alike, or the combine deadlocks:
rank 0 decides each admission and broadcasts the request id (or -1: wait)
to every rank of the grid, all q·pl·m of them (``RankGrid.all_group``):
on a model tier the lanes' ranks pair up in the tier's collectives, so
every lane must admit the same request at the same step, whatever its own
clock says, and the others follow. A model tier agrees so in every layout,
also where each lane holds the whole batch (one that its ranks do not
divide, whose state the ssm family never splits over the sequence).

Batch-sharded mode (a grid whose ranks the batch divides over): rank i
holds the rows [i * B_loc, (i + 1) * B_loc), B_loc = B / p, in a cache of
its own, and decodes them every step with no exchange (its own
``DecodeGraph`` on the card). Every rank keeps the same paged accounting
and queue; rank 0 decides each admission and broadcasts it, as in
sequential mode (one broadcast per admission tried while a row is free;
none in a decode step), and requests finish by budget, so releases need no
exchange. An admitted request is prefilled at B = 1 by the ranks of its
pod alone (``home_pod``, else the pod of its row; every rank on one pod),
as the JAX scheduler jits its prefill over the pod's submesh; a prefill
sends nothing. When the row is in that pod its owner copies the row from
its own prefill; otherwise the cache migrates (:mod:`.migrate`, the JAX
``make_migrate_insert_fn`` with its donor move made explicit). A rank
keeps the tokens and stamps of the rows it owns: ``step()`` returns the
requests it owns that finished, and ``drain()`` gathers every finished
request's result from its owner once, at its end (one exchange of the
results over the whole grid; on a model tier the owner's rank of tier 0
gives it), so that every rank returns the same results.

Clocks are injectable: :class:`WallClock` for real latency numbers,
:class:`StepClock` for deterministic replay (on a grid, every rank's clock
advances alike; a WallClock's stamps are the owner's).
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from .migrate import MigrateInsert
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
    dim), the rule of the JAX scheduler; None for the pos leaf. A window
    layer's ring (``k_ring``, ``v_ring``) is a row of the batch like a full
    cache: a prefill's ring rows, already rolled to slot t % L, are copied
    as they are."""
    if name in ("k", "v", "k_ring", "v_ring", "h"):
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
    first eager step would. Python's garbage collector is held off during
    the capture. A capture that fails raises. Launch counts: the
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
        # a garbage collection inside the capture may destroy an earlier
        # graph, which a capture does not permit (it fails): collect before,
        # none during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.logits, _ = model(tok, mode="decode", cache=cache)
        finally:
            if collecting:
                gc.enable()
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
    migrated: bool = False
    owned: bool = True            # this rank holds the row (tokens, stamps)
    n: int = 0                    # tokens generated
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
        self.resolved = engine.resolved
        self.grid = engine.grid
        self.clock = clock or WallClock()
        self.sequential = engine.combine.algorithm != "none"
        if self.sequential and self.spec.batch != 1:
            raise ValueError(
                "sequence-sharded layouts schedule one request at a time: "
                f"batch must be 1, got {self.spec.batch}")
        # batch-sharded over ranks: this rank's rows [lo, lo + local_batch)
        self.sharded = engine.sharded
        self.rank = self.grid.rank if self.sharded else 0
        self.rows_lo, self.local_batch = engine.rows_lo, engine.local_batch
        n_pods = self.resolved.n_pods if self.sharded else 1
        self.paged = PagedKVCache(self.spec.batch, self.spec.cache_len,
                                  self.spec.page_len, n_pods=n_pods)
        self.queue: list[Request] = []       # sorted by (arrival_s, rid)
        self.active: dict[int, _Active] = {}
        self.results: dict[int, RequestResult] = {}
        # batch-sharded: requests that finished since the last gather of
        # the results (the same count on every rank)
        self._ungathered = 0
        self._next_rid = 0
        self._tok = np.zeros((self.local_batch, 1), np.int64)
        self._tok_dev = torch.zeros((self.local_batch, 1), dtype=torch.long,
                                    device=self.model.device)
        # sequential mode: each request's prefill makes the serving cache
        self._cache = None if self.sequential else self.model.empty_cache(
            self.local_batch, self.spec.cache_len, vector_pos=True)
        self.graph_rule = (
            "the model tier's allreduces run on the host's side (gloo "
            "stages them through the host)" if engine.tp is not None else
            "a split cache combines over the grid in every layer"
            if self.sequential else
            "on the CPU every decode step runs eagerly"
            if self.model.device.type != "cuda" else "")
        self._graph = (None if self.graph_rule else
                       DecodeGraph(self.model, self._cache, self._tok_dev))
        # the cross-pod migration, where a row may lie outside its home pod
        self.migrate = MigrateInsert(
            self.grid, self.resolved.seq_span, self.spec.migrate,
            self.model.cache_shapes(1, self.spec.cache_len),
            self.model.device, spans={
                name: span for names, span in self.resolved.spans.items()
                for name in names}) if self.sharded and n_pods > 1 else None
        self.counts = {"decode_steps": 0, "prefills": 0, "prefill_tokens": 0,
                       "decode_tokens": 0, "migrations": 0}

    # -- public API -----------------------------------------------------
    def submit(self, req: Request) -> int:
        """Enqueue; returns the request id (the handle)."""
        if not self.paged.fits(req.tokens.size, req.max_new):
            raise ValueError(
                f"request of {req.tokens.size}+{req.max_new} tokens can "
                f"never fit a {self.spec.cache_len}-slot row")
        if self.migrate is not None and req.home_pod is not None \
                and not 0 <= req.home_pod < self.paged.n_pods:
            raise ValueError(f"home_pod {req.home_pod} outside the grid's "
                             f"{self.paged.n_pods} pods")
        rid = self._next_rid
        self._next_rid += 1
        arrival = req.arrival_s if req.arrival_s is not None \
            else self.clock.now()
        req = dataclasses.replace(req, rid=rid, arrival_s=arrival)
        bisect.insort(self.queue, req, key=lambda r: (r.arrival_s, r.rid))
        return rid

    def cancel(self, rid: int) -> bool:
        """Evict a queued or running request (finish_reason "evicted");
        every rank of a grid cancels alike."""
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
        """Admit what fits, run one decode step, harvest finished rows (on
        a batch-sharded grid, the finished requests this rank owns)."""
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
        """Run until queue and batch are empty; all results by rid, the
        same on every rank of a grid (gathered from their owners here)."""
        while self.queue or self.active:
            self.step()
        self._gather_results()
        return dict(self.results)

    def result(self, rid: int) -> RequestResult | None:
        return self.results.get(rid)

    def stats(self) -> dict:
        out = {**self.counts, "active": len(self.active),
               "queued": len(self.queue), "finished": len(self.results),
               "decode_graph": self._graph is not None,
               "decode_graph_rule": self.graph_rule}
        if self.migrate is not None:
            out.update(self.migrate.stats())
        return out

    # -- internals ------------------------------------------------------
    def _decode(self) -> torch.Tensor:
        """One decode step over this rank's rows (the cache updated in
        place); the logits (B_loc,1,Vpad)."""
        self._tok_dev.copy_(torch.from_numpy(self._tok))
        if self._graph is not None:
            return self._graph.replay()
        logits, _ = self.model(self._tok_dev, mode="decode",
                               cache=self._cache,
                               decode_combine=self.engine.hook)
        return logits

    def _next_token(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy rule of the JAX engine: argmax of the last position,
        clamped below the padded-vocab ids; (B,1) int64 on the host. A
        model rank's logits are its vocabulary's: the tier agrees on the
        token (``TensorParallel.greedy``)."""
        if self.engine.tp is not None:
            return self.engine.tp.greedy(logits,
                                         self.cfg.vocab_size).cpu().numpy()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return torch.clamp(tok, max=self.cfg.vocab_size - 1).cpu().numpy()

    def _agreed(self, rid: int) -> int:
        """Grid rank 0's admission decision (a request id, or -1: wait),
        on every rank of the engine's grid, every lane of a model tier."""
        grid = self.grid
        t = torch.tensor([rid], dtype=torch.long, device=grid.device)
        dist.broadcast(t, src=grid.all_ranks[0], group=grid.all_group)
        return int(t[0])

    def _admit(self) -> None:
        now = self.clock.now()
        # the ranks must decide alike where they exchange in a step: a split
        # cache, sharded rows, or a model tier (whose collectives pair
        # ranks even where every lane holds the whole batch)
        agree = self.sequential or self.sharded or self.engine.tp is not None
        while self.queue:
            if self.sequential and self.active:
                break                      # one request at a time
            if agree and not self.paged.free_rows:
                break                      # full: nothing to agree on
            req = self.queue[0]
            arrived = req.arrival_s <= now
            if agree:
                rid = self._agreed(req.rid if arrived else -1)
                if rid not in (-1, req.rid):
                    raise RuntimeError(
                        f"rank 0 admits request {rid}, this rank's queue "
                        f"starts at {req.rid}: the ranks' queues differ")
                arrived = rid == req.rid
            if not arrived:
                break                      # not arrived yet
            row = self.paged.reserve(req.rid, req.tokens.size, req.max_new,
                                     home_pod=req.home_pod)
            if row is None:
                break                      # FCFS: the head waits, nobody
            self.queue.pop(0)              # overtakes (starvation-free)
            self._start(req, row)
            now = self.clock.now()

    def _owner(self, row: int) -> int:
        """The grid rank that holds batch row ``row``."""
        return row // self.local_batch

    def _start(self, req: Request, row: int) -> None:
        S = int(req.tokens.size)
        # the pod that prefills: the home pod, else the row's (JAX
        # ``_start``); None: every rank (one pod, one rank, a split cache)
        pod = None
        if self.migrate is not None:
            pod = (req.home_pod if req.home_pod is not None
                   else self.paged.pod_of_row(row))
        req_cache = tok0 = None
        if pod is None or self.grid.R == pod:
            toks = torch.from_numpy(req.tokens.astype(np.int64))[None].to(
                self.model.device)
            if self.sequential:
                self._cache = None         # the last request's, freed first
                logits, self._cache = self.model(
                    toks, mode="prefill", cache_len=self.spec.cache_len,
                    shards=self.engine.prefill_shards)
            else:
                logits, req_cache = self.model(toks, mode="prefill",
                                               cache_len=self.spec.cache_len)
            tok0 = int(self._next_token(logits)[0, 0])
            self.counts["prefills"] += 1
            self.counts["prefill_tokens"] += S
        self.clock.advance("prefill")
        owner = self._owner(row) if self.sharded else self.rank
        owned = owner == self.rank
        migrated = pod is not None and self.paged.pod_of_row(row) != pod
        insert = lambda leaves: self._insert(row, leaves)
        if migrated:
            self.counts["migrations"] += 1
            tok0 = self.migrate(req.rid, req_cache, tok0, pod, owner, insert)
        elif owned and not self.sequential:
            insert(req_cache)
        t = self.clock.now()
        st = _Active(req=req, row=row, started_s=t, migrated=migrated,
                     owned=owned)
        self.active[req.rid] = st
        self._append(st, tok0, t)
        if st.n >= req.max_new:
            self._finish(req.rid, "length")

    def _insert(self, row: int, leaves: dict[str, torch.Tensor]) -> None:
        """Copy a B = 1 cache into this rank's row ``row``, every leaf."""
        r = row - self.rows_lo
        for name, leaf in self._cache.items():
            b = _leaf_batch_dim(name, leaf)
            if b is None:
                leaf[r] = leaves[name]
            else:
                leaf.select(b, r).copy_(leaves[name].select(b, 0))

    def _append(self, st: _Active, tok: int | None, t: float) -> None:
        """One generated token of ``st``, recorded where its row lives."""
        st.n += 1
        if st.owned:
            st.tokens.append(tok)
            st.times.append(t)
            self._tok[st.row - self.rows_lo, 0] = tok

    def _harvest(self, nxt: np.ndarray) -> list[RequestResult]:
        t = self.clock.now()
        done = []
        for rid in list(self.active):
            st = self.active[rid]
            tok = int(nxt[st.row - self.rows_lo, 0]) if st.owned else None
            self._append(st, tok, t)
            self.counts["decode_tokens"] += int(st.owned)
            if st.n >= st.req.max_new:
                res = self._finish(rid, "length")
                if res is not None:
                    done.append(res)
        return done

    def _finish(self, rid: int, reason: str) -> RequestResult | None:
        st = self.active.pop(rid)
        self.paged.release(rid)
        return self._finish_meta(rid, st.req, st, reason)

    def _finish_meta(self, rid: int, req: Request, st, reason: str
                     ) -> RequestResult | None:
        """The result, where this rank owns the request's row (or it never
        got one); None where another rank does (``drain`` gathers it)."""
        if st is not None and self.sharded:
            self._ungathered += 1
            if not st.owned:
                return None
        res = RequestResult(
            rid=rid,
            tokens=np.asarray(st.tokens if st else [], np.int32),
            finish_reason=reason,
            arrival_s=req.arrival_s or 0.0,
            started_s=st.started_s if st else self.clock.now(),
            finished_s=self.clock.now(),
            token_times_s=list(st.times) if st else [],
            home_pod=req.home_pod or 0,
            slot=st.row if st else -1,
            migrated=st.migrated if st else False)
        self.results[rid] = res
        return res

    def _gather_results(self) -> None:
        """Every rank's results of the rows it owns, to every rank: one
        exchange over the whole grid, where a request finished since the
        last. The rank of tier 0 speaks for its tier (the tier's ranks own
        the same rows; their stamps follow each one's clock)."""
        if not self._ungathered:
            return
        grid = self.grid
        parts = [None] * (grid.p * grid.m)
        dist.all_gather_object(parts, self.results, group=grid.all_group)
        for part in parts[::grid.m]:                   # grid ranks t = 0
            self.results.update(part)
        self._ungathered = 0
