"""Serving engine of the port: the request-level ``submit / step / drain``
API over one rank or a grid of ranks.

``Engine(cfg, params, spec, grid=None, device=None, clock=None)`` holds the
model in ``cfg.dtype`` (bf16 for the published configs, as the JAX engine
casts its fp32 parameters) and a :class:`~.scheduler.Scheduler`. It runs on
the card: with ``device=None`` it takes ``cuda`` and raises when no CUDA
device is visible; ``device="cpu"`` runs the kernels' plain versions, which
is what the tests ask for.

The dense variants (h2o-danube-3-4b, gemma2-9b: window layers with ring
caches, softcaps, sandwich norms, GeGLU, scaled embeddings) serve like
llama in every layout below: on one rank their decode is one CUDA graph a
step; on a grid each K/V stack, the full-length ``k``/``v`` and the rings
``k_ring``/``v_ring`` of min(cache_len, window) slots, is split over the
span of its own length (``ResolvedServeSpec.spans``), and a stack that no
span divides is held whole on every rank and attended as on one rank.
llama4-scout-17b-a16e serves so too: its chunked layers' rings hold
min(cache_len, chunk) slots each and keep the current chunk's tokens, its
NoPE layers the full-length cache. The MoE family (qwen2-moe-a2.7b,
llama4) takes the (pod, data) layouts below with every expert on every
rank, and the model tier with E/m experts a rank; its decode on one rank
is one CUDA graph a step.

On a :class:`~repro_torch.core.topology.RankGrid` every rank builds the
same engine and submits the same requests. A batch that divides over the
ranks is sharded over them (the JAX engine's batch-sharded layout): rank i
holds the rows [i * B_loc, (i + 1) * B_loc), B_loc = B / p, pod-major, in a
cache of its own, prefills the requests of its pod and decodes its rows
with no exchange; a request prefilled in another pod than its row's
migrates (``serve/scheduler.py``, ``serve/migrate.py``). A B = 1 cache is
split over the ranks' sequence (the JAX engine's sequence-parallel layout,
``cache_shardings``): rank (R, l) of a q x pl grid holds the slots
[i * L_loc, (i + 1) * L_loc), i = R * pl + l, pod-major, over
``("pod", "data")``, or i = l over ``("data",)``, where each pod holds the
whole cache (each stack by its own span and L_loc: :class:`CacheShard`).
Every rank prefills the whole prompt with the same kernels and keeps its
own slots; every decode attention layer of a split stack combines the
ranks' partial softmax stats over its span's grid in
:class:`LocalityDecodeCombine`, the counterpart of the JAX
``_make_locality_decode_combine``.

On a grid with a "model" tier (``RankGrid.build(q, pl, m)``) each rank
holds its part of the model (``models/tp.TensorParallel``: its q heads and
the KV heads they read, its MLP columns, its routed experts and
shared-expert columns, or its SSD heads; its vocabulary rows; the
row-parallel products, a MoE layer's one sum, the embedding, the gated
norm's statistic and the greedy token go over the tier), and each model
lane of
q·pl ranks serves as a grid of its own in one of the layouts above: rows
by lane rank, the combine and the migration over the lane, with the
rank's KV heads or SSD heads.

A gloo grid moves CPU tensors, so on the card the combine stages its fp32
payload (the maxima, then the packed [o, l]) to the host and back: the
transport of a host-side group, counted in :meth:`Engine.stats` as
``staging_bytes``; an NCCL grid moves CUDA tensors and stages nothing.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core import collectives as C
from ..kernels.decode_stats import ops as stats_ops
from ..models import attention as attn
from ..models.tp import TensorParallel
from ..models.transformer import RING_LEAVES, Transformer
from .migrate import sent_of, stage
from .scheduler import Scheduler
from .spec import DP_AXES, Request, RequestResult, ServeSpec


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless the caller names a device; never falls back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port serves on the "
                           "card (pass device='cpu' to run the plain "
                           "versions of its kernels on the CPU)")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """This rank's shard of one K/V stack of a split cache: the slots
    [offset, offset + length) of the stack's ``total``, shard ``index`` of
    the ``grid`` (the whole grid, or the pod's) its layers combine over."""

    grid: Any
    index: int
    length: int
    total: int

    @property
    def offset(self) -> int:
        return self.index * self.length


class LocalityDecodeCombine:
    """The ``decode_combine`` hook of a sequence-parallel rank.

    Per decode attention layer, the steps of the JAX region (``engine.py``
    ``_make_locality_decode_combine``), the accumulation queued before the
    max exchange, which it does not need, so that the card runs it while
    the host exchanges:

      1. the token's key and value are written into this rank's shard only
         when it owns slot ``pos`` (``pos % total`` on a ring:
         ``attention.write_cache`` with the shard's offset and total);
      2. the scores kernel gives the masked scores and their max over the
         shard (``decode_scores`` at the slot offset: NEG_INF where the
         shard keeps no slot);
      3. the maxima's copy to the host, then the accumulation kernel
         (o, l), are queued on the stream before any exchange, and the
         host waits for the copy alone;
      4. ``logsumexp_combine_start`` runs the max-allreduce over the grid
         while the card accumulates;
      5. ``logsumexp_combine_finish`` rescales and sums the packed [o, l];
      6. o / l, cast to the cache dtype.

    ``shards`` maps a layer's ``meta["ring"]`` to its stack's
    :class:`CacheShard`; a layer of a stack not in it (held whole on every
    rank) is left to the plain path (the hook returns None, the JAX
    region's fallback). Counters: the layers it ran, the
    host seconds spent in it and, of those, in the two halves of the
    combine's exchange, what the exchanges sent (``sent``: bytes, non-local
    bytes, non-local messages, read from each combine grid's recorder
    around them, so no other user of the grid counts) and the bytes staged
    between the card and a gloo grid's host tensors.
    """

    def __init__(self, shards: dict[bool, CacheShard], algorithm: str):
        self.shards, self.algorithm = shards, algorithm
        self.layers = 0
        self.host_s = 0.0
        self.exchange_s = 0.0
        self.sent = (0.0, 0.0, 0.0)
        self.staging_bytes = 0

    def __call__(self, q, k_new, v_new, k_cache, v_cache, pos, meta):
        shard = self.shards.get(meta["ring"])
        if shard is None:
            return None
        t0 = time.perf_counter()
        grid = shard.grid
        mask = dict(slot_offset=shard.offset, total_len=shard.total,
                    ring=meta["ring"])
        attn.write_cache(k_cache, k_new, pos, **mask)
        attn.write_cache(v_cache, v_new, pos, **mask)
        mask.update(window=meta["window"], chunk=meta["chunk"])
        s, m = stats_ops.decode_scores(q, k_cache, pos, cap=meta["cap"],
                                       **mask)
        m_host, m_ready = self._copy_out(m, grid)
        o, l = stats_ops.accumulate(s, m, v_cache, pos=pos, **mask)
        B, KV, G = m.shape
        n_o = o.numel()
        if m_ready is not None:
            m_ready.synchronize()
        sent = lambda: sent_of(grid.recorder.stats.edge_counts())
        t1, sent0 = time.perf_counter(), sent()
        pend = C.logsumexp_combine_start(m_host.reshape(B, 1, KV * G),
                                         grid, algorithm=self.algorithm)
        self.exchange_s += time.perf_counter() - t1
        ol = self._stage(torch.cat([o.reshape(-1), l.reshape(-1)]),
                         grid.device)
        t1 = time.perf_counter()
        o, l = C.logsumexp_combine_finish(ol[:n_o].reshape(o.shape),
                                          ol[n_o:].reshape(l.shape), pend)
        self.exchange_s += time.perf_counter() - t1
        self.sent = tuple(t + b - a for t, a, b in zip(self.sent, sent0,
                                                       sent()))
        ol = self._stage(torch.cat([o.reshape(-1), l.reshape(-1)]),
                         q.device)
        out = (ol[:n_o].reshape(o.shape) / ol[n_o:].reshape(l.shape)[..., None]
               ).to(v_cache.dtype)
        self.layers += 1
        self.host_s += time.perf_counter() - t0
        return out, k_cache, v_cache

    def _copy_out(self, t: torch.Tensor, grid):
        """(host copy of ``t``, the event that marks it done): a copy into
        pinned memory queued on the stream behind what produced ``t``, so
        the work queued after it runs while the host waits for the copy
        alone; (t, None) when ``grid`` takes ``t`` where it is."""
        if t.device.type == grid.device.type:
            return t, None
        self.staging_bytes += t.numel() * t.element_size()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _stage(self, t: torch.Tensor, device) -> torch.Tensor:
        t, n = stage(t, device)
        self.staging_bytes += n
        return t


class Engine:
    """Greedy serving engine over the port's transformer, on one rank or
    on every rank of a grid (module docstring)."""

    def __init__(self, cfg, params: dict, spec: ServeSpec, *, grid=None,
                 device: torch.device | str | None = None, clock=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec
        self.grid = grid
        self.resolved = spec.resolve(cfg, grid)
        self.combine = self.resolved.combine
        # batch-sharded over ranks: rank i holds rows [i * B_loc, ...)
        self.sharded = (grid is not None and grid.p > 1
                        and self.resolved.batch_sharded)
        self.local_batch = spec.batch // grid.p if self.sharded \
            else spec.batch
        self.rows_lo = grid.rank * self.local_batch if self.sharded else 0
        self.tp = self.tier_meter = None
        if grid is not None and grid.m > 1:
            from ..train.step import CommMeter      # train.step imports us
            self.tier_meter = CommMeter()
            self.tp = TensorParallel.build(cfg, grid, meter=self.tier_meter,
                                           use="serve")
        self.model = Transformer(cfg, params, self.device, tp=self.tp)
        self.hook: LocalityDecodeCombine | None = None
        # a split cache: each K/V stack's shard on this rank (a stack held
        # whole is not named); cache_len and cache_offset are the
        # full-length cache's shard
        self.shards: dict[tuple[str, str], CacheShard] = {}
        self.cache_len, self.cache_offset = spec.cache_len, None
        if self.combine.algorithm != "none":
            on = {DP_AXES: (grid, grid.rank),
                  ("data",): (grid.pod_grid(), grid.l)}
            lens = self.model.stack_lens(spec.cache_len)
            for names, span in self.resolved.spans.items():
                if span is not None:
                    cgrid, i = on[span]
                    self.shards[names] = CacheShard(
                        cgrid, i, lens[names] // cgrid.p, lens[names])
            cgrid, i = on[self.resolved.seq_span]
            self.cache_len = spec.cache_len // cgrid.p
            self.cache_offset = i * self.cache_len
            by_ring = {names == RING_LEAVES: sh
                       for names, sh in self.shards.items()}
            self.hook = LocalityDecodeCombine(by_ring, self.combine.algorithm)
        self.scheduler = Scheduler(self, clock=clock)

    @property
    def prefill_shards(self) -> dict[tuple[str, str], tuple[int, int]]:
        """What a prefill on this rank keeps of each split stack: its
        (offset, length) (``Transformer.forward``'s ``shards``)."""
        return {names: (sh.offset, sh.length)
                for names, sh in self.shards.items()}

    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its handle (the request id)."""
        return self.scheduler.submit(request)

    def step(self) -> list[RequestResult]:
        """Admit what fits, decode one step; the requests that finished."""
        return self.scheduler.step()

    def drain(self) -> dict[int, RequestResult]:
        """Run until every submitted request finished; results by handle."""
        return self.scheduler.drain()

    def cancel(self, rid: int) -> bool:
        return self.scheduler.cancel(rid)

    def result(self, rid: int) -> RequestResult | None:
        return self.scheduler.result(rid)

    def generate(self, prompts, max_new: int) -> np.ndarray:
        """prompts (B, S) int: (B, max_new) greedy tokens, on every rank.

        The legacy lockstep loop of the JAX engine (behind the same
        ``DeprecationWarning``): the batch prefills together and decodes
        ``max_new`` steps (the last one's token is not kept, as there).
        Batch-sharded, each rank prefills and decodes its own rows and the
        tokens are gathered to every rank over the grid; a split cache
        prefills its slots and decodes through the combine."""
        warnings.warn(
            "Engine.generate is the legacy lockstep loop; use "
            "Engine.submit/step/drain", DeprecationWarning, stacklevel=2)
        prompts = np.asarray(prompts)
        if prompts.ndim != 2 or prompts.shape[0] != self.spec.batch:
            raise ValueError(f"prompts of shape {prompts.shape}: want "
                             f"({self.spec.batch}, S)")
        rows = prompts[self.rows_lo:self.rows_lo + self.local_batch]
        sched = self.scheduler
        toks = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        logits, cache = self.model(toks, mode="prefill",
                                   cache_len=self.spec.cache_len,
                                   shards=self.prefill_shards)
        sched.counts["prefills"] += 1
        sched.counts["prefill_tokens"] += rows.size
        tok = sched._next_token(logits)
        out = []
        for _ in range(max_new):
            out.append(tok)
            logits, cache = self.model(torch.from_numpy(tok).to(self.device),
                                       mode="decode", cache=cache,
                                       decode_combine=self.hook)
            tok = sched._next_token(logits)
            sched.counts["decode_steps"] += 1
        out = np.concatenate(out, axis=1)
        if self.sharded:
            mine = torch.from_numpy(out).to(self.grid.device)
            parts = [torch.empty_like(mine) for _ in range(self.grid.p)]
            dist.all_gather(parts, mine, group=self.grid.group)
            out = torch.cat(parts).cpu().numpy()
        return out

    def stats(self) -> dict:
        """Counters: decode steps, prefills, prefill tokens (prompt tokens
        prefilled) and decode tokens (tokens the decode steps produced for
        live rows), the queue's state, and the combine's, with the JAX
        engine's keys: ``combine_steps`` (decode steps that combined),
        ``combine_bytes`` (bytes this rank sent in the combines),
        ``nonlocal_bytes`` and ``nonlocal_msgs`` (those crossing a pod),
        counted by the combine grid's ``CommRecorder`` (the JAX engine
        reads them from its compiled program); then ``combine_layers``,
        ``combine_host_s`` (host seconds inside the hook) and
        ``combine_exchange_s`` (of those, in the max and sum exchanges)
        and ``staging_bytes`` (moved between the card and a gloo grid, by
        the combine and the migrations); ``decode_graph`` (whether a decode
        step replays a CUDA graph) and ``decode_graph_rule`` (why not, by
        the scheduler's rule); on a model tier ``tier_calls``,
        ``tier_host_s``, ``tier_staged_bytes`` (the tier's collectives: the
        embedding, two row-parallel sums a layer, the greedy token's
        gather) and the tier recorder's ``tier_msgs``, ``tier_bytes`` and
        ``tier_nonlocal_msgs``. Batch-sharded, every count is this
        rank's (the prefills it ran, the tokens of its rows), and over
        pods: ``migrations``, the collective's ``migrate_bytes``,
        ``migrate_nonlocal_bytes`` and ``migrate_nonlocal_msgs`` (read
        around it alone), the donor move's ``donor_bytes``,
        ``donor_nonlocal_bytes`` and ``donor_nonlocal_msgs``, and
        ``migrate_host_s`` with its ``migrate_donor_s``,
        ``migrate_collective_s`` and ``migrate_insert_s``."""
        out = self.scheduler.stats()
        staged = out.pop("migrate_staging_bytes", 0)
        hook = self.hook
        sent = hook.sent if hook else (0.0, 0.0, 0.0)
        out.update(
            combine_steps=out["decode_steps"] if hook else 0,
            combine_bytes=sent[0], nonlocal_bytes=sent[1],
            nonlocal_msgs=sent[2],
            combine_layers=hook.layers if hook else 0,
            combine_host_s=hook.host_s if hook else 0.0,
            combine_exchange_s=hook.exchange_s if hook else 0.0,
            staging_bytes=(hook.staging_bytes if hook else 0) + staged)
        mt = self.tier_meter
        if mt is not None:
            st = mt.model_stats
            out.update(tier_calls=mt.model_calls, tier_host_s=mt.model_s,
                       tier_staged_bytes=mt.model_staged_bytes,
                       tier_msgs=st.group_msgs_local + st.group_msgs_nonlocal,
                       tier_bytes=(st.group_bytes_local
                                   + st.group_bytes_nonlocal),
                       tier_nonlocal_msgs=st.nonlocal_msgs)
        return out
