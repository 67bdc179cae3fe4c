"""Request-level serving API of the port: ServeSpec, Request, RequestResult.

The three dataclasses of ``repro.serve.spec``, so a caller shapes the port's
engine as it shapes the JAX one:

* ``combine`` (the decode cache combine) resolves to ``"none"`` on one rank
  and on a batch-sharded layout, as the JAX engine resolves it; on a
  sequence-parallel cache it must be ``"locality"`` or ``"xla"`` (``"auto"``
  needs the tuning policy, ROADMAP.md Queue 1 item 8);
* ``migrate`` (the cross-pod cache migration of a batch-sharded grid of
  two or more pods) is one of ``MIGRATE_ALGORITHMS``; the port's default
  is ``"locality_bruck"``, since ``"auto"`` resolves through the tuning
  policy's ``cache_migrate`` cell (item 8) and raises where a migration
  could run;
* ``prefill_len`` is carried, and read by nothing, as in the JAX package;
* ``Request.home_pod`` is the pod whose ranks prefill the request (None:
  the pod of the row it gets); ``RequestResult`` reports it (0 for None),
  the row (``slot``) and whether the prefilled cache migrated to another
  pod;
* ``seq_axes`` takes ``"auto"`` (the cache spans every rank, pods too) or
  ``("data",)`` (each pod holds the whole cache over its own ranks);
* ``fused_stats`` takes only ``"auto"``: the decode-stats kernel for a
  cache on the card, its plain version for a cache on the CPU.

On a grid with a "model" tier (``RankGrid.build(q, pl, m)``, every
family; ``models/tp.check_tp`` is the one gate) each model lane
of q·pl ranks takes the layout above, and the cache holds the rank's KV
heads: KV / m of them where m divides KV (the JAX ``cache_shardings`` puts
the heads on "model"), else the heads its q heads read, where the JAX
cache shards the head dim instead and its engine keeps the GSPMD ("xla")
combine (``_combine_eligible``); or its SSD heads' state and conv
channels (the ssm family, whose state is never split over the sequence:
a batch the lane does not divide is held whole on every lane).

The MoE family (qwen2-moe-a2.7b, llama4-scout-17b-a16e) takes both
(pod, data) layouts, every rank holding every expert, as the JAX engine
holds them over its DP axes: its routing is per batch row, so a
batch-sharded rank routes its rows as one rank would and a split-cache
rank runs every expert on the one token. On a model tier each rank holds
E/m routed experts and its shared-expert columns (``models/tp.moe_tp``),
and each model lane takes either layout as above. The dense variants
(``configs.variant_features``: window layers with their ring caches,
softcaps, sandwich norms, ``scale_embed``, GeGLU; h2o-danube-3-4b and
gemma2-9b) take every layout above, on a model tier too.
``cache_len`` stays the request's context limit, as in the JAX package: a
window or chunked layer holds min(cache_len, window or chunk) slots of
it, and each K/V stack (the full-length ``k``/``v``, the rings
``k_ring``/``v_ring``) takes the span of its own length (``stack_spans``,
the JAX ``cache_shardings``'s per-leaf ``_seq_axes_for``): a ring split
over the ranks by its ``total_len``, or held whole on every rank where no
span divides it; a chunked ring's shards combine with the chunk in the
combine's meta.

:meth:`ServeSpec.resolve` binds a spec to a model and a ``RankGrid`` (None:
one rank), as the JAX ``resolve`` binds it to a mesh; the cache layout and
the combine choice it derives (``_cache_layout``, ``_seq_axes_for``,
``resolve_cache_combine``, ``_combine_eligible``: the JAX engine's) live
here with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.collectives import MIGRATE_ALGORITHMS
from ..models.tp import check_tp
from ..models.transformer import FULL_LEAVES, RING_LEAVES, ring_cache_len

COMBINES = ("auto", "xla", "locality")
#: the grid's axes, outer-major, as the JAX package's DP axes ('pod','data')
DP_AXES = ("pod", "data")
SEQ_AXES = ("auto", ("data",))


def normalize_seq_axes(seq_axes) -> str | tuple[str, ...]:
    """``"auto"`` as it is; one axis name or a tuple of them as a tuple."""
    if seq_axes == "auto":
        return seq_axes
    return (seq_axes,) if isinstance(seq_axes, str) else tuple(seq_axes)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Static serving geometry.

    batch:       decode batch rows (the paged cache's row count).
    cache_len:   KV slots per row (prompt + decode budget ceiling).
    prefill_len: carried, unread (see the module docstring).
    combine:     decode cache-combine policy (see the module docstring).
    fused_stats: "auto" only (see the module docstring).
    seq_axes:    sequence-parallel cache domain, "auto" or ("data",).
    page_len:    paging granularity in KV slots: admission reserves
                 ceil((prompt + max_new) / page_len) pages in one row.
    migrate:     cross-pod cache-migration schedule (module docstring).
    """

    batch: int
    cache_len: int
    prefill_len: int | None = None
    combine: str = "auto"
    fused_stats: str = "auto"
    seq_axes: str | tuple[str, ...] = "auto"
    page_len: int = 16
    migrate: str = "locality_bruck"

    def validate(self) -> None:
        """Raise on anything the port's engine does not implement."""
        if self.fused_stats != "auto":
            raise ValueError(
                f"fused_stats={self.fused_stats!r}: the port takes only "
                "'auto' (the kernel on CUDA, the plain version on the CPU)")
        if self.combine not in COMBINES:
            raise ValueError(f"unknown combine {self.combine!r}; known: "
                             f"{COMBINES}")
        if self.migrate != "auto" and self.migrate not in MIGRATE_ALGORITHMS:
            raise ValueError(f"unknown migrate {self.migrate!r}; known: "
                             f"{MIGRATE_ALGORITHMS}")
        if normalize_seq_axes(self.seq_axes) not in SEQ_AXES:
            raise ValueError(f"seq_axes={self.seq_axes!r}: the port takes "
                             f"{SEQ_AXES}")
        if self.batch < 1 or self.cache_len < 1 or self.page_len < 1:
            raise ValueError(f"batch {self.batch}, cache_len {self.cache_len} "
                             f"and page_len {self.page_len} must be >= 1")

    def resolve(self, cfg, grid=None) -> "ResolvedServeSpec":
        """Bind the spec to (cfg, grid): the layout (batch- or
        sequence-sharded), the combine choice and the pod geometry, computed
        once here, so the engine and the scheduler cannot drift on them."""
        self.validate()
        sizes = _axis_sizes(grid)
        check_tp(cfg, sizes["model"], "serve")
        batch_sharded, cand = _cache_layout(grid, self.batch, self.seq_axes)
        seq_span = _seq_axes_for(grid, self.cache_len, cand)
        spans = stack_spans(cfg, grid, self.cache_len, cand)
        choice = _combine_for(
            cfg, grid, self.batch, None if batch_sharded else seq_span,
            None if self.combine == "auto" else self.combine)
        if choice.algorithm == "locality" and not _combine_eligible(
                cfg, grid, spans):
            choice = dataclasses.replace(choice, algorithm="xla")
        if batch_sharded and sizes["pod"] > 1 and self.migrate == "auto":
            raise NotImplementedError(
                "migrate='auto' on a batch-sharded grid of pods resolves "
                "through the tuning policy's cache_migrate cell, which comes "
                "with the tuning slice (ROADMAP.md Queue 1 item 8); pass one "
                f"of {MIGRATE_ALGORITHMS}")
        return ResolvedServeSpec(
            batch_sharded=batch_sharded, seq_span=seq_span,
            combine=choice, n_pods=sizes["pod"], p_local=sizes["data"],
            m=sizes["model"], kv_own=_kv_own(cfg, grid), spans=spans)


@dataclasses.dataclass(frozen=True)
class ResolvedServeSpec:
    """A ServeSpec bound to (cfg, grid): the derived geometry.

    seq_span: the span a full-length cache shards over: ("pod", "data")
              (every rank), ("data",) (each pod's ranks) or None. On a
              batch-sharded grid it is the donor layout of a migrating
              request's B = 1 cache.
    spans:    each K/V stack's span by its leaves' names (``stack_spans``):
              the split cache's layout where the combine is not "none",
              else the donor layout.
    n_pods, p_local: the grid's pods and ranks a pod (of a model lane).
    m:        the model tier's ranks (1: none);
    kv_own:   each tier rank holds KV / m heads of its own (m divides KV);
              otherwise it holds the KV heads its q heads read, which
              other tier ranks hold too.

    A row's pod is ``PagedKVCache.pod_of_row`` of the accounting the
    scheduler builds with ``n_pods`` on a batch-sharded layout (one pod
    otherwise), the JAX ``ResolvedServeSpec.pod_of_row``.
    """

    batch_sharded: bool
    seq_span: tuple[str, ...] | None
    combine: "CombineChoice"
    n_pods: int
    p_local: int
    m: int = 1
    kv_own: bool = True
    spans: dict = dataclasses.field(default_factory=dict)


def _axis_sizes(grid) -> dict[str, int]:
    return {"pod": grid.q if grid else 1, "data": grid.pl if grid else 1,
            "model": getattr(grid, "m", 1) if grid else 1}


def _kv_own(cfg, grid) -> bool:
    """Whether the tier splits the KV heads (the JAX ``kv_m``)."""
    return cfg.n_kv_heads % _axis_sizes(grid)["model"] == 0


def _cache_layout(grid, batch: int, seq_axes="auto"
                  ) -> tuple[bool, tuple[str, ...] | None]:
    """(batch_sharded, seq_axes candidates): the JAX ``_cache_layout`` on
    the grid's two tiers. The batch is sharded when it divides over every
    rank; otherwise the candidates are the axes a B = 1 cache may shard its
    sequence over: ("pod", "data") for ``"auto"``, ("data",) when forced."""
    sizes = _axis_sizes(grid)
    p = sizes["pod"] * sizes["data"]
    batch_sharded = batch % p == 0 and batch >= p
    seq_axes = normalize_seq_axes(seq_axes)
    cand = DP_AXES if seq_axes == "auto" else tuple(
        a for a in seq_axes if a in DP_AXES) or None
    return batch_sharded, cand


def _seq_axes_for(grid, L: int, cand: tuple[str, ...] | None
                  ) -> tuple[str, ...] | None:
    """The widest span a cache of ``L`` slots shards over: the candidates
    when their ranks divide L, the pod's ranks ("data",) when those do,
    else None (the cache is replicated)."""
    if not cand:
        return None
    sizes = _axis_sizes(grid)
    full = 1
    for a in cand:
        full *= sizes[a]
    if full > 1 and L % full == 0:
        return cand
    if "data" in cand and sizes["data"] > 1 and L % sizes["data"] == 0:
        return ("data",)
    return None


def stack_spans(cfg, grid, cache_len: int, cand: tuple[str, ...] | None
                ) -> dict[tuple[str, str], tuple[str, ...] | None]:
    """The span of each K/V stack of the model's attention layers, by its
    leaves' names: ``_seq_axes_for`` of its own length, ``cache_len`` for
    the full-length ``k``/``v``, min(cache_len, window or chunk) for the
    window or chunked layers' ``k_ring``/``v_ring`` (the JAX
    ``cache_shardings``, leaf by leaf)."""
    out = {}
    for spec in cfg.layer_plan():
        if spec.mixer != "attn":
            continue
        ring = ring_cache_len(cfg, spec)
        L = cache_len if ring is None else min(cache_len, ring)
        out[FULL_LEAVES if ring is None else RING_LEAVES] = _seq_axes_for(
            grid, L, cand)
    return out


def _combine_eligible(cfg, grid, spans: dict) -> bool:
    """Whether any decode attention layer takes the combine hook: the JAX
    ``_combine_eligible``. A head-dim-sharded cache (a tier that does not
    split the KV heads, whose head dim it divides) keeps GSPMD's combine;
    otherwise a stack whose span is not None combines."""
    m = _axis_sizes(grid)["model"]
    if m > 1 and not _kv_own(cfg, grid) and cfg.head_dim_ % m == 0:
        return False
    return any(span is not None for span in spans.values())


@dataclasses.dataclass(frozen=True)
class CombineChoice:
    """The resolved decode cache-combine of a sequence-parallel cache.

    algorithm: "locality" (the paper-structured allreduces), "xla" (the
               library's allreduce) or "none" (nothing to combine);
    source:    "explicit" (the spec named it) or "n/a";
    nbytes:    the per-layer stat payload of one step, fp32 o and l:
               B * H * (D + 1) * 4 bytes, H the rank's H / m heads where
               the tier splits the KV heads, as the JAX engine prices it;
    p, p_local: the ranks in the combine, and those of one pod among them.
    """

    algorithm: str
    source: str
    nbytes: int
    p: int
    p_local: int


def resolve_cache_combine(cfg, grid, batch: int, cache_len: int,
                          override: str | None = None,
                          seq_axes="auto") -> CombineChoice:
    """The JAX ``resolve_cache_combine`` without the tuning policy: the
    layout decides whether there is anything to combine; a sequence layout
    needs ``override`` "locality" or "xla" (``"auto"`` resolves through
    the tuning policy, which the port does not have yet)."""
    batch_sharded, cand = _cache_layout(grid, batch, seq_axes)
    span = None if batch_sharded else _seq_axes_for(grid, cache_len, cand)
    return _combine_for(cfg, grid, batch, span, override)


def _combine_for(cfg, grid, batch: int, span: tuple[str, ...] | None,
                 override: str | None) -> CombineChoice:
    """The combine of a cache sharded over ``span`` (None: not sharded).
    A model without attention layers has no cache to split (SSM caches are
    never sequence-sharded) and combines nothing."""
    if override is not None and override not in ("xla", "locality"):
        raise ValueError(f"unknown combine override {override!r}")
    if span is None or not any(s.mixer == "attn" for s in cfg.layer_plan()):
        return CombineChoice("none", "n/a", 0, 1, 1)
    if override is None:
        raise NotImplementedError(
            "combine='auto' on a sequence-parallel cache resolves through "
            "the tuning policy, which comes with the tuning slice "
            "(ROADMAP.md Queue 1 item 8); pass combine='locality' or 'xla'")
    sizes = _axis_sizes(grid)
    p = 1
    for a in span:
        p *= sizes[a]
    H = cfg.n_heads
    if sizes["model"] > 1 and _kv_own(cfg, grid):
        H //= sizes["model"]
    nbytes = batch * H * (cfg.head_dim_ + 1) * 4
    p_local = sizes["data"] if "pod" in span else p
    return CombineChoice(override, "explicit", nbytes, p, p_local)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``tokens`` is the (S,) int32 prompt; ``max_new``
    the decode budget; ``home_pod`` the pod whose ranks prefill it (None:
    the pod of the row it gets); ``arrival_s`` the arrival stamp on the
    scheduler's clock (the clock's now if unset)."""

    tokens: np.ndarray
    max_new: int
    home_pod: int | None = None
    arrival_s: float | None = None
    rid: int | None = None        # assigned by Engine.submit

    def __post_init__(self):
        t = np.asarray(self.tokens, dtype=np.int32)
        if t.ndim != 1 or t.size == 0:
            raise ValueError(f"Request.tokens must be a non-empty 1-D "
                             f"prompt, got shape {t.shape}")
        object.__setattr__(self, "tokens", t)
        if self.max_new < 1:
            raise ValueError("Request.max_new must be >= 1")


@dataclasses.dataclass
class RequestResult:
    """A finished request.

    finish_reason: "length" (decode budget exhausted) or "evicted"
    (cancelled). token_times_s: completion stamp of each generated token on
    the scheduler's clock. home_pod: the request's (0 for None); slot: its
    batch row; migrated: its prefilled cache moved to another pod.
    """

    rid: int
    tokens: np.ndarray
    finish_reason: str
    arrival_s: float
    started_s: float
    finished_s: float
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    home_pod: int = 0
    slot: int = -1
    migrated: bool = False

    @property
    def n_tokens(self) -> int:
        return int(np.asarray(self.tokens).size)
