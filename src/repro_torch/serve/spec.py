"""Request-level serving API of the port: ServeSpec, Request, RequestResult.

The three dataclasses of ``repro.serve.spec``, so a caller shapes the port's
engine as it shapes the JAX one, less what only a multi-rank engine uses
(``prefill_len``, ``migrate``, the home pod). This slice serves on one rank:

* ``combine`` (the decode cache combine) resolves to ``"none"`` on one rank,
  as the JAX engine resolves it on one device; it must still be a known
  policy;
* ``seq_axes`` takes only ``"auto"``: there is no rank grid to shard the
  cache over;
* ``fused_stats`` takes only ``"auto"``: the decode-stats kernel for a
  cache on the card, its plain version for a cache on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np

COMBINES = ("auto", "xla", "locality")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Static serving geometry.

    batch:       decode batch rows (the paged cache's row count).
    cache_len:   KV slots per row (prompt + decode budget ceiling).
    combine:     decode cache-combine policy; one rank has none to run.
    fused_stats: "auto" only (see the module docstring).
    seq_axes:    "auto" only (see the module docstring).
    page_len:    paging granularity in KV slots: admission reserves
                 ceil((prompt + max_new) / page_len) pages in one row.
    """

    batch: int
    cache_len: int
    combine: str = "auto"
    fused_stats: str = "auto"
    seq_axes: str | tuple[str, ...] = "auto"
    page_len: int = 16

    def validate(self) -> None:
        """Raise on anything the single-rank engine does not implement."""
        if self.fused_stats != "auto":
            raise ValueError(
                f"fused_stats={self.fused_stats!r}: the port takes only "
                "'auto' (the kernel on CUDA, the plain version on the CPU)")
        if self.combine not in COMBINES:
            raise ValueError(f"unknown combine {self.combine!r}; known: "
                             f"{COMBINES}")
        if self.seq_axes != "auto":
            raise ValueError(f"seq_axes={self.seq_axes!r}: a sequence-sharded "
                             "cache needs the multi-rank serving slice")
        if self.batch < 1 or self.cache_len < 1 or self.page_len < 1:
            raise ValueError(f"batch {self.batch}, cache_len {self.cache_len} "
                             f"and page_len {self.page_len} must be >= 1")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``tokens`` is the (S,) int32 prompt; ``max_new``
    the decode budget; ``arrival_s`` the arrival stamp on the scheduler's
    clock (the clock's now if unset)."""

    tokens: np.ndarray
    max_new: int
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
    the scheduler's clock.
    """

    rid: int
    tokens: np.ndarray
    finish_reason: str
    arrival_s: float
    started_s: float
    finished_s: float
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    slot: int = -1

    @property
    def n_tokens(self) -> int:
        return int(np.asarray(self.tokens).size)
