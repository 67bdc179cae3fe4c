"""Paged KV-cache accounting for the continuous-batching scheduler.

The port's own copy of ``repro.serve.paged`` (pure Python, no device
arrays). The scheduler builds it with the grid's pods on a batch-sharded
grid (``n_pods=resolved.n_pods``), as the JAX scheduler does, and with
``n_pods=1`` on one rank and on a sequence-parallel cache. Every rank of a
grid keeps the same accounting, in step.

Pure-Python bookkeeping over the physical cache the engine compiled: the
(B, cache_len, ...) cache is viewed as B *rows* (one request each) of
``cache_len // page_len`` *pages*. The accounting is the same for the dense
variants: ``cache_len`` is a request's context limit, and a window layer's
ring of min(cache_len, window) slots holds the last of that context, so a
row's pages count the full-length layers' slots as for any model.  Admission reserves the request's whole
worst case — ceil((prompt_len + max_new) / page_len) pages in one free row
— up front, so:

* **rows never alias**: a row belongs to at most one in-flight request
  (``reserve`` refuses a row that is taken; ``release`` is the only way
  back to the free pool);
* **no admission ever deadlocks or starves**: the queue is served strictly
  FCFS — a request is admitted only if the *head* of the queue is, so a
  small late request can never overtake (and thereby starve) a large early
  one; a request that can never fit (needs more pages than a row has)
  is rejected at submit time, not queued forever.

Row→pod affinity mirrors the batch-sharded layout (contiguous row blocks,
pod-major): ``reserve`` prefers a free row inside the request's home pod
and falls back to any pod — the scheduler then pays a cross-pod cache
migration for the fallback, which is exactly the traffic the
``cache_migrate`` collective cell prices.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RowState:
    rid: int                  # owning request id
    pages: int                # pages reserved (the worst-case footprint)
    home_pod: int             # pod the request asked for
    pod: int                  # pod the row actually lives in


class PagedKVCache:
    """Slot/page accounting; holds no device arrays."""

    def __init__(self, batch: int, cache_len: int, page_len: int,
                 n_pods: int = 1):
        if page_len < 1 or cache_len % page_len != 0:
            raise ValueError(f"page_len {page_len} must divide "
                             f"cache_len {cache_len}")
        self.batch = batch
        self.cache_len = cache_len
        self.page_len = page_len
        self.n_pods = max(1, n_pods)
        self.pages_per_row = cache_len // page_len
        self.rows: dict[int, RowState] = {}          # row -> owner
        self._by_rid: dict[int, int] = {}            # rid -> row

    # ------------------------------------------------------------------
    def pod_of_row(self, row: int) -> int:
        return (row * self.n_pods) // self.batch

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        total = prompt_len + max_new
        return -(-total // self.page_len)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether the request can EVER be admitted (rejecting oversized
        requests at submit keeps the FCFS queue starvation-free)."""
        return self.pages_needed(prompt_len, max_new) <= self.pages_per_row

    @property
    def free_rows(self) -> list[int]:
        return [r for r in range(self.batch) if r not in self.rows]

    @property
    def used_pages(self) -> int:
        return sum(s.pages for s in self.rows.values())

    @property
    def page_budget(self) -> int:
        return self.batch * self.pages_per_row

    # ------------------------------------------------------------------
    def reserve(self, rid: int, prompt_len: int, max_new: int,
                home_pod: int | None = None) -> int | None:
        """Reserve a row for ``rid``; returns the row or None when full.

        Prefers a free row whose pod matches ``home_pod`` (no migration);
        otherwise takes the lowest free row anywhere (the caller pays a
        cross-pod migration). Raises if ``rid`` already holds a row or the
        request cannot fit in any row.
        """
        if rid in self._by_rid:
            raise ValueError(f"request {rid} already holds row "
                             f"{self._by_rid[rid]}")
        pages = self.pages_needed(prompt_len, max_new)
        if pages > self.pages_per_row:
            raise ValueError(
                f"request {rid} needs {pages} pages "
                f"({prompt_len}+{max_new} tokens) but a row holds only "
                f"{self.pages_per_row} (cache_len {self.cache_len})")
        free = self.free_rows
        if not free:
            return None
        row = None
        if home_pod is not None:
            for r in free:
                if self.pod_of_row(r) == home_pod:
                    row = r
                    break
        if row is None:
            row = free[0]
        self.rows[row] = RowState(rid=rid, pages=pages,
                                  home_pod=home_pod if home_pod is not None
                                  else self.pod_of_row(row),
                                  pod=self.pod_of_row(row))
        self._by_rid[rid] = row
        return row

    def release(self, rid: int) -> int:
        """Free ``rid``'s row; returns the row index."""
        row = self._by_rid.pop(rid)
        del self.rows[row]
        return row

    def row_of(self, rid: int) -> int | None:
        return self._by_rid.get(rid)

    def check_invariants(self) -> None:
        """Assert the no-alias invariants (used by the property tests)."""
        rows = list(self._by_rid.values())
        assert len(rows) == len(set(rows)), f"aliased rows: {rows}"
        for rid, row in self._by_rid.items():
            assert self.rows[row].rid == rid
            assert 0 <= row < self.batch
        assert self.used_pages <= self.page_budget
