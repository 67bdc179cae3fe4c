"""Collective inventory of the port, counted where the messages are sent.

The counterpart of ``src/repro/core/hlo_analysis.py``'s ``CollectiveStats``
and ``collective_stats``. The port has no compiled program to scan, so a
:class:`CommRecorder` on each rank's ``RankGrid`` counts what the port's
collectives send, with the same fields and the same accounting:

* **collective-permute** (every point-to-point round): one message per
  edge, of the round's payload bytes; an edge whose ends sit in different
  pods is non-local. Each rank records the edges it sends.
* **group collectives** (all-gather, all-reduce, reduce-scatter over a
  process group): priced under the ring decomposition, as the JAX package
  prices a replica group — (n-1) messages of b/n bytes per link for
  all-gather (b: the gathered bytes), (n-1) of b for reduce-scatter (b: the
  scattered shard), 2(n-1) of b/n for all-reduce; each rank records the
  link to its successor in the group. An all-to-all is direct pairwise
  exchange: each rank records one message of b/n to every other member (b:
  its whole output), each classified by the pair's pods.

Summed over the ranks of a grid, the edge, message and byte counts equal
what ``collective_stats`` reads from the HLO of the same program (a
``lax.scan`` body is counted once there, so a loop's rounds are not).
``counts`` and ``bytes_`` count the calls of this rank, where the HLO
counts each operation of the program once.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

#: ring passes per group collective: one for all-gather or reduce-scatter,
#: two chained (reduce-scatter, then all-gather) for all-reduce
_RING_PASSES = {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 2}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    bytes_: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    # collective-permute: exact per-edge accounting
    permute_edges_local: int = 0
    permute_edges_nonlocal: int = 0
    permute_bytes_local: int = 0
    permute_bytes_nonlocal: int = 0
    # group collectives: ring-decomposition accounting (module docstring)
    group_msgs_local: int = 0
    group_msgs_nonlocal: int = 0
    group_bytes_local: float = 0.0
    group_bytes_nonlocal: float = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_.values())

    @property
    def nonlocal_msgs(self) -> float:
        """Messages crossing a pod boundary: permute edges plus the
        ring-modelled messages of the group collectives."""
        return self.permute_edges_nonlocal + self.group_msgs_nonlocal

    @property
    def nonlocal_bytes(self) -> float:
        return self.permute_bytes_nonlocal + self.group_bytes_nonlocal

    def edge_counts(self) -> dict:
        """The locality-classified fields, for comparing two records."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name.startswith(("permute_", "group_"))}

    def summary(self) -> str:
        lines = [f"  {k:20s} n={self.counts[k]:4d} bytes={self.bytes_[k]:,}"
                 for k in sorted(self.counts)]
        lines.append(f"  permute edges local/nonlocal: "
                     f"{self.permute_edges_local}/{self.permute_edges_nonlocal}"
                     f"  bytes {self.permute_bytes_local:,}/"
                     f"{self.permute_bytes_nonlocal:,}")
        lines.append(f"  group msgs local/nonlocal: "
                     f"{self.group_msgs_local}/{self.group_msgs_nonlocal}"
                     f"  bytes {self.group_bytes_local:,.0f}/"
                     f"{self.group_bytes_nonlocal:,.0f}")
        return "\n".join(lines)


class CommRecorder:
    """Counts one rank's messages; pods are grid rank // ``pl``."""

    def __init__(self, pl: int):
        self.pl = pl
        self.stats = CollectiveStats()

    def reset(self) -> CollectiveStats:
        """Start a new record; returns the one that ends."""
        old, self.stats = self.stats, CollectiveStats()
        return old

    def _local(self, a: int, b: int) -> bool:
        return a // self.pl == b // self.pl

    def permute(self, src: int, dsts: list[int], nbytes: int) -> None:
        """One point-to-point round: this rank (``src``) sends ``nbytes``
        to each of ``dsts`` (grid ranks; empty when it only receives)."""
        st = self.stats
        st.counts["collective-permute"] += 1
        st.bytes_["collective-permute"] += nbytes
        for dst in dsts:
            if self._local(src, dst):
                st.permute_edges_local += 1
                st.permute_bytes_local += nbytes
            else:
                st.permute_edges_nonlocal += 1
                st.permute_bytes_nonlocal += nbytes

    def group(self, op: str, members: tuple[int, ...], index: int,
              nbytes: int) -> None:
        """One group collective over grid ranks ``members`` (this rank at
        ``index``); ``nbytes`` is the per-participant payload as the HLO
        gives it (module docstring)."""
        st = self.stats
        st.counts[op] += 1
        st.bytes_[op] += nbytes
        n = len(members)
        if n <= 1:
            return
        if op == "all-to-all":
            me = members[index]
            for dst in members:
                if dst == me:
                    continue
                if self._local(me, dst):
                    st.group_msgs_local += 1
                    st.group_bytes_local += nbytes / n
                else:
                    st.group_msgs_nonlocal += 1
                    st.group_bytes_nonlocal += nbytes / n
            return
        shard = nbytes if op == "reduce-scatter" else nbytes / n
        msgs = _RING_PASSES[op] * (n - 1)
        if self._local(members[index], members[(index + 1) % n]):
            st.group_msgs_local += msgs
            st.group_bytes_local += msgs * shard
        else:
            st.group_msgs_nonlocal += msgs
            st.group_bytes_nonlocal += msgs * shard
