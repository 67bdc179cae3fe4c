"""Allgather schedule generators — the paper's algorithms in pure python.

Transcribed from ``src/repro/core/schedules.py``; the tests hold every
generator's rounds, sends and buffers equal to the JAX package's.

Each generator *executes* its algorithm over an abstract network and returns
the complete schedule (every point-to-point send of every round) plus the
final buffer contents of every rank. These serve three roles:

  1. Correctness oracle for the ``torch.distributed`` implementations
     (``core/collectives.py``) — same math, independent code.
  2. Input to the postal cost model (``core/cost_model.py``) — the paper's
     Eq. 2 evaluated on *actual* per-rank message/byte counts.
  3. Reproduction of the paper's §4 closed forms (tests assert them).

Algorithms:
  * ``bruck``            — Algorithm 1 (standard Bruck) [Bruck et al. '97]
  * ``ring``             — ring allgather [Chan et al. '07]
  * ``hierarchical``     — master-per-region gather/allgather/bcast [Träff '06]
  * ``multilane``        — one lane per local rank [Träff & Hunold '20]
  * ``locality_bruck``   — Algorithm 2, THE paper's contribution

A "block" is one rank's initial contribution (m/p values). Buffers are lists
of *origin rank ids* in canonical receive order; byte counts are in block
units (multiply by block_bytes for real sizes).
"""
from __future__ import annotations

import dataclasses

from .topology import RegionMap, ceil_log


@dataclasses.dataclass(frozen=True)
class Send:
    src: int
    dst: int
    blocks: tuple[int, ...]   # origin ids moved by this message


@dataclasses.dataclass(frozen=True)
class Round:
    sends: tuple[Send, ...]
    phase: str                # human-readable phase tag


@dataclasses.dataclass
class Schedule:
    p: int
    rounds: list[Round]
    buffers: list[list[int]]  # final buffer (origin ids, canonical order) per rank
    algorithm: str
    region: RegionMap | None = None

    # ---- derived stats (paper §4 terms) ------------------------------------
    def per_rank_stats(self, region: RegionMap | None = None):
        """Returns dict rank -> (n_local, s_local, n_nonlocal, s_nonlocal).

        n = message count, s = blocks sent, split by locality. With no region
        map everything is counted non-local (flat network, paper Eq. 1).
        """
        region = region or self.region
        stats = {r: [0, 0, 0, 0] for r in range(self.p)}
        for rnd in self.rounds:
            for s in rnd.sends:
                local = region.is_local(s.src, s.dst) if region else False
                k = 0 if local else 2
                stats[s.src][k] += 1
                stats[s.src][k + 1] += len(s.blocks)
        return {r: tuple(v) for r, v in stats.items()}

    def max_nonlocal_msgs(self, region: RegionMap | None = None) -> int:
        return max(v[2] for v in self.per_rank_stats(region).values())

    def max_nonlocal_blocks(self, region: RegionMap | None = None) -> int:
        return max(v[3] for v in self.per_rank_stats(region).values())

    def n_rounds(self) -> int:
        return len(self.rounds)

    def validate(self) -> None:
        """Every rank must end with every block exactly once, canonical order."""
        want = list(range(self.p))
        for r, buf in enumerate(self.buffers):
            if sorted(set(buf)) != want:
                missing = set(want) - set(buf)
                raise AssertionError(
                    f"{self.algorithm}: rank {r} buffer incomplete, missing {sorted(missing)[:8]}")
            if buf != want:
                raise AssertionError(
                    f"{self.algorithm}: rank {r} buffer not canonical: {buf[:8]}...")


def _exchange(bufs: list[list[int]], sends: list[Send]) -> None:
    """Apply one round of sends simultaneously (MPI_Isend/Irecv semantics)."""
    incoming: dict[int, list[int]] = {}
    for s in sends:
        incoming.setdefault(s.dst, []).extend(s.blocks)
    for dst, blocks in incoming.items():
        seen = set(bufs[dst])
        bufs[dst].extend(b for b in blocks if b not in seen)


# =============================================================================
# Algorithm 1 — standard Bruck allgather
# =============================================================================
def bruck(p: int, region: RegionMap | None = None) -> Schedule:
    bufs = [[r] for r in range(p)]
    rounds: list[Round] = []
    d = 1
    step = 0
    while d < p:
        cnt = min(d, p - d)
        sends = tuple(
            Send(src=r, dst=(r - d) % p, blocks=tuple(bufs[r][:cnt])) for r in range(p))
        _exchange(bufs, list(sends))
        rounds.append(Round(sends=sends, phase=f"bruck-step{step}"))
        d *= 2
        step += 1
    # final rotation: bruck leaves rank r with [r, r+1, ..., r+p-1] (mod p)
    bufs = [sorted(buf) for buf in bufs]
    return Schedule(p=p, rounds=rounds, buffers=bufs, algorithm="bruck", region=region)


# =============================================================================
# Ring allgather
# =============================================================================
def ring(p: int, region: RegionMap | None = None) -> Schedule:
    bufs = [[r] for r in range(p)]
    last = list(range(p))  # most recently received block per rank
    rounds: list[Round] = []
    for step in range(p - 1):
        sends = tuple(Send(src=r, dst=(r - 1) % p, blocks=(last[r],)) for r in range(p))
        new_last = [last[(r + 1) % p] for r in range(p)]
        _exchange(bufs, list(sends))
        last = new_last
        rounds.append(Round(sends=sends, phase=f"ring-step{step}"))
    bufs = [sorted(buf) for buf in bufs]
    return Schedule(p=p, rounds=rounds, buffers=bufs, algorithm="ring", region=region)


# =============================================================================
# Hierarchical allgather [Träff '06]: gather -> master allgather -> broadcast
# =============================================================================
def hierarchical(p: int, p_local: int) -> Schedule:
    region = RegionMap(p=p, p_local=p_local)
    pl, r = p_local, region.n_regions
    bufs = [[rank] for rank in range(p)]
    rounds: list[Round] = []

    # Phase 1: binomial-tree gather to master (local rank 0) in each region.
    d = 1
    while d < pl:
        sends = []
        for rank in range(p):
            l = region.local_rank_of(rank)
            if l % (2 * d) == d:
                sends.append(Send(src=rank, dst=rank - d, blocks=tuple(bufs[rank])))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"hier-gather-d{d}"))
        d *= 2

    # Phase 2: Bruck allgather among masters only.
    d = 1
    step = 0
    while d < r:
        cnt = min(d, r - d)
        sends = []
        for R in range(r):
            src = region.rank_of(R, 0)
            dst = region.rank_of((R - d) % r, 0)
            # master sends its first cnt *region-blocks* (cnt * pl origin blocks)
            sends.append(Send(src=src, dst=dst, blocks=tuple(bufs[src][: cnt * pl])))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"hier-bruck-step{step}"))
        d *= 2
        step += 1

    # Phase 3: binomial broadcast from master within each region.
    d = 1
    while d < pl:
        sends = []
        for rank in range(p):
            l = region.local_rank_of(rank)
            if l < d and l + d < pl:
                sends.append(Send(src=rank, dst=rank + d, blocks=tuple(bufs[rank])))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"hier-bcast-d{d}"))
        d *= 2

    bufs = [sorted(buf) for buf in bufs]
    return Schedule(p=p, rounds=rounds, buffers=bufs, algorithm="hierarchical", region=region)


# =============================================================================
# Multi-lane allgather [Träff & Hunold '20]
# =============================================================================
def multilane(p: int, p_local: int) -> Schedule:
    region = RegionMap(p=p, p_local=p_local)
    pl, r = p_local, region.n_regions
    bufs = [[rank] for rank in range(p)]
    rounds: list[Round] = []

    # Phase 1: per-lane Bruck over regions (all lanes concurrently; each lane
    # carries only its own block -> non-local bytes reduced by p_local).
    d = 1
    step = 0
    while d < r:
        cnt = min(d, r - d)
        sends = []
        for rank in range(p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            dst = region.rank_of((R - d) % r, l)
            sends.append(Send(src=rank, dst=dst, blocks=tuple(bufs[rank][:cnt])))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"lane-bruck-step{step}"))
        d *= 2
        step += 1

    # Phase 2: local Bruck allgather combining the lanes.
    d = 1
    step = 0
    while d < pl:
        cnt = min(d, pl - d)
        sends = []
        for rank in range(p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            dst = region.rank_of(R, (l - d) % pl)
            sends.append(Send(src=rank, dst=dst, blocks=tuple(bufs[rank][: cnt * r])))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"lane-local-step{step}"))
        d *= 2
        step += 1

    bufs = [sorted(buf) for buf in bufs]
    return Schedule(p=p, rounds=rounds, buffers=bufs, algorithm="multilane", region=region)


# =============================================================================
# Algorithm 2 — locality-aware Bruck allgather (the paper's contribution)
# =============================================================================
def _local_unit_bruck(bufs, region: RegionMap, units: dict[int, tuple[int, ...]],
                      phase: str, rounds: list[Round], contributors: int) -> None:
    """Local allgather of per-rank *units* within each region, in place.

    Faithful to Alg. 2's local step: each contributing rank (local id < g)
    contributes one unit — its newly received chunk (rank 0 re-contributes its
    current group chunk, the paper's "contribute the original data for
    simplicity"). A Bruck allgather runs among the g contributors on whole
    units; a binomial broadcast then fills the idle ranks (the paper's
    MPI_Allgatherv case for non-power region counts).
    """
    pl = region.p_local
    g = contributors
    # Bruck over units among contributors.
    unit_bufs = {rank: [units[rank]] for rank in units}
    d = 1
    while d < g:
        cnt = min(d, g - d)
        sends = []
        moved: list[tuple[int, list[tuple[int, ...]]]] = []
        for rank in range(region.p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            if l >= g:
                continue
            dst = region.rank_of(R, (l - d) % g)
            payload = unit_bufs[rank][:cnt]
            sends.append(Send(src=rank, dst=dst,
                              blocks=tuple(b for u in payload for b in u)))
            moved.append((dst, payload))
        for dst, payload in moved:
            unit_bufs[dst].extend(payload)
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"{phase}-bruck-d{d}"))
        d *= 2
    # Binomial broadcast of the gathered result to idle ranks (g < pl only).
    have = g
    while have < pl:
        sends = []
        for rank in range(region.p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            if l < have and l + have < pl:
                blocks = tuple(b for u in unit_bufs[region.rank_of(R, l % g)] for b in u)
                sends.append(Send(src=rank, dst=region.rank_of(R, l + have), blocks=blocks))
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"{phase}-bcast-{have}"))
        have *= 2


def locality_bruck(p: int, p_local: int) -> Schedule:
    """Paper Algorithm 2, generalized to any region count (allgatherv form).

    Round i (regions covered so far: ``group``): local rank ℓ exchanges its
    buffer with the region ℓ·group away (global distance ℓ·group·p_ℓ,
    matching Alg. 2's dist = id_ℓ · p_ℓ^{i+1} when r is a power of p_ℓ).
    Local rank 0 is idle non-locally (paper §3). A local allgather then
    redistributes the received group buffers inside each region.

    Allgatherv adaptation: lane ℓ sends only the ``min(group, r - ℓ·group)``
    region chunks its peer is actually missing — on the wrapped final round
    of a non-power region count this is a PARTIAL payload (the paper's
    MPI_Allgatherv case), so non-local blocks stay below the full-buffer
    exchange for every region count, not just powers of p_ℓ. Matches the
    executable ``core/collectives.locality_bruck_allgather``.
    """
    region = RegionMap(p=p, p_local=p_local)
    pl, r = p_local, region.n_regions
    if pl == 1:
        # single-rank regions: no lanes to spread over — degenerate to the
        # standard Bruck (matches collectives.locality_bruck_allgather)
        sched = bruck(p, region)
        return dataclasses.replace(sched, algorithm="locality_bruck")
    bufs = [[rank] for rank in range(p)]
    rounds: list[Round] = []

    # Step 0: local Bruck allgather of initial values (Alg. 2 line 1).
    init_units = {rank: (rank,) for rank in range(p)}
    _local_unit_bruck(bufs, region, init_units, "loc-init", rounds, contributors=pl)

    group = 1           # regions whose data each rank currently holds
    i = 0
    while group < r:
        n_groups = -(-r // group)                  # ceil: groups still distinct
        active = min(pl, n_groups)                 # offsets 0..active-1 exist
        # Non-local exchange: one message per rank with local id 1..active-1.
        # Lane ℓ holds chunks [R, R+group) and its peer (region R - ℓ·group)
        # is missing only the first min(group, r - ℓ·group) of them.
        sends = []
        received: dict[int, tuple[int, ...]] = {}
        for rank in range(p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            if l == 0 or l >= active:
                continue  # idle (paper: first process per region idle)
            need = min(group, r - l * group)
            dst = region.rank_of((R - l * group) % r, l)
            blocks = tuple(region.rank_of(R + j, lr)
                           for j in range(need) for lr in range(pl))
            assert set(blocks) <= set(bufs[rank]), (rank, i, need)
            sends.append(Send(src=rank, dst=dst, blocks=blocks))
            received[dst] = blocks
        _exchange(bufs, sends)
        rounds.append(Round(sends=tuple(sends), phase=f"loc-nonlocal-step{i}"))
        # Local redistribution: contributors' units are the chunks just
        # received (local rank 0 re-contributes its own group chunk).
        units = {}
        for rank in range(p):
            l = region.local_rank_of(rank)
            if l == 0:
                units[rank] = tuple(bufs[rank])
            elif l < active:
                units[rank] = received[rank]
        _local_unit_bruck(bufs, region, units, f"loc-redist{i}", rounds,
                          contributors=active)
        group = min(group * active, r)
        i += 1

    bufs = [sorted(buf) for buf in bufs]
    return Schedule(p=p, rounds=rounds, buffers=bufs, algorithm="locality_bruck",
                    region=region)


ALGORITHMS = {
    "bruck": lambda p, pl=None: bruck(p, RegionMap(p, pl) if pl else None),
    "ring": lambda p, pl=None: ring(p, RegionMap(p, pl) if pl else None),
    "hierarchical": lambda p, pl: hierarchical(p, pl),
    "multilane": lambda p, pl: multilane(p, pl),
    "locality_bruck": lambda p, pl: locality_bruck(p, pl),
}


# =============================================================================
# All-to-all oracles — personalized exchange (the MoE dispatch collective)
# =============================================================================
# A block here is a (source, destination) pair, encoded src·p + dst; every
# rank starts owning the p blocks {r·p + d} and must end holding the p blocks
# {s·p + r}. ``Schedule.buffers`` lists the blocks each rank RECEIVED (own
# block r·p+r included); ``validate_all_to_all`` replaces the allgather
# ``Schedule.validate``. ``per_rank_stats`` works unchanged, so the postal
# model prices these schedules through the same ``cost_model.schedule_cost``.


def a2a_block(src: int, dst: int, p: int) -> int:
    return src * p + dst


def validate_all_to_all(sched: Schedule) -> None:
    """Every rank must end with exactly the p blocks addressed to it."""
    p = sched.p
    for r, buf in enumerate(sched.buffers):
        want = [a2a_block(s, r, p) for s in range(p)]
        if sorted(set(buf)) != want:
            missing = set(want) - set(buf)
            raise AssertionError(
                f"{sched.algorithm}: rank {r} missing blocks for sources "
                f"{sorted(b // p for b in missing)[:8]}")


def _a2a_deliver(delivered: list[set], sends: list[Send], p: int) -> None:
    """Credit every block that just reached its destination rank."""
    for s in sends:
        for b in s.blocks:
            if b % p == s.dst:
                delivered[s.dst].add(b)


def xla_all_to_all(p: int, p_local: int | None = None) -> Schedule:
    """Flat direct pairwise exchange — the XLA baseline the analyzer prices:
    p-1 rotation rounds, each rank shipping one block straight to its
    destination (b/p bytes per ordered pair)."""
    region = RegionMap(p, p_local) if p_local else None
    delivered = [{a2a_block(r, r, p)} for r in range(p)]
    rounds: list[Round] = []
    for k in range(1, p):
        sends = [Send(src=r, dst=(r + k) % p,
                      blocks=(a2a_block(r, (r + k) % p, p),))
                 for r in range(p)]
        _a2a_deliver(delivered, sends, p)
        rounds.append(Round(sends=tuple(sends), phase=f"a2a-pairwise-k{k}"))
    return Schedule(p=p, rounds=rounds, buffers=[sorted(d) for d in delivered],
                    algorithm="xla", region=region)


def locality_all_to_all(p: int, p_local: int) -> Schedule:
    """Two-tier all-to-all (collectives.locality_all_to_all's oracle).

    Offsets o ∈ [1, q) are lane-assigned round-robin (offset o → lane
    (o-1) mod p_ℓ, round (o-1) div p_ℓ — Algorithm 2's modular lane
    geometry, partial last round for non-power q). Three phases:
    intra-region collect (each lane accumulates the whole region's blocks
    for its pods), one aggregated p_ℓ²-block inter-region message per
    active lane per round — q-1 DCN messages per region total vs
    p_ℓ²·(q-1) for the flat exchange — then intra-region delivery.
    Local sends are counted unpadded (the executable ships zero-padded
    uniform slabs on the partial round; DCN counts are exact either way).
    """
    region = RegionMap(p=p, p_local=p_local)
    pl, q = p_local, region.n_regions
    delivered = [{a2a_block(r, r, p)} for r in range(p)]
    rounds: list[Round] = []
    nrounds = -(-(q - 1) // pl) if q > 1 else 0

    def lane_offsets(lam: int) -> list[int]:
        return [t * pl + lam + 1 for t in range(nrounds)
                if t * pl + lam + 1 <= q - 1]

    # Phase 1: local collect — rank (R, m) hands lane (m+k)%pl the blocks
    # destined to that lane's assigned pods.
    for k in range(1, pl):
        sends = []
        for R in range(q):
            for m in range(pl):
                lam = (m + k) % pl
                src = region.rank_of(R, m)
                blocks = tuple(
                    a2a_block(src, region.rank_of((R + o) % q, dl), p)
                    for o in lane_offsets(lam) for dl in range(pl))
                if blocks:
                    sends.append(Send(src=src, dst=region.rank_of(R, lam),
                                      blocks=blocks))
        if sends:
            _a2a_deliver(delivered, sends, p)
            rounds.append(Round(sends=tuple(sends), phase=f"a2a-collect-k{k}"))

    # Phase 2: aggregated inter-region rounds (the minimized DCN phase).
    for t in range(nrounds):
        active = min(pl, (q - 1) - t * pl)
        sends = []
        for lam in range(active):
            o = t * pl + lam + 1
            for R in range(q):
                src = region.rank_of(R, lam)
                dst = region.rank_of((R + o) % q, lam)
                blocks = tuple(
                    a2a_block(region.rank_of(R, sm),
                              region.rank_of((R + o) % q, dl), p)
                    for sm in range(pl) for dl in range(pl))
                sends.append(Send(src=src, dst=dst, blocks=blocks))
        _a2a_deliver(delivered, sends, p)
        rounds.append(Round(sends=tuple(sends), phase=f"a2a-nonlocal-t{t}"))

    # Phase 3: local delivery of the received slab columns + own-region blocks.
    for k in range(1, pl):
        sends = []
        for R in range(q):
            for m in range(pl):
                dst_lane = (m + k) % pl
                src = region.rank_of(R, m)
                dst = region.rank_of(R, dst_lane)
                blocks = [a2a_block(src, dst, p)]       # own-region block
                for o in lane_offsets(m):
                    Rs = (R - o) % q
                    blocks.extend(a2a_block(region.rank_of(Rs, sm), dst, p)
                                  for sm in range(pl))
                sends.append(Send(src=src, dst=dst, blocks=tuple(blocks)))
        _a2a_deliver(delivered, sends, p)
        rounds.append(Round(sends=tuple(sends), phase=f"a2a-deliver-k{k}"))
    return Schedule(p=p, rounds=rounds, buffers=[sorted(d) for d in delivered],
                    algorithm="locality", region=region)


#: All-to-all schedule generators, keyed by the canonical algorithm strings
#: (collectives.ALL_TO_ALL_ALGORITHMS).
ALL_TO_ALL_SCHEDULES = {
    "locality": locality_all_to_all,
    "xla": lambda p, pl: xla_all_to_all(p, pl),
}
