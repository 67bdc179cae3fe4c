"""Compile a ``core.schedules.Schedule`` into dense per-rank DMA rounds.

Transcribed from ``src/repro/kernels/dma_allgather/schedule_compile.py``;
the tests hold its tables equal to the JAX package's.

The kernel executes R rounds; in round r rank i reads its row of the
schedule table: [target_rank, send_off, recv_off, send_flag, recv_flag]
(offsets in blocks). Sizes are uniform per round (asserted). A final
per-rank permutation restores canonical block order (the Bruck rotation,
generalized).

Unlike the message-level simulator (core/schedules.py), a DMA engine cannot
deduplicate on receive: every received slice is appended verbatim. Rounds
that re-send already-held blocks (the paper's "lane 0 re-contributes its
data for simplicity", and the broadcast to idle lanes) therefore grow the
buffer past p blocks; the capacity is the max over ranks of the final append
count and the canonicalization perm picks the first occurrence of each
origin block.

One check is the port's own: in no round does a rank's write range
``[recv_off, recv_off + size)`` in its target's buffer overlap a range that
the target reads in the same round. ``execute_table`` snapshots its reads
and would not show such an overlap.

The port's kernel executes the *folded* table (``DmaSchedule.folded``):
the same messages, with the final permutation folded in at compile time.
Each rank's output row ``out[i]`` (p slots, slot o for origin o) is its
receive buffer. When rank i sends its raw slots ``[send_off, +size)`` in
round r, the message becomes ``size`` block copies, one per origin o that
``compile_schedule``'s raw buffers record there: from the sender's slot o
to the receiver's slot o, or, where the receiver already holds o (a
schedule that re-sends a block; capacity > p), to one of the receiver's
``capacity - p`` spill slots, numbered p, p+1, ... . A copy into the
receiver's own slot o would race with its read of that slot in the same
round. The message sizes, and so ``nonlocal_stats``, stay the table's;
the first copy writes x[i] to slot i of ``out[i]``, and the raw layout's
``(p, capacity, n)`` buffer and gather pass go away. ``check_folded``
holds the folded rounds free of overlap.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...core.schedules import Round, Schedule, Send
from ...core.topology import RegionMap


@dataclasses.dataclass(frozen=True)
class DmaSchedule:
    table: np.ndarray        # (p, R, 5) int32
    sizes: tuple[int, ...]   # blocks per round (static)
    perm: np.ndarray         # (p, p) int32: canonical[j] = buf[perm[i, j]]
    p: int
    capacity: int            # buffer slots (blocks) needed per rank
    # (R, p, 1 + 3·max size) int32: per round and sending rank, the target
    # (-1: no send) then (origin, source slot, destination slot) for each
    # block of the message; -1 padding. Slots < p are the output row (the
    # source slot is the origin's), the rest its spill slots.
    folded: np.ndarray = dataclasses.field(compare=False, repr=False,
                                           default=None)
    # device copies of the kernel's tables, filled by the kernel wrapper
    device_tables: dict = dataclasses.field(default_factory=dict,
                                            compare=False, repr=False)

    @property
    def spill(self) -> int:
        """Spill slots per rank: blocks a rank receives a second time."""
        return self.capacity - self.p

    def nonlocal_stats(self, region) -> tuple[int, int]:
        """(max msgs, max blocks) crossing region boundaries per rank."""
        msgs = np.zeros(self.p, int)
        blocks = np.zeros(self.p, int)
        for r, size in enumerate(self.sizes):
            for i in range(self.p):
                if self.table[i, r, 3] and not region.is_local(
                        i, int(self.table[i, r, 0])):
                    msgs[i] += 1
                    blocks[i] += size
        return int(msgs.max()), int(blocks.max())


def check_no_overlap(row: np.ndarray, size: int, r: int) -> None:
    """Raise if a write of round ``r`` lands on a range read in round r."""
    reads: dict[int, tuple[int, int]] = {
        i: (int(row[i, 1]), int(row[i, 1]) + size)
        for i in np.flatnonzero(row[:, 3])}
    for i, (lo, hi) in reads.items():
        tgt, roff = int(row[i, 0]), int(row[i, 2])
        if tgt in reads:
            rlo, rhi = reads[tgt]
            if roff < rhi and rlo < roff + size:
                raise ValueError(
                    f"round {r}: rank {i} writes blocks [{roff}, "
                    f"{roff + size}) of rank {tgt}, which reads "
                    f"[{rlo}, {rhi}) in the same round")


def check_folded(folded: np.ndarray, sizes, p: int) -> None:
    """Raise if a folded round writes a slot that the round reads or that
    another copy of the round writes."""
    for r, size in enumerate(sizes):
        reads, writes = set(), set()
        for i in np.flatnonzero(folded[r, :, 0] >= 0):
            tgt = int(folded[r, i, 0])
            cps = folded[r, i, 1:1 + 3 * size].reshape(size, 3)
            reads.update((int(i), int(src)) for src in cps[:, 1])
            for dst in cps[:, 2]:
                if (tgt, int(dst)) in writes:
                    raise ValueError(f"round {r}: slot {int(dst)} of rank "
                                     f"{tgt} is written twice")
                writes.add((tgt, int(dst)))
        both = reads & writes
        if both:
            rank, slot = min(both)
            raise ValueError(f"round {r}: slot {slot} of rank {rank} is "
                             f"read and written in the same round")


def _fold(sched: Schedule, p: int, sizes: list[int]) -> np.ndarray:
    """The folded table of ``sched``'s non-empty rounds (module docstring)."""
    rounds = [rnd for rnd in sched.rounds if rnd.sends]
    folded = -np.ones((len(rounds), p, 1 + 3 * max(sizes, default=0)),
                      np.int32)
    held = [{i} for i in range(p)]
    spilled = [0] * p
    for r, rnd in enumerate(rounds):
        for s in rnd.sends:
            row = folded[r, s.src]
            row[0] = s.dst
            for k, origin in enumerate(s.blocks):
                if origin in held[s.dst]:
                    dst = p + spilled[s.dst]
                    spilled[s.dst] += 1
                else:
                    dst = origin
                    held[s.dst].add(origin)
                row[1 + 3 * k:4 + 3 * k] = (origin, origin, dst)
    check_folded(folded, sizes, p)
    return folded


def compile_schedule(sched: Schedule) -> DmaSchedule:
    p = sched.p
    bufs: list[list[int]] = [[r] for r in range(p)]   # raw append order
    rounds = []
    sizes = []
    for rnd in sched.rounds:
        if not rnd.sends:
            continue
        row = np.zeros((p, 5), np.int32)
        size = None
        incoming: dict[int, tuple[int, ...]] = {}
        for s in rnd.sends:
            if size is None:
                size = len(s.blocks)
            assert len(s.blocks) == size, "non-uniform round size"
            buf = bufs[s.src]
            # locate the send as a contiguous slice of the raw buffer
            off = _find_slice(buf, s.blocks)
            assert row[s.src, 3] == 0, "multiple sends per rank per round"
            row[s.src, 0] = s.dst
            row[s.src, 1] = off
            # the copy writes into the *receiver's* buffer — the sender's
            # row carries the receiver's append offset (per-rank, not
            # uniform: idle lanes have shorter buffers).
            row[s.src, 2] = len(bufs[s.dst])
            row[s.src, 3] = 1
            assert s.dst not in incoming, "multiple receives per rank"
            incoming[s.dst] = s.blocks
        check_no_overlap(row, size, len(rounds))
        for dst, blocks in incoming.items():
            row[dst, 4] = 1
            bufs[dst].extend(blocks)                  # verbatim append
        rounds.append(row)
        sizes.append(size)

    capacity = max(len(b) for b in bufs)
    perm = np.zeros((p, p), np.int32)
    for i in range(p):
        first = {}
        for j, origin in enumerate(bufs[i]):
            first.setdefault(origin, j)
        missing = set(range(p)) - set(first)
        assert not missing, f"rank {i} never received blocks {sorted(missing)[:8]}"
        for origin, j in first.items():
            perm[i, origin] = j
    table = (np.stack(rounds, axis=1) if rounds
             else np.zeros((p, 0, 5), np.int32))
    return DmaSchedule(table=table.astype(np.int32), sizes=tuple(sizes),
                       perm=perm, p=p, capacity=capacity,
                       folded=_fold(sched, p, sizes))


def locality_bruck_raw(p: int, p_local: int) -> Schedule:
    """Raw-append (DMA-clean) variant of paper Algorithm 2.

    The generator in core/schedules.py follows the paper's "lane 0
    re-contributes its data for simplicity" — which makes receivers
    deduplicate, something a DMA engine cannot do. This variant implements
    the paper's stated alternative (§3: "the first local process
    contributing no data", the MPI_Allgatherv route): the redistribution
    allgather runs among the ``active-1`` lanes that actually received a
    chunk, then lane 1 forwards the chunk area to lane 0 (+1 local message
    — local messages are exactly what the paper trades for) and a binomial
    broadcast fills lanes ≥ active. Every message is a contiguous slice of
    the sender's raw buffer and no block is ever received twice for
    power-of-p_ℓ region counts. Non-local traffic is identical to Alg. 2.
    """
    region = RegionMap(p=p, p_local=p_local)
    pl, r = p_local, region.n_regions
    bufs: list[list[int]] = [[rank] for rank in range(p)]
    rounds: list[Round] = []

    def apply_round(sends, phase):
        if not sends:
            return
        incoming = {}
        for s in sends:
            assert s.dst not in incoming
            incoming[s.dst] = s.blocks
        for dst, blocks in incoming.items():
            bufs[dst].extend(blocks)
        rounds.append(Round(sends=tuple(sends), phase=phase))

    def slice_of(rank, off, ln):
        return tuple(bufs[rank][off:off + ln])

    # ---- initial local allgather (bruck over lanes, unit = 1 block) -----
    d = 1
    while d < pl:
        cnt = min(d, pl - d)
        sends = []
        for rank in range(p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            dst = region.rank_of(R, (l - d) % pl)
            sends.append(Send(src=rank, dst=dst,
                              blocks=slice_of(rank, 0, cnt)))
        apply_round(sends, f"raw-init-d{d}")
        d *= 2

    group = 1
    step = 0
    while group < r:
        n_groups = -(-r // group)
        active = min(pl, n_groups)
        L0 = group * pl                     # buffer length entering the round
        u = group * pl                      # chunk (unit) length
        # ---- non-local exchange: lanes 1..active-1, entire buffer -------
        sends = []
        for rank in range(p):
            R, l = region.region_of(rank), region.local_rank_of(rank)
            if l == 0 or l >= active:
                continue
            dst = region.rank_of((R - l * group) % r, l)
            sends.append(Send(src=rank, dst=dst, blocks=slice_of(rank, 0, L0)))
        apply_round(sends, f"raw-nonlocal-{step}")

        g2 = active - 1                      # chunk holders: lanes 1..active-1
        # ---- unit bruck among the holders --------------------------------
        d = 1
        while d < g2:
            cnt = min(d, g2 - d)
            sends = []
            for rank in range(p):
                R, l = region.region_of(rank), region.local_rank_of(rank)
                if not (1 <= l <= g2):
                    continue
                j = l - 1
                dst = region.rank_of(R, 1 + (j - d) % g2)
                sends.append(Send(src=rank, dst=dst,
                                  blocks=slice_of(rank, L0, cnt * u)))
            apply_round(sends, f"raw-redist{step}-d{d}")
            d *= 2
        # ---- lane 1 forwards the chunk area to lane 0 ---------------------
        if g2 >= 1:
            sends = []
            for R in range(r):
                src = region.rank_of(R, 1)
                sends.append(Send(src=src, dst=region.rank_of(R, 0),
                                  blocks=slice_of(src, L0, g2 * u)))
            apply_round(sends, f"raw-fill0-{step}")
        # ---- binomial broadcast to idle lanes ≥ active ---------------------
        have = active
        while have < pl:
            sends = []
            for R in range(r):
                for l in range(min(have, pl - have)):
                    src = region.rank_of(R, l)
                    sends.append(Send(src=src, dst=region.rank_of(R, l + have),
                                      blocks=slice_of(src, L0, g2 * u)))
            apply_round(sends, f"raw-bcast{step}-{have}")
            have *= 2
        group *= active
        step += 1

    final = [sorted(set(b)) for b in bufs]
    for i, b in enumerate(final):
        assert b == list(range(p)), f"rank {i} incomplete"
    return Schedule(p=p, rounds=rounds, buffers=final,
                    algorithm="locality_bruck_raw", region=region)


def _find_slice(buf: list[int], blocks: tuple[int, ...]) -> int:
    """First offset where ``blocks`` appears as a contiguous slice."""
    n = len(blocks)
    for off in range(len(buf) - n + 1):
        if tuple(buf[off:off + n]) == blocks:
            return off
    raise AssertionError(f"send {blocks[:6]}... not contiguous in buffer")


def execute_table(dma: DmaSchedule) -> np.ndarray:
    """Pure-python executor of the compiled table (kernel-free oracle).

    Returns (p, p) int: row i = origin ids in canonical order — must equal
    arange(p) per row for a correct schedule.
    """
    p, cap = dma.p, dma.capacity
    bufs = -np.ones((p, cap), np.int64)
    bufs[:, 0] = np.arange(p)
    lens = np.ones(p, np.int64)
    for r, size in enumerate(dma.sizes):
        writes = []
        for i in range(p):
            tgt, soff, roff, sflag, rflag = dma.table[i, r]
            if sflag:
                writes.append((int(tgt), bufs[i, soff:soff + size].copy(),
                               int(roff)))
        for tgt, data, roff in writes:
            assert dma.table[tgt, r, 4] == 1, "send to non-receiving rank"
            bufs[tgt, roff:roff + size] = data
            lens[tgt] = max(lens[tgt], roff + size)
    out = np.empty((p, p), np.int64)
    for i in range(p):
        out[i] = bufs[i, dma.perm[i]]
    return out


def execute_folded(dma: DmaSchedule) -> tuple[np.ndarray, list]:
    """Pure-python executor of the folded table, as the kernel runs it.

    Returns the (p, p) origin ids of every rank's output row and, per round,
    the origins each sending rank's message carried (``{rank: tuple}``).
    Reads are not snapshotted: ``check_folded`` guarantees that no round
    reads a slot it writes, so copies may run in any order.
    """
    p = dma.p
    slots = -np.ones((p, dma.capacity), np.int64)
    slots[np.arange(p), np.arange(p)] = np.arange(p)
    messages = []
    for r, size in enumerate(dma.sizes):
        sent = {}
        for i in np.flatnonzero(dma.folded[r, :, 0] >= 0):
            tgt = int(dma.folded[r, i, 0])
            cps = dma.folded[r, i, 1:1 + 3 * size].reshape(size, 3)
            data = slots[i, cps[:, 1]]
            assert (data == cps[:, 0]).all(), "a copy reads a slot it lacks"
            slots[tgt, cps[:, 2]] = data
            sent[int(i)] = tuple(int(o) for o in data)
        messages.append(sent)
    return slots[:, :p], messages
