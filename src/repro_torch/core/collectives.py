"""The paper's collective algorithms over ``torch.distributed``, behind one API.

Ported from ``src/repro/core/collectives.py``. Every rank of a
:class:`~repro_torch.core.topology.RankGrid` calls the same function on its
own shard, as every device runs the JAX function inside ``shard_map``. The
JAX idioms map so:

* ``lax.ppermute(x, axes, pairs)`` is :func:`ppermute`: one
  ``dist.batch_isend_irecv`` round of this rank's edges in ``pairs`` (axis
  positions), recorded by the grid's ``CommRecorder``. A rank that is no
  target receives zeros, as under ``lax.ppermute``; the masks of the
  hierarchical gather and the recursive-doubling allreduce rely on it. A
  rank with no edge in a round makes no call.
* ``outer`` / ``local`` mesh axes are the grid's ``outer`` (this rank's
  lane across the pods) and ``local`` (this rank's pod) axes; ``outer +
  local`` is ``grid.world``. ``lax.axis_index`` is ``axis.index``, and a
  ``jnp.where`` on it is a Python branch.
* ``lax.all_gather`` / ``psum`` / ``psum_scatter`` (the ``"xla"``
  algorithms and the locality allreduce's local reduce-scatter) are the
  group collectives ``all_gather_into_tensor``, ``all_reduce`` and
  ``reduce_scatter_tensor`` on the axis's process group.

A CUDA tensor on a gloo grid, or a CPU tensor on an NCCL grid, raises:
nothing moves tensors between devices quietly. The one move there is is
asked for by name: a split gather started with ``stage=True``.

Public surface, one family function per collective kind, each taking
``(operand, grid, algorithm=..., **kw)``:

  allgather          ``bruck`` (Algorithm 1 [Bruck '97]), ``ring`` [Chan
                     '07], ``hierarchical`` [Träff '06], ``multilane``
                     [Träff & Hunold '20], ``locality_bruck`` (Algorithm 2,
                     the paper's contribution), ``xla`` (the library's
                     all-gather). Same five schedules as
                     ``core/schedules.py``, the oracle.
  reduce_scatter     the transpose of each allgather, written out: the
                     rounds run in reverse, each receive becomes a send of
                     that slice back and each send a receive added into the
                     slice sent. JAX gets it as the allgather's vjp.
  allreduce          ``locality``: local reduce-scatter → per-lane outer
                     allreduce (``rhd``, ``rd`` or ``psum``) → local
                     allgather; sum, max and min; or ``xla``.
  all_to_all         the personalized exchange: ``locality`` (two tiers:
                     a local collect, one aggregated inter-pod slab per
                     active lane per round, a local delivery; q - 1
                     non-local messages a pod against pl²(q - 1) flat) and
                     ``xla`` (the library's ``all_to_all_single``, the flat
                     pairwise exchange). Its own transpose: the backward
                     is the same algorithm's exchange of the cotangent.
  cache_migrate      the replication of a KV-cache slab (an allgather).
  logsumexp_combine  the decode cache-combine of flash-style partial softmax
                     stats: max-allreduce of the running maxima, rescale,
                     one packed [o, l] sum-allreduce; split into
                     ``logsumexp_combine_start`` / ``_finish`` so the
                     accumulation of o and l can run between the halves.

``allgather`` is differentiable for the Bruck schedules and the library's
gather (``DIFFERENTIABLE``): its backward is the reduce-scatter.
``allgather_start`` / ``allgather_finish`` split the locality gather
after its last non-local round; ``finish(start(x))`` is
bit-identical to the eager gather, and differentiable for the same
schedules: the pair's backward, taken at finish, is the schedule's
reduce-scatter. With ``stage=True`` the pair also moves a tensor of
another device (a card's, on a gloo grid) to the grid's and back, both
ways, inside that one autograd node. ``collective(kind, x, grid=...,
algorithm=...)`` is the string-keyed entry point over ``KINDS`` /
``ALGORITHMS_BY_KIND`` / ``DEFAULT_ALGORITHM``.

Not ported yet, raising ``NotImplementedError`` that names its slice:
``algorithm="auto"``. The JAX package's deprecated aliases are not
ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .topology import Axis, RankGrid

_NOT_PORTED = {
    "auto": 'algorithm="auto" comes with the tuning slice (ROADMAP.md Queue 1 '
            "item 8): it needs parameters measured on the H100, and the "
            "JAX package's TPU constants do not choose a schedule here",
}


def _not_ported(what: str):
    raise NotImplementedError(_NOT_PORTED[what])


# =============================================================================
# The port's lax.ppermute and group collectives (all recorded)
# =============================================================================
def _check_device(x: torch.Tensor, grid: RankGrid) -> None:
    if x.device.type != grid.device.type:
        raise ValueError(f"a {x.device.type} tensor on a {grid.backend} "
                         f"grid: {grid.backend} takes {grid.device.type} "
                         "tensors")


def ppermute(x: torch.Tensor, grid: RankGrid, axis: Axis,
             pairs: list[tuple[int, int]]) -> torch.Tensor:
    """One point-to-point round: for each (s, t) in ``pairs`` (positions on
    ``axis``), position s sends ``x`` to position t. Returns what this rank
    received, zeros where it is no target."""
    _check_device(x, grid)
    me = axis.index
    dsts = [t for s, t in pairs if s == me]
    srcs = [s for s, t in pairs if t == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"pairs {pairs} are not a permutation")
    x = x.contiguous()
    grid.recorder.permute(axis.members[me],
                          [axis.members[t] for t in dsts],
                          x.numel() * x.element_size())
    if dsts == [me] and srcs == [me]:
        return x.clone()
    recv = torch.zeros_like(x)
    peer = lambda pos: grid.global_rank(axis.members[pos])
    ops = [dist.P2POp(dist.isend, x, peer(t), grid.group) for t in dsts]
    ops += [dist.P2POp(dist.irecv, recv, peer(s), grid.group) for s in srcs]
    if ops:                    # an empty batch raises in batch_isend_irecv
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


@contextlib.contextmanager
def _quiet():
    """torch 2.13 deprecates ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` (FutureWarning); 2.11 has no other name."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _all_gather(x: torch.Tensor, grid: RankGrid, axis: Axis) -> torch.Tensor:
    """[n, *x.shape] over ``axis`` in axis order."""
    _check_device(x, grid)
    flat = x.contiguous().reshape(-1)
    out = torch.empty(axis.size * flat.numel(), dtype=x.dtype,
                      device=x.device)
    grid.recorder.group("all-gather", axis.members, axis.index,
                        out.numel() * out.element_size())
    with _quiet():
        dist.all_gather_into_tensor(out, flat, group=axis.group)
    return out.reshape((axis.size,) + tuple(x.shape))


def _reduce_scatter_sum(y: torch.Tensor, grid: RankGrid,
                        axis: Axis) -> torch.Tensor:
    """Sum over ``axis`` of 1-d ``y``; this rank keeps tile ``axis.index``."""
    _check_device(y, grid)
    out = torch.empty(y.numel() // axis.size, dtype=y.dtype, device=y.device)
    grid.recorder.group("reduce-scatter", axis.members, axis.index,
                        out.numel() * out.element_size())
    with _quiet():
        dist.reduce_scatter_tensor(out, y.contiguous(), op=dist.ReduceOp.SUM,
                                   group=axis.group)
    return out


_DIST_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _all_reduce(x: torch.Tensor, grid: RankGrid, axis: Axis,
                op: str) -> torch.Tensor:
    _check_device(x, grid)
    out = x.contiguous().clone()
    grid.recorder.group("all-reduce", axis.members, axis.index,
                        out.numel() * out.element_size())
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                    group=axis.group)
    return out


def _stack_to_tiled(buf: torch.Tensor, x_shape: tuple[int, ...]) -> torch.Tensor:
    """[p, *x_shape] -> concatenation along dim 0 (all_gather tiled=True)."""
    p = buf.shape[0]
    if not x_shape:
        return buf
    return buf.reshape((p * x_shape[0],) + tuple(x_shape[1:]))


def _out(buf: torch.Tensor, tiled: bool, x_shape) -> torch.Tensor:
    return _stack_to_tiled(buf, tuple(x_shape)) if tiled else buf


# =============================================================================
# Algorithm 1 — standard Bruck allgather: log2(p) rounds, doubling buffers.
# =============================================================================
def _doublings(n: int) -> list[int]:
    """1, 2, 4, ... below n: the distances of a doubling schedule."""
    out, d = [], 1
    while d < n:
        out.append(d)
        d *= 2
    return out


def _bruck_distances(p: int) -> list[tuple[int, int]]:
    """(distance, blocks sent) of each Bruck round."""
    return [(d, min(d, p - d)) for d in _doublings(p)]


def _bruck_allgather(x: torch.Tensor, grid: RankGrid, axis: Axis, *,
                     tiled: bool = False) -> torch.Tensor:
    """Round i (distance d=2^i): every rank sends the first min(d, p-d)
    blocks of its buffer to rank id-d and receives from id+d; a final
    rotation by the rank's index restores canonical order."""
    p = axis.size
    if p == 1:
        return _out(x[None], tiled, x.shape)
    buf = x[None]                       # buf[k] = block (idx + k) mod p
    for d, cnt in _bruck_distances(p):
        recv = ppermute(buf[:cnt], grid, axis,
                        [(s, (s - d) % p) for s in range(p)])
        buf = torch.cat([buf, recv])
    buf = torch.roll(buf, axis.index, 0)     # out[j] = block j
    return _out(buf, tiled, x.shape)


def _bruck_reduce_scatter(ct: torch.Tensor, grid: RankGrid,
                          axis: Axis) -> torch.Tensor:
    """Transpose of :func:`_bruck_allgather`: ct [p, *s] -> [*s]."""
    p = axis.size
    if p == 1:
        return ct[0]
    ct = torch.roll(ct, -axis.index, 0)
    for d, cnt in reversed(_bruck_distances(p)):
        keep = ct.shape[0] - cnt
        back = ppermute(ct[keep:], grid, axis,
                        [((s - d) % p, s) for s in range(p)])
        ct = ct[:keep].clone()
        ct[:cnt] += back
    return ct[0]


# =============================================================================
# Ring allgather: p-1 neighbor rounds (bandwidth-optimal, locality-friendly).
# =============================================================================
def _ring_allgather(x: torch.Tensor, grid: RankGrid, axis: Axis, *,
                    tiled: bool = False) -> torch.Tensor:
    p = axis.size
    if p == 1:
        return _out(x[None], tiled, x.shape)
    pairs = [(s, (s - 1) % p) for s in range(p)]
    cur, bufs = x, [x]
    for _ in range(p - 1):
        cur = ppermute(cur, grid, axis, pairs)
        bufs.append(cur)
    buf = torch.roll(torch.stack(bufs), axis.index, 0)  # buf[k]: block idx+k
    return _out(buf, tiled, x.shape)


def _ring_reduce_scatter(ct: torch.Tensor, grid: RankGrid,
                         axis: Axis) -> torch.Tensor:
    p = axis.size
    if p == 1:
        return ct[0]
    ct = torch.roll(ct, -axis.index, 0)
    pairs = [((s - 1) % p, s) for s in range(p)]
    g = ct[p - 1]
    for k in range(p - 1, 0, -1):
        g = ppermute(g, grid, axis, pairs)       # cotangent of round k's input
        if k > 1:
            g = ct[k - 1] + g
    return ct[0] + g


# =============================================================================
# Hierarchical allgather [Träff '06]: binomial gather to a master per region,
# Bruck among masters, binomial broadcast. Non-masters idle during phase 2.
# =============================================================================
def _hierarchical_allgather(x: torch.Tensor, grid: RankGrid, *,
                            tiled: bool = False) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    if pl == 1:
        return _bruck_allgather(x, grid, grid.world, tiled=tiled)
    R, l = grid.R, grid.l
    flat = lambda Rg, lg: Rg * pl + lg
    # Phase 1: binomial gather to lane 0. B[k] = block of lane k of the own
    # region (zeros where unknown), padded to a power of two so a sender's
    # subtree slice [l, l+d) and a receiver's write at l+d stay in bounds.
    pl2 = 1 << (pl - 1).bit_length()
    B = x.new_zeros((pl2,) + tuple(x.shape))
    B[l] = x
    for d in _doublings(pl):
        pairs = [(flat(Rg, lg), flat(Rg, lg - d))
                 for Rg in range(r) for lg in range(d, pl, 2 * d)]
        s = min(l, pl2 - d)
        recv = ppermute(B[s:s + d], grid, grid.world, pairs)
        if l % (2 * d) == 0 and l + d < pl:
            u = min(l + d, pl2 - d)
            B[u:u + d] = recv
    B = B[:pl]
    # Phase 2: Bruck among masters (lane 0) over regions; chunk k = region R+k.
    buf = B[None]
    for d, cnt in _bruck_distances(r):
        pairs = [(flat(Rg, 0), flat((Rg - d) % r, 0)) for Rg in range(r)]
        recv = ppermute(buf[:cnt], grid, grid.world, pairs)
        buf = torch.cat([buf, recv])
    buf = torch.roll(buf, R, 0)
    # Phase 3: binomial broadcast of the full buffer within each region.
    for have in _doublings(pl):
        pairs = [(flat(Rg, lg), flat(Rg, lg + have))
                 for Rg in range(r) for lg in range(min(have, pl - have))]
        recv = ppermute(buf, grid, grid.world, pairs)
        if have <= l < 2 * have:
            buf = recv
    buf = buf.reshape((r * pl,) + tuple(x.shape))
    return _out(buf, tiled, x.shape)


def _hierarchical_reduce_scatter(ct: torch.Tensor,
                                 grid: RankGrid) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    if pl == 1:
        return _bruck_reduce_scatter(ct, grid, grid.world)
    R, l = grid.R, grid.l
    flat = lambda Rg, lg: Rg * pl + lg
    xs = tuple(ct.shape[1:])
    ct = ct.reshape((r, pl) + xs)
    # Phase 3, reversed: a receiver hands its cotangent back to its sender.
    for have in reversed(_doublings(pl)):
        pairs = [(flat(Rg, lg + have), flat(Rg, lg))
                 for Rg in range(r) for lg in range(min(have, pl - have))]
        is_recv = have <= l < 2 * have
        back = ppermute(ct if is_recv else torch.zeros_like(ct), grid,
                        grid.world, pairs)
        ct = back if is_recv else ct + back
    # Phase 2, reversed.
    ct = torch.roll(ct, -R, 0)
    for d, cnt in reversed(_bruck_distances(r)):
        pairs = [(flat((Rg - d) % r, 0), flat(Rg, 0)) for Rg in range(r)]
        keep = ct.shape[0] - cnt
        back = ppermute(ct[keep:], grid, grid.world, pairs)
        ct = ct[:keep].clone()
        ct[:cnt] += back
    # Phase 1, reversed.
    pl2 = 1 << (pl - 1).bit_length()
    cB = ct.new_zeros((pl2,) + xs)
    cB[:pl] = ct[0]
    for d in reversed(_doublings(pl)):
        pairs = [(flat(Rg, lg - d), flat(Rg, lg))
                 for Rg in range(r) for lg in range(d, pl, 2 * d)]
        send = torch.zeros((d,) + xs, dtype=ct.dtype, device=ct.device)
        if l % (2 * d) == 0 and l + d < pl:
            u = min(l + d, pl2 - d)
            send = cB[u:u + d].clone()
            cB[u:u + d] = 0
        back = ppermute(send, grid, grid.world, pairs)
        s = min(l, pl2 - d)
        cB[s:s + d] += back
    return cB[l]


# =============================================================================
# Multi-lane allgather [Träff & Hunold '20]: every lane runs a Bruck over the
# regions concurrently (its own block only), then one local allgather
# combines the lanes. Non-local bytes drop by p_local; messages unchanged.
# =============================================================================
def _multilane_allgather(x: torch.Tensor, grid: RankGrid, *,
                         tiled: bool = False) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    lane = _bruck_allgather(x, grid, grid.outer)      # [r, ...] region order
    allb = _bruck_allgather(lane, grid, grid.local)   # [pl, r, ...]
    buf = allb.transpose(0, 1).reshape((r * pl,) + tuple(x.shape))
    return _out(buf, tiled, x.shape)


def _multilane_reduce_scatter(ct: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    xs = tuple(ct.shape[1:])
    ct = ct.reshape((r, pl) + xs).transpose(0, 1).contiguous()
    lane = _bruck_reduce_scatter(ct, grid, grid.local)     # [r, ...]
    return _bruck_reduce_scatter(lane, grid, grid.outer)


# =============================================================================
# Algorithm 2 — locality-aware Bruck allgather (the paper's contribution).
# =============================================================================
def _nonlocal_round_geometry(r: int, pl: int, group: int
                             ) -> tuple[int, int, int]:
    """Static geometry of one Algorithm-2 non-local round.

    With ``group`` region chunks held per rank, returns ``(active, span,
    rem)``: the lanes that exchange this round (offsets 0..active-1 name
    distinct peer regions), the chunks held after the round (``span =
    min(active·group, r)``), and the chunk count the LAST active lane's peer
    is actually missing (``rem ∈ (0, group]``; ``rem < group`` only on the
    wrapped final round of a non-power region count — the allgatherv case).
    """
    n_groups = -(-r // group)                 # distinct groups remaining
    active = min(pl, n_groups)
    span = min(active * group, r)
    rem = span - (active - 1) * group
    return active, span, rem


def _nonlocal_rounds(r: int, pl: int) -> list[tuple[int, int, int, int]]:
    """(group, active, span, rem) of every non-local round."""
    out, group = [], 1
    while group < r:
        active, span, rem = _nonlocal_round_geometry(r, pl, group)
        out.append((group, active, span, rem))
        group = span
    return out


def _nonlocal_pairs(r: int, pl: int, group: int, active: int):
    flat = lambda Rg, lg: Rg * pl + lg
    last = active - 1
    full = [(flat(Rg, lg), flat((Rg - lg * group) % r, lg))
            for Rg in range(r) for lg in range(1, last)]
    last_pairs = [(flat(Rg, last), flat((Rg - last * group) % r, last))
                  for Rg in range(r)]
    return full, last_pairs


def _nonlocal_exchange(buf: torch.Tensor, grid: RankGrid, group: int,
                       active: int, rem: int) -> torch.Tensor:
    """One Algorithm-2 non-local round, allgatherv-adapted (paper §3).

    Lane ℓ ∈ [1, active) sends to region R - ℓ·group (same lane) and
    receives from R + ℓ·group. The last active lane's peer is missing only
    ``rem`` chunks, so on a wrapped final round (``rem < group``) that lane
    sends exactly the ``rem``-chunk prefix, zero-padded back to ``group``
    chunks on receipt. The two rounds carry disjoint edge sets: one send
    per active lane per round.
    """
    pl = grid.pl
    full, last_pairs = _nonlocal_pairs(grid.q, pl, group, active)
    if rem == group:                      # uniform round: one exchange
        return ppermute(buf, grid, grid.world, full + last_pairs)
    part = ppermute(buf[: rem * pl], grid, grid.world, last_pairs)
    part = F.pad(part, (0, 0) * (buf.ndim - 1) + (0, (group - rem) * pl))
    if not full:                          # active == 2: only the partial
        return part
    recv = ppermute(buf, grid, grid.world, full)
    return part if grid.l == active - 1 else recv


def _nonlocal_exchange_t(ct: torch.Tensor, grid: RankGrid, group: int,
                         active: int, rem: int) -> torch.Tensor:
    """Transpose of :func:`_nonlocal_exchange`: the receive's cotangent
    goes back to the sender, added into the slice it sent."""
    pl = grid.pl
    full, last_pairs = _nonlocal_pairs(grid.q, pl, group, active)
    rev = lambda pairs: [(t, s) for s, t in pairs]
    if rem == group:
        return ppermute(ct, grid, grid.world, rev(full + last_pairs))
    is_last = grid.l == active - 1
    if full:
        out = ppermute(torch.zeros_like(ct) if is_last else ct, grid,
                       grid.world, rev(full))
        part = ct if is_last else torch.zeros_like(ct)
    else:
        out = torch.zeros_like(ct)
        part = ct
    back = ppermute(part[: rem * pl], grid, grid.world, rev(last_pairs))
    out = out.clone()
    out[: rem * pl] += back
    return out


def _redistribute(buf: torch.Tensor, recv: torch.Tensor, grid: RankGrid,
                  group: int, active: int, span: int,
                  x_shape) -> torch.Tensor:
    """Local allgather of the received units (lane 0 re-contributes its
    own buffer; lanes ≥ active carry nothing and are dropped), trimmed to
    the ``span`` chunks held after the round."""
    pl = grid.pl
    unit = buf if grid.l == 0 else recv
    stacked = _bruck_allgather(unit, grid, grid.local)[:active]
    buf = stacked.reshape((active * group * pl,) + tuple(x_shape))
    return buf[: span * pl]


def _redistribute_t(ct: torch.Tensor, grid: RankGrid, group: int,
                    active: int, span: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Transpose of :func:`_redistribute`: (cotangent of buf, of recv)."""
    pl = grid.pl
    xs = tuple(ct.shape[1:])
    full = ct.new_zeros((pl * group * pl,) + xs)
    full[: span * pl] = ct
    unit = _bruck_reduce_scatter(full.reshape((pl, group * pl) + xs), grid,
                                 grid.local)
    zero = torch.zeros_like(unit)
    return (unit, zero) if grid.l == 0 else (zero, unit)


def _canonical(buf: torch.Tensor, grid: RankGrid, tiled: bool,
               x_shape) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    chunks = buf.reshape((r, pl) + tuple(x_shape))
    chunks = torch.roll(chunks, grid.R, 0)         # canonical region order
    return _out(chunks.reshape((r * pl,) + tuple(x_shape)), tiled, x_shape)


@dataclasses.dataclass(frozen=True)
class _SplitMeta:
    """Static half of a PendingCollective."""

    op: str                        # "allgather" | "allreduce" | "logsumexp"
                                   # | "all_to_all"
    kind: str                      # "done" | "local_done" | "pending"
                                   # | "max_done" | "local_only"
    grid: RankGrid | None = None
    tiled: bool = False
    x_shape: tuple[int, ...] = ()
    group: int = 1                 # locality_bruck: chunks held pre-finish;
                                   # all_to_all: its inter-pod rounds
    active: int = 1                # locality_bruck: lanes live in last round
    rem: int = 0                   # chunks the last active lane carried in
                                   # the final round (rem < group on the
                                   # allgatherv wrapped round)
    algorithm: str = ""            # logsumexp: the max phase's algorithm


@dataclasses.dataclass
class PendingCollective:
    """An in-flight split collective: its tensors and its static half; for
    a differentiable or staged gather, ``source`` is the gathered input
    (the result comes back to its device), through which the backward of
    finish returns."""

    arrays: tuple
    meta: _SplitMeta
    source: torch.Tensor | None = None


def _locality_bruck_allgather_start(x: torch.Tensor, grid: RankGrid, *,
                                    tiled: bool = False) -> PendingCollective:
    """Algorithm 2, split after the LAST non-local round: every non-local
    byte is sent when start returns; the final local redistribution and the
    canonical reordering are left to finish."""
    if grid.pl == 1:
        full = _bruck_allgather(x, grid, grid.world, tiled=tiled)
        return PendingCollective((full,), _SplitMeta("allgather", "done"))
    shape = tuple(x.shape)
    buf = _bruck_allgather(x, grid, grid.local)   # Alg. 2 line 1
    rounds = _nonlocal_rounds(grid.q, grid.pl)
    if not rounds:
        return PendingCollective((buf,), _SplitMeta(
            "allgather", "local_done", grid, tiled, shape))
    for i, (group, active, span, rem) in enumerate(rounds):
        recv = _nonlocal_exchange(buf, grid, group, active, rem)
        if i == len(rounds) - 1:
            return PendingCollective((buf, recv), _SplitMeta(
                "allgather", "pending", grid, tiled, shape, group=group,
                active=active, rem=rem))
        buf = _redistribute(buf, recv, grid, group, active, span, shape)


def _locality_bruck_allgather_finish(pending: PendingCollective
                                     ) -> torch.Tensor:
    meta = pending.meta
    if meta.kind == "done":
        return pending.arrays[0]
    grid = meta.grid
    if meta.kind == "local_done":
        (buf,) = pending.arrays
    else:
        buf, recv = pending.arrays
        valid = (meta.active - 1) * meta.group + meta.rem
        if valid != grid.q:
            raise ValueError(f"pending gather of {valid} regions on a grid "
                             f"of {grid.q}")
        buf = _redistribute(buf, recv, grid, meta.group, meta.active, valid,
                            meta.x_shape)
    return _canonical(buf, grid, meta.tiled, meta.x_shape)


def _locality_bruck_allgather(x: torch.Tensor, grid: RankGrid, *,
                              tiled: bool = False) -> torch.Tensor:
    """Paper Algorithm 2 on any region count: a local Bruck allgather,
    then ceil(log_pl(r)) rounds of one non-local exchange per lane and a
    local redistribution. The split halves composed, so the eager and the
    split gathers cannot drift."""
    return _locality_bruck_allgather_finish(
        _locality_bruck_allgather_start(x, grid, tiled=tiled))


def _locality_bruck_reduce_scatter(ct: torch.Tensor,
                                   grid: RankGrid) -> torch.Tensor:
    r, pl = grid.q, grid.pl
    if pl == 1:
        return _bruck_reduce_scatter(ct, grid, grid.world)
    xs = tuple(ct.shape[1:])
    ct = torch.roll(ct.reshape((r, pl) + xs), -grid.R, 0)
    ct = ct.reshape((r * pl,) + xs)
    for group, active, span, rem in reversed(_nonlocal_rounds(r, pl)):
        ct_buf, ct_recv = _redistribute_t(ct, grid, group, active, span)
        ct = ct_buf + _nonlocal_exchange_t(ct_recv, grid, group, active, rem)
    return _bruck_reduce_scatter(ct, grid, grid.local)


# =============================================================================
# Dispatch and autograd
# =============================================================================
ALLGATHERS = {
    "bruck": lambda x, grid, tiled: _bruck_allgather(x, grid, grid.world,
                                                     tiled=tiled),
    "ring": lambda x, grid, tiled: _ring_allgather(x, grid, grid.world,
                                                   tiled=tiled),
    "hierarchical": lambda x, grid, tiled: _hierarchical_allgather(
        x, grid, tiled=tiled),
    "multilane": lambda x, grid, tiled: _multilane_allgather(x, grid,
                                                             tiled=tiled),
    "locality_bruck": lambda x, grid, tiled: _locality_bruck_allgather(
        x, grid, tiled=tiled),
    "xla": lambda x, grid, tiled: _out(_all_gather(x, grid, grid.world),
                                       tiled, x.shape),
}

#: the transpose of each allgather: [p, *shard] -> [*shard]
REDUCE_SCATTERS = {
    "bruck": lambda ct, grid: _bruck_reduce_scatter(ct, grid, grid.world),
    "ring": lambda ct, grid: _ring_reduce_scatter(ct, grid, grid.world),
    "hierarchical": _hierarchical_reduce_scatter,
    "multilane": _multilane_reduce_scatter,
    "locality_bruck": _locality_bruck_reduce_scatter,
    "xla": lambda ct, grid: _reduce_scatter_sum(
        ct.reshape(-1), grid, grid.world).reshape(ct.shape[1:]),
}

#: the gathers that are differentiable: the Bruck schedules (as in the JAX
#: package, where only they may be differentiated with ``assume_varying``)
#: and the library's, whose transpose is the library's reduce-scatter (as
#: ``lax.all_gather``'s is ``psum_scatter``)
DIFFERENTIABLE = ("bruck", "locality_bruck", "xla")


def _check_algorithm(algorithm: str, table: dict) -> None:
    if algorithm == "auto":
        _not_ported("auto")
    if algorithm not in table:
        raise ValueError(f"unknown algorithm {algorithm!r}; known: "
                         f"{tuple(table)}")


class _AllGather(torch.autograd.Function):
    """allgather whose backward is the schedule's reduce-scatter."""

    @staticmethod
    def forward(ctx, x, grid, algorithm, tiled):
        ctx.grid, ctx.algorithm, ctx.x_shape = grid, algorithm, tuple(x.shape)
        return ALLGATHERS[algorithm](x, grid, tiled)

    @staticmethod
    def backward(ctx, g):
        ct = g.reshape((ctx.grid.p,) + ctx.x_shape).contiguous()
        return (REDUCE_SCATTERS[ctx.algorithm](ct, ctx.grid), None, None,
                None)


def allgather(x: torch.Tensor, grid: RankGrid, *,
              algorithm: str = "locality_bruck",
              tiled: bool = False) -> torch.Tensor:
    """Gather every rank's ``x`` over the grid, in grid-rank order:
    [p, *x.shape], or their concatenation along dim 0 when ``tiled``."""
    _check_algorithm(algorithm, ALLGATHERS)
    if x.requires_grad and torch.is_grad_enabled():
        if algorithm not in DIFFERENTIABLE:
            raise ValueError(f"only the gathers {DIFFERENTIABLE} are "
                             f"differentiable, not algorithm={algorithm!r}")
        return _AllGather.apply(x, grid, algorithm, tiled)
    return ALLGATHERS[algorithm](x, grid, tiled)


def reduce_scatter(y: torch.Tensor, grid: RankGrid, *,
                   algorithm: str = "locality_bruck") -> torch.Tensor:
    """Sum-reduce-scatter, the transpose of the chosen allgather: ``y``'s
    leading dim is divisible by p; rank i ends with the i-th tile of the
    sum over ranks. The same edges as the gather, reversed, so the
    locality structure (paper Eq. 4's non-local counts) carries over."""
    _check_algorithm(algorithm, REDUCE_SCATTERS)
    p = grid.p
    if y.ndim == 0 or y.shape[0] % p:
        raise ValueError(f"leading dim of {tuple(y.shape)} not divisible by "
                         f"{p}")
    x_shape = (y.shape[0] // p,) + tuple(y.shape[1:])
    with torch.no_grad():
        return REDUCE_SCATTERS[algorithm](
            y.reshape((p,) + x_shape).contiguous(), grid)


# Algorithms eligible for KV-cache migration (see ``cache_migrate``): the
# locality schedule minimizes inter-pod messages, multilane minimizes
# per-rank inter-pod bytes, and the library's flat gather is the baseline.
MIGRATE_ALGORITHMS = ("locality_bruck", "multilane", "xla")


def cache_migrate(x: torch.Tensor, grid: RankGrid, *,
                  algorithm: str = "auto", tiled: bool = True) -> torch.Tensor:
    """Replicate a sequence-sharded KV-cache slab over the grid: a
    gatherv-shaped replication where Algorithm 2 applies directly."""
    if algorithm == "auto":
        _not_ported("auto")
    if algorithm not in MIGRATE_ALGORITHMS:
        raise ValueError(f"cache_migrate algorithm {algorithm!r} not in "
                         f"{MIGRATE_ALGORITHMS}")
    return ALLGATHERS[algorithm](x, grid, tiled)


# =============================================================================
# Split (start/finish) collectives
# =============================================================================
def allgather_start(x: torch.Tensor, grid: RankGrid, *,
                    algorithm: str = "locality_bruck", tiled: bool = False,
                    stage: bool = False) -> PendingCollective:
    """Issue an allgather; complete it with :func:`allgather_finish`.

    For ``locality_bruck`` the non-local rounds complete in start; every
    other algorithm has no local tail to defer, so start runs the whole
    gather and the split is a program-order hook. When ``x`` needs a
    gradient (the gathers in ``DIFFERENTIABLE``, as :func:`allgather`), the
    pending gather keeps ``x``, and the backward of finish is the
    reduce-scatter. ``stage=True`` lets ``x`` lie on another device than
    the grid's (a card's tensor on a gloo grid): start copies it to the
    grid's device and finish copies the result back to ``x``'s; the
    backward moves the same way around its reduce-scatter, inside finish's
    one autograd node on ``x``'s device, so that every rank's backward
    issues its reduce-scatters in the order of that device's graph."""
    _check_algorithm(algorithm, ALLGATHERS)
    grad = x.requires_grad and torch.is_grad_enabled()
    if grad and algorithm not in DIFFERENTIABLE:
        raise ValueError(f"only the gathers {DIFFERENTIABLE} are "
                         f"differentiable, not algorithm={algorithm!r}")
    with torch.no_grad():
        xs = x.to(grid.device) if stage else x
        if algorithm == "locality_bruck":
            pending = _locality_bruck_allgather_start(xs, grid, tiled=tiled)
        else:
            pending = PendingCollective(
                (ALLGATHERS[algorithm](xs, grid, tiled),),
                _SplitMeta("allgather", "done"))
    if grad or xs is not x:
        pending = PendingCollective(pending.arrays, dataclasses.replace(
            pending.meta, grid=grid, algorithm=algorithm), source=x)
    return pending


class _SplitGatherFinish(torch.autograd.Function):
    """The finish of a differentiable or staged split gather: the gather's
    local tail, on the source's device, forward; the whole reduce-scatter
    on the grid's device backward (the start's rounds sent nothing that
    autograd sees)."""

    @staticmethod
    def forward(ctx, x, pending):
        meta = pending.meta
        ctx.grid, ctx.algorithm, ctx.x_shape = (meta.grid, meta.algorithm,
                                                tuple(x.shape))
        return _locality_bruck_allgather_finish(pending).to(x.device)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        # contiguous on g's own device before the move: g is often a
        # transposed view, and moving it strided costs the host far more
        ct = g.reshape((grid.p,) + ctx.x_shape).contiguous().to(grid.device)
        return REDUCE_SCATTERS[ctx.algorithm](ct, grid).to(g.device), None


def allgather_finish(pending: PendingCollective) -> torch.Tensor:
    """Complete an :func:`allgather_start`; bit-identical to the eager path
    (on the source's device when it was staged)."""
    if pending.meta.op != "allgather":
        raise ValueError(f"not a pending allgather: {pending.meta}")
    if pending.source is not None:
        return _SplitGatherFinish.apply(pending.source, pending)
    return _locality_bruck_allgather_finish(pending)



# =============================================================================
# All-to-all — the two-tier personalized exchange (the MoE dispatch)
# =============================================================================
# The paper's two-tier idea applied to a personalized exchange. Offsets
# o ∈ [1, q) go round-robin over the pl lanes (offset o: lane (o-1) % pl,
# round (o-1) // pl), Algorithm 2's modular lane geometry:
#   1. local collect  — a local all-to-all hands lane λ every local rank's
#      blocks for λ's pods;
#   2. inter-pod rounds — in round t, active lane λ ships ONE aggregated
#      (pl x pl)-block slab to pod R + t·pl + λ + 1; the last round of a
#      non-power q runs with (q-1) - (nrounds-1)·pl lanes: q - 1 non-local
#      messages a pod against pl²(q - 1) for the flat exchange;
#   3. local deliver  — a second local all-to-all fans the slabs' columns
#      (and the own pod's blocks) out to their lanes, then a reordering
#      restores source-rank order.
#: Canonical algorithm names for the all_to_all family.
ALL_TO_ALL_ALGORITHMS = ("locality", "xla")


def _a2a_rounds(q: int, pl: int) -> int:
    """Inter-pod rounds of the two-tier all-to-all: offsets 1..q-1 over pl
    lanes."""
    return -(-(q - 1) // pl) if q > 1 else 0


def _a2a_active(q: int, pl: int, t: int) -> int:
    """Active lanes in inter-pod round ``t`` (partial on the last round of
    a non-power q)."""
    return max(0, min(pl, (q - 1) - t * pl))


def _local_exchange(struct: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """Local all-to-all of ``struct`` (leading dim pl: entry λ is the
    payload for local rank λ). Returns the mirror: entry m is what local
    rank m addressed to this rank. pl - 1 rounds (offset k pairs lane m
    with lane m + k), plus the rank's own entry."""
    pl, l = grid.pl, grid.l
    sends = torch.roll(struct, -l, 0)            # sends[k] -> lane (l+k)%pl
    arr = [sends[0]]
    for k in range(1, pl):
        arr.append(ppermute(sends[k], grid, grid.local,
                            [(m, (m + k) % pl) for m in range(pl)]))
    # arr[k] came from lane (l-k)%pl; reindex to source-lane order
    return torch.roll(torch.stack(arr).flip(0), l + 1, 0)


def _locality_all_to_all_start(x: torch.Tensor, grid: RankGrid
                               ) -> PendingCollective:
    """The local collect and every inter-pod round: each non-local byte is
    sent when start returns; the local delivery and the reordering are
    left to finish."""
    q, pl, p = grid.q, grid.pl, grid.p
    if x.ndim == 0 or x.shape[0] % p:
        raise ValueError(f"all_to_all leading dim of {tuple(x.shape)} not "
                         f"divisible by p={p}")
    if p == 1:
        return PendingCollective((x,), _SplitMeta("all_to_all", "done"))
    blk = (x.shape[0] // p,) + tuple(x.shape[1:])
    xb = x.reshape((q, pl) + blk)                 # [dest_pod][dest_lane]
    if q == 1:   # nothing crosses a pod: the delivery happens in finish
        return PendingCollective((xb[0],), _SplitMeta(
            "all_to_all", "local_only", grid, False, blk))
    nrounds = _a2a_rounds(q, pl)
    # xs[s]: the slab for pod (R+1+s) % q; xs[q-1]: the own pod's
    xs = torch.roll(xb, -(grid.R + 1), 0)
    own, rs = xs[q - 1], xs[:q - 1]
    pad = nrounds * pl - (q - 1)                  # inactive lanes' slots
    if pad:
        rs = torch.cat([rs, rs.new_zeros((pad,) + tuple(rs.shape[1:]))])
    # offset slot s = t·pl + λ  ->  send structure [λ][t][dest_lane]
    sendst = rs.reshape((nrounds, pl, pl) + blk).movedim(1, 0)
    # phase 1: lane λ collects every local rank's slabs for λ's pods
    coll = _local_exchange(sendst, grid)     # (pl_src, nrounds, pl_dst, ..)
    A = coll.movedim(1, 0)
    # phase 2: one aggregated non-local message per active lane per round
    recvs = []
    for t in range(nrounds):
        off = t * pl + grid.l + 1
        pairs = ([(R, (R + off) % q) for R in range(q)]
                 if grid.l < _a2a_active(q, pl, t) else [])
        recvs.append(ppermute(A[t].contiguous(), grid, grid.outer, pairs))
    return PendingCollective((torch.stack(recvs), own), _SplitMeta(
        "all_to_all", "pending", grid, False, blk, group=nrounds))


def _locality_all_to_all_finish(pending: PendingCollective) -> torch.Tensor:
    """The local delivery of the received slabs' columns (and the own
    pod's blocks), then canonical source-rank order."""
    meta = pending.meta
    if meta.kind == "done":
        return pending.arrays[0]
    grid, blk = meta.grid, meta.x_shape
    q, pl, p = grid.q, grid.pl, grid.p
    nrounds = meta.group if meta.kind == "pending" else 0
    if meta.kind == "pending":
        slabs, own = pending.arrays
        # the payload for lane m: the m-columns of every received slab, then
        # the own pod's block, one structure for the pl - 1 local rounds
        cols = slabs.movedim(2, 0).reshape((pl, nrounds * pl) + blk)
        struct = torch.cat([cols, own[:, None]], 1)
    else:
        (own,) = pending.arrays
        struct = own[:, None]
    got = _local_exchange(struct, grid)
    # got[λ][s], s < nrounds·pl: the block from pod (R - (t·pl+λ+1)) % q,
    # source lane s % pl; got[λ][-1]: the own pod's block from lane λ
    own_blocks = got[:, -1]
    if q > 1:
        rem = got[:, :-1].reshape((pl, nrounds, pl) + blk).movedim(1, 0)
        rem = rem.reshape((nrounds * pl, pl) + blk)[:q - 1]
        stacked = torch.cat([own_blocks[None], rem])
        # stacked[o]: the blocks from pod (R - o) % q -> canonical pod order
        canon = torch.roll(stacked.flip(0), grid.R + 1, 0)
    else:
        canon = own_blocks[None]
    # block i of the output (the input's leading-dim split) came from rank i
    return canon.reshape((p * blk[0],) + blk[1:])


def _xla_all_to_all(x: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """The flat pairwise exchange: the library's ``all_to_all_single`` over
    the grid's group (gloo has it; the recorder prices it as the HLO prices
    an all-to-all, b/p to every other rank)."""
    _check_device(x, grid)
    if x.ndim == 0 or x.shape[0] % grid.p:
        raise ValueError(f"all_to_all leading dim of {tuple(x.shape)} not "
                         f"divisible by p={grid.p}")
    if grid.p == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    grid.recorder.group("all-to-all", grid.world.members, grid.world.index,
                        out.numel() * out.element_size())
    dist.all_to_all_single(out, x, group=grid.world.group)
    return out


def _all_to_all(x: torch.Tensor, grid: RankGrid,
                algorithm: str) -> torch.Tensor:
    if algorithm == "locality":
        return _locality_all_to_all_finish(
            _locality_all_to_all_start(x, grid))
    return _xla_all_to_all(x, grid)


def _check_a2a(algorithm: str) -> None:
    if algorithm == "auto":
        _not_ported("auto")
    if algorithm not in ALL_TO_ALL_ALGORITHMS:
        raise ValueError(f"unknown all_to_all algorithm {algorithm!r}; "
                         f"known: {ALL_TO_ALL_ALGORITHMS + ('auto',)}")


class _AllToAll(torch.autograd.Function):
    """The exchange on the grid's device, from and back to ``x``'s (a
    card's tensor on a gloo grid stages through the host inside this one
    node); its backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, grid, algorithm):
        ctx.grid, ctx.algorithm = grid, algorithm
        return _all_to_all(x.to(grid.device), grid, algorithm).to(x.device)

    @staticmethod
    def backward(ctx, g):
        ct = g.contiguous().to(ctx.grid.device)
        return (_all_to_all(ct, ctx.grid, ctx.algorithm).to(g.device), None,
                None)


def all_to_all(x: torch.Tensor, grid: RankGrid, *,
               algorithm: str = "locality",
               stage: bool = False) -> torch.Tensor:
    """Personalized exchange over the grid: ``x``'s leading dim splits into
    p blocks, block j goes to grid rank j, and block i of the output came
    from grid rank i (``lax.all_to_all`` with ``split_axis=concat_axis=0,
    tiled=True``). Differentiable: the backward is the same algorithm's
    exchange of the cotangent. ``stage=True`` lets ``x`` lie on another
    device than the grid's (a card's tensor on a gloo grid), moved there
    and back, both ways, inside the one autograd node."""
    _check_a2a(algorithm)
    if x.requires_grad and torch.is_grad_enabled() or (
            stage and x.device.type != grid.device.type):
        return _AllToAll.apply(x, grid, algorithm)
    return _all_to_all(x, grid, algorithm)


def all_to_all_start(x: torch.Tensor, grid: RankGrid, *,
                     algorithm: str = "locality") -> PendingCollective:
    """Issue an all-to-all; complete it with :func:`all_to_all_finish`.
    For "locality" every inter-pod round completes in start; "xla" has no
    local tail, so start runs it all. A ``x`` that needs a gradient is
    kept, and the backward of finish is the eager exchange of the
    cotangent."""
    _check_a2a(algorithm)
    grad = x.requires_grad and torch.is_grad_enabled()
    with torch.no_grad():
        if algorithm == "locality":
            pending = _locality_all_to_all_start(x, grid)
        else:
            pending = PendingCollective((_xla_all_to_all(x, grid),),
                                        _SplitMeta("all_to_all", "done"))
    if grad:
        pending = PendingCollective(pending.arrays, dataclasses.replace(
            pending.meta, grid=grid, algorithm=algorithm), source=x)
    return pending


class _SplitAllToAllFinish(torch.autograd.Function):
    """The finish of a differentiable split all-to-all: the local tail
    forward, the whole exchange of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.grid, ctx.algorithm = pending.meta.grid, pending.meta.algorithm
        return _locality_all_to_all_finish(pending)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.grid, ctx.algorithm), None


def all_to_all_finish(pending: PendingCollective) -> torch.Tensor:
    """Complete an :func:`all_to_all_start`; bit-identical to eager."""
    if pending.meta.op != "all_to_all":
        raise ValueError(f"not a pending all_to_all: {pending.meta}")
    if pending.source is not None:
        return _SplitAllToAllFinish.apply(pending.source, pending)
    return _locality_all_to_all_finish(pending)

# =============================================================================
# Reductions
# =============================================================================
REDUCE_BINOPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _binop(op: str):
    if op not in REDUCE_BINOPS:
        raise ValueError(f"unknown reduction op {op!r}; "
                         f"known: {sorted(REDUCE_BINOPS)}")
    return REDUCE_BINOPS[op]


def _rhd_reduce_scatter(x: torch.Tensor, grid: RankGrid, axis: Axis,
                        op: str = "sum") -> torch.Tensor:
    """Recursive-halving reduce-scatter over ``axis`` (XOR partners):
    log2(p) rounds, round k exchanging 1/2^{k+1} of the buffer; rank i
    ends with tile i of the reduction."""
    combine = _binop(op)
    p, idx = axis.size, axis.index
    if x.shape[0] % p or p & (p - 1):
        raise ValueError(f"recursive halving needs a power-of-two size "
                         f"dividing the leading dim: {p}, {tuple(x.shape)}")
    buf = x
    d = p // 2
    while d >= 1:
        half = buf.shape[0] // 2
        bit = (idx & d) != 0
        # keep the half matching our bit (MSB-first -> final tile = idx)
        send, keep = (buf[:half], buf[half:]) if bit else (buf[half:],
                                                           buf[:half])
        recv = ppermute(send, grid, axis, [(s, s ^ d) for s in range(p)])
        buf = combine(keep, recv)
        d //= 2
    return buf


def _rd_allreduce(x: torch.Tensor, grid: RankGrid, axis: Axis,
                  op: str = "sum") -> torch.Tensor:
    """Recursive-doubling allreduce over ``axis``, any size: powers of two
    run log2(p) XOR-partner full-buffer rounds; other sizes fold the p - m
    surplus ranks (m = largest power of two <= p) into a core partner, run
    the core, and unfold the result back — log2(m) + 2 rounds. A rank that
    receives nothing in a round keeps its value (ppermute gives it zeros,
    which an unmasked max would take)."""
    combine = _binop(op)
    p, idx = axis.size, axis.index
    if p == 1:
        return x
    buf = x
    m = 1 << (p.bit_length() - 1)
    surplus = p - m
    if surplus:
        recv = ppermute(buf, grid, axis, [(s, s - m) for s in range(m, p)])
        if idx < surplus:
            buf = combine(buf, recv)
    d = 1
    while d < m:
        recv = ppermute(buf, grid, axis, [(s, s ^ d) for s in range(m)])
        if idx < m:
            buf = combine(buf, recv)
        d *= 2
    if surplus:
        recv = ppermute(buf, grid, axis, [(s, s + m) for s in range(surplus)])
        if idx >= m:
            buf = recv
    return buf


def _locality_allreduce(x: torch.Tensor, grid: RankGrid, *,
                        outer_algorithm: str = "rhd",
                        op: str = "sum") -> torch.Tensor:
    """Locality-aware allreduce: local reduce-scatter → per-lane allreduce
    across regions → local allgather (Bruck).

    ``outer_algorithm``: "rhd" (recursive halving + Bruck gather; on a
    non-power region count the Bruck-transpose reduce-scatter), "rd"
    (recursive doubling, fold/unfold for non-powers) or "psum" (the
    library's allreduce). Non-sum ops skip the scatter structure: local
    then per-lane outer recursive doubling. Any shape (flattened and
    padded internally)."""
    r, pl = grid.q, grid.pl
    if op != "sum":
        _binop(op)
        if pl > 1:
            x = _rd_allreduce(x, grid, grid.local, op=op)
        if r > 1:
            x = _rd_allreduce(x, grid, grid.outer, op=op)
        return x
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % pl
    if pad:
        flat = F.pad(flat, (0, pad))
    part = _reduce_scatter_sum(flat, grid, grid.local) if pl > 1 else flat
    if r > 1:
        if outer_algorithm == "rhd":
            npart = part.shape[0]
            pad2 = (-npart) % r
            if pad2:
                part = F.pad(part, (0, pad2))
            if r & (r - 1):
                rs = _bruck_reduce_scatter(part.reshape(r, -1), grid,
                                           grid.outer)
            else:
                rs = _rhd_reduce_scatter(part, grid, grid.outer)
            part = _bruck_allgather(rs, grid, grid.outer, tiled=True)
            if pad2:
                part = part[:npart]
        elif outer_algorithm == "rd":
            part = _rd_allreduce(part, grid, grid.outer)
        elif outer_algorithm == "psum":
            part = _all_reduce(part, grid, grid.outer, "sum")
        else:
            raise ValueError(f"unknown outer_algorithm {outer_algorithm!r}")
    full = _bruck_allgather(part, grid, grid.local, tiled=True) if pl > 1 \
        else part
    if pad:
        full = full[:n]
    return full.reshape(shape)


def allreduce(x: torch.Tensor, grid: RankGrid, *, algorithm: str = "locality",
              outer_algorithm: str = "rhd", op: str = "sum") -> torch.Tensor:
    """Allreduce: 'locality' (paper-structured) or 'xla' (the library's
    allreduce with ``op``)."""
    _binop(op)
    if algorithm == "auto":
        _not_ported("auto")
    if algorithm == "xla" or grid.pl == 1:
        return _all_reduce(x, grid, grid.world, op)
    if algorithm == "locality":
        return _locality_allreduce(x, grid, outer_algorithm=outer_algorithm,
                                   op=op)
    raise ValueError(f"unknown allreduce algorithm {algorithm!r}")


def allreduce_start(x: torch.Tensor, grid: RankGrid, *,
                    algorithm: str = "locality", outer_algorithm: str = "rhd",
                    op: str = "sum") -> PendingCollective:
    """Issue an allreduce; complete it with :func:`allreduce_finish`. The
    rounds form one dependency chain, so start runs the whole reduction."""
    red = allreduce(x, grid, algorithm=algorithm,
                    outer_algorithm=outer_algorithm, op=op)
    return PendingCollective((red,), _SplitMeta("allreduce", "done"))


def allreduce_finish(pending: PendingCollective) -> torch.Tensor:
    if pending.meta.op != "allreduce":
        raise ValueError(f"not a pending allreduce: {pending.meta}")
    return pending.arrays[0]


# =============================================================================
# Logsumexp combine — the serve decode cache-combine (serve/engine.py)
# =============================================================================
def logsumexp_combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      grid: RankGrid, *, algorithm: str = "locality",
                      outer_algorithm: str = "rhd"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Numerically safe combine of flash-style partial softmax stats.

    Each rank holds, for its slice of the attention (reduction) axis,
    o (..., D) = sum_j exp(s_j - m) v_j, m (...) its running maximum and
    l (...) = sum_j exp(s_j - m). Three steps over the grid:

      1. max-allreduce of ``m`` -> the global maximum M (recursive doubling
         per locality level; the payload is 1/(D+1) of the bytes);
      2. this rank's rescale of o and l by exp(m - M): a rank whose slice
         is fully masked carries m = NEG_INF, o = l = 0, and adds 0;
      3. one packed sum-allreduce of [o, l] ("locality": the paper-structured
         local reduce-scatter, outer allreduce, local allgather; "xla": the
         library's allreduce).

    Returns (o_total, l_total) in fp32; the caller divides o by l. Composed
    of the split halves, so the eager and the overlapped serve paths cannot
    drift."""
    pending = logsumexp_combine_start(m, grid, algorithm=algorithm)
    return logsumexp_combine_finish(o, l, pending, algorithm=algorithm,
                                    outer_algorithm=outer_algorithm)


def logsumexp_combine_start(m: torch.Tensor, grid: RankGrid, *,
                            algorithm: str = "locality") -> PendingCollective:
    """Phase 1 of the decode cache-combine: the max-allreduce of the running
    maxima (``outer_algorithm="rd"``, ``op="max"``). It needs only ``m``:
    the accumulation of o and l can run beside it."""
    m = m.float()
    M = allreduce(m, grid, algorithm=algorithm, outer_algorithm="rd",
                  op="max")
    return PendingCollective((m, M), _SplitMeta("logsumexp", "max_done", grid,
                                                algorithm=algorithm))


def logsumexp_combine_finish(o: torch.Tensor, l: torch.Tensor,
                             pending: PendingCollective, *,
                             algorithm: str | None = None,
                             outer_algorithm: str = "rhd"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phases 2 and 3: rescale by exp(m - M), one packed [o, l]
    sum-allreduce. ``algorithm`` defaults to the start's."""
    meta = pending.meta
    if meta.op != "logsumexp":
        raise ValueError(f"not a pending logsumexp combine: {meta}")
    m, M = pending.arrays
    scale = torch.exp(m - M)
    o32 = o.float() * scale[..., None]
    l32 = l.float() * scale
    payload = torch.cat([o32.reshape(-1), l32.reshape(-1)])
    tot = allreduce(payload, meta.grid, algorithm=algorithm or meta.algorithm,
                    outer_algorithm=outer_algorithm, op="sum")
    n_o = o32.numel()
    return tot[:n_o].reshape(o32.shape), tot[n_o:].reshape(l32.shape)


# =============================================================================
# Unified collective surface — one entry point, one vocabulary
# =============================================================================
#: Canonical collective kinds, as in the JAX package ("combine" is the
#: decode logsumexp cache-combine; "logsumexp_combine" is its alias).
KINDS = ("allgather", "allreduce", "reduce_scatter", "all_to_all",
         "cache_migrate", "combine")

#: The algorithm vocabulary per kind: the JAX package's strings.
ALGORITHMS_BY_KIND = {
    "allgather": ("bruck", "ring", "hierarchical", "multilane",
                  "locality_bruck", "xla", "auto"),
    "allreduce": ("locality", "xla", "auto"),
    "reduce_scatter": ("bruck", "ring", "hierarchical", "multilane",
                       "locality_bruck", "xla"),
    "all_to_all": ("locality", "xla", "auto"),
    "cache_migrate": ("locality_bruck", "multilane", "xla", "auto"),
    "combine": ("locality", "xla", "auto"),
}

#: Per-kind default when ``algorithm`` is omitted.
DEFAULT_ALGORITHM = {
    "allgather": "locality_bruck", "allreduce": "locality",
    "reduce_scatter": "locality_bruck", "all_to_all": "locality",
    "cache_migrate": "auto", "combine": "locality",
}

_KIND_ALIASES = {"logsumexp_combine": "combine"}


def _norm_kind(kind: str) -> str:
    kind = _KIND_ALIASES.get(kind, kind)
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")
    return kind


def collective(kind: str, *operands: torch.Tensor, grid: RankGrid,
               algorithm: str | None = None, start: bool = False, **kwargs):
    """The single collective entry point (thin dispatch, no new math).

    ``collective(kind, x, grid=grid, algorithm=...)`` runs the named family
    eagerly; ``start=True`` returns a :class:`PendingCollective` to complete
    with :func:`finish`. Operands: one tensor for every kind but "combine",
    which takes ``(o, m, l)`` eagerly and ``(m,)`` at start (o and l go to
    :func:`finish`). Remaining ``kwargs`` (``tiled``, ``op``,
    ``outer_algorithm``) pass through to the family function."""
    kind = _norm_kind(kind)
    if algorithm is None:
        algorithm = DEFAULT_ALGORITHM[kind]
    if algorithm not in ALGORITHMS_BY_KIND[kind]:
        raise ValueError(
            f"unknown algorithm {algorithm!r} for kind {kind!r}; known: "
            f"{ALGORITHMS_BY_KIND[kind]}")
    if kind == "combine":
        if start:
            (m,) = operands
            return logsumexp_combine_start(m, grid, algorithm=algorithm,
                                           **kwargs)
        o, m, l = operands
        return logsumexp_combine(o, m, l, grid, algorithm=algorithm, **kwargs)
    (x,) = operands
    if kind == "reduce_scatter":
        if start:
            raise NotImplementedError(
                "reduce_scatter has no start/finish split (its rounds form "
                "one dependency chain ending at the caller)")
        return reduce_scatter(x, grid, algorithm=algorithm, **kwargs)
    eager, starter = {
        "allgather": (allgather, allgather_start),
        "allreduce": (allreduce, allreduce_start),
        "cache_migrate": (cache_migrate, None),
        "all_to_all": (all_to_all, all_to_all_start),
    }[kind]
    if start:
        if starter is None:
            raise NotImplementedError(f"{kind} has no start/finish split")
        return starter(x, grid, algorithm=algorithm, **kwargs)
    return eager(x, grid, algorithm=algorithm, **kwargs)


def finish(pending: PendingCollective, *operands: torch.Tensor, **kwargs):
    """Complete any ``collective(..., start=True)``. The "combine" kind
    takes its deferred ``(o, l)`` here; every other kind takes none."""
    if pending.meta.op == "logsumexp":
        o, l = operands
        return logsumexp_combine_finish(o, l, pending, **kwargs)
    if operands or kwargs:
        raise ValueError(f"{pending.meta.op} takes no operands at finish")
    return {"allgather": allgather_finish,
            "allreduce": allreduce_finish,
            "all_to_all": all_to_all_finish}[pending.meta.op](pending)


@dataclasses.dataclass(frozen=True)
class Collective:
    """A configured collective: kind + algorithm + grid bound once, applied
    many times — ``Collective("allgather", grid)`` then ``c(x)`` /
    ``c.start(x)`` + ``c.finish(pending)``. Sugar over :func:`collective`."""

    kind: str
    grid: RankGrid
    algorithm: str | None = None

    def __post_init__(self):
        _norm_kind(self.kind)

    def __call__(self, *operands, **kwargs):
        return collective(self.kind, *operands, grid=self.grid,
                          algorithm=self.algorithm, **kwargs)

    def start(self, *operands, **kwargs) -> PendingCollective:
        return self(*operands, start=True, **kwargs)

    @staticmethod
    def finish(pending: PendingCollective, *operands, **kwargs):
        return finish(pending, *operands, **kwargs)
