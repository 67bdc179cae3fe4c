"""Topology / region abstractions for locality-aware collectives.

A *region* (paper §2.1) is a set of ranks within which communication is
cheap (intra-node or intra-socket on MPI clusters, the GPUs of one NVLink
host here). Ranks are numbered region-major: grid rank = region * p_local +
local_rank, as in the JAX package's ("pod", "local") mesh axes.

``RegionMap``, ``ceil_log``, ``rd_rounds`` and ``is_power_of`` are
transcribed from ``src/repro/core/topology.py``. ``RankGrid`` takes the
place of its mesh helpers: ``q`` pods x ``pl`` lanes over a
``torch.distributed`` group, with this rank's ``(R, l)`` and the process
groups of its pod and its lane; with a third tier, ``m`` model ranks
(tensor parallelism) at each ``(R, l)``, the JAX ("pod", "data", "model")
mesh.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .comm_record import CommRecorder


@dataclasses.dataclass(frozen=True)
class RegionMap:
    """Maps flat ranks <-> (region, local_rank) for a two-level hierarchy."""

    p: int          # total ranks
    p_local: int    # ranks per region

    def __post_init__(self):
        if self.p % self.p_local != 0:
            raise ValueError(f"p={self.p} not divisible by p_local={self.p_local}")

    @property
    def n_regions(self) -> int:
        return self.p // self.p_local

    def region_of(self, rank: int) -> int:
        return rank // self.p_local

    def local_rank_of(self, rank: int) -> int:
        return rank % self.p_local

    def rank_of(self, region: int, local_rank: int) -> int:
        return (region % self.n_regions) * self.p_local + (local_rank % self.p_local)

    def is_local(self, src: int, dst: int) -> bool:
        return self.region_of(src) == self.region_of(dst)


def ceil_log(base: int, x: int) -> int:
    """ceil(log_base(x)) computed exactly with integers."""
    if x <= 1:
        return 0
    steps, cover = 0, 1
    while cover < x:
        cover *= base
        steps += 1
    return steps


def rd_rounds(n: int) -> int:
    """Message rounds of the non-power-capable recursive-doubling allreduce
    (``collectives._rd_allreduce``): log2(n) for powers of two, otherwise
    log2(m) + 2 for the fold/unfold adaptation (m = largest power of two
    below n: one fold round, the power-of-two core, one unfold round)."""
    if n <= 1:
        return 0
    lg = ceil_log(2, n)
    return lg if n & (n - 1) == 0 else (lg - 1) + 2


def is_power_of(base: int, x: int) -> bool:
    if x < 1:
        return False
    while x % base == 0:
        x //= base
    return x == 1


@dataclasses.dataclass(frozen=True)
class Axis:
    """One communication axis of a :class:`RankGrid`, seen from this rank:
    the counterpart of a tuple of JAX mesh axis names inside ``shard_map``.

    ``members`` are grid ranks in axis order (``lax.axis_index`` order) and
    ``index`` is this rank's position among them; ``group`` is the process
    group over the members, for the group collectives (None for the
    one-member lane axis of :meth:`RankGrid.pod_grid`, over which nothing
    is sent)."""

    name: str                      # "world", "local" (pod), "outer" (lane)
    #                                or "model"
    members: tuple[int, ...]
    index: int
    group: dist.ProcessGroup | None

    @property
    def size(self) -> int:
        return len(self.members)


class RankGrid:
    """``q`` pods x ``pl`` lanes of ``torch.distributed`` ranks, and ``m``
    model ranks at each of them (tensor parallelism; 1 without).

    Grid rank ``(R * pl + l) * m + t`` is global rank
    ``all_ranks[(R * pl + l) * m + t]``: the row-major order of the JAX
    ("pod", "data", "model") mesh. ``t`` picks this rank's model lane, the
    q·pl ranks that share it, over which the locality collectives run; the
    DP axes see that lane alone: ``rank = R * pl + l``, ``p = q * pl``,
    ``ranks`` the lane's global ranks. Four axes: ``world`` (the lane's
    q·pl ranks, the JAX ``outer + local`` axes), ``local`` (the pl ranks of
    this rank's pod in the lane), ``outer`` (the q ranks of this rank's
    DP lane, one per pod) and ``model`` (the m ranks that share ``(R, l)``,
    all in one pod; members by grid rank). ``recorder`` counts every
    message the port's collectives send from this rank over the lane
    (``comm_record``); the model tier's are counted by :meth:`model_grid`'s
    own recorder. ``all_group`` spans every rank of the grid, all q·pl·m
    (the lane's group when m = 1), for what every rank must agree on.

    Build it with :meth:`build`, which every rank of the default group must
    call with the same arguments, in the same order as any other group
    creation (``dist.new_group`` demands it).
    """

    def __init__(self, q: int, pl: int, ranks: tuple[int, ...], rank: int,
                 world: Axis, local: Axis, outer: Axis,
                 model: Axis | None = None,
                 all_ranks: tuple[int, ...] | None = None,
                 all_group=None):
        self.q, self.pl, self.p = q, pl, q * pl
        self.ranks = ranks
        self.rank = rank
        self.R, self.l = divmod(rank, pl)
        self.world, self.local, self.outer = world, local, outer
        self.model = model or Axis("model", (rank,), 0, None)
        self.m, self.t = self.model.size, self.model.index
        self.all_ranks = all_ranks or ranks
        self.group = world.group
        self.all_group = all_group or self.group
        self.backend = dist.get_backend(self.group)
        self.device = torch.device("cuda" if self.backend == "nccl" else "cpu")
        self.recorder = CommRecorder(pl)
        self._model_grid = None

    def __repr__(self) -> str:
        tp = f", m={self.m}, t={self.t}" if self.m > 1 else ""
        return (f"RankGrid(q={self.q}, pl={self.pl}{tp}, rank={self.rank}, "
                f"R={self.R}, l={self.l}, backend={self.backend})")

    @property
    def grid_rank(self) -> int:
        """This rank's place in the whole grid, (R * pl + l) * m + t."""
        return self.rank * self.m + self.t

    def global_rank(self, grid_rank: int) -> int:
        return self.ranks[grid_rank]

    @classmethod
    def build(cls, q: int, pl: int, m: int = 1, ranks=None
              ) -> RankGrid | None:
        """Make the grid over global ``ranks`` (default: the first q·pl·m
        of the default group). Returns None on a rank outside the grid."""
        if q < 1 or pl < 1 or m < 1:
            raise ValueError(f"grid {q} x {pl} x {m}")
        p, n = q * pl, q * pl * m
        ranks = tuple(range(n)) if ranks is None else tuple(ranks)
        if len(ranks) != n or list(ranks) != sorted(set(ranks)):
            raise ValueError(f"grid {q} x {pl} x {m} needs {n} increasing "
                             f"ranks (the groups' rank order), got {ranks}")
        if max(ranks) >= dist.get_world_size():
            raise ValueError(f"ranks {ranks} exceed the world of "
                             f"{dist.get_world_size()}")
        me = dist.get_rank()
        # every rank makes every group, in one order: per model lane t its
        # world, pods and DP lanes, then the model groups and the whole grid
        lane_groups = []
        for t in range(m):
            lane = ranks[t::m]
            lane_groups.append((
                lane, dist.new_group(list(lane)),
                [dist.new_group([lane[R * pl + l] for l in range(pl)])
                 for R in range(q)],
                [dist.new_group([lane[R * pl + l] for R in range(q)])
                 for l in range(pl)]))
        models = ([dist.new_group(list(ranks[i * m:(i + 1) * m]))
                   for i in range(p)] if m > 1 else None)
        everyone = dist.new_group(list(ranks)) if m > 1 else None
        if me not in ranks:
            return None
        rank, t = divmod(ranks.index(me), m)
        R, l = divmod(rank, pl)
        lane, lane_group, pods, dp_lanes = lane_groups[t]
        model = (Axis("model", tuple(rank * m + j for j in range(m)), t,
                      models[rank]) if m > 1 else None)
        grid = cls(q, pl, lane, rank,
                   Axis("world", tuple(range(p)), rank, lane_group),
                   Axis("local", tuple(R * pl + j for j in range(pl)), l,
                        pods[R]),
                   Axis("outer", tuple(j * pl + l for j in range(q)), R,
                        dp_lanes[l]),
                   model, ranks, everyone)
        if grid.backend == "nccl" and p > 1:
            grid._first_batch()
        return grid

    def pod_grid(self) -> RankGrid:
        """This rank's pod as a grid of its own, 1 pod x pl lanes, over the
        pod's process group: no group is made, so a rank may build it
        alone. It has a recorder of its own; every edge is local."""
        pl, l = self.pl, self.l
        members = tuple(range(pl))
        group = self.local.group
        return RankGrid(1, pl, tuple(self.ranks[self.R * pl + j]
                                     for j in range(pl)), l,
                        Axis("world", members, l, group),
                        Axis("local", members, l, group),
                        Axis("outer", (l,), 0, None))

    def lane_grid(self) -> RankGrid:
        """This rank's lane (its position in every pod) as a grid of its
        own, 1 x q over the lane's process group, as :meth:`pod_grid`. Its
        members sit in q different pods, so its recorder counts every edge
        non-local."""
        q, l = self.q, self.l
        members = tuple(range(q))
        group = self.outer.group
        lane = RankGrid(1, q, tuple(self.ranks[R * self.pl + l]
                                    for R in range(q)), self.R,
                        Axis("world", members, self.R, group),
                        Axis("local", members, self.R, group),
                        Axis("outer", (self.R,), 0, None))
        lane.recorder = CommRecorder(1)
        return lane

    def model_grid(self) -> RankGrid:
        """This rank's model tier as a grid of its own, 1 pod x m lanes over
        the model group (one instance a grid: its recorder keeps the model
        tier's messages, every edge local, as all of them share a pod)."""
        if self._model_grid is None:
            m, t = self.m, self.t
            members = tuple(range(m))
            group = self.model.group
            ranks = tuple(self.all_ranks[g] for g in self.model.members)
            self._model_grid = RankGrid(
                1, m, ranks, t, Axis("world", members, t, group),
                Axis("local", members, t, group), Axis("outer", (t,), 0, None))
        return self._model_grid

    def _first_batch(self) -> None:
        """NCCL needs every rank of a group in the group's first
        ``batch_isend_irecv``; the collectives' rounds may leave ranks out
        (hierarchical's master rounds), so one ring round goes first."""
        send = torch.zeros(1, device=self.device)
        recv = torch.empty_like(send)
        nxt = self.ranks[(self.rank + 1) % self.p]
        prv = self.ranks[(self.rank - 1) % self.p]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, self.group),
            dist.P2POp(dist.irecv, recv, prv, self.group)])
        for r in reqs:
            r.wait()
