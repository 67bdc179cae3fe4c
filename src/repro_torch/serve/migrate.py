"""Cross-pod cache migration of a batch-sharded grid: the port's
``make_migrate_insert_fn`` (``repro.serve.scheduler``).

A request homed in pod h is prefilled by h's ranks alone; when the row it
was given lives in another pod, its B = 1 cache moves to the rank that owns
the row. The JAX scheduler does it in two moves:

1. ``device_put(req_cache, donor_sh)``: the slab is resharded into the
   **donor layout**, each K/V leaf sequence-sharded over the span of its
   own length (``ResolvedServeSpec.spans``: a window layer's ring of
   min(L, window) slots may take another span than the full-length
   leaves): ("pod", "data"), shard i of L / p slots on rank i, pod-major;
   ("data",), shard j of L / pl slots on every rank of lane j, the pods
   replicating; None, nothing sharded. GSPMD moves it implicitly and
   nothing counts it.
2. one ``cache_migrate`` per sequence-sharded leaf, over its span
   (``outer=("pod",), local=("data",)``, or ``outer=("data",), local=()``,
   which the JAX function runs as ``bruck``), then the masked row insert.

Here the first move is explicit: rank i gets its donor shard from the
home-pod rank of its lane (h * pl + i % pl), which holds the whole slab, by
point-to-point sends recorded on the grid's ``CommRecorder`` and counted
apart (``donor_*``); a rank of the home pod sends nothing to itself. The
leaves that are not sequence-sharded (``pos`` with the request's first
token, the SSM ``conv`` and ``h``, and a K/V leaf whose span is None) go
whole to the owner from the home-pod rank of its lane. Then every rank of
a span runs :func:`~repro_torch.core.collectives.cache_migrate` on each of
its K/V shards with the spec's algorithm (over the grid, or over its
pod's grid for a ("data",) span, every pod alike), its messages read from
the recorders around the collectives alone; the owner inserts the row and
the other ranks drop the slab. On a gloo grid the tensors a rank sends or
gathers stage through the host (``staging_bytes``).

On a grid with a "model" tier the engine hands it the rank's model lane
(``RankGrid``'s ``rank``, ``p`` and groups are the lane's) and the cache
shapes of the rank's KV heads (or SSD heads), so each lane moves its own
heads: 1/m of the bytes where m divides the KV heads.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..core import collectives as C
from ..core.comm_record import CollectiveStats
from .spec import DP_AXES

#: the leaves a donor layout may shard over the sequence, and their L dim
SEQ_LEAVES = ("k", "v", "k_ring", "v_ring")
SEQ_DIM = 2                   # (n_layers, B, L, KV, D)


def sent_of(counts: dict) -> tuple[float, float, float]:
    """(bytes, non-local bytes, non-local messages) of a recorder's
    ``edge_counts``."""
    return (counts["permute_bytes_local"] + counts["permute_bytes_nonlocal"]
            + counts["group_bytes_local"] + counts["group_bytes_nonlocal"],
            counts["permute_bytes_nonlocal"] + counts["group_bytes_nonlocal"],
            counts["permute_edges_nonlocal"] + counts["group_msgs_nonlocal"])


def stage(t: torch.Tensor, device) -> tuple[torch.Tensor, int]:
    """(``t`` on the device type of ``device``, the bytes moved there): a
    gloo grid takes host tensors, so a card's tensor stages through the
    host and back; nothing moves when the types already agree."""
    if t.device.type == torch.device(device).type:
        return t, 0
    return t.to(device), t.numel() * t.element_size()


def _add(total: dict, before: dict, after: dict) -> None:
    for k in after:
        total[k] += after[k] - before[k]


class MigrateInsert:
    """Moves a prefilled B = 1 cache from its home pod to the row's owner
    (module docstring). Every rank of the grid calls it, in the same order.

    ``shapes`` are the (shape, dtype) of a B = 1 cache's leaves but ``pos``
    (``Transformer.cache_shapes``); ``spans`` the donor span of each K/V
    leaf by name (absent or None: moved whole); ``seq_span`` the
    full-length cache's, which ``span`` reports; ``device`` is where the
    cache lives.
    Counters, per rank: ``migrations``; ``donor`` and ``collective``, the
    recorder's ``edge_counts`` summed over the donor moves and over the
    collectives; ``sent_by_request`` (rid -> bytes this rank sent for it);
    host seconds in the donor move, the collective and the insert; the
    bytes staged between the card and a gloo grid's host tensors.
    """

    def __init__(self, grid, seq_span, algorithm: str, shapes: dict,
                 device: torch.device, spans: dict):
        if algorithm not in C.MIGRATE_ALGORITHMS:
            raise ValueError(f"migrate algorithm {algorithm!r} not in "
                             f"{C.MIGRATE_ALGORITHMS}")
        self.grid, self.algorithm, self.device = grid, algorithm, device
        self.shapes = shapes
        self.span = seq_span
        # each sharded leaf's span, and the grid its collective runs over
        self.spans = {n: spans[n] for n in SEQ_LEAVES
                      if n in shapes and spans.get(n) is not None}
        self.seq = tuple(self.spans)
        pod = grid.pod_grid() if ("data",) in self.spans.values() else None
        self.cgrids = {DP_AXES: grid, ("data",): pod}
        self.migrations = 0
        self.donor = CollectiveStats().edge_counts()          # all zero
        self.collective = CollectiveStats().edge_counts()
        self.sent_by_request: dict[int, float] = {}
        self.donor_s = self.collective_s = self.insert_s = 0.0
        self.staging_bytes = 0

    # -- geometry -------------------------------------------------------
    def shard_of(self, name: str, rank: int) -> int:
        """The donor shard of leaf ``name`` that grid rank ``rank`` holds."""
        return rank if self.spans[name] == DP_AXES else rank % self.grid.pl

    def sender(self, home: int, rank: int) -> int:
        """The home-pod rank that sends grid rank ``rank`` what it needs."""
        return home * self.grid.pl + rank % self.grid.pl

    def _cgrid(self, name: str):
        return self.cgrids[self.spans[name]]

    def _shard(self, name: str, leaf: torch.Tensor, i: int) -> torch.Tensor:
        n = leaf.shape[SEQ_DIM] // self._cgrid(name).p
        return leaf.narrow(SEQ_DIM, i * n, n).contiguous()

    def _shard_shape(self, name: str) -> tuple[tuple[int, ...], torch.dtype]:
        shape, dtype = self.shapes[name]
        shape = list(shape)
        shape[SEQ_DIM] //= self._cgrid(name).p
        return tuple(shape), dtype

    def _stage(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        t, n = stage(t, device)
        self.staging_bytes += n
        return t

    # -- the move -------------------------------------------------------
    def __call__(self, rid: int, req_cache: dict | None, tok0: int | None,
                 home: int, owner: int, insert) -> int | None:
        """Migrate request ``rid``'s cache from pod ``home`` to grid rank
        ``owner``. Ranks of the home pod pass the prefill's ``req_cache``
        and first token, the others None. On the owner, ``insert(leaves)``
        gets the whole B = 1 cache on ``device`` and the first token is
        returned; None elsewhere."""
        g = self.grid
        me, tdev, peer = g.rank, g.device, g.global_rank
        t0 = time.perf_counter()
        ops, mine, whole, meta = [], {}, {}, None

        def send(t, dst, tag):
            g.recorder.permute(me, [dst], t.numel() * t.element_size())
            ops.append(dist.P2POp(dist.isend, t, peer(dst), g.group, tag))

        def recv(shape, dtype, src, tag):
            t = torch.empty(shape, dtype=dtype, device=tdev)
            ops.append(dist.P2POp(dist.irecv, t, peer(src), g.group, tag))
            return t

        # one tag a leaf: K and V shards, then the whole leaves, then meta
        rest = [n for n in self.shapes if n not in self.seq]
        before = g.recorder.stats.edge_counts()
        if g.R == home:
            staged = {}

            def shard(name, i):
                key = (name, self.shard_of(name, i))
                if key not in staged:
                    staged[key] = self._stage(
                        self._shard(name, req_cache[name], key[1]), tdev)
                return staged[key]

            mine = {name: shard(name, me) for name in self.seq}
            for i in range(g.p):
                if i // g.pl != home and self.sender(home, i) == me:
                    for tag, name in enumerate(self.seq):
                        send(shard(name, i), i, tag)
            if self.sender(home, owner) == me:
                for tag, name in enumerate(rest, len(self.seq)):
                    send(self._stage(req_cache[name].contiguous(), tdev),
                         owner, tag)
                pos = req_cache["pos"].to(torch.long)
                send(self._stage(torch.stack(
                    [pos, torch.full_like(pos, tok0)]), tdev),
                    owner, len(self.shapes))
        else:
            src = self.sender(home, me)
            mine = {name: recv(*self._shard_shape(name), src, tag)
                    for tag, name in enumerate(self.seq)}
            if me == owner:
                for tag, name in enumerate(rest, len(self.seq)):
                    whole[name] = recv(*self.shapes[name], src, tag)
                meta = recv((2,), torch.long, src, len(self.shapes))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        after = g.recorder.stats.edge_counts()
        _add(self.donor, before, after)
        sent = sent_of(after)[0] - sent_of(before)[0]
        t1 = time.perf_counter()
        self.donor_s += t1 - t0

        for name in self.seq:
            cg = self._cgrid(name)
            before = cg.recorder.stats.edge_counts()
            y = mine.pop(name).movedim(SEQ_DIM, 0)
            shape = tuple(y.shape)
            full = C.cache_migrate(y.contiguous().reshape(-1), cg,
                                   algorithm=self.algorithm, tiled=True)
            if me == owner:
                whole[name] = full.reshape((-1,) + shape[1:]).movedim(
                    0, SEQ_DIM)
            after = cg.recorder.stats.edge_counts()
            _add(self.collective, before, after)
            sent += sent_of(after)[0] - sent_of(before)[0]
        t2 = time.perf_counter()
        self.collective_s += t2 - t1

        out = None
        if me == owner:
            leaves = {name: self._stage(t, self.device)
                      for name, t in whole.items()}
            pos, out = meta.tolist()
            leaves["pos"] = torch.tensor(pos, device=self.device)
            insert(leaves)
        self.insert_s += time.perf_counter() - t2
        self.migrations += 1
        self.sent_by_request[rid] = sent
        return out

    def stats(self) -> dict:
        """The counters (class docstring) under the engine's names:
        ``migrate_*`` of the collective, ``donor_*`` of the donor move."""
        mb, mnb, mnm = sent_of(self.collective)
        db, dnb, dnm = sent_of(self.donor)
        return {"migrations": self.migrations, "migrate_bytes": mb,
                "migrate_nonlocal_bytes": mnb, "migrate_nonlocal_msgs": mnm,
                "donor_bytes": db, "donor_nonlocal_bytes": dnb,
                "donor_nonlocal_msgs": dnm,
                "migrate_host_s": (self.donor_s + self.collective_s
                                   + self.insert_s),
                "migrate_donor_s": self.donor_s,
                "migrate_collective_s": self.collective_s,
                "migrate_insert_s": self.insert_s,
                "migrate_staging_bytes": self.staging_bytes}
