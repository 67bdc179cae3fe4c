"""Train-step factory of the port, ported from ``src/repro/train/step.py``:
loss, backward, gradient sync and optimizer, run by every rank of a
``RankGrid`` on its own share of the batch (the JAX step is one program in
a ``shard_map`` manual over the DP axes; here each rank is a process).

``grad_sync`` picks the collectives:

* ``"locality"`` / ``"locality_rd"`` / ``"flat_psum"``: paper mode. FSDP
  parameters (``fsdp=True``) are gathered where they are used with the
  locality-aware Bruck allgather (``core/collectives``, Algorithm 2) over
  ("pod", "data"), or the Bruck allgather within the pod for a leaf that
  shards over "data" only; the backward of each gather is the schedule's
  reduce-scatter, the same edges reversed. The gradients then sync by the
  leaf's geometry: ("pod", "data") leaves are already reduce-scattered over
  both tiers and only scaled; "data" leaves were reduce-scattered in the pod
  and add the pod allreduce (``sync_pod``, over the rank's lane); replicated
  leaves are allreduced in fp32 buckets of ``bucket_mb`` (``sync_full``,
  the locality allreduce with recursive halving, recursive doubling or the
  library's allreduce as the outer tier).
* ``"xla"``: the library route. The same geometry through the library's
  collectives (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``), the calls the port makes for ``"xla"`` elsewhere.

With FSDP the gather moves the ``cfg.dtype`` copy (cast, then gather), so the
reduce-scatter runs in that dtype and the gradient is cast back to fp32
after it, as the JAX transpose does. Each block's gathers run inside its
``torch.utils.checkpoint`` (``remat``), so the backward gathers again; with
``prefetch_depth`` d >= 1 (:class:`BlockPrefetch`) layer i + d's gather is
started before layer i runs and finished outside the checkpoint, bitwise
the eager result.

A CUDA tensor on a gloo grid stages through the host around each collective
(gloo moves host tensors); for the parameter gathers the collectives' split
gather does it (``stage=True``), inside its one autograd node on the card's
side, so every rank's backward issues its reduce-scatters in one order. The
meter of the artifacts (:class:`CommMeter`) counts the gathers and
reduce-scatters (the latter through hooks on that node), their host
seconds, the messages the recorder saw inside them and the bytes staged.

On a grid with a model tier (``RankGrid.build(q, pl, m)``) the step is
tensor-parallel as well (``models/tp.py``): each rank holds its (model,
FSDP) shard of every leaf by ``param_specs``, the gathers and the DP sync
above run over the rank's model lane (the q·pl ranks of one t) and move 1/m
of each model-sharded leaf, the loss is the vocabulary-parallel
cross-entropy, and ``seq_shard`` splits the residual stream over the
sequence. A leaf sharded over "model" never syncs over the tier (where a
rank uses more of it than its part, ``wk``/``wv`` whose KV heads m does not
divide, the tier's gather does, in its backward); a leaf the tier holds
whole takes the tier's sum where each model rank saw only part of the work:
the norm scales with ``seq_shard`` (gemma2's post-norms too: each rank
norms its S/m positions of the tier's sum; without it every rank norms the
whole sum, and the scales' gradients are the same on every rank), and a
Mamba2 layer's whole-held leaves always (each rank's gradient covers its
SSD heads' work: the B and C columns and channels, ``conv_b``,
``dt_bias``, ``A_log``, ``D`` and the gated norm's scale; the ssm
family's tree on a tier is
``transformer.train_layout``'s). The tier's collectives are the
library's, under every ``grad_sync``, metered apart (``CommMeter.model_*``).

MoE expert parallelism (``moe_dispatch``, the JAX resolution): on a grid of
p > 1 ranks whose p divides ``n_experts`` (and the global batch, where it
is given), under any ``grad_sync`` but "xla", "locality" and "xla" shard
the routed experts' E dim over every rank (``param_specs(..., moe_ep=
True)``) and exchange the token slots through the ``all_to_all``
collective (``models/moe.MoeDispatch``), on the "tokens" transport where
the algorithm is "locality" and the pods (the ranks, on one pod) number
fewer than ``top_k · capacity_factor``, on "slots" otherwise. Those leaves
are never gathered or prefetched, and their gradients skip the sync: the
return leg's backward has summed every rank's cotangent at the owner
already, so they are only scaled to the mean. Anything else resolves to
"none" (source "n/a"): every rank holds every expert. The loss the
backward takes adds the MoE layers' auxiliary loss; the metrics report the
cross-entropy ("loss") and the auxiliary loss ("moe_aux") apart. Under
"locality", "locality_rd" and "flat_psum" it is each DP rank's rows' (the
JAX step's manual DP body); under "xla" it is the global batch's, as the
JAX GSPMD step routes it (each rank's router takes the global
first-choice shares, one allreduce of E values a MoE layer and forward). The
meter counts the dispatch's all-to-alls (``a2a_*``, both legs, forward and
backward) and the tokens transport's gathers (``moe_gather_*``).

The parameter tree may hold several layer slots and a ``rest`` (a plan
whose period is 2, gemma2's window / full pair, or whose depth the period
does not divide): each layer's gathers take that layer's own geometry (a
slot's leaf in one layer's coordinates, a ``rest`` leaf as it is), the
autograd view slices every slot's reps and takes each ``rest`` layer, and
the gradients sync in the JAX flattening order.

On a model tier the MoE family holds E/m routed experts a rank (over
"model", then FSDP over the lane, by the JAX spec) and its shared-expert
columns, the router whole (``models/tp.moe_tp``): the router's gradient
is each rank's experts' share, summed over the tier. Expert parallelism
runs over the rank's model lane (p its q·pl ranks), the routed experts
whole on the tier; with ``seq_shard`` each rank keeps its positions of
the routed output, so the router's and the experts' gradients take the
tier's sum. The aux loss is counted once a tier in the metrics.

Refused, each naming its ROADMAP.md Queue 1 item: ``grad_sync="auto"``,
``prefetch_depth="auto"`` and ``moe_dispatch="auto"`` (tuning, item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..configs import ModelConfig, check_supported
from ..core import collectives as C
from ..core.comm_record import CollectiveStats
from ..models import transformer as T
from ..models.moe import MoeDispatch
from ..models.tp import TensorParallel
from ..optim.adamw import AdamW, TrainState, leaves, tree_map
from ..serve.engine import resolve_device
from .sharding import (block_slice_dims, fsdp_param_axes, fsdp_param_dims,
                       gather_outer_local, grid_axes, model_param_dims,
                       moe_ep_mask, param_specs)

GRAD_SYNCS = ("locality", "locality_rd", "flat_psum", "xla")
MOE_DISPATCHES = ("none", "locality", "xla")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in fp32, the label's logit picked by an
    iota == label mask (the JAX form, elementwise over the vocab)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    vocab_pos = torch.arange(lg.shape[-1], device=lg.device)
    ll = torch.where(vocab_pos == labels[..., None], lg, 0.0).sum(-1)
    return torch.mean(lse - ll)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 tp: TensorParallel | None = None,
                 moe_dispatch: MoeDispatch | None = None, moe_shares=None):
    """loss_fn(params, batch, gather=None, prefetch=None) -> (total,
    {"loss": cross-entropy, "moe_aux": the MoE auxiliary loss}), total the
    sum of the two; ``params`` is ``transformer.forward_train``'s view.
    With ``tp`` the logits are the rank's vocabulary columns and the loss
    the vocabulary-parallel one (``TensorParallel.xent_loss``)."""
    def loss_fn(params, batch, gather=None, prefetch=None):
        logits, aux = T.forward_train(params, cfg, batch["tokens"],
                                      remat=remat, gather=gather,
                                      prefetch=prefetch, tp=tp,
                                      moe_dispatch=moe_dispatch,
                                      moe_shares=moe_shares)
        loss = (xent_loss(logits, batch["labels"]) if tp is None
                else tp.xent_loss(logits, batch["labels"]))
        return loss + aux, {"loss": loss, "moe_aux": aux}
    return loss_fn


# ---------------------------------------------------------------------------
# the collectives of one leaf, metered
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CommMeter:
    """What the step's parameter gathers and gradient reduce-scatters did
    on this rank since the last :meth:`take`: calls, host seconds, the
    recorder's messages inside them (``CollectiveStats``) and the bytes
    staged between the card and a gloo grid's host tensors (both ways);
    ``sync_*`` the same for the gradient sync after the backward, and
    ``model_*`` for the model tier's collectives (forward, backward, the
    loss and the tier's gradient sum; their staged bytes are in
    ``staged_bytes`` too); ``a2a_*`` for the MoE dispatch's all-to-alls
    (both legs, forward and backward; ``a2a_bytes`` the exchanged tensors'
    bytes, p blocks each) and ``moe_gather_*`` for its tokens transport's
    gathers (the backward's reduce-scatters included)."""

    gathers: int = 0
    reduce_scatters: int = 0
    gather_s: float = 0.0
    reduce_scatter_s: float = 0.0
    sync_s: float = 0.0
    staged_bytes: int = 0
    model_calls: int = 0
    model_s: float = 0.0
    model_staged_bytes: int = 0
    a2a_calls: int = 0
    a2a_bytes: int = 0
    a2a_s: float = 0.0
    moe_gathers: int = 0
    moe_gather_s: float = 0.0
    gather_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    reduce_scatter_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    sync_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    model_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    a2a_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    moe_gather_stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)

    def take(self) -> "CommMeter":
        """The record so far; the meter starts again from zero."""
        out = dataclasses.replace(self)
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default_factory() if f.default_factory
                    is not dataclasses.MISSING else f.default)
        return out


_EDGE_FIELDS = [f.name for f in dataclasses.fields(CollectiveStats)
                if f.name.startswith(("permute_", "group_"))]


class _Metered:
    """Adds the recorders' edge counts and the host seconds of a block of
    collectives to one of the meter's records."""

    def __init__(self, meter: CommMeter, kind: str, grids):
        self.meter, self.kind, self.grids = meter, kind, grids

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.before = [g.recorder.stats.edge_counts() for g in self.grids]
        return self

    def __exit__(self, *exc):
        m = self.meter
        setattr(m, f"{self.kind}_s", getattr(m, f"{self.kind}_s")
                + time.perf_counter() - self.t0)
        st = getattr(m, f"{self.kind}_stats")
        for g, before in zip(self.grids, self.before):
            after = g.recorder.stats.edge_counts()
            for name in _EDGE_FIELDS:
                setattr(st, name, getattr(st, name)
                        + after[name] - before[name])
        return False


@dataclasses.dataclass
class LeafGather:
    """The parameter gather of one leaf: over ``grid`` with ``algorithm``,
    along dim ``dim`` of the leaf (the shards in grid-rank order), through
    the collectives' staged split gather, whose backward, taken at finish,
    is the schedule's reduce-scatter; metered both ways."""

    grid: Any
    algorithm: str
    dim: int
    meter: CommMeter

    def _staged(self, t: torch.Tensor) -> int:
        """The bytes ``t`` moves to or from the grid's device."""
        if t.device.type == self.grid.device.type:
            return 0
        return t.numel() * t.element_size()

    def start(self, x: torch.Tensor) -> C.PendingCollective:
        """The gather's non-local rounds (all of it but the local tail)."""
        with _Metered(self.meter, "gather", [self.grid]):
            xs = x.movedim(self.dim, 0).contiguous()
            self.meter.staged_bytes += self._staged(xs)
            return C.allgather_start(xs, self.grid, algorithm=self.algorithm,
                                     tiled=True, stage=True)

    def finish(self, pending: C.PendingCollective) -> torch.Tensor:
        with _Metered(self.meter, "gather", [self.grid]):
            self.meter.gathers += 1
            full = C.allgather_finish(pending)
            staged = self._staged(full)
            self.meter.staged_bytes += staged
        if full.requires_grad:      # the reduce-scatter stages g and its tile
            back = staged + staged // self.grid.p

            def done():
                self.meter.reduce_scatters += 1
                self.meter.staged_bytes += back
            _meter_node(self.meter, "reduce_scatter", self.grid,
                        full.grad_fn, done)
        return full.movedim(0, self.dim).contiguous()


def _meter_node(meter: CommMeter, kind: str, grid, node,
                on_exit: Callable[[], None]) -> None:
    """Meter the collectives that ``node``'s backward runs into ``kind``:
    hooks on the node itself, so the record holds that node alone."""
    open_: list[_Metered] = []

    def pre(grad_outputs):
        open_.append(_Metered(meter, kind, [grid]).__enter__())

    def post(grad_inputs, grad_outputs):
        open_.pop().__exit__(None, None, None)
        on_exit()

    node.register_prehook(pre)
    node.register_hook(post)


@dataclasses.dataclass(frozen=True)
class MeteredDispatch(MoeDispatch):
    """``MoeDispatch`` whose all-to-alls and gathers, forward and backward,
    are counted into ``meter`` (``a2a_*``, ``moe_gather_*``)."""

    meter: CommMeter | None = None

    def _count(self, kind: str, calls: str, fn, x: torch.Tensor
               ) -> torch.Tensor:
        m = self.meter
        nbytes = x.numel() * x.element_size()

        def bump():
            setattr(m, calls, getattr(m, calls) + 1)
            if kind == "a2a":
                m.a2a_bytes += nbytes
        with _Metered(m, kind, [self.grid]):
            y = fn(x)
            bump()
        if y.requires_grad:
            _meter_node(m, kind, self.grid, y.grad_fn, bump)
        return y

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        return self._count("a2a", "a2a_calls", super().exchange, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._count("moe_gather", "moe_gathers", super().gather, x)


# ---------------------------------------------------------------------------
# double-buffered FSDP parameter prefetch
# ---------------------------------------------------------------------------
class BlockPrefetch:
    """Per-layer gather hook of ``transformer.forward_train``: ``start(i,
    layer)`` casts layer i's shards and issues their gathers (every
    non-local round of a ("pod", "data") leaf completes in start),
    ``finish`` completes the local tail at the consumer. Bitwise the eager
    gathers: the same cast, the same schedule per leaf (layer i's leaf's
    own geometry)."""

    def __init__(self, geos: list[dict[str, LeafGather | None]], dtype,
                 depth: int):
        self.geos = geos              # per layer: leaf name -> gather
        self.dtype = dtype            # (None: replicated, cast only)
        self.depth = depth

    def start(self, i: int, layer: dict[str, torch.Tensor]
              ) -> tuple[int, dict]:
        out = {}
        for name, t in layer.items():
            x = t.to(self.dtype)
            geo = self.geos[i][name]
            out[name] = x if geo is None else geo.start(x)
        return i, out

    def finish(self, pending: tuple[int, dict]) -> dict[str, torch.Tensor]:
        i, parts = pending
        geos = self.geos[i]
        return {name: p if geos[name] is None else geos[name].finish(p)
                for name, p in parts.items()}


# ---------------------------------------------------------------------------
# gradient bucketing for the DP sync
# ---------------------------------------------------------------------------
def bucketed_sync(grads: list[torch.Tensor],
                  sync_flat: Callable[[torch.Tensor], torch.Tensor],
                  bucket_mb: float = 64.0, compress: bool = False
                  ) -> list[torch.Tensor]:
    """Flatten grads into <= bucket_mb fp32 buckets (bf16 on the wire with
    ``compress``), sync each, unflatten to fp32."""
    sizes = [g.numel() for g in grads]
    limit = int(bucket_mb * 1024 * 1024 / 4)
    buckets: list[list[int]] = [[]]
    acc = 0
    for i, n in enumerate(sizes):
        if acc + n > limit and buckets[-1]:
            buckets.append([])
            acc = 0
        buckets[-1].append(i)
        acc += n
    out: list[torch.Tensor | None] = [None] * len(grads)
    for idxs in buckets:
        flat = torch.cat([grads[i].float().reshape(-1) for i in idxs])
        if compress:
            flat = flat.to(torch.bfloat16)
        flat = sync_flat(flat).float()
        off = 0
        for i in idxs:
            out[i] = flat[off:off + sizes[i]].reshape(grads[i].shape)
            off += sizes[i]
    return out


# ---------------------------------------------------------------------------
# step factory
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepArtifacts:
    step_fn: Callable                 # (state, batch) -> (state, metrics)
    pspecs: Any
    device: torch.device
    meter: CommMeter
    grid: Any = None
    grad_sync: str = ""
    grad_algorithm: str = ""          # the gather schedule of ("pod","data")
    prefetch_depth: int = 0
    moe_dispatch: str = "none"        # the resolved expert-parallel dispatch
    moe_transport: str = ""           # "tokens" | "slots" ("" without EP)
    moe_dispatch_source: str = "n/a"  # "explicit" | "n/a"


def _refuse(grad_sync, prefetch_depth, moe_dispatch) -> None:
    if "auto" in (grad_sync, prefetch_depth, moe_dispatch):
        raise NotImplementedError(
            '"auto" (grad_sync, prefetch_depth or moe_dispatch) comes with '
            "the tuning slice (ROADMAP.md Queue 1 item 8): it needs "
            "parameters measured on the H100")
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"unknown grad_sync {grad_sync!r}; known: "
                         f"{GRAD_SYNCS}")
    if moe_dispatch not in MOE_DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}; known: "
                         f"{MOE_DISPATCHES + ('auto',)}")


def resolve_moe_dispatch(cfg: ModelConfig, grid, grad_sync: str,
                         moe_dispatch: str,
                         global_batch: int | None = None
                         ) -> tuple[str, str, str]:
    """(algorithm, transport, source) of the expert-parallel dispatch, the
    JAX ``make_train_step`` rule: EP only under a ``grad_sync`` other than
    "xla", on p > 1 ranks dividing ``n_experts`` (and the global batch);
    "tokens" where the algorithm is "locality" and the span (the pods, or
    the ranks on one pod) is below ``top_k · capacity_factor``."""
    p = grid.p if grid is not None else 1
    ok = (moe_dispatch != "none" and grad_sync != "xla"
          and cfg.n_experts > 0 and p > 1 and cfg.n_experts % p == 0
          and (global_batch is None or global_batch % p == 0))
    if not ok:
        return "none", "", "n/a"
    span = grid.q if grid.q > 1 else p
    transport = ("tokens" if moe_dispatch == "locality"
                 and span < cfg.top_k * cfg.capacity_factor else "slots")
    return moe_dispatch, transport, "explicit"


def _shard(t: torch.Tensor, mdim: int, dim: int, axes: str, grid
           ) -> torch.Tensor:
    """This rank's (model, FSDP) shard of a full leaf: part t of the m
    along ``mdim`` (-1: the tier holds it whole), then this rank's part of
    that over its model lane along ``dim`` (-1: replicated)."""
    if mdim >= 0:
        t = t.chunk(grid.m, mdim)[grid.t]
    if dim >= 0:
        n, i = (grid.p, grid.rank) if "pod" in axes else (grid.pl, grid.l)
        t = t.chunk(n, dim)[i]
    return t.contiguous().clone() if mdim >= 0 or dim >= 0 \
        else t.contiguous()      # the optimizer updates flat views in place


def _path_tree(tree, path=()):
    """``tree`` with each leaf replaced by its "/"-joined path."""
    if isinstance(tree, dict):
        return {k: _path_tree(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_path_tree(v, path + (str(i),)) for i, v in enumerate(tree)]
    return "/".join(path)


def make_train_step(cfg: ModelConfig, grid=None, *,
                    optimizer: AdamW | None = None,
                    grad_sync: str = "locality", fsdp: bool = False,
                    grad_accum: int = 1, bucket_mb: float = 64.0,
                    compress: bool = False, prefetch_depth: int | str = 0,
                    remat: bool = True, seq_shard: bool = False,
                    moe_dispatch: str = "none",
                    global_batch: int | None = None,
                    device: torch.device | str | None = None
                    ) -> StepArtifacts:
    """The step of one rank of ``grid`` (None: one process, no
    collectives). ``step_fn(state, batch)`` takes this rank's rows of the
    global batch (``data.host_shard`` by grid rank) as tensors or numpy
    arrays, updates ``state`` in place and returns (state, metrics): the
    loss averaged over the ranks, ``moe_aux`` for a MoE model,
    ``grad_norm`` and ``lr``. ``global_batch`` (optional) enters the
    expert-parallel eligibility as the JAX batch shape does. It runs on
    ``cuda`` unless ``device`` names another (``"cpu"``: the kernels'
    plain versions)."""
    _refuse(grad_sync, prefetch_depth, moe_dispatch)
    check_supported(cfg, "train")
    optimizer = optimizer or AdamW()
    device = resolve_device(device)
    meter = CommMeter()
    dist_on = grid is not None
    p = grid.p if dist_on else 1
    axes = grid_axes(grid) if dist_on else {"data": 1}
    moe_alg, moe_transport, moe_source = resolve_moe_dispatch(
        cfg, grid, grad_sync, moe_dispatch, global_batch)
    ep_on = moe_alg != "none"
    m = grid.m if dist_on else 1
    shapes = T.train_param_shapes(cfg, m)
    pspecs = param_specs(shapes, axes, fsdp=fsdp and dist_on, moe_ep=ep_on)
    tp = (TensorParallel.build(cfg, grid, seq_shard=seq_shard, meter=meter)
          if dist_on and grid.m > 1 else None)
    hook_ep = MeteredDispatch(grid, moe_alg, moe_transport,
                              meter) if ep_on else None
    # the routed experts under EP stay sharded through the forward: no
    # gather, and their gradients need no sync beyond the mean
    ep_tree = (moe_ep_mask(shapes) if ep_on else
               tree_map(lambda _: False, shapes))
    dims = tree_map(lambda k, e: -1 if e else k, fsdp_param_dims(pspecs),
                    ep_tree)
    fsaxes = fsdp_param_axes(pspecs)
    depth = int(prefetch_depth)
    if depth and not (fsdp and dist_on):
        raise ValueError(f"prefetch_depth={depth} pipelines the FSDP gather: "
                         "it needs fsdp=True on a grid")
    xla = grad_sync == "xla"
    outer_alg = "rd" if grad_sync == "locality_rd" else "rhd"
    allreduce_alg = "xla" if grad_sync in ("xla", "flat_psum") else "locality"
    pod = grid.pod_grid() if dist_on else None
    lane = grid.lane_grid() if dist_on else None

    def geo(dim: int, ax: str) -> LeafGather | None:
        if dim < 0:
            return None
        outer, _ = gather_outer_local(ax)
        if outer:
            return LeafGather(grid, "xla" if xla else "locality_bruck", dim,
                              meter)
        return LeafGather(pod, "xla" if xla else "bruck", dim, meter)

    moe = any(s.mlp == "moe" for s in cfg.layer_plan())
    # each layer's gather geometry, from its own slot (a stacked leaf's dim
    # in one layer's coordinates) or rest entry (unstacked)
    layer_dims = T.train_layers(dims, cfg, leaf=lambda k, i: k if i is None
                                else block_slice_dims(k))
    layer_axes = T.train_layers(fsaxes, cfg, leaf=lambda a, i: a)
    layer_geos = [{n: geo(ld[n], la[n]) for n in ld}
                  for ld, la in zip(layer_dims, layer_axes)]
    geos = {"embed": geo(dims["embed"], fsaxes["embed"]),
            "final_norm": geo(dims["final_norm"]["scale"],
                              fsaxes["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        geos["head"] = geo(dims["head"], fsaxes["head"])

    def gather(name: str, t: torch.Tensor, layer: int | None = None
               ) -> torch.Tensor:
        x = t.to(cfg.dtype)                 # the cfg.dtype copy is gathered
        g = geos[name] if layer is None else layer_geos[layer][name]
        return x if g is None else g.finish(g.start(x))

    hook = BlockPrefetch(layer_geos, cfg.dtype, depth) if depth else None

    # sync by the leaf's geometry (leaves in the JAX flattening order); the
    # EP experts' gradients are whole at their owner already
    flat_dims, flat_axes = leaves(dims), leaves(fsaxes)
    flat_ep = leaves(ep_tree)
    idx_done = [i for i, (k, a, e) in enumerate(zip(flat_dims, flat_axes,
                                                    flat_ep))
                if e or (k >= 0 and "pod" in a)]
    idx_rs = [i for i, (k, a) in enumerate(zip(flat_dims, flat_axes))
              if k >= 0 and "pod" not in a]
    idx_full = [i for i, (k, e) in enumerate(zip(flat_dims, flat_ep))
                if k < 0 and not e]
    # the model tier: the leaves it shards hold distinct parts on its
    # ranks; the norm scales and a Mamba2 layer's whole-held leaves it
    # holds whole
    model_sharded = [k >= 0 for k in leaves(model_param_dims(pspecs))]
    paths = leaves(_path_tree(pspecs))
    idx_scale = {i for i, path in enumerate(paths) if path.endswith("/scale")}
    idx_mamba = {i for i, path in enumerate(paths)
                 if "/mamba/" in path and not model_sharded[i]} \
        if m > 1 else set()
    # a MoE layer's router on a model tier: each rank's gradient covers its
    # experts' gates (without EP) or its positions (EP with seq_shard), as
    # do the EP experts' with seq_shard (models/tp.moe_tp)
    idx_router = {i for i, path in enumerate(paths)
                  if path.endswith("/moe/router")} if m > 1 else set()
    idx_ep = {i for i, e in enumerate(leaves(ep_tree)) if e} \
        if m > 1 else set()

    def staged(fn, g: Any, t: torch.Tensor) -> torch.Tensor:
        """``fn`` on ``t`` moved to the grid's device and back."""
        if t.device.type == g.device.type:
            return fn(t)
        meter.staged_bytes += 2 * t.numel() * t.element_size()
        return fn(t.to(g.device)).to(t.device)

    def batch_shares(me: torch.Tensor) -> torch.Tensor:
        """The experts' first-choice shares over the global batch, from
        this rank's: the JAX "xla" step routes the global batch as one
        program, so its aux loss is the whole batch's (every rank holds
        as many tokens)."""
        return staged(lambda u: C.allreduce(u, grid, algorithm="xla"),
                      grid, me) / p

    loss_fn = make_loss_fn(cfg, remat=remat, tp=tp, moe_dispatch=hook_ep,
                           moe_shares=batch_shares if xla and dist_on
                           and moe else None)

    def sync_pod(t: torch.Tensor) -> torch.Tensor:
        if grid.q == 1:
            return t / p
        return staged(lambda u: C.allreduce(
            u, lane, algorithm=allreduce_alg, outer_algorithm=outer_alg),
            lane, t) / p

    def sync_full(t: torch.Tensor) -> torch.Tensor:
        return staged(lambda u: C.allreduce(
            u, grid, algorithm=allreduce_alg, outer_algorithm=outer_alg),
            grid, t) / p

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch = {k: torch.as_tensor(v).to(device=device, dtype=torch.long)
                 for k, v in batch.items()}
        n_rows = batch["tokens"].shape[0]
        if n_rows % grad_accum:
            raise ValueError(f"{n_rows} rows do not split into "
                             f"{grad_accum} microbatches")
        params = state.params
        flat_p = leaves(params)
        bufs = [torch.zeros_like(t, dtype=torch.float32) for t in flat_p]
        # autograd leaves: each layer's slice of a stacked leaf is a leaf of
        # its own (a view of the stack), its gradient added into the stacked
        # buffer as soon as it is complete
        ids = {id(t): j for j, t in enumerate(flat_p)}
        hooks = []

        def leaf(t: torch.Tensor, i: int | None = None) -> torch.Tensor:
            j = ids[id(t)]
            v = (t if i is None else t[i]).detach().requires_grad_(True)
            dst = bufs[j] if i is None else bufs[j][i]

            def add(v):
                dst.add_(v.grad)
                v.grad = None
            hooks.append(v.register_post_accumulate_grad_hook(add))
            return v

        metrics_sum = torch.zeros((), dtype=torch.float32, device=device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=device)
        mb = n_rows // grad_accum
        for a in range(grad_accum):
            view = {"embed": leaf(params["embed"]),
                    "final_norm": leaf(params["final_norm"]["scale"]),
                    "layers": T.train_layers(params, cfg, leaf=leaf)}
            if not cfg.tie_embeddings:
                view["head"] = leaf(params["head"])
            part = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
            try:
                total, parts = loss_fn(view, part, gather=gather,
                                       prefetch=hook)
                total.backward()
            finally:
                for h in hooks:
                    h.remove()
                hooks.clear()
            metrics_sum = metrics_sum + parts["loss"].detach()
            aux_sum = aux_sum + parts["moe_aux"].detach()
        if grad_accum > 1:
            for b in bufs:
                b.div_(grad_accum)
        loss_local = metrics_sum / grad_accum
        aux_local = aux_sum / grad_accum

        # each model rank normed S/m rows (seq_shard), ran its SSD heads'
        # part of a Mamba2 layer or its share of a MoE layer's routing:
        # those gradients are the tier's sum (fp32 buckets)
        seq = tp is not None and tp.seq_split(batch["tokens"].shape[1])
        idx_tier = idx_mamba | (idx_scale if seq else set())
        if seq or not ep_on:        # EP alone keeps the routed path whole
            idx_tier |= idx_router | idx_ep
        idx_tier = sorted(idx_tier)
        if idx_tier:
            out = bucketed_sync([bufs[i] for i in idx_tier],
                                tp.tier.all_reduce, bucket_mb=bucket_mb)
            for i, g in zip(idx_tier, out):
                bufs[i] = g
        if dist_on:
            with _Metered(meter, "sync", [grid, pod, lane]):
                for i in idx_done:
                    bufs[i].div_(p)
                for idxs, fn in ((idx_rs, sync_pod), (idx_full, sync_full)):
                    if idxs:
                        out = bucketed_sync([bufs[i] for i in idxs], fn,
                                            bucket_mb=bucket_mb,
                                            compress=compress)
                        for i, g in zip(idxs, out):
                            bufs[i] = g
                # the loss's mean and the squares of the whole gradient:
                # sharded leaves from every rank that holds a distinct part
                # (on a model tier: the leaves it shards from every model
                # rank, the rest from t = 0)
                mine = lambda i: grid.t == 0 or model_sharded[i]
                sq = lambda idxs: sum((torch.sum(torch.square(bufs[i]))
                                       for i in idxs if mine(i)),
                                      torch.zeros((), device=device))
                zero = torch.zeros((), device=device)
                sums = [loss_local if grid.t == 0 else zero, sq(idx_done),
                        sq(idx_rs) if grid.R == 0 else zero,
                        sq(idx_full) if grid.rank == 0 else zero]
                if moe:
                    sums.append(aux_local if grid.t == 0 else zero)
                vec = torch.stack(sums)
                if tp is not None:
                    vec = tp.tier.all_reduce(vec)
                tot = staged(lambda u: C.allreduce(u, grid, algorithm="xla"),
                             grid, vec)
            loss_mean = tot[0] / p
            aux_mean = tot[4] / p if moe else None
            gnorm = torch.sqrt(tot[1] + tot[2] + tot[3])
        else:
            loss_mean, aux_mean, gnorm = loss_local, aux_local, None
        grads = _unflatten(params, bufs)
        state, opt = optimizer.apply(state, grads, grad_norm=gnorm)
        aux = {"moe_aux": aux_mean} if moe else {}
        return state, {"loss": loss_mean, **aux, **opt}

    return StepArtifacts(
        step_fn=step_fn, pspecs=pspecs, device=device, meter=meter,
        grid=grid, grad_sync=grad_sync,
        grad_algorithm="xla" if xla else "locality_bruck",
        prefetch_depth=depth, moe_dispatch=moe_alg,
        moe_transport=moe_transport, moe_dispatch_source=moe_source)


def _unflatten(tree, flat: list[torch.Tensor]):
    """``flat`` (in ``leaves(tree)``'s order) as a tree shaped like tree."""
    return _rebuild(tree, iter(flat))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(x, it) for x in tree]
    return next(it)


def init_state(cfg: ModelConfig, artifacts: StepArtifacts, *,
               params: dict | None = None, seed: int = 0) -> TrainState:
    """This rank's state: its shards of ``params`` (the full fp32 tree,
    e.g. ``transformer.train_params_from_jax``), or of
    ``transformer.init_train_params`` drawn on the step's device from
    ``seed``, in ``transformer.train_layout``'s tree for the step's grid;
    zero ``mu``, ``nu`` and step."""
    device = artifacts.device
    if params is None:
        params = T.init_train_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
    dims = fsdp_param_dims(artifacts.pspecs)
    axes = fsdp_param_axes(artifacts.pspecs)
    mdims = model_param_dims(artifacts.pspecs)
    grid = artifacts.grid
    params = T.train_layout(params, cfg, grid.m if grid is not None else 1)
    shards = tree_map(lambda t, mk, k, a: _shard(
        t.to(device=device, dtype=torch.float32), mk, k, a, grid), params,
        mdims, dims, axes)
    return TrainState.create(shards)
