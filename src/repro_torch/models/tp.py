"""Tensor parallelism of the port: the dense decoder's layers split over the
grid's "model" tier, Megatron-style.

The JAX step leaves the "model" axis to GSPMD, which partitions the program
from the parameter specs (``train/sharding.param_specs``) and the activation
hooks; the port computes the same function explicitly, rank by rank. Rank t
of the m model ranks holds q heads ``[t·H/m, (t+1)·H/m)`` and the KV heads
they read (``[t·KV/m, …)`` where m divides KV: the GQA grouping holds), the
columns ``[t·F/m, …)`` of the MLP and the vocabulary rows ``[t·Vpad/m, …)``
of the tied embedding. ``wq``, ``wk``, ``wv``, ``gate`` and ``up`` are
column-parallel, ``wo`` and ``down`` row-parallel: their partial sums are
allreduced over the tier, or, with ``seq_shard``, reduce-scattered over the
sequence (the residual stream between the blocks holds S/m positions a rank)
and the next block's normed input gathered.

Where m does not divide KV (but KV divides m), the JAX spec still shards
``wk``/``wv`` over the tier: its rule tests their KV·D columns, not the
heads, so a rank holds part of a head. The port gathers the leaf over the
tier (its backward, the reduce-scatter, is the tier's gradient sum) and each
rank takes the KV head its q heads read. Heads that do not divide (H, or KV
neither dividing nor divided by m, or KV·D columns that m does not divide,
which JAX keeps whole), an MLP width or a vocabulary that m does not divide,
and the ssm family are refused.

Serving (``Transformer(..., tp=)``, under ``torch.no_grad``) cuts each
rank's part from the full weights (:meth:`TensorParallel.part`: the JAX
serving specs, ``param_specs(..., fsdp=False)``, but whole KV heads where m
does not divide KV: the ones its q heads read, ``kv_heads``), keeps those
KV heads in its cache, sums the row-parallel products and the embedding
with ``ModelTier.all_reduce`` directly, and takes the greedy token from
the vocabulary shards (:meth:`TensorParallel.greedy`).

In training every model-tier collective is an autograd function with its
transpose as the backward: the identity and the allreduce (``copy_in`` /
``reduce_out``), the allgather and the reduce-scatter (``gather`` /
``scatter``). They run the library's group collectives
(``core/collectives`` with ``algorithm="xla"``) over the tier's own grid
(``RankGrid.model_grid``), staging a tensor of another device through the
grid's (a card's tensor on a gloo grid goes through the host), under
every ``grad_sync``: the JAX package does not route GSPMD's collectives
through the locality schedules, and neither does the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.nn.functional as F

from ..configs import ModelConfig
from ..core import collectives as C

#: where the ssm family's model tier is queued
SSM_TP_ITEM = "ROADMAP.md Queue 1 item 13"
#: the serving tree's norm scales, by the JAX tree's leaf name ("scale")
SCALE_NAMES = {"ln1": "scale", "ln2": "scale", "final_norm": "scale"}


def check_tp(cfg: ModelConfig, m: int) -> None:
    """Refuse what the port's tensor parallelism does not split over m."""
    if m <= 1:
        return
    if cfg.family == "moe" or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name} on a model tier of {m}: the MoE family and the "
            "untied head are not split over 'model' yet (ROADMAP.md Queue 1 "
            "item 14)")
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name} on a model tier of {m}: the Mamba2 mixer's "
            "in_proj output (z, x, B, C, dt) needs a split aligned to the "
            f"heads over 'model' ({SSM_TP_ITEM})")
    H, KV = cfg.n_heads, cfg.n_kv_heads
    bad = [f"{what} {n}" for what, n in (
        ("n_heads", H), ("d_ff", cfg.d_ff), ("padded vocab", cfg.padded_vocab))
        if n % m]
    if KV % m and (m % KV or KV * cfg.head_dim_ % m):
        bad.append(f"n_kv_heads {KV}")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port splits whole heads, MLP columns and "
            f"vocabulary rows over a model tier of {m}; it does not divide "
            f"{', '.join(bad)}")


class ModelTier:
    """The model-tier collectives of one rank, over ``grid.model_grid()``,
    metered into ``meter`` (a ``train/step.CommMeter``; None: not metered):
    calls, host seconds, the tier recorder's messages and the bytes staged
    between the tensor's device and the grid's."""

    def __init__(self, grid, meter=None):
        self.grid = grid.model_grid()
        self.m, self.t = grid.m, grid.t
        self.meter = meter

    def _run(self, fn, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        stats = self.grid.recorder.stats
        before = stats.edge_counts()
        dev = x.device
        u, staged = x.contiguous(), 0
        if dev.type != self.grid.device.type:
            u = u.to(self.grid.device)
            staged += u.numel() * u.element_size()
        with torch.no_grad():
            out = fn(u)
        if out.device != dev:
            staged += out.numel() * out.element_size()
            out = out.to(dev)
        mt = self.meter
        if mt is not None:
            mt.model_calls += 1
            mt.model_s += time.perf_counter() - t0
            mt.staged_bytes += staged
            mt.model_staged_bytes += staged
            for name, v in stats.edge_counts().items():
                setattr(mt.model_stats, name,
                        getattr(mt.model_stats, name) + v - before[name])
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self._run(lambda u: C.allreduce(u, self.grid, algorithm="xla",
                                               op=op), x)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tier's parts of ``x`` concatenated along ``dim`` in rank
        order."""
        def fn(u):
            full = C.allgather(u.movedim(dim, 0).contiguous(), self.grid,
                               algorithm="xla", tiled=True)
            return full.movedim(0, dim).contiguous()
        return self._run(fn, x)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tier's sum of ``x``; this rank keeps part t along ``dim``."""
        def fn(u):
            part = C.reduce_scatter(u.movedim(dim, 0).contiguous(), self.grid,
                                    algorithm="xla")
            return part.movedim(0, dim).contiguous()
        return self._run(fn, x)


class _CopyIn(torch.autograd.Function):
    """A replicated tensor entering split work: identity; its gradient,
    partial on each rank, is allreduced."""

    @staticmethod
    def forward(ctx, x, tier):
        ctx.tier = tier
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tier.all_reduce(g), None


class _ReduceOut(torch.autograd.Function):
    """Partial sums leaving split work: allreduced; the gradient of the
    (replicated) sum is each part's."""

    @staticmethod
    def forward(ctx, x, tier):
        return tier.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The tier's parts concatenated along ``dim``; the gradient, partial
    on each rank, is reduce-scattered back to the parts."""

    @staticmethod
    def forward(ctx, x, tier, dim):
        ctx.tier, ctx.dim = tier, dim
        return tier.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tier.reduce_scatter(g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """Partial sums reduce-scattered along ``dim``; the gradient of each
    part is gathered whole."""

    @staticmethod
    def forward(ctx, x, tier, dim):
        ctx.tier, ctx.dim = tier, dim
        return tier.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tier.all_gather(g, ctx.dim), None, None


@dataclasses.dataclass
class TensorParallel:
    """One rank's share of the dense decoder on a model tier: its heads,
    whether ``wk``/``wv`` are its own columns (``kv_local``: m divides KV)
    or gathered over the tier, and the tier's collectives. ``seq_shard``
    splits the residual stream over the sequence where m divides it (the
    activation-kind rule of ``train/sharding.act_spec``)."""

    cfg: ModelConfig
    tier: ModelTier
    seq_shard: bool = False

    @classmethod
    def build(cls, cfg: ModelConfig, grid, *, seq_shard: bool = False,
              meter=None) -> "TensorParallel":
        check_tp(cfg, grid.m)
        return cls(cfg, ModelTier(grid, meter), seq_shard)

    @property
    def kv_local(self) -> bool:
        return self.cfg.n_kv_heads % self.m == 0

    @property
    def m(self) -> int:
        return self.tier.m

    @property
    def t(self) -> int:
        return self.tier.t

    def seq_split(self, S: int) -> bool:
        """Whether the residual stream of S positions is split."""
        from ..train.sharding import MODEL_AXIS, act_spec
        return act_spec("act", (1, S, 1), {MODEL_AXIS: self.m},
                        seq_shard=self.seq_shard)[1] == MODEL_AXIS

    def kv_heads(self) -> tuple[int, int]:
        """[lo, hi) of the KV heads this rank's q heads read."""
        H, KV = self.cfg.n_heads, self.cfg.n_kv_heads
        hl, g = H // self.m, H // KV
        return self.t * hl // g, ((self.t + 1) * hl - 1) // g + 1

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a full leaf of the serving tree
        (``Transformer``'s flat names, ``layers.{i}.wq`` ...): its part
        over "model" by the JAX serving spec (``param_specs(...,
        fsdp=False)``: columns of ``wq``/``wk``/``wv``/``gate``/``up``,
        rows of ``wo``/``down``, vocabulary rows of ``embed``, norm scales
        whole), but for ``wk``/``wv`` where m does not divide KV, whose
        flat columns the JAX spec splits mid-head: there the columns of
        the KV heads this rank's q heads read (:meth:`kv_heads`). A part
        is a copy of its own, so the full leaf can be freed."""
        from ..train.sharding import MODEL_AXIS, model_dim, param_specs
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("wk", "wv") and not self.kv_local:
            lo, hi = self.kv_heads()
            D = self.cfg.head_dim_
            t = t[:, lo * D:hi * D]
        else:
            key = SCALE_NAMES.get(leaf, leaf)
            dim = model_dim(param_specs({key: t}, {MODEL_AXIS: self.m})[key])
            if dim < 0:
                return t
            t = t.chunk(self.m, dim)[self.t]
        return t.clone(memory_format=torch.contiguous_format)

    def greedy(self, logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """The JAX greedy token from this rank's (B, 1, Vpad/m) logits: the
        first index of the maximum of the last position over the whole
        padded vocabulary, clamped below ``vocab_size``; (B, 1) int64, the
        same on every rank of the tier. One gather of each rank's (max,
        first index of it); the first rank holding the largest wins, as
        its ids come first."""
        lg = logits[:, -1].float()
        n = lg.shape[-1]
        idx = lg.argmax(-1)
        mx = lg.gather(-1, idx[:, None])[:, 0]
        pair = torch.stack([mx.double(), (idx + self.t * n).double()])
        both = self.tier.all_gather(pair[None], 0)          # (m, 2, B)
        best = both[:, 0].argmax(0)
        tok = both[:, 1].gather(0, best[None])[0].long()
        return tok.clamp(max=vocab_size - 1)[:, None]

    # -- the tier's collectives, differentiable ---------------------------
    def copy_in(self, x):
        return _CopyIn.apply(x, self.tier)

    def reduce_out(self, x):
        return _ReduceOut.apply(x, self.tier)

    def gather(self, x, dim: int):
        return _Gather.apply(x, self.tier, dim)

    def scatter(self, x, dim: int):
        return _Scatter.apply(x, self.tier, dim)

    def enter(self, h, seq: bool):
        """A block's normed input, entering the split projections."""
        return self.gather(h, 1) if seq else self.copy_in(h)

    def leave(self, y, seq: bool):
        """A row-parallel product's partial sums, leaving for the residual
        stream."""
        return self.scatter(y, 1) if seq else self.reduce_out(y)

    def kv_weight(self, w: torch.Tensor) -> torch.Tensor:
        """``wk`` or ``wv`` as this rank's columns of its KV heads."""
        if self.kv_local:
            return w
        w = self.gather(w, 1)
        lo, hi = self.kv_heads()
        D = self.cfg.head_dim_
        return w[:, lo * D:hi * D]

    # -- the vocabulary-parallel embedding and its tied head -------------
    def local_embed(self, tokens: torch.Tensor, rows: torch.Tensor):
        """The lookup of ``tokens`` in this rank's vocabulary rows, zeros
        for a token another rank holds: one part of the tier's sum."""
        n = rows.shape[0]
        local = tokens - self.t * n
        mine = (local >= 0) & (local < n)
        x = F.embedding(torch.where(mine, local, 0), rows)
        return torch.where(mine[..., None], x,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def embed(self, tokens: torch.Tensor, rows: torch.Tensor, seq: bool):
        """:meth:`local_embed` summed over the tier: allreduced, or
        reduce-scattered over the sequence."""
        return self.leave(self.local_embed(tokens, rows), seq)

    def vocab_positions(self, n: int, device) -> torch.Tensor:
        """The vocabulary ids of this rank's n logit columns."""
        return torch.arange(self.t * n, (self.t + 1) * n, device=device)

    def xent_loss(self, logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        """Mean cross-entropy over the whole padded vocabulary from this
        rank's (B, S, Vpad/m) logits: the max, the sum of exponentials and
        the label's logit reduced over the tier (the JAX ``xent_loss``'s
        iota == label mask, kept elementwise over the split vocabulary)."""
        lg = logits.float()
        with torch.no_grad():
            mx = self.tier.all_reduce(lg.amax(-1), op="max")
        se = self.reduce_out(torch.exp(lg - mx[..., None]).sum(-1))
        lse = torch.log(se) + mx
        pos = self.vocab_positions(lg.shape[-1], lg.device)
        ll = self.reduce_out(torch.where(pos == labels[..., None], lg,
                                         0.0).sum(-1))
        return torch.mean(lse - ll)


def block_train_tp(x, w: dict[str, Any], cos, sin, cfg: ModelConfig,
                   tp: TensorParallel, seq: bool):
    """``transformer.block_train`` on one model rank: ``x`` is the residual
    stream (B, S/m, d) with ``seq``, else (B, S, d); ``w`` the rank's
    weights (its columns of the column-parallel leaves, its rows of the
    row-parallel ones). The same kernels: flash attention over the rank's
    heads, the plain and residual RMSNorm forms."""
    from ..kernels.flash_attention.ops import flash_attention_train
    from ..kernels.rmsnorm.ops import rmsnorm_residual_train, rmsnorm_train
    from .layers import apply_rope_angles, mlp_apply
    B = x.shape[0]
    D = cfg.head_dim_
    h = tp.enter(rmsnorm_train(x, w["ln1"], eps=cfg.norm_eps), seq)
    S = h.shape[1]
    q = apply_rope_angles((h @ w["wq"]).reshape(B, S, -1, D), cos, sin)
    k = apply_rope_angles((h @ tp.kv_weight(w["wk"])).reshape(B, S, -1, D),
                          cos, sin)
    v = (h @ tp.kv_weight(w["wv"])).reshape(B, S, -1, D)
    o = flash_attention_train(q, k, v, causal=True)
    y = tp.leave(o.reshape(B, S, -1) @ w["wo"], seq)
    x, h = rmsnorm_residual_train(x, y, w["ln2"], eps=cfg.norm_eps)
    h = tp.enter(h, seq)
    return x + tp.leave(mlp_apply(h, w["gate"], w["up"], w["down"]), seq)
