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
which JAX keeps whole), an MLP width or a vocabulary that m does not divide
are refused.

The ssm family (Mamba2) splits by SSD heads: with H = d_inner / P heads in
G groups, rank t holds heads ``[t·H/m, (t+1)·H/m)``: the z, x and dt
columns of ``in_proj`` for them, the conv channels of its x, ``dt_bias``,
``A_log``, ``D`` and the gated norm's scale for them, and its rows of
``out_proj`` (row-parallel, leaving through :meth:`TensorParallel.leave`).
The B and C columns of ``in_proj`` and their conv channels are held whole
on every rank (each computes B and C in full and takes the groups its
heads read), so JAX's flat column split of the concatenated ``in_proj``,
which cuts mid-head and mid-field, is not copied. The gated norm's
statistic is the mean over the whole d_inner row, so its rows' partial
sums go over the tier (``kernels/rmsnorm/ops.rmsnorm_gated_tier``). In
training a leaf that mixes split and whole parts is held as two leaves
(:func:`ssm_tier_tree`: ``in_proj`` and ``in_proj_bc``, ``conv_w`` and
``conv_w_bc``); the small head-indexed leaves stay whole, as the JAX spec
keeps them, and each rank uses its heads' part. A rank's gradients of the
whole-held leaves cover only its heads' work, dB and dC included: they
flow back unreduced through the conv and the B/C columns, so the block
input's cotangent stays a partial sum that the entering allreduce counts
once, and the step sums those leaves' gradients over the tier. Head
counts that m does not divide, and groups that a rank's heads would split,
are refused.

Serving (``Transformer(..., tp=)``, under ``torch.no_grad``) cuts each
rank's part from the full weights (:meth:`TensorParallel.part`: the JAX
serving specs, ``param_specs(..., fsdp=False)``, but whole KV heads where m
does not divide KV: the ones its q heads read, ``kv_heads``), keeps those
KV heads in its cache, sums the row-parallel products and the embedding
with ``ModelTier.all_reduce`` directly, and takes the greedy token from
the vocabulary shards (:meth:`TensorParallel.greedy`). The dense variants
serve so too: a window, the attention softcap and GeGLU act per head and
per column; gemma2's post-norms and the embedding scale act on the tier's
sums, whole on every rank; the final softcap acts elementwise on the
rank's vocabulary columns (an untied head's columns), before the greedy
token. Training takes them the same way (``transformer.block_train`` with
``tp``): the post-norms norm what :meth:`TensorParallel.leave` gives, the
tier's sum (with ``seq_shard`` the rank's positions of it, so their
scales' gradients take the tier's sum in the step), and the capped
logits of the rank's columns enter the vocabulary-parallel loss.

The MoE family splits its routed experts' E over the tier: rank t holds
the experts [t·E/m, (t+1)·E/m) (``gate``/``up`` (E, d, f) and ``down``
(E, f, d), the JAX spec's E over "model"), the columns of the shared
experts' ``shared_gate``/``shared_up`` and rows of ``shared_down``, and
the router whole (:meth:`TensorParallel.part` reads each leaf's spec at
its JAX path). Every rank routes the whole row alike and runs its
experts' slots; the routed and shared partial sums leave the tier as one
sum a layer (:func:`moe_tp`). With expert parallelism over the rank's
model lane the routed experts are whole on the tier and only the shared
experts' part is summed. Experts, shared-expert columns, heads or a
vocabulary that m does not divide are refused.

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

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ModelConfig, check_supported
from ..core import collectives as C
from .moe import (MOE_LEAF_PATHS, d_shared, moe_apply, moe_route,
                  moe_routed, shared_expert)
from .ssm import MAMBA_PARAMS, mamba_apply, ssm_dims

#: the serving tree's norm scales, by the JAX tree's leaf name ("scale"):
#: held whole on every rank, gemma2's post-norms and llama4's qk-norm too
SCALE_NAMES = {"ln1": "scale", "ln2": "scale", "final_norm": "scale",
               "post_ln1": "scale", "post_ln2": "scale",
               "q_norm": "scale", "k_norm": "scale"}
#: the leaves a Mamba2 layer of the training tree adds on a model tier: the
#: B and C columns of ``in_proj`` and their conv channels, held whole
MAMBA_TIER_LEAVES = ("in_proj_bc", "conv_w_bc")


def check_tp(cfg: ModelConfig, m: int, use: str = "train") -> None:
    """Refuse what the port's tensor parallelism does not split over m, for
    ``use`` "serve" (``Transformer(..., tp=)``) or "train" (the blocks of
    ``transformer.block_train`` on a model rank). Both take the dense
    variants (window, softcaps and GeGLU per head and column, the
    post-norms and embedding scale on the tier's sums), the untied head
    (its vocabulary columns) and the MoE family (its routed experts and
    shared-expert columns; llama4's features in training stay refused by
    ``configs.check_supported``, ROADMAP.md Queue 1 item 15)."""
    if use not in ("serve", "train"):
        raise ValueError(f"unknown use {use!r}")
    if m <= 1:
        return
    if cfg.family == "ssm":
        _, H, _, _, G = ssm_dims(cfg)
        hl, hg = H // m, H // G
        bad = [f"SSD heads {H}"] if H % m else (
            [f"ssm_ngroups {G} (its groups of {hg} heads against {hl} "
             "heads a rank)"] if hl % hg and hg % hl else [])
        if cfg.padded_vocab % m:
            bad.append(f"padded vocab {cfg.padded_vocab}")
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: the port splits whole SSD heads and "
                f"vocabulary rows over a model tier of {m}; it does not "
                f"divide {', '.join(bad)}")
        return
    if cfg.family == "moe" and use == "train":
        check_supported(cfg, "train")
    plan = cfg.layer_plan()
    counts = [("n_heads", cfg.n_heads)]
    if any(s.mlp == "dense" for s in plan):
        counts.append(("d_ff", cfg.d_ff))
    if cfg.family == "moe":
        counts.append(("n_experts", cfg.n_experts))
        if cfg.n_shared_experts:
            counts.append(("d_shared_expert", d_shared(cfg)))
    counts.append(("padded vocab", cfg.padded_vocab))
    H, KV = cfg.n_heads, cfg.n_kv_heads
    bad = [f"{what} {n}" for what, n in counts if n % m]
    if KV % m and (m % KV or KV * cfg.head_dim_ % m):
        bad.append(f"n_kv_heads {KV}")
    if bad:
        parts = ("whole heads, experts, shared-expert columns"
                 if cfg.family == "moe" else "whole heads, MLP columns")
        raise NotImplementedError(
            f"{cfg.name}: the port splits {parts} and vocabulary rows over "
            f"a model tier of {m}; it does not divide {', '.join(bad)}")


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


class _ScaleGrad(torch.autograd.Function):
    """Identity; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _nest(path: tuple[str, ...], t):
    """``t`` as the one leaf of a tree at ``path``."""
    for k in reversed(path):
        t = {k: t}
    return t


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
              meter=None, use: str = "train") -> "TensorParallel":
        check_tp(cfg, grid.m, use)
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

    def experts(self) -> tuple[int, int]:
        """[lo, hi) of this rank's routed experts."""
        E = self.cfg.n_experts
        return self.t * E // self.m, (self.t + 1) * E // self.m

    def ssm_heads(self) -> tuple[int, int]:
        """[lo, hi) of this rank's SSD heads."""
        H = ssm_dims(self.cfg)[1]
        return self.t * H // self.m, (self.t + 1) * H // self.m

    def ssm_groups(self) -> tuple[int, int]:
        """[lo, hi) of the groups whose B and C this rank's heads read."""
        _, H, _, _, G = ssm_dims(self.cfg)
        lo, hi = self.ssm_heads()
        return lo // (H // G), (hi - 1) // (H // G) + 1

    def _ssm_part(self, leaf: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a Mamba2 leaf of the serving tree, laid out
        as a Mamba2 layer of H/m heads whose B and C span every group:
        ``in_proj``'s columns [z, x, B, C, dt] of its heads (B and C
        whole), ``conv_w``'s and ``conv_b``'s channels [x, B, C], its
        heads' ``dt_bias``, ``A_log``, ``D`` and norm scale, its rows of
        ``out_proj``; ``ln`` whole."""
        d_inner, H, _, N, G = ssm_dims(self.cfg)
        lo, hi = self.ssm_heads()
        dl, P = d_inner // self.m, d_inner // H
        x = slice(lo * P, hi * P)
        if leaf == "in_proj":
            bc = slice(2 * d_inner, 2 * d_inner + 2 * G * N)
            return torch.cat([t[:, x], t[:, d_inner:][:, x], t[:, bc],
                              t[:, bc.stop:][:, lo:hi]], 1)
        if leaf in ("conv_w", "conv_b"):
            return torch.cat([t[..., x], t[..., d_inner:]], -1)
        if leaf in ("dt_bias", "A_log", "D"):
            return t[lo:hi]
        if leaf in ("norm", "out_proj"):
            return t[lo * P:lo * P + dl]
        return t

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a full leaf of the serving tree
        (``Transformer``'s flat names, ``layers.{i}.wq`` ...): its part
        over "model" by the JAX serving spec (``param_specs(...,
        fsdp=False)``, read at the leaf's path in the JAX tree: columns of
        ``wq``/``wk``/``wv``/``gate``/``up`` and of the shared experts'
        ``shared_gate``/``shared_up``, rows of ``wo``/``down`` and
        ``shared_down``, the routed experts' E/m of ``gate``/``up``/
        ``down``, vocabulary rows of ``embed``, norm scales and the
        router whole), but for ``wk``/``wv`` where m does not divide KV, whose
        flat columns the JAX spec splits mid-head: there the columns of
        the KV heads this rank's q heads read (:meth:`kv_heads`); and the
        Mamba2 leaves by its SSD heads (:meth:`_ssm_part`). A part is a
        copy of its own, so the full leaf can be freed."""
        from ..train.sharding import MODEL_AXIS, model_dim, param_specs
        leaf = name.rsplit(".", 1)[-1]
        if self.cfg.family == "ssm" and leaf in MAMBA_PARAMS + ("ln",):
            t = self._ssm_part(leaf, t)
        elif leaf in ("wk", "wv") and not self.kv_local:
            lo, hi = self.kv_heads()
            D = self.cfg.head_dim_
            t = t[:, lo * D:hi * D]
        else:
            path = MOE_LEAF_PATHS.get(leaf, (SCALE_NAMES.get(leaf, leaf),))
            spec = param_specs(_nest(path, t), {MODEL_AXIS: self.m})
            for k in path:
                spec = spec[k]
            dim = model_dim(spec)
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

    def once(self, x):
        """A value every rank computes whole (a MoE layer's aux loss),
        entering partial work: its gradient is taken 1/m on each rank, so
        the tier's sums of the partial gradients count it once."""
        return _ScaleGrad.apply(x, 1.0 / self.m)

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

    def ssm_local(self, w: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """A Mamba2 layer's weights on this rank, from its leaves of the
        training tree (:func:`ssm_tier_tree`: its chunk of ``in_proj`` [z,
        x, dt] and of ``conv_w``, the whole ``in_proj_bc``, ``conv_w_bc``
        and small leaves), in :meth:`_ssm_part`'s layout; the concatenations
        and slices are differentiable, so each leaf gets the gradient of
        the part this rank used."""
        d_inner = ssm_dims(self.cfg)[0]
        lo, hi = self.ssm_heads()
        dl = d_inner // self.m
        ch = slice(self.t * dl, (self.t + 1) * dl)
        ip = w["in_proj"]
        return {"in_proj": torch.cat([ip[:, :2 * dl], w["in_proj_bc"],
                                      ip[:, 2 * dl:]], 1),
                "conv_w": torch.cat([w["conv_w"], w["conv_w_bc"]], 1),
                "conv_b": torch.cat([w["conv_b"][ch], w["conv_b"][d_inner:]]),
                "dt_bias": w["dt_bias"][lo:hi], "A_log": w["A_log"][lo:hi],
                "D": w["D"][lo:hi], "norm": w["norm"][ch],
                "out_proj": w["out_proj"]}

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


def mamba_train_tp(x, w: dict[str, Any], cfg: ModelConfig,
                   tp: TensorParallel, seq: bool):
    """``transformer.mamba_block_train`` on one model rank: ``x + mamba(
    rmsnorm(x, ln))`` over the rank's SSD heads (``x`` the residual stream,
    (B, S/m, d) with ``seq``); ``w`` the rank's leaves of the training
    tree. The normed input enters the tier, the mixer runs its heads
    (the SSD kernel on them, the gated norm's statistic over the tier) and
    its ``out_proj`` partial sums leave in fp32, rounded once after the
    tier's sum."""
    from ..kernels.rmsnorm.ops import rmsnorm_train
    h = tp.enter(rmsnorm_train(x, w["ln"], eps=cfg.norm_eps), seq)
    y, _ = mamba_apply(tp.ssm_local(w), h, cfg, tp=tp)
    return x + tp.leave(y, seq).to(x.dtype)


def moe_tp(w: dict[str, Any], h, cfg: ModelConfig, tp: TensorParallel,
           seq: bool, dispatch=None, shares=None):
    """A MoE layer's MLP on one model rank: (its update of the residual
    stream, the layer's aux loss). ``h`` is ``ln2``'s output, whole on
    every rank ((B, S/m, d) with ``seq``); ``w`` the rank's leaves.

    Without ``dispatch`` the rank holds E/m routed experts: ``h`` enters
    the tier (gathered over the sequence with ``seq``: routing and the
    capacity are per whole row), every rank routes it alike, runs its
    experts' slots and its shared-expert columns (``moe_apply(...,
    experts=)``), and the sum leaves the tier once. The router's gradient
    then is a partial sum on each rank (its experts' gates), which the
    step sums over the tier; the aux loss, whole on every rank, enters
    that sum through :meth:`TensorParallel.once`.

    With ``dispatch`` (expert parallelism over the rank's model lane) the
    routed experts are whole on the tier: each rank routes and dispatches
    ``h`` as one rank would, so the routed output is whole on every rank,
    and only the shared experts' partial sum leaves the tier. The routed
    path reads ``h`` outside the tier's ``copy_in`` (its gradient is whole
    already; the allreduce would count it m times); with ``seq`` the
    gathered row is routed and the rank keeps its positions of the
    routed output, so its gradients are partial sums again (the step sums
    the router's and the experts' over the tier) and the aux loss enters
    through :meth:`TensorParallel.once`. ``shares``:
    ``moe.moe_route``'s."""
    if dispatch is None:
        y, aux = moe_apply(w, tp.enter(h, seq), cfg, experts=tp.experts(),
                           shares=shares)
        return tp.leave(y, seq), tp.once(aux)
    row = tp.gather(h, 1) if seq else h
    gates, idx, aux = moe_route(w, row, cfg, shares)
    y = moe_routed(w, row, cfg, gates, idx, dispatch)
    if seq:
        n = h.shape[1]
        y, aux = y[:, tp.t * n:(tp.t + 1) * n], tp.once(aux)
    if cfg.n_shared_experts:
        y = y + tp.leave(shared_expert(w, row if seq else tp.copy_in(h)),
                         seq)
    return y, aux


def _mamba_node(tree: dict) -> tuple[dict, dict]:
    slot = tree["blocks"]["slot0"]
    return slot, slot["mamba"]


def _with_mamba(tree: dict, slot: dict, mamba: dict) -> dict:
    return {**tree, "blocks": {**tree["blocks"],
                               "slot0": {**slot, "mamba": mamba}}}


def ssm_tier_tree(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """The JAX training tree of a Mamba2 model (layers stacked in
    ``blocks/slot0``) in the layout of a model tier of m: ``in_proj`` holds
    the z, x and dt columns in rank-major order, rank t's chunk (dim 1,
    1/m of it) being [z, x, dt] of its heads, and ``in_proj_bc`` the B and
    C columns; ``conv_w`` holds the x channels (chunk t: its heads') and
    ``conv_w_bc`` the B and C channels. Every other leaf as it is.
    :func:`ssm_jax_tree` is the inverse."""
    d_inner, H, _, N, G = ssm_dims(cfg)
    dl, hl = d_inner // m, H // m
    slot, mam = _mamba_node(tree)
    ip, cw = mam["in_proj"], mam["conv_w"]
    z, x, bc, dt = torch.split(ip, [d_inner, d_inner, 2 * G * N, H], -1)
    parts = [p for t in range(m) for p in (z[..., t * dl:(t + 1) * dl],
                                           x[..., t * dl:(t + 1) * dl],
                                           dt[..., t * hl:(t + 1) * hl])]
    return _with_mamba(tree, slot, {
        **mam, "in_proj": torch.cat(parts, -1),
        "in_proj_bc": bc.contiguous(),
        "conv_w": cw[..., :d_inner].contiguous(),
        "conv_w_bc": cw[..., d_inner:].contiguous()})


def ssm_jax_tree(tree: dict, cfg: ModelConfig, m: int) -> dict:
    """The inverse of :func:`ssm_tier_tree`: the JAX tree's ``in_proj``
    and ``conv_w`` put back whole. Leaves may be torch tensors or numpy
    arrays."""
    d_inner, H, _, N, G = ssm_dims(cfg)
    dl, hl = d_inner // m, H // m
    slot, mam = _mamba_node(tree)
    mam = dict(mam)
    ip, bc = mam.pop("in_proj"), mam.pop("in_proj_bc")
    cw, cw_bc = mam.pop("conv_w"), mam.pop("conv_w_bc")
    cat = (torch.cat if isinstance(ip, torch.Tensor)
           else lambda xs, dim: np.concatenate(xs, dim))
    w = 2 * dl + hl
    chunk = lambda t, a, b: ip[..., t * w + a:t * w + b]
    z = cat([chunk(t, 0, dl) for t in range(m)], -1)
    x = cat([chunk(t, dl, 2 * dl) for t in range(m)], -1)
    dt = cat([chunk(t, 2 * dl, w) for t in range(m)], -1)
    return _with_mamba(tree, slot, {**mam, "in_proj": cat([z, x, bc, dt], -1),
                                    "conv_w": cat([cw, cw_bc], -1)})
