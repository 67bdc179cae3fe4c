"""Mixture-of-Experts MLP of the port, with capacity-bounded sort-based
dispatch: ``src/repro/models/moe.py`` in torch.

Dispatch never builds a (B, S, E, C) one-hot: per batch row the S·K
(token, expert) assignments are sorted by expert id (stable), ranked within
their expert, and turned into an (E·C,) gather table of token rows (the
sentinel row S, zeros, where a slot is empty) and its combine weights. An
assignment ranked at or past the capacity C drops to the trash slot E·C,
which is sliced off: the token keeps its residual alone. Every shape is
fixed by (B, S, E, K, C), and the expert counts are a scatter-add of ones
into E bins (no ``bincount``, whose length depends on the data), so the
decode step is one captured CUDA graph. C = ``capacity(cfg, S)`` depends on
the length S of the call: a prefill and a decode step drop differently, as
in the JAX package.

The combine is the JAX scatter-add, done as a gather: each token sums its
K weighted slot outputs in ascending slot order (the order in which the
scatter adds them), a dropped assignment reading a zero row, so the sum is
the same on every run (no atomics on the card). The dispatch's backward
sums each token's slot gradients the same way (``_Dispatch``), where the
gather's own backward would add them with atomics.

On a model tier (``models/tp.moe_tp``) rank t of m holds the experts
[t·E/m, (t+1)·E/m) and its columns of the shared experts' ``gate`` and
``up`` and rows of their ``down``; the router is whole. Every rank routes
the whole row alike (the same top-k, aux loss, dispatch tables, capacity
and drops as one rank), runs only its experts' slots (``moe_apply(...,
experts=)``), and its combine reads a zero row for every other slot: the
ranks' outputs are partial sums of the layer's.

Expert parallelism (:class:`MoeDispatch`, built by ``train/step.py``): the
routed experts' E dim shards over the p ranks of the DP grid, each rank
owning E/p experts, and the slots travel through the ``all_to_all``
collective. Two transports: "slots" ships the dispatched slot table both
ways; "tokens" gathers each rank's token block once over the grid (the
locality-Bruck allgather) and routes only the int32 slot tables through
the all-to-all, the owner gathering its slots from the full copy. Both
deliver the same slot values to the owner, so the forward and the
gradients are the same under either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

AUX_LOSS_W = 0.01


@dataclasses.dataclass(frozen=True)
class MoeDispatch:
    """The expert-parallel hook of ``moe_apply``: the expert weights it
    gets are this rank's E/p experts, and the exchange runs over ``grid``
    (every rank of the DP grid). ``algorithm`` is "locality" or "xla",
    ``transport`` "tokens" or "slots". :meth:`exchange` and :meth:`gather`
    are the collectives, staged through the host where the grid's device
    is not the tensor's; ``train/step.py`` meters them."""

    grid: Any
    algorithm: str
    transport: str

    @property
    def p(self) -> int:
        return self.grid.p

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        from ..core import collectives as C
        return C.all_to_all(x, self.grid, algorithm=self.algorithm,
                            stage=True)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, tiled in grid-rank order: the locality-Bruck
        gather for "locality", the library's for "xla"."""
        from ..core import collectives as C
        alg = "xla" if self.algorithm == "xla" else "locality_bruck"
        return C.allgather_finish(C.allgather_start(
            x, self.grid, algorithm=alg, tiled=True, stage=True))


def d_expert(cfg) -> int:
    return cfg.d_expert or cfg.d_ff


def d_shared(cfg) -> int:
    return cfg.d_shared_expert or cfg.n_shared_experts * d_expert(cfg)


def moe_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """The MoE leaves of one layer by their names in a layer of the port's
    flat serving tree: ``router``, the routed experts' stacked ``gate``,
    ``up`` (E, d, f) and ``down`` (E, f, d), and the shared experts'
    ``shared_gate``, ``shared_up``, ``shared_down``."""
    d, E, f = cfg.d_model, cfg.n_experts, d_expert(cfg)
    out = {"router": (d, E), "gate": (E, d, f), "up": (E, d, f),
           "down": (E, f, d)}
    if cfg.n_shared_experts:
        dsh = d_shared(cfg)
        out |= {"shared_gate": (d, dsh), "shared_up": (d, dsh),
                "shared_down": (dsh, d)}
    return out


#: where each of :func:`moe_shapes`' leaves sits in a MoE layer of the JAX
#: tree (``src/repro/models/moe.py`` ``moe_init``): the path its spec is
#: read by (a shared expert's ``gate`` is column-parallel, a routed
#: expert's (E, d, f) ``gate`` splits its E)
MOE_LEAF_PATHS = {
    "router": ("moe", "router"), "gate": ("moe", "gate"),
    "up": ("moe", "up"), "down": ("moe", "down"),
    "shared_gate": ("moe", "shared", "gate"),
    "shared_up": ("moe", "shared", "up"),
    "shared_down": ("moe", "shared", "down")}


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Random MoE leaves (:func:`moe_shapes`) with the JAX ``moe_init``
    distributions, N(0, 1/d_in) each (other bits): drawn in fp32, expert
    by expert, router first, stored in ``dtype``."""
    out = {}
    for name, shape in moe_shapes(cfg).items():
        d_in = shape[-2]
        w = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0] if len(shape) == 3 else 1):
            draw = torch.randn(shape[-2:], generator=gen,
                               dtype=torch.float32, device=device)
            (w[e] if len(shape) == 3 else w).copy_(
                draw * (1.0 / math.sqrt(d_in)))
        out[name] = w
    return out


def moe_param_count(cfg, active_only: bool = False) -> int:
    E = cfg.top_k if active_only else cfg.n_experts
    n = cfg.d_model * cfg.n_experts            # the router, always whole
    n += E * 3 * cfg.d_model * d_expert(cfg)
    if cfg.n_shared_experts:
        n += 3 * cfg.d_model * d_shared(cfg)
    return n


def capacity(cfg, S: int) -> int:
    """Slots an expert has in a row of S tokens: S·K/E·cf, at least K."""
    c = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


def dispatch_tables(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (E·C) gather tables of every row: the JAX ``_dispatch_tables``
    over the batch.

    idx, gates: (B, S, K) expert ids and combine weights. Returns
    ``tok_idx`` (B, E·C) int64 in [0, S] (S: the sentinel row),
    ``weight`` (B, E·C) and ``slot_of`` (B, S, K): each assignment's slot,
    E·C where it was dropped, ascending along K (the combine's order)."""
    B, S, K = idx.shape
    n = S * K
    dev = idx.device
    flat_e = idx.reshape(B, n)
    flat_w = gates.reshape(B, n)
    order = torch.argsort(flat_e, dim=1, stable=True)   # expert-major
    e_sorted = flat_e.gather(1, order)
    tok_sorted = order // K                              # the assignment's
    w_sorted = flat_w.gather(1, order)                   # token
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts            # exclusive prefix
    rank = torch.arange(n, device=dev) - starts.gather(1, e_sorted)
    slot = torch.where(rank < C, e_sorted * C + rank.clamp(0, C - 1), E * C)
    # dropped assignments land in the trash slot E·C, sliced off
    tok_idx = torch.full((B, E * C + 1), S, dtype=torch.long,
                         device=dev).scatter_(1, slot, tok_sorted)[:, :E * C]
    weight = torch.zeros((B, E * C + 1), dtype=flat_w.dtype,
                         device=dev).scatter_(1, slot, w_sorted)[:, :E * C]
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    slot_of = torch.sort(slot_of.reshape(B, S, K), dim=-1).values
    return tok_idx, weight, slot_of


def expert_mlp(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The per-expert SwiGLU on dispatched slots: (B, E, C, d) -> same, as
    batched products over the experts."""
    B, E, C, d = h.shape
    dt = h.dtype
    hh = h.transpose(0, 1).reshape(E, B * C, d)
    g = torch.bmm(hh, params["gate"].to(dt))
    u = torch.bmm(hh, params["up"].to(dt))
    y = torch.bmm(F.silu(g) * u, params["down"].to(dt))
    return y.reshape(E, B, C, d).transpose(0, 1)


def slot_sum(y: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """Each token's K slot rows of ``y`` (B, n, d), summed in ascending slot
    order (``slot_of`` (B, S, K); n reads a zero row: a dropped assignment,
    or another share's slot): (B, S, d). A gather, no atomics: the same sum
    on every run."""
    B, S, K = slot_of.shape
    d = y.shape[-1]
    y = torch.cat([y, y.new_zeros((B, 1, d))], 1)
    parts = y.gather(1, slot_of.reshape(B, S * K, 1).expand(-1, -1, d))
    parts = parts.reshape(B, S, K, d)
    out = parts[:, :, 0]
    for k in range(1, K):
        out = out + parts[:, :, k]
    return out


class _Dispatch(torch.autograd.Function):
    """The slots' token rows: x (B, S, d) at ``tok_idx`` (B, n) in [0, S],
    S the sentinel (a zero row) -> (B, n, d). The backward sums each
    token's K slot gradients by :func:`slot_sum` (``slot_of``: the same
    slots seen from the tokens), where the gather's own backward would add
    them with atomics in an order that varies between runs on the card."""

    @staticmethod
    def forward(ctx, x, tok_idx, slot_of):
        ctx.save_for_backward(slot_of)
        x_pad = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], 1)
        return x_pad.gather(1, tok_idx[..., None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, g):
        return slot_sum(g, ctx.saved_tensors[0]), None, None


def _ep_apply(params: dict, x: torch.Tensor, tok_idx: torch.Tensor,
              slot_of: torch.Tensor, cfg, dispatch: MoeDispatch, C: int
              ) -> torch.Tensor:
    """Expert-parallel slot compute: route the slots to the rank that owns
    their expert, apply its E/p experts, route the results home. Returns
    the (B, E·C, d) slot outputs in global expert-major order."""
    Bl, S, d = x.shape
    S1 = S + 1
    E, p = cfg.n_experts, dispatch.p
    Ep = E // p
    if dispatch.transport == "tokens":
        # each rank's (sentinel-padded) token block once over the grid; the
        # int32 slot tables through the all-to-all; the owner gathers its
        # slots from the full copy
        x_pad = torch.cat([x, x.new_zeros((Bl, 1, d))], 1)      # sentinel
        xg = dispatch.gather(x_pad.reshape(Bl * S1, d)).reshape(p, Bl, S1, d)
        ii = tok_idx.to(torch.int32).reshape(Bl, p, Ep * C).transpose(0, 1)
        ri = dispatch.exchange(ii.reshape(p * Bl, Ep * C).contiguous())
        ri = ri.long().reshape(p, Bl, Ep * C)
        h_in = xg.gather(2, ri[..., None].expand(-1, -1, -1, d))
    else:
        # dispatch at home, ship the (E/p)·C slot slabs to their owners
        disp = _Dispatch.apply(x, tok_idx, slot_of)
        dd = disp.reshape(Bl, p, Ep * C, d).transpose(0, 1)
        h_in = dispatch.exchange(dd.reshape(p * Bl, Ep * C, d).contiguous())
    y = expert_mlp(params, h_in.reshape(p * Bl, Ep, C, d))
    back = dispatch.exchange(y.reshape(p * Bl, Ep * C, d).contiguous())
    return back.reshape(p, Bl, Ep * C, d).transpose(0, 1).reshape(
        Bl, E * C, d)


def moe_route(params: dict, x: torch.Tensor, cfg, shares=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on x (B, S, d): (gates, idx) (B, S, K), the combine
    weights and expert ids of each token's top-k, and the Switch
    load-balance loss, fp32. ``shares(f)`` (a DP rank of the JAX "xla"
    step, which routes the global batch as one program) turns this rank's
    first-choice shares f_e into the global batch's: the loss then is
    this rank's term of the global one, whose mean over the ranks it is,
    and whose gradient the ranks' mean is."""
    E, K = cfg.n_experts, cfg.top_k
    logits = (x @ params["router"].to(x.dtype)).float()          # (B,S,E)
    if cfg.router_act == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)                     # (B,S,K)
    if cfg.router_norm_topk and K > 1:
        gates = gates / gates.sum(-1, keepdim=True)

    # the auxiliary load-balance loss (Switch): E · <f_e> . <p_e>, f_e the
    # share of tokens whose first choice is e (counted by a scatter-add: no
    # one-hot, nothing that waits on the data)
    top1 = idx[..., 0].reshape(-1)
    me = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, top1, torch.ones(top1.shape, dtype=torch.float32,
                            device=x.device)) / top1.numel()
    if shares is not None:
        me = shares(me)
    pe = torch.softmax(logits, dim=-1).mean((0, 1))
    return gates, idx, AUX_LOSS_W * E * torch.sum(me * pe)


def moe_routed(params: dict, x: torch.Tensor, cfg, gates: torch.Tensor,
               idx: torch.Tensor, dispatch: MoeDispatch | None = None,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """The routed experts' weighted sum for x (B, S, d), from the router's
    ``gates`` and ``idx``. ``experts`` = [lo, hi) runs only those experts'
    slots (a model rank's share: ``params``' stacks hold those experts);
    every other slot reads a zero row in the combine, so the sum over the
    shares is the whole sum."""
    B, S, d = x.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    dt = x.dtype
    tok_idx, weight, slot_of = dispatch_tables(idx, gates, E, C)
    if dispatch is not None:
        y = _ep_apply(params, x, tok_idx, slot_of, cfg, dispatch, C)
    else:
        lo, hi = experts or (0, E)
        n = (hi - lo) * C
        tok_idx, weight = tok_idx[:, lo * C:hi * C], weight[:, lo * C:hi * C]
        # another share's slot, or a dropped assignment, reads the zero row
        slot_of = slot_of - lo * C
        slot_of = torch.where((slot_of >= 0) & (slot_of < n), slot_of, n)
        disp = _Dispatch.apply(x, tok_idx, slot_of)
        y = expert_mlp(params, disp.reshape(B, hi - lo, C, d)).reshape(
            B, n, d)
    # combine: each token's K slot outputs in ascending slot order
    return slot_sum(y * weight[..., None].to(dt), slot_of)


def shared_expert(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU (of a model rank: its columns of
    ``shared_gate``/``shared_up`` and rows of ``shared_down``, a partial
    sum)."""
    dt = x.dtype
    sg = F.silu(x @ params["shared_gate"].to(dt))
    return (sg * (x @ params["shared_up"].to(dt))) \
        @ params["shared_down"].to(dt)


def moe_apply(params: dict, x: torch.Tensor, cfg,
              dispatch: MoeDispatch | None = None,
              experts: tuple[int, int] | None = None, shares=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) in the compute dtype -> (out, aux): the routed experts'
    weighted sum (plus the shared experts) and the Switch load-balance
    loss, fp32. ``params`` holds :func:`moe_shapes`' leaves (the routed
    ones this rank's E/p experts under ``dispatch``). ``experts`` = [lo,
    hi) gives one model rank's share (``params`` its experts and its
    columns and rows of the shared experts): the routing, the aux loss and
    the dispatch tables of the whole row, as on every rank, then only its
    experts' slots and its part of the shared experts; the shares sum to
    the whole output. ``shares``: :func:`moe_route`'s."""
    gates, idx, aux = moe_route(params, x, cfg, shares)
    out = moe_routed(params, x, cfg, gates, idx, dispatch, experts)
    if cfg.n_shared_experts:
        out = out + shared_expert(params, x)
    return out, aux
