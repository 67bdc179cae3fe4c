"""Decoder-only stack of the port: the dense llama family and its variants,
its MoE variant and Mamba2.

Mirrors ``repro.models.transformer.forward`` for three families:

* ``mode="prefill"``: tokens (B,S) -> last-position logits (B,1,Vpad) and a
  decode cache, with ``cache["pos"] = S``;
* ``mode="decode"``: tokens (B,1) against that cache -> logits (B,1,Vpad);
  the cache is updated in place, ``pos`` too (it advances by one), and the
  same dict comes back (the JAX package returns a new cache with a new
  ``pos`` array), so a CUDA graph captured over one step replays the next
  on the same tensors. ``pos`` is a 0-d tensor (lockstep batch) or (B,)
  (continuous batching).

A sequence-parallel rank holds a shard of each K/V stack (``shards``:
the slots [offset, offset + length) of the full-length cache, or of the
rings, each ring of min(cache_len, window or chunk) slots split by its own
length):
its prefill runs the whole prompt and keeps only those slots (of a ring,
the rank's slice of the rolled ring), and its decode passes each
attention layer's cache write and attention to a ``decode_combine`` hook,
the JAX protocol
(``repro.models.attention.attention``): ``decode_combine(q, k_new, v_new,
k_cache, v_cache, pos, meta) -> (o, k_cache, v_cache)`` or None for the
plain path, with ``meta = {window, chunk, cap, ring}``.

The JAX package scans stacked ``blocks/slot{j}`` parameters; here the
layers are a ``ModuleList`` in global layer order, built from
``cfg.layer_plan()``: a :class:`Block` (attention then the gated MLP) for
an ``attn`` mixer (its MLP the routed and shared experts of
``models/moe.py`` where the plan's ``mlp`` is "moe", the auxiliary loss
dropped in serving, as the JAX engine drops it), a :class:`MambaBlock`
(``x + mamba(rmsnorm(x))``) for a ``mamba2`` one. The dense variants
(yi-6b, h2o-danube-3-4b, gemma2-9b) add, per the config: sliding-window
layers (``attn == "window"``, gemma2's every other layer), a tanh softcap
on the attention scores and on the logits, sandwich norms (``post_ln1``
on the attention output, ``post_ln2`` on the MLP's, before each residual
add), the embedding scaled by sqrt(d_model) and GeGLU. llama4-scout
adds chunked-local layers (``attn == "chunked"``: a query sees the keys
of its own ``chunk``-token chunk), NoPE layers (every 4th: no rotary
embedding) and qk-norm (q and k normed over the head dim by
``q_norm``/``k_norm`` before the rotary embedding). Each layer's decode
meta (:func:`decode_meta`) carries its window, chunk, cap and ring.

The cache holds one stacked tensor per leaf: ``k`` and ``v``
(n_full, B, L, KV, D) for the full-attention layers, padded to
``cache_len`` slots; ``k_ring`` and ``v_ring`` (n_ring, B, L_ring, KV, D)
for the window or chunked layers, each a ring of L_ring = min(cache_len,
window or chunk) slots holding token t at slot t % L_ring (the JAX
``ring_cache_len``; a prompt longer than the ring keeps its last L_ring
keys); a stack with no layer is left out (llama keeps ``k`` and ``v``
alone, h2o-danube ``k_ring`` and ``v_ring`` alone, gemma2 21 layers in
each, llama4 its chunked layers in the rings and its NoPE layers in
``k``/``v``); ``conv``
(n_layers, B, W-1, Ch) and ``h`` (n_layers, B, H, N, P) fp32 for the SSM
family.

Training (:func:`forward_train`) takes the JAX package's parameter tree
instead, fp32 master weights with the layers stacked by the plan's period
(``blocks/slot{j}``: ``{ln1, attn, ln2, mlp}`` for the dense family, with
``post_ln1`` and ``post_ln2`` where it has sandwich norms, ``{ln,
mamba}`` for the ssm one; gemma2's window / full pair two slots) and the
remainder's layers unstacked in ``rest`` (:func:`train_slots`), see
:func:`init_train_params`; it runs each layer's block math (its window,
the softcaps, the sandwich norms, GeGLU, the scaled embedding) with the
differentiable kernels.

Parameters are a flat dict keyed like this module's ``state_dict``:
``embed`` (Vpad, d), ``final_norm`` (d,), ``head`` (d, Vpad) where the
output head is untied, and ``layers.{i}.{name}``, for ``ln1, wq, wk, wv,
wo, ln2, gate, up, down`` (dense), the same attention leaves with
``router``, the experts' stacked ``gate, up, down`` and ``shared_gate,
shared_up, shared_down`` (MoE; llama4 adds ``q_norm`` and ``k_norm``,
(head_dim,) each), or ``ln, in_proj, conv_w, conv_b,
dt_bias, A_log, D, norm, out_proj`` (Mamba2), in the JAX ``(d_in, d_out)``
layout. :func:`init_params` makes them from a
``torch.Generator``; :func:`params_from_jax` converts the JAX package's
``init_params`` tree (passed as numpy arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..configs import LayerSpec, ModelConfig, check_supported
from . import attention as attn
from ..kernels.flash_attention.ops import flash_attention_train
from ..kernels.rmsnorm.ops import rmsnorm_residual_train, rmsnorm_train
from .layers import (apply_rope_angles, dense_init, embed_init, embed_scale,
                     mlp_apply, rmsnorm, rmsnorm_residual, rope_angles,
                     softcap)
from .moe import MOE_LEAF_PATHS, moe_apply, moe_init, moe_shapes
from .ssm import (MAMBA_PARAMS, mamba_apply, mamba_cache_shapes, mamba_init,
                  mamba_shapes)
from .tp import MAMBA_TIER_LEAVES, mamba_train_tp, moe_tp, ssm_tier_tree

ATTN_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
QK_NORM_PARAMS = ("q_norm", "k_norm")          # llama4's qk-norm scales
LAYER_PARAMS = ATTN_PARAMS + ("gate", "up", "down")
SANDWICH_PARAMS = ("post_ln1", "post_ln2")     # gemma2's post-norms
MAMBA_LAYER_PARAMS = ("ln",) + MAMBA_PARAMS
#: the cache leaves of the full-attention layers and of the ring layers
FULL_LEAVES, RING_LEAVES = ("k", "v"), ("k_ring", "v_ring")


def ring_cache_len(cfg: ModelConfig, spec) -> int | None:
    """The ring's size of a window or chunked-local layer (None: a
    full-length cache): the JAX ``ring_cache_len``, the window or the
    chunk; a cache of ``cache_len`` slots holds min(cache_len, this)."""
    if spec.mixer != "attn":
        return None
    if spec.attn == "window" and cfg.window:
        return cfg.window
    if spec.attn == "chunked" and cfg.chunk:
        return cfg.chunk
    return None


def prefill_rows(t: torch.Tensor, total: int, offset: int, length: int,
                 ring: bool) -> torch.Tensor:
    """The rows that a prefill of keys or values ``t`` (B,S,KV,D) leaves
    in the slots [offset, offset + length) of a ``total``-slot stack (the
    whole stack, or a rank's shard of it), at its first slots: the
    prompt's tokens there, fewer where the prompt ends first; of a ring
    that the prompt overflows, the last ``total`` tokens, token t at slot
    t % total (the JAX prefill's rolled ring), then the shard's slice."""
    S = t.shape[1]
    if ring and S > total:
        t = torch.roll(t[:, S - total:], (S - total) % total, dims=1)
    return t[:, offset:offset + length]


def decode_meta(cfg: ModelConfig, spec) -> dict:
    """The decode_combine hook's meta of a layer of the plan entry
    ``spec``: its window (window layers), chunk (chunked-local layers),
    the attention softcap and whether its cache is a ring."""
    ring = ring_cache_len(cfg, spec) is not None
    return {"window": cfg.window if spec.attn == "window" else 0,
            "chunk": cfg.chunk if spec.attn == "chunked" else 0,
            "cap": cfg.attn_softcap, "ring": ring}


def find_period(plan) -> tuple[int, int, int]:
    """(period, reps, remainder) of a layer plan: the JAX package's
    super-block structure, needed to read its stacked parameters."""
    keys = [s.key() for s in plan]
    n = len(keys)
    for pi in range(1, n + 1):
        reps = n // pi
        if reps < 1:
            break
        if all(keys[i] == keys[i % pi] for i in range(reps * pi)):
            return pi, reps, n - reps * pi
    return n, 1, 0


def _same(t):
    return t


def attn_qkv(x, w, cos, sin, cfg: ModelConfig, norm=rmsnorm, enter=_same,
             kv_weight=_same, rope: bool = True):
    """A dense layer's first half up to attention: ``ln1``, the q/k/v
    projections, qk-norm where ``w`` holds ``q_norm`` and ``k_norm`` (q
    (B,S,H,D) and k normed over D, each its (D,) scale, before the rotary
    embedding) and the rotary embeddings (none on a NoPE layer,
    ``rope=False``); ``w`` maps ``LAYER_PARAMS`` names to weights in
    ``cfg.dtype``. On a model rank (``w`` its heads' columns) ``enter``
    takes the normed input into the tier's split work and ``kv_weight``
    gives ``wk``/``wv`` as the columns of its KV heads."""
    D = cfg.head_dim_
    h = enter(norm(x, w["ln1"], eps=cfg.norm_eps))
    B, S, _ = h.shape
    q = (h @ w["wq"]).reshape(B, S, -1, D)
    k = (h @ kv_weight(w["wk"])).reshape(B, S, -1, D)
    v = (h @ kv_weight(w["wv"])).reshape(B, S, -1, D)
    if "q_norm" in w:
        q = norm(q, w["q_norm"], eps=cfg.norm_eps)
        k = norm(k, w["k_norm"], eps=cfg.norm_eps)
    if rope:
        q = apply_rope_angles(q, cos, sin)
        k = apply_rope_angles(k, cos, sin)
    return q, k, v


def out_mlp(x, o, w, cfg: ModelConfig, norm_residual=rmsnorm_residual,
            reduce=_same, norm=rmsnorm, enter=_same):
    """A dense layer's second half from the attention output: ``x + o @ wo``
    and ``ln2`` in one pass, then ``x + mlp``; with sandwich norms ``o @
    wo`` and the MLP's output each go through their plain post-norm before
    their residual add. On a model rank (``w`` its heads' rows of ``wo``,
    its columns of the MLP) ``reduce`` sums the row-parallel products'
    partial sums over the tier (with ``seq_shard`` it also keeps the rank's
    positions), before the post-norm: RMSNorm is not linear, so it norms
    the tier's sum; ``enter`` takes ``ln2``'s output into the MLP's split
    work."""
    post = (lambda y, name: norm(y, w[name], eps=cfg.norm_eps)) \
        if cfg.sandwich_norm else (lambda y, name: y)
    a = post(reduce(o.reshape(*o.shape[:2], -1) @ w["wo"]), "post_ln1")
    x, h = norm_residual(x, a, w["ln2"], eps=cfg.norm_eps)
    m = reduce(mlp_apply(enter(h), w["gate"], w["up"], w["down"],
                         cfg.mlp_act))
    return x + post(m, "post_ln2")


def out_moe(x, o, w, cfg: ModelConfig, norm_residual=rmsnorm_residual,
            dispatch=None, reduce=_same, tp=None, seq: bool = False,
            shares=None):
    """A MoE layer's second half: ``x + o @ wo`` and ``ln2`` in one pass,
    then ``x + moe``; returns (x, the layer's auxiliary loss). On a model
    rank (``tp``) ``reduce`` sums ``o @ wo`` over the tier as in
    :func:`out_mlp`, and the MoE runs the rank's share
    (``models/tp.moe_tp``), whose partial sums leave the tier once.
    ``shares``: ``moe.moe_route``'s."""
    x, h = norm_residual(x, reduce(o.reshape(*o.shape[:2], -1) @ w["wo"]),
                         w["ln2"], eps=cfg.norm_eps)
    m, aux = (moe_apply(w, h, cfg, dispatch=dispatch, shares=shares)
              if tp is None else moe_tp(w, h, cfg, tp, seq, dispatch, shares))
    return x + m, aux


class Block(nn.Module):
    """One pre-norm decoder layer: attention then the gated MLP, or the
    MoE experts when ``weights`` holds a router. ``meta`` is the layer's
    :func:`decode_meta` (its window, chunk, softcap and ring); ``rope``
    False makes it a NoPE layer."""

    def __init__(self, cfg: ModelConfig, weights: dict[str, torch.Tensor],
                 meta: dict, tp=None, rope: bool = True):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.meta = meta
        self.rope = rope
        self.moe = "router" in weights
        for name in weights:
            self.register_parameter(
                name, nn.Parameter(weights[name], requires_grad=False))

    def forward(self, x, cos, sin, *, kv_cache=None, pos=None,
                decode_combine=None):
        """Prefill (``kv_cache`` None): returns (x, (k, v)) with this
        layer's keys and values. Decode: writes the token's key and value
        into ``kv_cache = (k_cache, v_cache)`` in place at ``pos`` (``pos %
        L`` on a ring) and returns (x, None); a ``decode_combine`` hook
        (module docstring) does the write and the attention when it takes
        the layer."""
        w, meta = self._parameters, self.meta
        q, k, v = attn_qkv(x, w, cos, sin, self.cfg, rope=self.rope)
        if kv_cache is None:
            o = attn.multihead_attention(q, k, v, causal=True,
                                         window=meta["window"],
                                         chunk=meta["chunk"],
                                         cap=meta["cap"])
            kv = (k, v)
        else:
            k_cache, v_cache = kv_cache
            res = None if decode_combine is None else decode_combine(
                q, k, v, k_cache, v_cache, pos, meta)
            if res is None:
                attn.write_cache(k_cache, k, pos, ring=meta["ring"])
                attn.write_cache(v_cache, v, pos, ring=meta["ring"])
                o = attn.decode_attention(q, k_cache, v_cache, pos,
                                          window=meta["window"],
                                          chunk=meta["chunk"],
                                          cap=meta["cap"], ring=meta["ring"])
            else:
                o = res[0]
            kv = None
        # x = x + o @ wo; h = rmsnorm(x, ln2): one pass on the card
        reduce = _same if self.tp is None else self.tp.tier.all_reduce
        if self.moe:
            return out_moe(x, o, w, self.cfg, reduce=reduce,
                           tp=self.tp)[0], kv
        return out_mlp(x, o, w, self.cfg, reduce=reduce), kv


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 layer: ``x + mamba(rmsnorm(x, ln))``; on a model
    rank (``tp``) the mixer's partial sums are summed over the tier."""

    def __init__(self, cfg: ModelConfig, weights: dict[str, torch.Tensor],
                 tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        for name in MAMBA_LAYER_PARAMS:
            self.register_parameter(
                name, nn.Parameter(weights[name], requires_grad=False))

    def forward(self, x, *, cache=None):
        """Prefill (``cache`` None): returns (x, {"conv", "h"}) with this
        layer's decode cache. Decode: ``cache = {"conv", "h"}`` holds this
        layer's views of the stacked cache, which are updated in place;
        returns (x, None)."""
        h = rmsnorm(x, self.ln, eps=self.cfg.norm_eps)
        params = {n: getattr(self, n) for n in MAMBA_PARAMS}
        y, nc = mamba_apply(params, h, self.cfg,
                            cache={} if cache is None else cache, tp=self.tp)
        if self.tp is not None:
            y = self.tp.tier.all_reduce(y).to(x.dtype)
        if cache is None:
            return x + y, nc
        cache["conv"].copy_(nc["conv"])
        cache["h"].copy_(nc["h"])
        return x + y, None


class Transformer(nn.Module):
    """The decoder, parameters held in ``cfg.dtype`` on ``device``.

    ``tp`` (``models/tp.TensorParallel``) makes it one rank of a model
    tier: it holds its part of each leaf (``tp.part``: its q heads and the
    KV heads they read, its MLP columns, its routed experts and
    shared-expert columns, or its SSD heads; its vocabulary rows), its
    cache holds those KV heads or SSD heads (and their conv channels),
    each layer's row-parallel products (a MoE layer's routed and shared
    partial sums in one) and the embedding are summed over the tier, and
    the logits are its vocabulary's columns
    (B, 1, Vpad/m). ``params`` holds full leaves, or
    leaves already cut to the rank's part (``init_params(..., part=
    tp.part)``), which are taken as they are."""

    def __init__(self, cfg: ModelConfig, params: dict[str, Any],
                 device: torch.device | str, tp=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp = tp
        full = {} if tp is None else param_shapes(cfg)

        def load(name):
            t = torch.as_tensor(params[name])
            if tp is not None and tuple(t.shape) == full[name]:
                t = tp.part(name, t)
            return t.to(device=device, dtype=cfg.dtype)

        def block(i, spec):
            names = spec_params(cfg, spec)
            if spec.mixer == "mamba2":
                return MambaBlock(cfg, {n: load(f"layers.{i}.{n}")
                                        for n in names}, tp)
            return Block(cfg, {n: load(f"layers.{i}.{n}") for n in names},
                         decode_meta(cfg, spec), tp, rope=spec.rope)

        self.embed = nn.Parameter(load("embed"), requires_grad=False)
        self.final_norm = nn.Parameter(load("final_norm"), requires_grad=False)
        self.head = (None if cfg.tie_embeddings else
                     nn.Parameter(load("head"), requires_grad=False))
        plan = cfg.layer_plan()
        self.layers = nn.ModuleList(block(i, s) for i, s in enumerate(plan))
        self.ssm = cfg.family == "ssm"
        # layer i's cache: (its stack's leaves, its index in the stack)
        sizes = [ring_cache_len(cfg, s) for s in plan]
        rings = [n is not None for n in sizes]
        # every ring layer's: the config's window or chunk (a plan has
        # window layers or chunked ones, not both)
        self.ring_size = next((n for n in sizes if n), None)
        self.cache_slot = [(RING_LEAVES if r else FULL_LEAVES,
                            sum(rings[:i]) if r else i - sum(rings[:i]))
                           for i, r in enumerate(rings)]
        self.n_ring = sum(rings)
        # the layers of each K/V stack (none for the SSM family)
        self.stack_layers = {} if self.ssm else {
            names: n for names, n in ((FULL_LEAVES, len(plan) - self.n_ring),
                                      (RING_LEAVES, self.n_ring)) if n}
        self.embed_scale = (embed_scale(cfg.d_model, cfg.dtype)
                            if cfg.scale_embed else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def ring_len(self, cache_len: int) -> int | None:
        """The slots of a window or chunked layer's ring in a
        ``cache_len``-slot cache: min(cache_len, its ``ring_cache_len``);
        None where no layer is a ring."""
        return (None if self.ring_size is None
                else min(cache_len, self.ring_size))

    def stack_lens(self, cache_len: int) -> dict[tuple[str, str], int]:
        """The slots of each K/V stack with a layer in a ``cache_len``-slot
        cache, by its leaves' names: ``cache_len`` for the full-attention
        layers' ``k``/``v``, :meth:`ring_len` for the rings; none for the
        SSM family."""
        return {names: cache_len if names == FULL_LEAVES
                else self.ring_len(cache_len) for names in self.stack_layers}

    def cache_shapes(self, batch: int, cache_len: int, shards=None
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every cache leaf but ``pos``, stacked over the
        layers of each stack (module docstring; the SSM state has no slots:
        ``cache_len`` does not size it). ``shards`` maps a stack's leaves'
        names to (offset, length) where this rank holds a shard of it."""
        cfg = self.cfg
        if self.ssm:
            m = 1 if self.tp is None else self.tp.m
            return {name: ((cfg.n_layers,) + shape, dtype)
                    for name, (shape, dtype)
                    in mamba_cache_shapes(cfg, batch, m).items()}
        kv = cfg.n_kv_heads
        if self.tp is not None:
            lo, hi = self.tp.kv_heads()
            kv = hi - lo
        shards = shards or {}
        return {name: ((self.stack_layers[names], batch,
                        shards[names][1] if names in shards else L, kv,
                        cfg.head_dim_), cfg.dtype)
                for names, L in self.stack_lens(cache_len).items()
                for name in names}

    def empty_cache(self, batch: int, cache_len: int, *,
                    vector_pos: bool = False, shards=None
                    ) -> dict[str, torch.Tensor]:
        """A zeroed cache for ``batch`` rows of ``cache_len`` slots (of the
        ``shards`` this rank holds)."""
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
        pos = zeros((batch,) if vector_pos else (), torch.long)
        return {name: zeros(shape, dtype) for name, (shape, dtype)
                in self.cache_shapes(batch, cache_len, shards).items()
                } | {"pos": pos}

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, mode: str = "prefill",
                cache: dict[str, torch.Tensor] | None = None,
                cache_len: int = 0, *, shards=None, decode_combine=None):
        """Returns ``(logits, new_cache)``; see the module docstring.
        ``shards`` (prefill: a stack's leaves' names -> the (offset,
        length) of the ``cache_len``-slot cache's stack this rank keeps;
        a stack not named is kept whole) and ``decode_combine`` (decode)
        serve a sequence-parallel rank's shards of the cache."""
        cfg = self.cfg
        B, S = tokens.shape
        if self.tp is None:
            x = self.embed[tokens]
        else:
            x = self.tp.tier.all_reduce(self.tp.local_embed(tokens,
                                                            self.embed))
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if mode == "prefill":
            if cache is not None:
                raise ValueError("prefill builds its cache; pass cache_len")
            L = cache_len or S
            if S > L:
                raise ValueError(f"prompt of {S} tokens exceeds the "
                                 f"{L}-slot cache")
            shards = shards or {}
            if shards and self.ssm:
                raise ValueError("SSM caches are never sequence-sharded")
            new_cache = self.empty_cache(B, L, shards=shards)
            if self.ssm:
                for i, layer in enumerate(self.layers):
                    x, nc = layer(x)
                    for name, t in nc.items():
                        new_cache[name][i] = t
            else:
                positions = torch.arange(S, device=tokens.device)[None]
                cos, sin = rope_angles(positions, cfg.head_dim_,
                                       cfg.rope_theta)
                lens = self.stack_lens(L)
                for i, layer in enumerate(self.layers):
                    x, kv = layer(x, cos, sin)
                    names, j = self.cache_slot[i]
                    off, n = shards.get(names, (0, lens[names]))
                    for name, t in zip(names, kv):
                        rows = prefill_rows(t, lens[names], off, n,
                                            names == RING_LEAVES)
                        new_cache[name][j, :, :rows.shape[1]] = rows
            new_cache["pos"] = torch.tensor(S, dtype=torch.long,
                                            device=tokens.device)
            # the norm is per row, so norming the last position alone is exact
            x = x[:, -1:].contiguous()
        elif mode == "decode":
            if cache is None:
                raise ValueError("decode needs a cache")
            pos = cache["pos"]
            if self.ssm:
                for i, layer in enumerate(self.layers):
                    x, _ = layer(x, cache={"conv": cache["conv"][i],
                                           "h": cache["h"][i]})
            else:
                positions = (pos[:, None] if pos.ndim == 1
                             else pos.expand(B, 1))
                cos, sin = rope_angles(positions, cfg.head_dim_,
                                       cfg.rope_theta)
                for i, layer in enumerate(self.layers):
                    (nk, nv), j = self.cache_slot[i]
                    x, _ = layer(x, cos, sin, kv_cache=(cache[nk][j],
                                                        cache[nv][j]),
                                 pos=pos, decode_combine=decode_combine)
            pos.add_(1)             # in place: a captured graph reads it
            new_cache = cache
        else:
            raise ValueError(f"unknown mode {mode!r}")
        x = rmsnorm(x, self.final_norm, eps=cfg.norm_eps)
        logits = x @ (self.embed.T if self.head is None else self.head)
        return softcap(logits, cfg.final_softcap), new_cache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shape of every leaf of the serving tree, by its flat name."""
    head = {} if cfg.tie_embeddings else {
        "head": (cfg.d_model, cfg.padded_vocab)}
    return {"embed": (cfg.padded_vocab, cfg.d_model),
            "final_norm": (cfg.d_model,), **head,
            **{f"layers.{i}.{n}": shp
               for i, spec in enumerate(cfg.layer_plan())
               for n, shp in _spec_shapes(cfg, spec).items()}}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str, *, part=None
                ) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX ``init_params`` distributions (other
    bits): dense N(0, 1/d_in), embedding N(0, 0.02^2), norm scales 0, the
    Mamba2 leaves as ``ssm.mamba_init`` draws them, the MoE leaves as
    ``moe.moe_init`` does, the untied head as the embedding (transposed),
    the sandwich post-norms' scales 0.
    Each tensor is drawn
    in fp32 on ``device`` and stored in ``cfg.dtype``, the dtype the model
    holds it in (the JAX engine casts its fp32 parameters to ``cfg.dtype``
    the same way). ``part(name, leaf)`` (a model rank's
    ``TensorParallel.part``) keeps the rank's part of each leaf as it is
    drawn, so no more than one layer is ever held whole."""
    keep = part or (lambda name, t: t)
    dtype = cfg.dtype
    d, D, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv_heads
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)
    dense = lambda a, b: dense_init(generator, a, b, dtype, device)
    params = {"embed": keep("embed", embed_init(
        generator, cfg.padded_vocab, d, dtype, device)),
              "final_norm": zeros()}
    if not cfg.tie_embeddings:
        params["head"] = keep("head", embed_init(
            generator, cfg.padded_vocab, d, dtype, device).T.contiguous())
    for i, spec in enumerate(cfg.layer_plan()):
        if spec.mixer == "mamba2":
            layer = {"ln": zeros(), **mamba_init(generator, cfg, device)}
        else:
            layer = {"ln1": zeros(), "wq": dense(d, H * D),
                     "wk": dense(d, KV * D), "wv": dense(d, KV * D),
                     "wo": dense(H * D, d), "ln2": zeros()}
            if cfg.qk_norm:
                layer |= {n: torch.zeros((D,), dtype=dtype, device=device)
                          for n in QK_NORM_PARAMS}
            if spec.mlp == "moe":
                layer |= moe_init(generator, cfg, dtype, device)
            else:
                layer |= {"gate": dense(d, f), "up": dense(d, f),
                          "down": dense(f, d)}
            if cfg.sandwich_norm:
                layer |= {n: zeros() for n in SANDWICH_PARAMS}
        params.update({f"layers.{i}.{n}": keep(f"layers.{i}.{n}", t)
                       for n, t in layer.items()})
    return params


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The JAX ``transformer.init_params`` tree, with numpy leaves, as the
    port's flat parameter dict (CPU tensors, straight copies: both packages
    keep weights as (d_in, d_out)). Layer ``i*pi + j`` is
    ``blocks["slot{j}"][i]``, layer ``reps*pi + r`` is ``rest[r]``."""
    check_supported(cfg)
    pi, reps, rem = find_period(cfg.layer_plan())
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    params = {"embed": t(tree["embed"]),
              "final_norm": t(tree["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        params["head"] = t(tree["head"])

    def put(i, lp, idx=None):
        take = (lambda a: a[idx]) if idx is not None else (lambda a: a)
        params.update({f"layers.{i}.{n}": t(take(a))
                       for n, a in layer_leaves(lp, cfg).items()})

    for i in range(reps):
        for j in range(pi):
            put(i * pi + j, tree["blocks"][f"slot{j}"], i)
    for r in range(rem):
        put(reps * pi + r, tree["rest"][r])
    return params


# ---------------------------------------------------------------------------
# training: the JAX package's stacked parameter tree, forward with mode="train"
# ---------------------------------------------------------------------------
#: where each of ``LAYER_PARAMS`` sits in a layer of the JAX tree
TRAIN_LEAF_PATHS = {"ln1": ("ln1", "scale"), "wq": ("attn", "wq"),
                    "wk": ("attn", "wk"), "wv": ("attn", "wv"),
                    "wo": ("attn", "wo"), "ln2": ("ln2", "scale"),
                    "gate": ("mlp", "gate"), "up": ("mlp", "up"),
                    "down": ("mlp", "down")}
#: where each of ``MAMBA_LAYER_PARAMS`` sits in a Mamba2 layer of the JAX
#: tree (``src/repro/models/transformer.py`` ``_layer_init``)
MAMBA_TRAIN_LEAF_PATHS = {
    "ln": ("ln", "scale"), **{n: ("mamba", n) for n in MAMBA_PARAMS},
    "norm": ("mamba", "norm", "scale")}


def spec_leaf_paths(cfg: ModelConfig, spec, tier: bool = False
                    ) -> dict[str, tuple[str, ...]]:
    """A layer's leaf name -> its path in the JAX tree's layer of the plan
    entry ``spec``, in the order :func:`spec_params` gives; a Mamba2 layer
    of a model tier's tree (``tier``) adds ``models/tp.MAMBA_TIER_LEAVES``
    (:func:`train_layout`)."""
    if spec.mixer == "mamba2":
        extra = {n: ("mamba", n) for n in MAMBA_TIER_LEAVES} if tier else {}
        return {n: MAMBA_TRAIN_LEAF_PATHS[n]
                for n in MAMBA_LAYER_PARAMS} | extra
    qk = ({n: ("attn", n, "scale") for n in QK_NORM_PARAMS}
          if cfg.qk_norm else {})
    if spec.mlp == "moe":
        return ({n: TRAIN_LEAF_PATHS[n] for n in ATTN_PARAMS} | qk
                | {n: MOE_LEAF_PATHS[n] for n in moe_shapes(cfg)})
    if cfg.sandwich_norm:
        return (TRAIN_LEAF_PATHS | qk
                | {n: (n, "scale") for n in SANDWICH_PARAMS})
    return TRAIN_LEAF_PATHS | qk


def spec_params(cfg: ModelConfig, spec) -> tuple[str, ...]:
    """The leaf names of one layer of the plan entry ``spec``."""
    return tuple(spec_leaf_paths(cfg, spec))


def train_leaf_paths(cfg: ModelConfig, m: int = 1, spec=None
                     ) -> dict[str, tuple[str, ...]]:
    """A layer's leaf name -> its path in a layer of the JAX tree, for the
    plan entry ``spec`` (None: every layer of ``cfg``, which must hold one
    set of leaves), in the order :func:`layer_params` gives (on a model
    tier of m, of its tree)."""
    if spec is None:
        kinds = {tuple(spec_leaf_paths(cfg, s, m > 1))
                 for s in cfg.layer_plan()}
        if len(kinds) > 1:
            raise ValueError(f"{cfg.name}: its layers hold different leaves; "
                             "name the plan entry")
        spec = cfg.layer_plan()[0]
    return spec_leaf_paths(cfg, spec, m > 1)


def layer_params(cfg: ModelConfig, m: int = 1, spec=None) -> tuple[str, ...]:
    """The leaf names of a layer of the plan entry ``spec`` of ``cfg``'s
    training tree (None: of every layer, :func:`train_leaf_paths`):
    ``LAYER_PARAMS`` (dense; with ``SANDWICH_PARAMS`` where the config has
    sandwich norms), the attention and MoE leaves (moe) or
    ``MAMBA_LAYER_PARAMS`` (ssm; with ``MAMBA_TIER_LEAVES`` on a model tier
    of m > 1)."""
    return tuple(train_leaf_paths(cfg, m, spec))


def train_slots(cfg: ModelConfig) -> list[tuple[tuple, LayerSpec]]:
    """Where each layer sits in the training tree, in plan order, with its
    plan entry: layer ``rep * pi + j`` of the stacked periods is
    ``("blocks", "slot{j}", rep)``, layer ``reps * pi + r`` of the
    remainder ``("rest", r)`` (the JAX ``init_params`` structure, pi the
    plan's period: gemma2's window, full pair stacks two slots)."""
    plan = cfg.layer_plan()
    pi, reps, rem = find_period(plan)
    return ([(("blocks", f"slot{j}", i), plan[i * pi + j])
             for i in range(reps) for j in range(pi)]
            + [(("rest", r), plan[reps * pi + r]) for r in range(rem)])


def _spec_shapes(cfg: ModelConfig, spec) -> dict[str, tuple[int, ...]]:
    """The leaf shapes of one layer of the plan entry ``spec``."""
    d, f = cfg.d_model, cfg.d_ff
    if spec.mixer == "mamba2":
        return {"ln": (d,), **mamba_shapes(cfg)}
    hq, hkv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    attn = {"ln1": (d,), "wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv),
            "wo": (hq, d), "ln2": (d,)}
    if cfg.qk_norm:
        attn |= {n: (cfg.head_dim_,) for n in QK_NORM_PARAMS}
    if spec.mlp == "moe":
        return attn | moe_shapes(cfg)
    post = {n: (d,) for n in SANDWICH_PARAMS} if cfg.sandwich_norm else {}
    return attn | {"gate": (d, f), "up": (d, f), "down": (f, d)} | post


def _head(cfg: ModelConfig, head) -> dict:
    """The untied head's entry of a training tree ({} when tied)."""
    return {} if cfg.tie_embeddings else {"head": head}


def stack_tree(layers: dict[str, Any], cfg: ModelConfig, spec) -> dict:
    """Leaf name -> leaf, as the JAX tree of a layer (or a stacked slot) of
    the plan entry ``spec``."""
    tree: dict = {}
    for name, path in train_leaf_paths(cfg, spec=spec).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = layers[name]
    return tree


def layer_leaves(slot: dict, cfg: ModelConfig) -> dict[str, Any]:
    """The inverse of :func:`stack_tree`, for a layer of any kind (a MoE
    layer holds ``moe``, a Mamba2 one ``mamba``, a sandwich-normed one
    ``post_ln1`` and ``post_ln2``)."""
    kind = LayerSpec(mixer="mamba2" if "mamba" in slot else "attn",
                     mlp="moe" if "moe" in slot else "dense")
    tier = "mamba" in slot and MAMBA_TIER_LEAVES[0] in slot["mamba"]
    out = {}
    for name, path in spec_leaf_paths(cfg, kind, tier).items():
        node = slot
        for k in path:
            node = node[k]
        out[name] = node
    return out


def _tree_of_layers(cfg: ModelConfig, layer) -> dict:
    """``{"blocks": {slot{j}: stacked}, "rest": [...]}`` from ``layer(spec,
    reps)``: a slot's leaf dict stacked over ``reps`` (None: one unstacked
    layer of the remainder), keyed by leaf name."""
    plan = cfg.layer_plan()
    pi, reps, rem = find_period(plan)
    return {"blocks": {f"slot{j}": stack_tree(layer(plan[j], reps), cfg,
                                              plan[j]) for j in range(pi)},
            "rest": [stack_tree(layer(plan[reps * pi + r], None), cfg,
                                plan[reps * pi + r]) for r in range(rem)]}


def train_param_shapes(cfg: ModelConfig, m: int = 1) -> dict:
    """:func:`init_train_params`'s tree with empty tensors on the ``meta``
    device: the shapes, nothing allocated; on a model tier of m, of
    :func:`train_layout`'s tree."""
    check_supported(cfg, "train")
    d = cfg.d_model
    meta = lambda *shape: torch.empty(shape, device="meta")
    layers = _tree_of_layers(cfg, lambda spec, reps: {
        n: meta(*(() if reps is None else (reps,)), *shp)
        for n, shp in _spec_shapes(cfg, spec).items()})
    return train_layout({"embed": meta(cfg.padded_vocab, d),
                         "final_norm": {"scale": meta(d)},
                         **_head(cfg, meta(d, cfg.padded_vocab)),
                         **layers}, cfg, m)


def train_layout(tree: dict, cfg: ModelConfig, m: int = 1) -> dict:
    """The training tree a step on a model tier of m holds, from the JAX
    tree: the same for the dense and moe families; for the ssm family
    ``models/tp.ssm_tier_tree`` (``in_proj`` and ``conv_w`` each split
    into the rank-major columns of the heads and the B and C columns
    every rank holds whole). ``tp.ssm_jax_tree`` maps it back."""
    if m > 1 and cfg.family == "ssm":
        return ssm_tier_tree(tree, cfg, m)
    return tree


def init_train_params(cfg: ModelConfig, generator: torch.Generator,
                      device: torch.device | str) -> dict:
    """fp32 master weights in the JAX package's tree: ``embed`` (Vpad, d),
    ``final_norm/scale``, ``head`` (d, Vpad) where untied, ``blocks/slot{j}``
    (``{ln1, attn, ln2, mlp}`` and, with sandwich norms, ``post_ln1`` and
    ``post_ln2``; ``{ln1, attn, ln2, moe}`` for the moe family, or ``{ln,
    mamba}`` for the ssm family) stacked over the plan's periods, and
    ``rest`` the remainder's layers unstacked (:func:`train_slots`). The
    values are :func:`init_params`'s for the same generator (layer i's
    draws in plan order), in fp32; every leaf is contiguous."""
    check_supported(cfg, "train")
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    embed = embed_init(generator, cfg.padded_vocab, d, torch.float32, device)
    head = _head(cfg, None if cfg.tie_embeddings else embed_init(
        generator, cfg.padded_vocab, d, torch.float32, device).T.contiguous())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    tree = _tree_of_layers(cfg, lambda spec, reps: {
        n: torch.zeros((() if reps is None else (reps,)) + shp, **f32)
        for n, shp in _spec_shapes(cfg, spec).items()})
    for place, spec in train_slots(cfg):
        shapes = _spec_shapes(cfg, spec)
        if spec.mixer == "mamba2":
            drawn = mamba_init(generator, cfg32, device)
        else:
            drawn = {n: dense_init(generator, *shapes[n], torch.float32,
                                   device)
                     for n in ATTN_PARAMS if n not in ("ln1", "ln2")}
            if spec.mlp == "moe":
                drawn |= moe_init(generator, cfg, torch.float32, device)
            else:
                drawn |= {n: dense_init(generator, *shapes[n],
                                        torch.float32, device)
                          for n in ("gate", "up", "down")}
        node = tree[place[0]][place[1]]
        leaves = layer_leaves(node, cfg)
        for name, t in drawn.items():
            if len(place) == 3:
                leaves[name][place[2]] = t
            else:
                leaves[name].copy_(t)
    return {"embed": embed, "final_norm": {"scale": torch.zeros((d,), **f32)},
            **head, **tree}


def train_params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """The JAX ``init_params`` tree (numpy leaves) as the port's training
    tree: the same structure (``blocks/slot{j}``, ``rest``), torch tensors
    (contiguous copies)."""
    check_supported(cfg, "train")
    conv = lambda a: torch.from_numpy(np.array(a, dtype=np.float32,
                                                copy=True))
    layer = lambda lp, spec: stack_tree(
        {n: conv(a) for n, a in layer_leaves(lp, cfg).items()}, cfg, spec)
    plan = cfg.layer_plan()
    pi, reps, _ = find_period(plan)
    return {"embed": conv(tree["embed"]),
            "final_norm": {"scale": conv(tree["final_norm"]["scale"])},
            **_head(cfg, None if cfg.tie_embeddings else conv(tree["head"])),
            "blocks": {f"slot{j}": layer(tree["blocks"][f"slot{j}"], plan[j])
                       for j in range(pi)},
            "rest": [layer(lp, plan[reps * pi + r])
                     for r, lp in enumerate(tree["rest"])]}


def train_layers(params: dict, cfg: ModelConfig, leaf=None
                 ) -> list[dict[str, Any]]:
    """Each layer's leaves in plan order, from a training tree (or a tree
    of the same structure: specs, dims): a slot's rep ``i`` sliced from its
    stacked leaves, a ``rest`` layer's own; ``leaf(t, i)`` (i None for a
    ``rest`` leaf) takes each instead of the plain ``t[i]``."""
    leaf = leaf or (lambda t, i: t if i is None else t[i])
    out = []
    for place, _ in train_slots(cfg):
        if place[0] == "blocks":
            node, i = params["blocks"][place[1]], place[2]
        else:
            node, i = params["rest"][place[1]], None
        out.append({n: leaf(t, i) for n, t in layer_leaves(node,
                                                            cfg).items()})
    return out


def _window(cfg: ModelConfig, spec) -> int:
    """The attention window of a layer of the plan entry ``spec`` (0: full
    attention)."""
    return cfg.window if spec.attn == "window" else 0


def block_train(x, w, cos, sin, cfg: ModelConfig, spec, tp=None,
                seq: bool = False, dispatch=None, shares=None):
    """:class:`Block`'s math for a layer of the plan entry ``spec``, with
    the differentiable kernels: flash attention (the layer's window, the
    config's softcap) and the RMSNorm forms whose backward passes are
    kernels (the sandwich's post-norms too); the gated MLP, or for a MoE
    layer the experts (``dispatch``, ``shares``: :func:`out_moe`'s),
    returning (x, the layer's aux loss). With ``tp``
    (``models/tp.TensorParallel``) it runs on one model rank: ``x`` is the
    residual stream, (B, S/m, d) with ``seq``, ``w`` the rank's columns
    of the column-parallel leaves and rows of the row-parallel ones (a MoE
    layer's experts, ``models/tp.moe_tp``); the normed inputs enter the
    tier (``tp.enter``), the row-parallel partial sums leave it
    (``tp.leave``) before the post-norms, and the attention runs over the
    rank's heads."""
    enter = reduce = kv_weight = _same
    if tp is not None:
        enter = lambda h: tp.enter(h, seq)
        reduce = lambda y: tp.leave(y, seq)
        kv_weight = tp.kv_weight
    q, k, v = attn_qkv(x, w, cos, sin, cfg, norm=rmsnorm_train, enter=enter,
                       kv_weight=kv_weight)
    o = flash_attention_train(q, k, v, causal=True, window=_window(cfg, spec),
                              cap=cfg.attn_softcap)
    if spec.mlp == "moe":
        return out_moe(x, o, w, cfg, norm_residual=rmsnorm_residual_train,
                       dispatch=dispatch, reduce=reduce, tp=tp, seq=seq,
                       shares=shares)
    return out_mlp(x, o, w, cfg, norm_residual=rmsnorm_residual_train,
                   norm=rmsnorm_train, reduce=reduce, enter=enter)


def mamba_block_train(x, w, cfg: ModelConfig):
    """:class:`MambaBlock`'s math, ``x + mamba(rmsnorm(x, ln))``, with the
    differentiable kernels (the mixer's training branch: the SSD scan and
    the gated RMSNorm whose backward passes are kernels)."""
    h = rmsnorm_train(x, w["ln"], eps=cfg.norm_eps)
    y, _ = mamba_apply({n: w[n] for n in MAMBA_PARAMS}, h, cfg)
    return x + y


def forward_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  remat: bool = True, gather=None, prefetch=None, tp=None,
                  moe_dispatch=None, moe_shares=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``forward(mode="train")`` of the dense (and its variants),
    moe and ssm families: tokens (B, S) -> (logits (B, S, Vpad) in
    ``cfg.dtype``, softcapped where the config caps them, the MoE layers'
    summed auxiliary loss, fp32, 0 without them).

    ``params`` is {embed, final_norm, head (where untied), layers: [one
    dict of a layer's leaves a layer, in plan order]}: the leaves of the
    training tree, each layer's a slice of a slot's stacked leaves or a
    ``rest`` layer's (or a shard of it; :func:`train_layers`). Layer i runs
    the block of its plan entry: its window, the config's softcaps,
    sandwich norms and MLP activation; the embedding is scaled by
    :func:`layers.embed_scale` where ``cfg.scale_embed``.
    ``moe_dispatch`` (``moe.MoeDispatch``) runs the MoE layers expert-
    parallel: their routed experts are this rank's E/p; ``moe_shares``
    makes their aux losses terms of the global batch's
    (``moe.moe_route``'s ``shares``). ``gather(name,
    leaf, layer)`` turns a leaf (``embed``, ``final_norm``, ``head`` with
    ``layer`` None, or layer ``layer``'s leaf of that name) into the full
    weight in ``cfg.dtype`` where it is used (default: the cast; FSDP: the
    cast, then the parameter gather of that leaf's geometry). With
    ``remat`` each block runs under ``torch.utils.checkpoint`` with its
    gathers inside, so the backward gathers again. ``prefetch``
    (train/step.BlockPrefetch) takes the blocks' gathers instead, in plan
    order: layer i + depth's is started before layer i runs and finished
    outside the checkpoint, so it is not repeated.

    ``tp`` (``models/tp.TensorParallel``) runs the dense decoder, the MoE
    decoder or the Mamba2 stack on one rank of a model tier: the gathered
    weights are the rank's part over "model" (its vocabulary rows of
    ``embed``, columns of an untied ``head``; its routed experts; a Mamba2
    layer's leaves of :func:`train_layout`'s tree), the blocks are
    :func:`block_train` with ``tp`` or
    ``tp.mamba_train_tp``, the embedding is scaled after the tier's sum
    and the logits are the rank's (B, S, Vpad/m) columns, softcapped
    elementwise."""
    from torch.utils.checkpoint import checkpoint
    check_supported(cfg, "train")
    gather = gather or (lambda name, t, layer=None: t.to(cfg.dtype))
    B, S = tokens.shape
    embed = gather("embed", params["embed"], None)
    seq = tp is not None and tp.seq_split(S)
    if tp is not None:
        x = tp.embed(tokens, embed, seq)
    else:
        x = torch.nn.functional.embedding(tokens, embed)
    if cfg.scale_embed:
        x = x * embed_scale(cfg.d_model, cfg.dtype)
    if cfg.family != "ssm":
        cos, sin = rope_angles(torch.arange(S, device=tokens.device)[None],
                               cfg.head_dim_, cfg.rope_theta)

    def block(spec, x, w):
        if spec.mixer == "mamba2":
            return (mamba_block_train(x, w, cfg) if tp is None
                    else mamba_train_tp(x, w, cfg, tp, seq))
        return block_train(x, w, cos, sin, cfg, spec, tp, seq, moe_dispatch,
                           moe_shares)

    def gathered(i, spec, names, x, *leaves):
        return block(spec, x, {n: gather(n, t, i)
                               for n, t in zip(names, leaves)})

    def full(i, spec, names, x, *weights):
        return block(spec, x, dict(zip(names, weights)))

    def run(fn, i, x, w: dict):
        names = tuple(w)
        args = (i, plan[i], names, x, *w.values())
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    plan = cfg.layer_plan()
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def step(x, out):
        nonlocal aux
        if isinstance(out, tuple):        # a MoE layer: (x, its aux loss)
            out, a = out
            aux = aux + a
        return out

    if prefetch is None:
        for i, lp in enumerate(layers):
            x = step(x, run(gathered, i, x, lp))
    else:
        depth = max(1, int(prefetch.depth))
        fifo = [prefetch.start(i, layers[i])
                for i in range(min(depth, len(layers)))]
        for i in range(len(layers)):
            if i + depth < len(layers):
                fifo.append(prefetch.start(i + depth, layers[i + depth]))
            x = step(x, run(full, i, x, prefetch.finish(fifo.pop(0))))
    x = rmsnorm_train(x, gather("final_norm", params["final_norm"], None),
                      eps=cfg.norm_eps)
    if tp is not None:
        x = tp.enter(x, seq)
    head = embed.T if cfg.tie_embeddings else gather("head", params["head"],
                                                     None)
    return softcap(x @ head, cfg.final_softcap), aux
