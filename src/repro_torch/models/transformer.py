"""Decoder-only stack of the port: the dense llama family and Mamba2.

Mirrors ``repro.models.transformer.forward`` for two families:

* ``mode="prefill"``: tokens (B,S) -> last-position logits (B,1,Vpad) and a
  decode cache, with ``cache["pos"] = S``;
* ``mode="decode"``: tokens (B,1) against that cache -> logits (B,1,Vpad);
  the cache is updated in place, ``pos`` too (it advances by one), and the
  same dict comes back (the JAX package returns a new cache with a new
  ``pos`` array), so a CUDA graph captured over one step replays the next
  on the same tensors. ``pos`` is a 0-d tensor (lockstep batch) or (B,)
  (continuous batching).

A sequence-parallel rank holds the cache slots [slot_offset, slot_offset +
cache_len) of a longer cache: its prefill runs the whole prompt and keeps
only those slots, and its decode passes each attention layer's cache write
and attention to a ``decode_combine`` hook, the JAX protocol
(``repro.models.attention.attention``): ``decode_combine(q, k_new, v_new,
k_cache, v_cache, pos, meta) -> (o, k_cache, v_cache)`` or None for the
plain path, with ``meta = {window, chunk, cap, ring}``.

The JAX package scans stacked ``blocks/slot{j}`` parameters; here the
layers are a ``ModuleList`` in global layer order, built from
``cfg.layer_plan()``: a :class:`Block` (attention then SwiGLU MLP) for an
``attn`` mixer, a :class:`MambaBlock` (``x + mamba(rmsnorm(x))``) for a
``mamba2`` one. The cache holds one stacked tensor per leaf: ``k`` and
``v`` (n_layers, B, L, KV, D) for the dense family, padded to
``cache_len`` slots; ``conv`` (n_layers, B, W-1, Ch) and ``h``
(n_layers, B, H, N, P) fp32 for the SSM family.

Parameters are a flat dict keyed like this module's ``state_dict``:
``embed`` (Vpad, d), ``final_norm`` (d,), and ``layers.{i}.{name}``, for
``ln1, wq, wk, wv, wo, ln2, gate, up, down`` (dense) or ``ln, in_proj,
conv_w, conv_b, dt_bias, A_log, D, norm, out_proj`` (Mamba2), in the JAX
``(d_in, d_out)`` layout. :func:`init_params` makes them from a
``torch.Generator``; :func:`params_from_jax` converts the JAX package's
``init_params`` tree (passed as numpy arrays).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig, check_supported
from . import attention as attn
from .layers import (apply_rope_angles, dense_init, embed_init, mlp_apply,
                     rmsnorm, rmsnorm_residual, rope_angles)
from .ssm import MAMBA_PARAMS, mamba_apply, mamba_cache_shapes, mamba_init

LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "gate", "up", "down")
# the decode_combine hook's meta for the layers this port builds: full
# causal attention (check_supported refuses window, chunk, softcap, ring)
DECODE_META = {"window": 0, "chunk": 0, "cap": 0.0, "ring": False}
MAMBA_LAYER_PARAMS = ("ln",) + MAMBA_PARAMS


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


class Block(nn.Module):
    """One pre-norm decoder layer: attention then SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, weights: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in LAYER_PARAMS:
            self.register_parameter(
                name, nn.Parameter(weights[name], requires_grad=False))

    def forward(self, x, cos, sin, *, kv_cache=None, pos=None,
                decode_combine=None):
        """Prefill (``kv_cache`` None): returns (x, (k, v)) with this
        layer's keys and values. Decode: writes the token's key and value
        into ``kv_cache = (k_cache, v_cache)`` in place at ``pos`` and
        returns (x, None); a ``decode_combine`` hook (module docstring)
        does the write and the attention when it takes the layer."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        h = rmsnorm(x, self.ln1, eps=cfg.norm_eps)
        q = apply_rope_angles((h @ self.wq).reshape(B, S, H, D), cos, sin)
        k = apply_rope_angles((h @ self.wk).reshape(B, S, KV, D), cos, sin)
        v = (h @ self.wv).reshape(B, S, KV, D)
        if kv_cache is None:
            o = attn.multihead_attention(q, k, v, causal=True)
            kv = (k, v)
        else:
            k_cache, v_cache = kv_cache
            res = None if decode_combine is None else decode_combine(
                q, k, v, k_cache, v_cache, pos, DECODE_META)
            if res is None:
                attn.write_cache(k_cache, k, pos)
                attn.write_cache(v_cache, v, pos)
                o = attn.decode_attention(q, k_cache, v_cache, pos)
            else:
                o = res[0]
            kv = None
        # x = x + o @ wo; h = rmsnorm(x, ln2): one pass on the card
        x, h = rmsnorm_residual(x, o.reshape(B, S, H * D) @ self.wo, self.ln2,
                                eps=cfg.norm_eps)
        return x + mlp_apply(h, self.gate, self.up, self.down), kv


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 layer: ``x + mamba(rmsnorm(x, ln))``."""

    def __init__(self, cfg: ModelConfig, weights: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
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
                            cache={} if cache is None else cache)
        if cache is None:
            return x + y, nc
        cache["conv"].copy_(nc["conv"])
        cache["h"].copy_(nc["h"])
        return x + y, None


class Transformer(nn.Module):
    """The decoder, parameters held in ``cfg.dtype`` on ``device``."""

    def __init__(self, cfg: ModelConfig, params: dict[str, Any],
                 device: torch.device | str):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg

        def load(name):
            t = torch.as_tensor(params[name])
            return t.to(device=device, dtype=cfg.dtype)

        def block(i, spec):
            kind, names = ((MambaBlock, MAMBA_LAYER_PARAMS)
                           if spec.mixer == "mamba2" else (Block, LAYER_PARAMS))
            return kind(cfg, {n: load(f"layers.{i}.{n}") for n in names})

        self.embed = nn.Parameter(load("embed"), requires_grad=False)
        self.final_norm = nn.Parameter(load("final_norm"), requires_grad=False)
        self.layers = nn.ModuleList(
            block(i, spec) for i, spec in enumerate(cfg.layer_plan()))
        self.ssm = cfg.family == "ssm"

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def cache_shapes(self, batch: int, cache_len: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every cache leaf but ``pos``, stacked over the
        layers (the SSM state has no slots: ``cache_len`` does not size
        it)."""
        cfg = self.cfg
        if self.ssm:
            return {name: ((cfg.n_layers,) + shape, dtype)
                    for name, (shape, dtype)
                    in mamba_cache_shapes(cfg, batch).items()}
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}

    def empty_cache(self, batch: int, cache_len: int, *,
                    vector_pos: bool = False) -> dict[str, torch.Tensor]:
        """A zeroed cache for ``batch`` rows of ``cache_len`` slots."""
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
        pos = zeros((batch,) if vector_pos else (), torch.long)
        return {name: zeros(shape, dtype) for name, (shape, dtype)
                in self.cache_shapes(batch, cache_len).items()} | {"pos": pos}

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, mode: str = "prefill",
                cache: dict[str, torch.Tensor] | None = None,
                cache_len: int = 0, *, slot_offset: int | None = None,
                decode_combine=None):
        """Returns ``(logits, new_cache)``; see the module docstring.
        ``slot_offset`` (prefill: the cache is the shard of ``cache_len``
        slots from there) and ``decode_combine`` (decode) serve a
        sequence-parallel rank's shard of the cache."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens]
        if mode == "prefill":
            if cache is not None:
                raise ValueError("prefill builds its cache; pass cache_len")
            L = cache_len or S
            if slot_offset is None:
                if S > L:
                    raise ValueError(f"prompt of {S} tokens exceeds the "
                                     f"{L}-slot cache")
                slot_offset = 0
            elif self.ssm:
                raise ValueError("SSM caches are never sequence-sharded")
            # the prompt's slots this cache holds: [lo, hi) of the prompt
            lo, hi = min(S, slot_offset), min(S, slot_offset + L)
            new_cache = self.empty_cache(B, L)
            if self.ssm:
                for i, layer in enumerate(self.layers):
                    x, nc = layer(x)
                    for name, t in nc.items():
                        new_cache[name][i] = t
            else:
                positions = torch.arange(S, device=tokens.device)[None]
                cos, sin = rope_angles(positions, cfg.head_dim_,
                                       cfg.rope_theta)
                for i, layer in enumerate(self.layers):
                    x, (k, v) = layer(x, cos, sin)
                    new_cache["k"][i, :, :hi - lo] = k[:, lo:hi]
                    new_cache["v"][i, :, :hi - lo] = v[:, lo:hi]
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
                    x, _ = layer(x, cos, sin, kv_cache=(cache["k"][i],
                                                        cache["v"][i]),
                                 pos=pos, decode_combine=decode_combine)
            pos.add_(1)             # in place: a captured graph reads it
            new_cache = cache
        else:
            raise ValueError(f"unknown mode {mode!r}")
        x = rmsnorm(x, self.final_norm, eps=cfg.norm_eps)
        return x @ self.embed.T, new_cache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX ``init_params`` distributions (other
    bits): dense N(0, 1/d_in), embedding N(0, 0.02^2), norm scales 0, the
    Mamba2 leaves as ``ssm.mamba_init`` draws them. Each tensor is drawn
    in fp32 on ``device`` and stored in ``cfg.dtype``, the dtype the model
    holds it in (the JAX engine casts its fp32 parameters to ``cfg.dtype``
    the same way)."""
    dtype = cfg.dtype
    d, D, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv_heads
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)
    dense = lambda a, b: dense_init(generator, a, b, dtype, device)
    params = {"embed": embed_init(generator, cfg.padded_vocab, d, dtype,
                                  device),
              "final_norm": zeros()}
    for i, spec in enumerate(cfg.layer_plan()):
        if spec.mixer == "mamba2":
            layer = {"ln": zeros(), **mamba_init(generator, cfg, device)}
        else:
            layer = {"ln1": zeros(), "wq": dense(d, H * D),
                     "wk": dense(d, KV * D), "wv": dense(d, KV * D),
                     "wo": dense(H * D, d), "ln2": zeros(),
                     "gate": dense(d, f), "up": dense(d, f),
                     "down": dense(f, d)}
        params.update({f"layers.{i}.{n}": t for n, t in layer.items()})
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

    def put(i, lp, idx=None):
        take = (lambda a: a[idx]) if idx is not None else (lambda a: a)
        if "mamba" in lp:
            m = lp["mamba"]
            leaves = {"ln": lp["ln"]["scale"], "norm": m["norm"]["scale"],
                      **{n: m[n] for n in MAMBA_PARAMS if n != "norm"}}
        else:
            leaves = {"ln1": lp["ln1"]["scale"], "wq": lp["attn"]["wq"],
                      "wk": lp["attn"]["wk"], "wv": lp["attn"]["wv"],
                      "wo": lp["attn"]["wo"], "ln2": lp["ln2"]["scale"],
                      "gate": lp["mlp"]["gate"], "up": lp["mlp"]["up"],
                      "down": lp["mlp"]["down"]}
        params.update({f"layers.{i}.{n}": t(take(a))
                       for n, a in leaves.items()})

    for i in range(reps):
        for j in range(pi):
            put(i * pi + j, tree["blocks"][f"slot{j}"], i)
    for r in range(rem):
        put(reps * pi + r, tree["rest"][r])
    return params
