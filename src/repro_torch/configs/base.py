"""Model configuration schema of the port.

A ``ModelConfig`` determines an architecture: the layer plan (which mixer
and which MLP sit at every depth) and every dimension. Field names and
defaults are those of the JAX package's ``repro.configs.base`` so a
configuration reads the same in both; dtypes are torch dtypes.

The port builds only what it serves. Flags whose code paths have not been
ported are still carried here (so configurations stay complete) and are
rejected by :func:`check_supported` when a model is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the stack: a (mixer, mlp) pair.

    mixer: 'attn' | 'mamba2' | 'shared_attn'
    attn:  'full' | 'window' | 'chunked' | 'none'
    mlp:   'dense' | 'moe' | 'none'
    rope:  rotary applied to this layer's attention (False => NoPE)
    """

    mixer: str = "attn"
    attn: str = "full"
    mlp: str = "dense"
    rope: bool = True

    def key(self) -> tuple:
        return (self.mixer, self.attn, self.mlp, self.rope)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // n_heads

    # --- attention options ---------------------------------------------------
    rope_theta: float = 10_000.0
    window: int = 0
    chunk: int = 0
    attn_pattern: tuple[str, ...] = ("full",)
    nope_every: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    sandwich_norm: bool = False
    mlp_act: str = "silu"
    scale_embed: bool = False
    norm_type: str = "rms"

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    d_shared_expert: int = 0
    moe_every: int = 1
    router_norm_topk: bool = True
    router_act: str = "softmax"
    capacity_factor: float = 1.25

    # --- SSM (Mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid / enc-dec / vlm ---------------------------------------------------
    shared_attn_every: int = 0
    n_enc_layers: int = 0
    enc_seq: int = 0
    n_img_tokens: int = 0

    # --- embedding / misc --------------------------------------------------------
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 256
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    def layer_plan(self) -> tuple[LayerSpec, ...]:
        """The (mixer, mlp) pair at every depth, derived from the family."""
        if self.family == "ssm":
            return tuple(LayerSpec(mixer="mamba2", attn="none", mlp="none")
                         for _ in range(self.n_layers))
        plan: list[LayerSpec] = []
        if self.family == "hybrid":
            for i in range(self.n_layers):
                plan.append(LayerSpec(mixer="mamba2", attn="none", mlp="none"))
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    plan.append(LayerSpec(mixer="shared_attn", attn="full",
                                          mlp="dense"))
            return tuple(plan)
        for i in range(self.n_layers):
            if self.nope_every and (i + 1) % self.nope_every == 0:
                attn, rope = "full", False
            else:
                attn = self.attn_pattern[i % len(self.attn_pattern)]
                rope = True
            mlp = "moe" if (self.n_experts and i % self.moe_every == 0) else "dense"
            plan.append(LayerSpec(mixer="attn", attn=attn, mlp=mlp, rope=rope))
        return tuple(plan)


def variant_features(cfg: ModelConfig) -> list[str]:
    """The dense variants' features ``cfg`` uses: sliding-window layers
    (ring caches), softcaps, sandwich norms, ``scale_embed`` and GeGLU.
    The port serves and trains them on one rank and on grids, a model
    tier too (``models/tp.check_tp``)."""
    out = []
    if cfg.window or any(s.attn == "window" for s in cfg.layer_plan()):
        out.append("window layers (ring caches)")
    if cfg.attn_softcap or cfg.final_softcap:
        out.append("attn_softcap/final_softcap")
    if cfg.sandwich_norm:
        out.append("sandwich_norm")
    if cfg.scale_embed:
        out.append("scale_embed")
    if cfg.mlp_act == "gelu":
        out.append("mlp_act='gelu'")
    return out


def llama4_features(cfg: ModelConfig) -> list[str]:
    """llama4's features ``cfg`` uses: chunked-local layers (ring caches of
    ``chunk`` slots), NoPE layers (no rotary embedding) and qk-norm. The
    port serves them on one rank and on (pod, data) grids."""
    plan = [s for s in cfg.layer_plan() if s.mixer == "attn"]
    out = []
    if cfg.chunk or any(s.attn == "chunked" for s in plan):
        out.append("chunked layers (ring caches)")
    if any(not s.rope for s in plan):
        out.append("NoPE layers")
    if cfg.qk_norm:
        out.append("qk_norm")
    return out


def check_supported(cfg: ModelConfig, mode: str = "serve") -> None:
    """Raise on any flag whose code path this port does not have yet.

    Three families are served and trained (``mode="train"``): the dense
    llama-family decoder with full causal attention, SwiGLU, RMSNorm and
    rotary embeddings, with a tied or an untied output head; the MoE
    decoder (``family="moe"`` with ``n_experts``: that decoder with
    routed and shared SwiGLU experts in place of the MLP, ``moe_every``,
    a softmax or sigmoid router); and the attention-free Mamba2 stack
    (``family="ssm"`` with ``ssm_state``), whose training runs the SSD
    scan's and the gated RMSNorm's backward kernels. The dense variants'
    features (:func:`variant_features`: window layers with ring caches,
    softcaps, sandwich norms, ``scale_embed``, GeGLU) are served on one
    rank and on grids, a model tier included, and trained there too.
    llama4's features (:func:`llama4_features`: chunked-local layers with
    their ring caches, NoPE layers, qk-norm) are served on one rank and
    on (pod, data) grids; training them waits for ROADMAP.md Queue 1
    item 15. Everything else waits for a later slice of the port and must
    not be ignored silently.
    """
    if mode not in ("serve", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    unsupported = []
    if cfg.family not in ("dense", "moe", "ssm"):
        unsupported.append(f"family={cfg.family!r}")
    if cfg.family == "moe" and not (cfg.n_experts and cfg.top_k):
        unsupported.append("family='moe' without n_experts and top_k")
    if cfg.family != "moe" and cfg.n_experts:
        unsupported.append(f"n_experts in family={cfg.family!r}")
    if cfg.family == "ssm" and not cfg.ssm_state:
        unsupported.append("family='ssm' without ssm_state")
    if cfg.family != "ssm" and cfg.ssm_state:
        unsupported.append(f"ssm_state in family={cfg.family!r}")
    attn = [s for s in cfg.layer_plan() if s.mixer == "attn"]
    if any(s.attn not in ("full", "window", "chunked") for s in attn):
        unsupported.append("attention other than full, window or chunked")
    if any(s.attn == "chunked" for s in attn) and not cfg.chunk:
        unsupported.append("chunked layers without a chunk")
    if mode == "train" and llama4_features(cfg):
        unsupported.append(", ".join(llama4_features(cfg)) + " in training "
                           "(ROADMAP.md Queue 1 item 15, llama4 trained)")
    if cfg.mlp_act not in ("silu", "gelu"):
        unsupported.append(f"mlp_act={cfg.mlp_act!r}")
    if cfg.norm_type != "rms":
        unsupported.append(f"norm_type={cfg.norm_type!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not implement "
            f"{', '.join(unsupported)} yet (see ROADMAP.md)")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (the JAX package's
    ``reduced`` field for field)."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        window=min(cfg.window, 64) if cfg.window else 0,
        chunk=min(cfg.chunk, 64) if cfg.chunk else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        d_expert=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2),
        d_shared_expert=64 if cfg.n_shared_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=32 if cfg.enc_seq else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        vocab_pad_multiple=64,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
