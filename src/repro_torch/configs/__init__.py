"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only the architectures the port serves are listed. The JAX package's other
architectures raise ``NotImplementedError`` naming the slice they wait for.
"""
from __future__ import annotations

import importlib

from .base import (LayerSpec, ModelConfig, check_supported, llama4_features,
                   reduced, variant_features)

ARCHS = ("llama3.2-3b", "mamba2-780m", "qwen2-moe-a2.7b", "yi-6b",
         "h2o-danube-3-4b", "gemma2-9b", "llama4-scout-17b-a16e")

# the JAX package's other architectures -> the port slice that brings them
PENDING = {
    "zamba2-1.2b": "the hybrid slice (the shared attention block and the "
                   "SSD's h0 input: ROADMAP.md Queue 1 item 7)",
    "whisper-tiny": "the encoder-decoder slice (ROADMAP.md Queue 1 item 7)",
    "internvl2-26b": "the VLM slice (ROADMAP.md Queue 1 item 7)",
}

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def _module(name: str):
    if name in PENDING:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it waits for {PENDING[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "LayerSpec", "ModelConfig", "PENDING", "check_supported",
           "get", "get_smoke", "llama4_features", "reduced",
           "variant_features"]
