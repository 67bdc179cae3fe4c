"""Serving engine of the port: the request-level ``submit / step / drain``
API over one rank.

``Engine(cfg, params, spec, device=None, clock=None)`` holds the model in
``cfg.dtype`` (bf16 for the published configs, as the JAX engine casts its
fp32 parameters) and a continuous-batching :class:`~.scheduler.Scheduler`.
It runs on the card: with ``device=None`` it takes ``cuda`` and raises when
no CUDA device is visible; ``device="cpu"`` runs the kernels' plain
versions, which is what the tests ask for.
"""
from __future__ import annotations

import torch

from ..models.transformer import Transformer
from .scheduler import Scheduler
from .spec import Request, RequestResult, ServeSpec


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless the caller names a device; never falls back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port serves on the "
                           "card (pass device='cpu' to run the plain "
                           "versions of its kernels on the CPU)")
    return torch.device("cuda")


class Engine:
    """Greedy continuous-batching engine over the port's transformer."""

    def __init__(self, cfg, params: dict, spec: ServeSpec, *,
                 device: torch.device | str | None = None, clock=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        spec.validate()
        self.spec = spec
        self.model = Transformer(cfg, params, self.device)
        self.scheduler = Scheduler(self, clock=clock)

    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its handle (the request id)."""
        return self.scheduler.submit(request)

    def step(self) -> list[RequestResult]:
        """Admit what fits, decode one step; the requests that finished."""
        return self.scheduler.step()

    def drain(self) -> dict[int, RequestResult]:
        """Run until every submitted request finished; results by handle."""
        return self.scheduler.drain()

    def cancel(self, rid: int) -> bool:
        return self.scheduler.cancel(rid)

    def result(self, rid: int) -> RequestResult | None:
        return self.scheduler.result(rid)

    def stats(self) -> dict:
        """Counters: decode steps, prefills, prefill tokens (prompt tokens
        prefilled) and decode tokens (tokens the decode steps produced for
        live rows), plus the queue's state."""
        return self.scheduler.stats()
