"""The training loop of the port, ported from ``src/repro/train/trainer.py``:
data, step, metrics history.

``Trainer(cfg, grid, tcfg).run()`` draws each step's global batch from
``SyntheticLM`` (a pure function of seed and step), keeps this rank's rows
(``host_shard`` by grid rank), runs the step of ``make_train_step`` and
appends the step's metrics (loss, grad_norm, lr, step, wall seconds) to
``metrics_history``. The JAX trainer's operations layers are not here yet:
no checkpoints, fault injection and recovery, straggler monitor or
telemetry spans. They come with ROADMAP.md Queue 1 item 8, and a
``TrainerConfig`` that asks for them is refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..data import SyntheticLM, host_shard
from ..optim import AdamW
from .step import StepArtifacts, init_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    log_every: int = 10
    grad_sync: str = "locality"
    fsdp: bool = False
    seq_shard: bool = False
    prefetch_depth: int | str = 0     # FSDP gather lookahead
    moe_dispatch: str = "none"
    grad_accum: int = 1
    lr: float = 3e-4
    seed: int = 0
    # the operations layers (ROADMAP.md Queue 1 item 8): refused when set
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    comm_telemetry: bool = False


class Trainer:
    def __init__(self, model_cfg, grid, tcfg: TrainerConfig, *,
                 data: SyntheticLM | None = None,
                 device: torch.device | str | None = None,
                 params: dict | None = None,
                 log: Callable[[str], None] = print):
        """``grid``: this rank's ``RankGrid`` (None: one process).
        ``params``: the full fp32 parameter tree to start from (default:
        ``init_train_params`` from ``tcfg.seed`` on ``device``)."""
        if tcfg.ckpt_dir or tcfg.ckpt_every or tcfg.comm_telemetry:
            raise NotImplementedError(
                "checkpoints and telemetry come with the operations layers "
                "(ROADMAP.md Queue 1 item 8)")
        self.model_cfg, self.grid, self.tcfg = model_cfg, grid, tcfg
        self.data = data or SyntheticLM(
            vocab_size=model_cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.log = log
        self.artifacts: StepArtifacts = make_train_step(
            model_cfg, grid, optimizer=AdamW(lr=tcfg.lr),
            grad_sync=tcfg.grad_sync, fsdp=tcfg.fsdp,
            grad_accum=tcfg.grad_accum, prefetch_depth=tcfg.prefetch_depth,
            seq_shard=tcfg.seq_shard, moe_dispatch=tcfg.moe_dispatch,
            global_batch=tcfg.global_batch, device=device)
        self.state = init_state(model_cfg, self.artifacts, params=params,
                                seed=tcfg.seed)
        self.step = 0
        self.metrics_history: list[dict] = []
        self.status = "initialized"

    def _batch(self, step: int) -> dict:
        batch = self.data.batch(step)
        if self.grid is None:
            return batch
        return host_shard(batch, self.grid.rank, self.grid.p)

    def run(self) -> dict[str, Any]:
        t = self.tcfg
        self.status = "running"
        device = self.artifacts.device
        while self.step < t.steps:
            batch = self._batch(self.step)
            t0 = time.perf_counter()
            self.state, metrics = self.artifacts.step_fn(self.state, batch)
            m = {k: float(v) for k, v in metrics.items()}   # synchronises
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.step += 1
            m["step"], m["dt"] = self.step, dt
            m["grad_algorithm"] = self.artifacts.grad_algorithm
            self.metrics_history.append(m)
            if self.step % t.log_every == 0 or self.step == t.steps:
                self.log(f"[trainer] step {self.step:5d} "
                         f"loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                         f"({dt * 1e3:.0f} ms)")
        self.status = "complete"
        return {"final_loss": (self.metrics_history[-1]["loss"]
                               if self.metrics_history else None),
                "steps": self.step, "status": self.status}
