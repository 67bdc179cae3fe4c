"""Deterministic synthetic LM data pipeline: a copy of
``src/repro/data/pipeline.py`` (numpy only), so that the port's batches are
bitwise the JAX package's without importing it.

Sequences follow a noisy affine recurrence (tokens[t+1] ≈ (a·tokens[t] + c)
mod V with ε-noise), so a model can actually reduce loss — the end-to-end
examples demonstrate real learning, not noise-fitting. Batches are a pure
function of (seed, step): restarts resume mid-stream with no state to
checkpoint beyond the step counter, and every host can independently
materialize exactly its shard (host_shard) — no data service needed at
1000-node scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05       # fraction of positions replaced by uniform noise

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch for ``step`` (tokens, labels), both (B, S)."""
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        rng = np.random.Generator(np.random.Philox(key=self.seed + (step << 20)))
        a = 31337 % V or 7
        # c fixed per stream (seed), so tokens[t+1] is a fixed learnable
        # function of tokens[t]; per-sequence x0 + noise provide variety.
        c = np.random.Generator(np.random.Philox(key=self.seed)).integers(
            1, V, dtype=np.int64)
        c = np.full((B, 1), c, dtype=np.int64)
        x0 = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        seqs = np.empty((B, S + 1), dtype=np.int64)
        seqs[:, 0] = x0[:, 0]
        for i in range(1, S + 1):
            seqs[:, i] = (a * seqs[:, i - 1] + c[:, 0]) % V
        noise_mask = rng.random((B, S + 1)) < self.noise
        noise_vals = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        seqs = np.where(noise_mask, noise_vals, seqs)
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def host_shard(batch: dict[str, np.ndarray], host_id: int,
               n_hosts: int) -> dict[str, np.ndarray]:
    """The rows of the global batch owned by ``host_id`` (contiguous split)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n_hosts
        out[k] = v[host_id * per:(host_id + 1) * per]
    return out
