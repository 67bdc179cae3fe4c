"""AdamW with global-norm clipping, ported from ``src/repro/optim/adamw.py``.

The state is a :class:`TrainState` whose ``params``, ``mu`` and ``nu`` are
dict trees of torch tensors shaped like the JAX package's parameter tree
(fp32 ``mu``/``nu``); a rank of an FSDP grid holds its shards of each
leaf. :meth:`AdamW.apply` updates the state in place, leaf by leaf and in
slices of at most ``CHUNK`` elements, so that its temporaries stay a slice
wide (the largest leaf of llama3.2-3b, a stacked MLP projection, is 2.8 GB
in fp32); each element goes through the JAX package's arithmetic, op for
op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

CHUNK = 1 << 24          # elements a slice of one in-place update


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a dict/list tree in JAX's flattening order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves(tree)))


@dataclasses.dataclass
class TrainState:
    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor

    @staticmethod
    def create(params) -> "TrainState":
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return TrainState(params=params, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params),
                          step=torch.zeros((), dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def _lr(self, step) -> torch.Tensor:
        return (self.lr(step) if callable(self.lr)
                else torch.tensor(self.lr, dtype=torch.float32))

    def apply(self, state: TrainState, grads, *,
              grad_norm: torch.Tensor | None = None
              ) -> tuple[TrainState, dict]:
        """One step, in place; returns the state and {grad_norm, lr}.
        ``grad_norm`` is the norm of the whole gradient where the caller
        holds only shards of it (FSDP); by default :func:`global_norm`."""
        step = state.step + 1
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        scale = (torch.minimum(f32(1.0), self.clip_norm / (gnorm + 1e-12))
                 if self.clip_norm else f32(1.0))
        lr = self._lr(step)
        b1, b2 = f32(self.b1), f32(self.b2)
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)
        consts = [t.cpu() for t in (scale, lr, c1, c2)]
        for p, g, mu, nu in zip(*(leaves(t) for t in (state.params, grads,
                                                       state.mu, state.nu))):
            self._update(p, g, mu, nu, *consts)
        state.step = step
        return state, {"grad_norm": gnorm, "lr": lr}

    def _update(self, p, g, mu, nu, scale, lr, c1, c2) -> None:
        decay = bool(self.weight_decay) and p.ndim >= 2   # matrices only
        flat = [t.reshape(-1) for t in (p, g, mu, nu)]
        dev = lambda t: t.to(p.device)
        scale, lr, c1, c2 = map(dev, (scale, lr, c1, c2))
        for lo in range(0, flat[0].numel(), CHUNK):
            pp, gg, m, v = (t[lo:lo + CHUNK] for t in flat)
            gs = gg.float() * scale
            m_new = self.b1 * m + (1 - self.b1) * gs
            v_new = self.b2 * v + (1 - self.b2) * gs * gs
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            if decay:
                delta = delta + self.weight_decay * pp.float()
            pp.copy_((pp.float() - lr * delta).to(pp.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
