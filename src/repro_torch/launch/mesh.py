"""Production rank grids, ported from ``src/repro/launch/mesh.py``.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (pods, 16, 16) ranks, axes ("pod", "data", "model"): the "pod"
axis crosses the region boundary (the paper's non-local tier); "data" and
"model" stay inside a pod. ``pods`` defaults to 2 and need not be a power of
two (Algorithm 2's allgatherv adaptation runs on any region count).

Where the JAX package makes a ``jax.sharding.Mesh``, these make the port's
``core/topology.RankGrid`` over the default ``torch.distributed`` group:
every rank calls the function with the same arguments (it creates process
groups), and a rank outside the grid gets None. The axes are a row-major
subset of ("pod", "data", "model"), the order of the grid's ranks;
:func:`grid_shape` reads (q, pl, m) from a shape and axis names without
making anything.
"""
from __future__ import annotations

from ..core.topology import RankGrid

AXES = ("pod", "data", "model")


def grid_shape(shape: tuple[int, ...], axes: tuple[str, ...]
               ) -> tuple[int, int, int]:
    """(q, pl, m) of a mesh shape over ``axes`` (an axis left out has size
    1). The axes must keep the order of ("pod", "data", "model")."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not match axes {axes}")
    if any(a not in AXES for a in axes) or \
            [AXES.index(a) for a in axes] != sorted(AXES.index(a)
                                                    for a in set(axes)):
        raise ValueError(f"axes {axes}: the port's grids are a row-major "
                         f"subset of {AXES}, each axis once")
    size = dict(zip(axes, shape))
    return size.get("pod", 1), size.get("data", 1), size.get("model", 1)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]
              ) -> RankGrid | None:
    """The ``RankGrid`` of a mesh shape over ``axes``."""
    return RankGrid.build(*grid_shape(shape, axes))


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2
                         ) -> RankGrid | None:
    shape = (pods, 16, 16) if multi_pod else (16, 16)
    axes = AXES if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_dp_mesh(pods: int, data: int) -> RankGrid | None:
    """A pure-DP ("pod", "data") grid (no model tier); a single pod is the
    ("data",) grid."""
    if pods > 1:
        return make_mesh((pods, data), ("pod", "data"))
    return make_mesh((data,), ("data",))
