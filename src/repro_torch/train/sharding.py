"""Parameter sharding rules of the port's FSDP, ported from
``src/repro/train/sharding.py`` (the ``_leaf_spec`` heuristic, ``param_specs``
and the FSDP gather geometry).

A spec is a tuple with one entry per dim of a leaf, as the JAX
``PartitionSpec``: None (not sharded), ``"data"`` (over the ranks of a pod;
the pods hold replicas) or ``("pod", "data")`` (over every rank, pod-major,
the grid-rank order of ``core/topology.RankGrid``). The FSDP dim shards over
``("pod", "data")`` when it divides by the whole grid, over ``"data"`` when
it divides only by a pod's ranks, and stays whole otherwise; norm scales
stay replicated. Stacked leaves (``blocks/...``) carry a leading None for the
layer dim.

The grid is given as its axes and sizes, ``{"pod": q, "data": pl}``
(:func:`grid_axes`); a third tier (``"model"``, tensor parallelism) is
refused: it is ROADMAP.md Queue 1 item 11.
"""
from __future__ import annotations

import math

DP_AXES = ("pod", "data")       # batch axes (outer = pod boundary)


def grid_axes(grid) -> dict[str, int]:
    """The axes of a ``RankGrid`` (anything with ``q`` and ``pl``)."""
    return {"pod": grid.q, "data": grid.pl}


def _check_axes(axes: dict[str, int]) -> None:
    other = [a for a, n in axes.items() if a not in DP_AXES]
    if other:
        raise NotImplementedError(
            f"grid axes {other}: the port shards parameters over ('pod', "
            "'data') only; the 'model' tier (tensor parallelism) is "
            "ROADMAP.md Queue 1 item 11")


def dp_axes(axes: dict[str, int]) -> tuple[str, ...]:
    """The DP axes present ('pod' only on a grid that names it)."""
    return tuple(a for a in DP_AXES if a in axes)


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _leaf_spec(name: str, shape: tuple[int, ...], axes: dict[str, int],
               fs_axes: tuple[str, ...]) -> tuple:
    """The JAX heuristic from the leaf's key name, its FSDP entries (the
    'model' entries it would add are refused with the tier)."""
    d = axes.get("data", 1)
    full = math.prod(axes.get(a, 1) for a in fs_axes) if fs_axes else 1

    def fdim(dim):
        # prefer the whole ('pod', 'data') span; a dim that divides only by
        # the 'data' size shards within the pod (the pods replicate it)
        if not fs_axes:
            return None
        if len(fs_axes) > 1 and _div(dim, full):
            return tuple(fs_axes)
        return "data" if ("data" in fs_axes and _div(dim, d)) else None

    if len(shape) == 0:
        return ()
    if name in ("scale", "bias", "A_log", "D", "dt_bias", "conv_b",
                "router", "conv_w"):
        return (None,) * len(shape)
    if name in ("embed", "head"):
        spec = [None, None]
        spec[1 if name == "embed" else 0] = fdim(shape[1 if name == "embed"
                                                       else 0])
        return tuple(spec)
    if name in ("wq", "wk", "wv", "in_proj"):          # (d, out)
        return (fdim(shape[0]), None)
    if name in ("wo", "out_proj"):                     # (in, d)
        return (None, fdim(shape[1]))
    if name in ("gate", "up"):
        if len(shape) == 3:                            # MoE experts (E, d, f)
            return (None, fdim(shape[1]), None)
        return (fdim(shape[0]), None)
    if name == "down":
        if len(shape) == 3:                            # (E, f, d)
            return (None, None, fdim(shape[2]))
        return (None, fdim(shape[1]))
    return (None,) * len(shape)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),))
    else:
        yield path, tree


def _rebuild(tree, values: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, path + (str(k),)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values, path + (str(i),))
                          for i, x in enumerate(tree))
    return values[path]


def param_specs(params, axes: dict[str, int], *, fsdp: bool = False) -> dict:
    """The spec tree of a parameter tree (leaves: anything with ``.shape``)
    on a grid of ``axes``; with ``fsdp`` the FSDP dims shard over every DP
    axis of the grid (the JAX ``fsdp_axes="auto"``)."""
    _check_axes(axes)
    fs_axes = dp_axes(axes) if fsdp else ()
    specs = {}
    for path, leaf in _walk(params):
        stacked = any(k == "blocks" or k.endswith("_layers") for k in path)
        shape = tuple(leaf.shape)
        spec = _leaf_spec(path[-1], shape[1:] if stacked else shape, axes,
                          fs_axes)
        specs[path] = (None,) + spec if stacked else spec
    return _rebuild(params, specs)


# ---------------------------------------------------------------------------
# FSDP gather geometry (shared by the eager gather and the prefetch pipeline)
# ---------------------------------------------------------------------------
def _names(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def fsdp_dim(spec: tuple) -> int:
    """Index of the DP-sharded dim of a leaf spec (-1 = replicated): the dim
    the parameter gather and its reduce-scatter transpose run over."""
    for i, s in enumerate(spec):
        if "data" in _names(s):
            return i
    return -1


def fsdp_leaf_axes(spec: tuple) -> str:
    """Comma-joined DP axes of the leaf's FSDP dim, outer-major ("pod,data"
    / "data" / "" = replicated)."""
    k = fsdp_dim(spec)
    if k < 0:
        return ""
    return ",".join(a for a in DP_AXES if a in _names(spec[k]))


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def fsdp_param_dims(specs):
    """Per-leaf FSDP dim of a whole spec tree."""
    return _map_specs(fsdp_dim, specs)


def fsdp_param_axes(specs):
    """Per-leaf comma-joined FSDP axes ("" = replicated) of a spec tree."""
    return _map_specs(fsdp_leaf_axes, specs)


def gather_outer_local(axes: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(outer, local) split of a comma-joined FSDP axes string: 'pod' is the
    non-local tier, everything else local."""
    names = tuple(a for a in axes.split(",") if a)
    return (tuple(a for a in names if a == "pod"),
            tuple(a for a in names if a != "pod"))


def block_slice_dims(block_dims):
    """Stacked-block FSDP dims in ONE layer's coordinates (the stack's
    leading layer dim dropped; replicated leaves stay -1)."""
    return _map_specs(lambda k: k - 1 if k >= 1 else -1, block_dims)
