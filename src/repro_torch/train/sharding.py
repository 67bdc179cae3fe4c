"""Parameter sharding rules of the port's FSDP and tensor parallelism,
ported from ``src/repro/train/sharding.py`` (the ``_leaf_spec`` heuristic,
``param_specs``, the FSDP gather geometry and the activation-kind table).

A spec is a tuple with one entry per dim of a leaf, as the JAX
``PartitionSpec``: None (not sharded), ``"data"`` (over the ranks of a pod;
the pods hold replicas), ``("pod", "data")`` (over every rank of a model
lane, pod-major, the grid-rank order of ``core/topology.RankGrid``) or
``"model"`` (over the m ranks of the model tier). Parameters shard 2-D:
Megatron-style column- and row-parallel projections over ``"model"`` where
the dim divides by m (else the dim stays whole; the port's own leaves of a
Mamba2 layer on a model tier, ``in_proj_bc`` and ``conv_w_bc``, are whole
on the tier, the former FSDP-sharded as ``in_proj``), and the FSDP dim over
``("pod", "data")`` when it divides by the lane's q·pl ranks, over
``"data"`` when it divides only by a pod's ranks, whole otherwise; norm
scales stay replicated. Stacked leaves (``blocks/...``) carry a leading
None for the layer dim.

The grid is given as its axes and sizes, ``{"pod": q, "data": pl}`` and
``"model": m`` on a grid with a model tier (:func:`grid_axes`).
:data:`ACT_RULES` and :func:`act_spec` are the JAX activation hooks' table:
which dims of an activation a rank holds a part of.
"""
from __future__ import annotations

import math

DP_AXES = ("pod", "data")       # batch axes (outer = pod boundary)
MODEL_AXIS = "model"


def grid_axes(grid) -> dict[str, int]:
    """The axes of a ``RankGrid`` (anything with ``q``, ``pl`` and, for a
    model tier, ``m``)."""
    axes = {"pod": grid.q, "data": grid.pl}
    m = getattr(grid, "m", 1)
    return axes | {MODEL_AXIS: m} if m > 1 else axes


def _check_axes(axes: dict[str, int]) -> None:
    other = [a for a in axes if a not in DP_AXES + (MODEL_AXIS,)]
    if other:
        raise ValueError(f"grid axes {other}: the port's grids have the "
                         f"axes {DP_AXES + (MODEL_AXIS,)}")


def dp_axes(axes: dict[str, int]) -> tuple[str, ...]:
    """The DP axes present ('pod' only on a grid that names it)."""
    return tuple(a for a in DP_AXES if a in axes)


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def moe_expert_leaf(path: tuple[str, ...], shape: tuple[int, ...]) -> bool:
    """True for the routed experts' weight leaves: the (E, d_in, d_out)
    stacks that expert parallelism shards over the DP axes (the shared
    experts' and the dense MLP's projections are 2-D and never match)."""
    return path[-1] in ("gate", "up", "down") and len(shape) == 3 \
        and "shared" not in path


def _leaf_spec(path: tuple[str, ...], shape: tuple[int, ...],
               axes: dict[str, int], fs_axes: tuple[str, ...],
               ep_axes: tuple[str, ...] = ()) -> tuple:
    """The JAX heuristic from the leaf's key name. ``fs_axes`` are the DP
    axes the FSDP dim may shard over (none: no FSDP); ``ep_axes`` those the
    routed experts' E dim shards over (none: the TP/FSDP layout)."""
    name = path[-1]
    m = axes.get(MODEL_AXIS, 1)
    d = axes.get("data", 1)
    full = math.prod(axes.get(a, 1) for a in fs_axes) if fs_axes else 1
    ep = math.prod(axes.get(a, 1) for a in ep_axes) if ep_axes else 1

    def fdim(dim):
        # prefer the whole ('pod', 'data') span; a dim that divides only by
        # the 'data' size shards within the pod (the pods replicate it)
        if not fs_axes:
            return None
        if len(fs_axes) > 1 and _div(dim, full):
            return tuple(fs_axes)
        return "data" if ("data" in fs_axes and _div(dim, d)) else None

    def mdim(dim):
        return MODEL_AXIS if _div(dim, m) else None

    if len(shape) == 0:
        return ()
    if name in ("scale", "bias", "A_log", "D", "dt_bias", "conv_b"):
        return (None,) * len(shape)
    if name == "router":                               # (d, E), small
        return (None, None)
    if name in ("embed", "head"):
        v_dim, d_dim = (0, 1) if name == "embed" else (1, 0)
        spec = [None, None]
        spec[v_dim] = mdim(shape[v_dim])
        spec[d_dim] = fdim(shape[d_dim])
        return tuple(spec)
    if name in ("wq", "wk", "wv", "in_proj"):          # column-parallel
        return (fdim(shape[0]), mdim(shape[1]))
    if name == "in_proj_bc":      # Mamba2's B and C columns on a model tier,
        return (fdim(shape[0]), None)    # whole on each rank (models/tp.py)
    if name == "conv_w_bc":
        return (None, None)
    if name in ("wo", "out_proj"):                     # row-parallel
        return (mdim(shape[0]), fdim(shape[1]))
    if name in ("gate", "up"):
        if len(shape) == 3:                            # MoE experts (E, d, f)
            if moe_expert_leaf(path, shape) and _div(shape[0], ep):
                return (tuple(ep_axes), None, None)    # expert parallel
            return (mdim(shape[0]), fdim(shape[1]), None)
        return (fdim(shape[0]), mdim(shape[1]))
    if name == "down":
        if len(shape) == 3:                            # (E, f, d)
            if moe_expert_leaf(path, shape) and _div(shape[0], ep):
                return (tuple(ep_axes), None, None)
            return (mdim(shape[0]), None, fdim(shape[2]))
        return (mdim(shape[0]), fdim(shape[1]))
    if name == "conv_w":                               # (W, Ch) depthwise
        return (None, mdim(shape[1]))
    # fallback: the largest dim over model, where it divides
    best = max(range(len(shape)), key=lambda i: shape[i])
    spec = [None] * len(shape)
    if _div(shape[best], m):
        spec[best] = MODEL_AXIS
    return tuple(spec)


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


def _stacked(path: tuple[str, ...]) -> bool:
    return any(k == "blocks" or k.endswith("_layers") for k in path)


def param_specs(params, axes: dict[str, int], *, fsdp: bool = False,
                moe_ep: bool = False) -> dict:
    """The spec tree of a parameter tree (leaves: anything with ``.shape``)
    on a grid of ``axes``; with ``fsdp`` the FSDP dims shard over every DP
    axis of the grid (the JAX ``fsdp_axes="auto"``). ``moe_ep``: the
    routed experts' E dim shards over the whole DP composite (expert
    parallelism: each rank owns E/p experts) where p divides it."""
    _check_axes(axes)
    fs_axes = dp_axes(axes) if fsdp else ()
    ep_axes = dp_axes(axes) if moe_ep else ()
    specs = {}
    for path, leaf in _walk(params):
        stacked = _stacked(path)
        shape = tuple(leaf.shape)
        spec = _leaf_spec(path, shape[1:] if stacked else shape, axes,
                          fs_axes, ep_axes)
        specs[path] = (None,) + spec if stacked else spec
    return _rebuild(params, specs)


def moe_ep_mask(params) -> dict:
    """Per-leaf bool tree: True for the routed experts' leaves, which
    :func:`param_specs` with ``moe_ep`` shards over the DP axes and the
    step never gathers (their gradients arrive whole at the owner)."""
    out = {}
    for path, leaf in _walk(params):
        shape = tuple(leaf.shape)
        out[path] = moe_expert_leaf(
            path, shape[1:] if _stacked(path) else shape)
    return _rebuild(params, out)


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


def model_dim(spec: tuple) -> int:
    """Index of the dim of a leaf spec sharded over "model" (-1: the model
    tier holds the leaf whole)."""
    for i, s in enumerate(spec):
        if MODEL_AXIS in _names(s):
            return i
    return -1


def model_param_dims(specs):
    """Per-leaf model-sharded dim of a whole spec tree."""
    return _map_specs(model_dim, specs)


# ---------------------------------------------------------------------------
# the activation kinds (the JAX shard hooks' table)
# ---------------------------------------------------------------------------
#: kind -> dims: "dp" marks the batch dim, "model" the model-sharded dim
ACT_RULES: dict[str, tuple] = {
    "act":        ("dp", None, None),            # (B, S, d)
    "act_heads":  ("dp", None, "model", None),   # (B, S, H, D)
    "act_ff":     ("dp", None, "model"),         # (B, S, F)
    "moe_act":    ("dp", "model", None, None),   # (B, E, C, d)
    "logits":     ("dp", None, "model"),         # (B, S, V)
}


def act_spec(kind: str, shape: tuple[int, ...], axes: dict[str, int], *,
             seq_shard: bool = False) -> tuple:
    """Which dims of an activation of ``kind`` and global ``shape`` a rank
    holds a part of, on a grid of ``axes``: the JAX ``make_shard_fn`` rule
    with the DP axes manual (each rank runs its own rows, so the batch dim
    is never marked). A "model" dim is sharded where m divides it; with
    ``seq_shard`` the sequence dim of ``act`` (the residual stream between
    the blocks) is sharded over "model" instead."""
    m = axes.get(MODEL_AXIS, 1)
    rule = ACT_RULES.get(kind)
    if rule is None or len(shape) != len(rule):
        return (None,) * len(shape)
    on_model = lambda dim: MODEL_AXIS if _div(dim, m) else None
    spec = [on_model(shape[i]) if r == "model" else None
            for i, r in enumerate(rule)]
    if seq_shard and kind == "act":
        spec[1] = on_model(shape[1])
    return tuple(spec)
