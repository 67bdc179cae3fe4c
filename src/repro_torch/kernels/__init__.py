"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``ref.py`` (the plain PyTorch version, run for CPU
tensors and held against the kernel on the card) and ``ops.py`` (the
wrapper: checks, allocation, launch, a ``LAUNCHES`` count; the ``_d120``
counts are the flash launches at head dim 120, forward and backward, and
the ``_ring`` ones the decode launches over a ring cache, already inside
their kernels' counts). The CUDA
sources live in ``csrc/`` and are built at first use by ``_build.py``.
:func:`launch_counts` reads every count, :func:`add_launch_counts` advances
them for launches a CUDA graph replays.
"""


def _counters():
    """(name, module, attribute) of every launch counter."""
    from .decode_stats import ops as decode_stats
    from .dma_allgather import ops as dma_allgather
    from .flash_attention import ops as flash_attention
    from .rmsnorm import ops as rmsnorm
    from .ssd import ops as ssd
    return [("rmsnorm", rmsnorm, "LAUNCHES"),
            ("rmsnorm_bwd", rmsnorm, "BWD_LAUNCHES"),
            ("flash_attention", flash_attention, "LAUNCHES"),
            ("flash_attention_d120", flash_attention, "D120_LAUNCHES"),
            ("flash_attention_bwd_dq", flash_attention, "BWD_DQ_LAUNCHES"),
            ("flash_attention_bwd_dkdv", flash_attention,
             "BWD_DKDV_LAUNCHES"),
            ("flash_attention_bwd_wgmma", flash_attention,
             "BWD_WGMMA_LAUNCHES"),
            ("flash_attention_bwd_d120", flash_attention,
             "BWD_D120_LAUNCHES"),
            ("decode_scores", decode_stats, "SCORES_LAUNCHES"),
            ("decode_stats", decode_stats, "LAUNCHES"),
            ("decode_scores_ring", decode_stats, "RING_SCORES_LAUNCHES"),
            ("decode_stats_ring", decode_stats, "RING_LAUNCHES"),
            ("dma_allgather", dma_allgather, "LAUNCHES"),
            ("ssd", ssd, "LAUNCHES"),
            ("ssd_bwd", ssd, "BWD_LAUNCHES")]


def _form_counts() -> dict[str, dict[str, int]]:
    """RMSNorm's per-form counts, forward and backward, by key prefix."""
    from .rmsnorm import ops as rmsnorm
    return {"rmsnorm": rmsnorm.FORM_LAUNCHES,
            "rmsnorm_bwd": rmsnorm.FORM_BWD_LAUNCHES}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, and RMSNorm's per form, forward
    (``rmsnorm.<form>``) and backward (``rmsnorm_bwd.<form>``)."""
    counts = {name: getattr(mod, attr) for name, mod, attr in _counters()}
    for prefix, forms in _form_counts().items():
        counts.update({f"{prefix}.{form}": n for form, n in forms.items()})
    return counts


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (keys of :func:`launch_counts`) to the
    counts: a CUDA graph's replay launches what its capture recorded, and
    the wrappers, which count a launch where they make it, do not run."""
    mods = {name: (mod, attr) for name, mod, attr in _counters()}
    forms = _form_counts()
    for key, n in delta.items():
        if "." in key:
            prefix, form = key.split(".", 1)
            forms[prefix][form] += n * times
        else:
            mod, attr = mods[key]
            setattr(mod, attr, getattr(mod, attr) + n * times)
