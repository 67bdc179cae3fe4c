from .adamw import AdamW, TrainState, global_norm  # noqa: F401
