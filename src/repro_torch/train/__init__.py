from .step import (BlockPrefetch, CommMeter, StepArtifacts,  # noqa: F401
                   bucketed_sync, init_state, make_loss_fn, make_train_step,
                   xent_loss)
from .trainer import Trainer, TrainerConfig  # noqa: F401
