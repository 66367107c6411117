from .noise_levels import NoiseLevelConfig, training_noise_levels
from .optim import Optimizer, make_lr_schedule, make_optimizer
from .state import TrainState, create_train_state, ema_update, gated_ema_update
from .trainer import make_train_step

__all__ = [
    "NoiseLevelConfig", "training_noise_levels", "Optimizer", "make_lr_schedule",
    "make_optimizer", "TrainState", "create_train_state", "ema_update",
    "gated_ema_update", "make_train_step",
]
