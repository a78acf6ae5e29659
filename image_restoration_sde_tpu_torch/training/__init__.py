from . import checkpoint, ema, losses, lr_schedules, optimizers
from .ema import EMA, EmaConfig
from .latent import make_compressor_train_step, make_latent_sampler, make_latent_train_step
from .losses import matching_loss
from .lr_schedules import build_lr_schedule
from .optimizers import Lion, ScheduledOptimizer, build_from_options, build_optimizer
from .trainer import TrainState, create_train_state, make_denoising_train_step, make_train_step

__all__ = [
    "checkpoint", "ema", "losses", "lr_schedules", "optimizers",
    "EMA", "EmaConfig", "Lion", "ScheduledOptimizer", "TrainState",
    "build_from_options", "build_lr_schedule", "build_optimizer", "create_train_state",
    "make_compressor_train_step", "make_denoising_train_step", "make_latent_sampler", "make_latent_train_step",
    "make_train_step", "matching_loss",
]
