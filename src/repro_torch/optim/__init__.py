"""Optimizers of the LM training path (counterpart of `repro.optim`):
Adam(W) and learning-rate schedules as functions on lists of tensors.
The PPO path keeps its `torch.optim.Adam` (`core/ppo.py`)."""
from .adam import (AdamConfig, AdamState, adam_init, adam_update,
                   clip_by_global_norm, global_norm)
from .schedules import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamConfig",
    "AdamState",
    "adam_init",
    "adam_update",
    "global_norm",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
]
