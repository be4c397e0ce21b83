"""Solver-agnostic RL environments: the Env protocol and scenario registry
(PyTorch port of `repro.envs`: HIT-LES, the wall-modeled channel and
forced Burgers).

    from repro_torch import envs

    env = envs.make("hit_les_reduced")
    print(envs.registered())
"""
from .base import (ActionSpec, ChannelSpec, Env, EnvState, ObsSpec,
                   StepResult, as_env, init_state, velocity_channels)
from .registry import make, register, registered

# Importing the scenario modules populates the registry.
from . import burgers, channel, hit_les  # noqa: F401  (registration side effects)
from .burgers import BurgersEnv
from .channel import ChannelEnv
from .hit_les import HITLESEnv

__all__ = [
    "ActionSpec",
    "BurgersEnv",
    "ChannelEnv",
    "ChannelSpec",
    "Env",
    "EnvState",
    "HITLESEnv",
    "ObsSpec",
    "StepResult",
    "as_env",
    "init_state",
    "make",
    "register",
    "registered",
    "velocity_channels",
]
