"""Solver-agnostic RL environments: the Env protocol and scenario registry
(PyTorch port of `repro.envs`; HIT-LES and the wall-modeled channel so far).

    from repro_torch import envs

    env = envs.make("hit_les_reduced")
    print(envs.registered())
"""
from .base import (ActionSpec, ChannelSpec, Env, EnvState, ObsSpec,
                   StepResult, velocity_channels)
from .registry import make, register, registered

# Importing the scenario modules populates the registry.
from . import channel, hit_les  # noqa: F401  (registration side effects)
from .channel import ChannelEnv
from .hit_les import HITLESEnv

__all__ = [
    "ActionSpec",
    "ChannelEnv",
    "ChannelSpec",
    "Env",
    "EnvState",
    "HITLESEnv",
    "ObsSpec",
    "StepResult",
    "make",
    "register",
    "registered",
    "velocity_channels",
]
