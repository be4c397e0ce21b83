"""Solver-agnostic RL environments: the Env protocol and scenario registry
(PyTorch port of `repro.envs`; HIT-LES only so far).

    from repro_torch import envs

    env = envs.make("hit_les_reduced")
    print(envs.registered())
"""
from .base import (ActionSpec, ChannelSpec, Env, EnvState, ObsSpec,
                   StepResult, velocity_channels)
from .registry import make, register, registered

# Importing the scenario module populates the registry.
from . import hit_les  # noqa: F401  (registration side effects)
from .hit_les import HITLESEnv

__all__ = [
    "ActionSpec",
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
