"""String-keyed environment registry: `envs.make("hit_les_24dof")` (PyTorch
port of `repro.envs.registry`).  A factory may accept keyword overrides,
forwarded verbatim, e.g. `envs.make("hit_les_reduced", t_end=1.0)`.

>>> from repro_torch import envs
>>> envs.make("hit_les_reduced").obs_spec.channel_names
('u_x', 'u_y', 'u_z')
"""
from __future__ import annotations

from typing import Callable

from .base import Env

_REGISTRY: dict[str, Callable[..., Env]] = {}


def register(name: str) -> Callable[[Callable[..., Env]], Callable[..., Env]]:
    """Decorator registering an env factory under `name`."""

    def deco(factory: Callable[..., Env]) -> Callable[..., Env]:
        if name in _REGISTRY:
            raise ValueError(f"environment {name!r} already registered")
        _REGISTRY[name] = factory
        return factory

    return deco


def make(name: str, **overrides) -> Env:
    """Instantiate a registered environment, optionally overriding config
    fields (forwarded to the factory as keyword arguments)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown environment {name!r}; registered: {known}"
                       ) from None
    return factory(**overrides)


def registered() -> tuple[str, ...]:
    """Sorted names of all registered environments."""
    return tuple(sorted(_REGISTRY))
