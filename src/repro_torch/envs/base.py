"""The solver-agnostic environment contract (PyTorch port of
`repro.envs.base`).

An environment is a hashable, static object whose methods are functions of
tensors.  Layout conventions shared by every environment:

  * `EnvState.u` is a single conservative/nodal state tensor whose leading
    axes may carry an environment batch; `initial_state_bank` returns a
    stack of such tensors with the bank axis first.
  * Observations are element-local: shape (..., E, *spatial, C), every
    channel declared by name in `ObsSpec.channel_specs` with the physical
    scale the env already divided by.
  * Actions are per-element scalars (..., E) bounded to
    [`ActionSpec.low`, `ActionSpec.high`].
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, runtime_checkable

import torch


class EnvState(NamedTuple):
    """Carried MDP state: solver field + RL step counter."""

    u: torch.Tensor       # solver state; leading axes may be a batch
    t_step: torch.Tensor  # RL step counter (int32, scalar or (B,))


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """One named observation channel: `scale` is the divisor `observe()`
    already applied; `gain` an optional policy-input multiplier."""

    name: str
    scale: float = 1.0
    gain: float = 1.0


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Declarative per-environment observation layout (..., E, *spatial, C).

    >>> spec = ObsSpec(n_elements=8, spatial=(4, 4, 4),
    ...                channel_specs=velocity_channels(3, 2.0))
    >>> spec.channels, spec.channel_names, spec.shape
    (3, ('u_x', 'u_y', 'u_z'), (8, 4, 4, 4, 3))
    """

    n_elements: int
    spatial: tuple[int, ...]
    channel_specs: tuple[ChannelSpec, ...]

    def __post_init__(self):
        names = self.channel_names
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate channel names: {names}")

    @property
    def channels(self) -> int:
        return len(self.channel_specs)

    @property
    def channel_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.channel_specs)

    @property
    def channel_gains(self) -> tuple[float, ...]:
        return tuple(c.gain for c in self.channel_specs)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.n_elements, *self.spatial, self.channels)


def velocity_channels(ndim: int, scale: float) -> tuple[ChannelSpec, ...]:
    """The standard velocity channel block: ('u_x'[, 'u_y', 'u_z'])."""
    return tuple(ChannelSpec(f"u_{ax}", scale=scale)
                 for ax in ("x", "y", "z")[:ndim])


@dataclasses.dataclass(frozen=True)
class ActionSpec:
    """Per-element bounded scalar action (..., E) in [low, high]."""

    n_elements: int
    low: float = 0.0
    high: float = 1.0

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.n_elements,)


@runtime_checkable
class Env(Protocol):
    """The contract every registered scenario implements."""

    @property
    def obs_spec(self) -> ObsSpec: ...

    @property
    def action_spec(self) -> ActionSpec: ...

    @property
    def n_actions(self) -> int:
        """Episode horizon T (fixed-length episodes, as in the paper)."""
        ...

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """(n, *state_shape) bank of initial solver states on gen's device."""
        ...

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]: ...

    def observe(self, state: EnvState) -> torch.Tensor: ...

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One MDP transition; deterministic given (state, action)."""
        ...
