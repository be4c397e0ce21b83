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

`SplitEnv` is an env split over the ranks of a group by its first element
axis (the paper's several ranks per environment), as the orchestrator
builds it for `FleetConfig.elem_axis` through the env's `split_x`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, runtime_checkable

import torch
import torch.distributed as dist


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


def guard(u_next: torch.Tensor, u: torch.Tensor, state_ndim: int,
          split=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The solver blow-up guard: (u_next where every value of an env's
    state is finite, else that env's u; the per-env flag (...,)).  The
    state's last `state_ndim` axes are one env's.  With `split` (u this
    rank's slabs) the flag is the minimum over the ranks, so every rank
    reverts the same envs."""
    finite = torch.isfinite(u_next).flatten(start_dim=u_next.ndim
                                            - state_ndim).all(-1)
    if split is not None:
        finite = split.all_reduce_(finite.to(torch.int32),
                                   dist.ReduceOp.MIN).bool()
    keep = finite.reshape(finite.shape + (1,) * state_ndim)
    return torch.where(keep, u_next, u), finite


class SplitEnv:
    """An env whose every env is split over the ranks of a group
    (`core.collectives.ElemSplit`) by its first element axis, axis
    `-state_ndim` of the state: each rank holds `n_slabs / size`
    contiguous slabs of every env's state.  `slab` cuts a rank's part out
    of whole states (bank rows).

    Observations and actions are the whole env's, so the specs, the
    policy, the trajectory and the PPO update are the unsplit ones: the
    policy runs replicated over the group.  `step` advances the rank's
    slabs (`env.advance(u, action, split)`, which takes the rank's part of
    the action), guards them with the flag's minimum over the ranks, then
    gathers the new state once: the observation and the reward are the
    unsplit env's of the whole state (`env.outcome`).  `observe` of the
    state `step` just returned hands back that step's observation."""

    def __init__(self, env, split, n_slabs: int, state_ndim: int):
        if n_slabs % split.size:
            raise ValueError(f"{split.size} ranks do not divide the "
                             f"{n_slabs} element slabs of {env.cfg}")
        self.env, self.cfg, self.split = env, env.cfg, split
        self.state_ndim = state_ndim
        self._last = (None, None)  # (state tensor, its observation)

    @property
    def obs_spec(self) -> ObsSpec:
        return self.env.obs_spec

    @property
    def action_spec(self) -> ActionSpec:
        return self.env.action_spec

    @property
    def n_actions(self) -> int:
        return self.env.n_actions

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """The whole env's bank: every rank holds all of it."""
        return self.env.initial_state_bank(gen, n)

    def _dim(self, u: torch.Tensor) -> int:
        return u.ndim - self.state_ndim

    def slab(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's slabs of whole states (..., K, ...)."""
        return self.split.slab(u, self._dim(u))

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]:
        state = init_state(self.slab(bank[index]), tuple(index.shape))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> torch.Tensor:
        u, obs = self._last
        if state.u is not u:
            obs = self._observe(state)
        return obs

    def _observe(self, state: EnvState) -> torch.Tensor:
        whole = self.split.gather(state.u, self._dim(state.u))
        return self.env.observe(state._replace(u=whole))

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        res = self._step(state, action)
        self._last = (res.state.u, res.obs)
        return res

    def _step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        u_next, finite = guard(self.env.advance(state.u, action, self.split),
                               state.u, self.state_ndim, self.split)
        t_next = state.t_step + 1
        obs, reward, done = self.env.outcome(
            self.split.gather(u_next, self._dim(u_next)), finite, t_next)
        return StepResult(EnvState(u_next, t_next), obs, reward, done)


def init_state(u0: torch.Tensor, batch_shape: tuple[int, ...] = ()
               ) -> EnvState:
    """Wrap bank rows (or a single state) into a fresh EnvState at t=0."""
    return EnvState(u=u0, t_step=torch.zeros(batch_shape, dtype=torch.int32,
                                             device=u0.device))


def as_env(env_or_cfg) -> Env:
    """Coerce a bare `HITConfig` to the Env protocol (the HIT-LES adapter);
    any other value is returned as it is."""
    from ..cfd.solver import HITConfig
    if isinstance(env_or_cfg, HITConfig):
        from .hit_les import HITLESEnv
        return HITLESEnv(cfg=env_or_cfg)
    return env_or_cfg
