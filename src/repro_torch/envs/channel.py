"""Wall-modeled channel-flow control scenario on the generic Env protocol
(PyTorch port of `repro.envs.channel`): the first non-periodic scenario, with
anisotropic element counts and weak wall boundary conditions (physics in
`cfd/channel.py`).

Obs    : the two layers of wall-adjacent elements, channels declared by name:
           * `channel_wm`: ('u_x', 'u_y', 'u_z') over u_bulk,
             (2*Kx*Kz, n, n, n, 3);
           * `channel_wm_p` (obs_pressure): plus 'p_wall', p - p0 over the
             wall shear stress rho u_tau^2, policy gain 0.5;
           * `channel_wm_t` (obs_temperature): plus 'T_wall', T - T0 over the
             friction-temperature scale u_tau^2 / cp, policy gain 0.5;
           * `channel_wm_hre`: the base observation at Re_tau ~ 90.
         Top-wall elements are mirrored (y node axis flipped, v_y negated).
Action : per-wall-element wall-stress scaling a in [0, a_max]; a = 1 applies
         the equilibrium wall model as it is.
Reward : 2 exp(-l/alpha) - 1 with l the quadrature-weighted relative L2
         error of the x-z mean velocity profile against Reichardt's law.

Registry overrides reach every `ChannelConfig` field, e.g.
`envs.make("channel_wm", precision="bf16")` or `use_kernels=False`.

`ChannelEnv.split_x(split)` is the env split over the ranks of a group by
its x-slabs (`base.SplitEnv`), as the orchestrator builds it for
`FleetConfig.elem_axis`; y is bounded by the walls, x is periodic.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cfd import channel, spectra, tables
from ..cfd.channel import ChannelConfig
from .base import (ActionSpec, ChannelSpec, EnvState, ObsSpec, SplitEnv,
                   StepResult, guard, velocity_channels)
from .registry import register


@dataclasses.dataclass(frozen=True)
class ChannelEnv:
    """Plane-channel WMLES, per-wall-element stress-scaling control.
    Observation channels: velocities [, p_wall][, T_wall]."""

    cfg: ChannelConfig
    obs_pressure: bool = False
    obs_temperature: bool = False

    @property
    def obs_spec(self) -> ObsSpec:
        n = self.cfg.n
        chans = velocity_channels(3, self.cfg.u_bulk)
        if self.obs_pressure:
            chans = chans + (ChannelSpec("p_wall", scale=self.cfg.tau_wall,
                                         gain=0.5),)
        if self.obs_temperature:
            chans = chans + (ChannelSpec("T_wall", scale=self.cfg.t_tau,
                                         gain=0.5),)
        return ObsSpec(n_elements=self.cfg.n_wall_elements,
                       spatial=(n, n, n), channel_specs=chans)

    @property
    def action_spec(self) -> ActionSpec:
        return ActionSpec(n_elements=self.cfg.n_wall_elements, low=0.0,
                          high=self.cfg.a_max)

    @property
    def n_actions(self) -> int:
        return self.cfg.n_actions

    def u_ref(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """Reference mean profile (config-time constant)."""
        return tables.table(channel.reference_profile, self.cfg,
                            device=device)

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return channel.make_state_bank(gen, self.cfg, n)

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]:
        u = bank[index]
        state = EnvState(u=u, t_step=torch.zeros(index.shape,
                                                 dtype=torch.int32,
                                                 device=u.device))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> torch.Tensor:
        """Named-channel near-wall observation, both walls in one
        orientation: (..., 2*Kx*Kz, n, n, n, C)."""
        cfg = self.cfg
        obs = channel.wall_velocity_observation(state.u, cfg) / cfg.u_bulk
        if self.obs_pressure:
            p = channel.wall_pressure_observation(state.u, cfg)
            obs = torch.cat([obs, p / cfg.tau_wall], dim=-1)
        if self.obs_temperature:
            t = channel.wall_temperature_observation(state.u, cfg)
            obs = torch.cat([obs, t / cfg.t_tau], dim=-1)
        return obs

    def _split_action(self, action: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., 2*Kx*Kz) -> per-wall (..., Kx, Kz) scaling fields."""
        kx, _, kz = self.cfg.n_elem
        a = torch.clamp(action, 0.0, self.cfg.a_max)
        grid = tuple(a.shape[:-1]) + (kx, kz)
        return a[..., : kx * kz].reshape(grid), a[..., kx * kz:].reshape(grid)

    def advance(self, u: torch.Tensor, action: torch.Tensor,
                split=None) -> torch.Tensor:
        """u advanced by one RL interval under `action` (the whole env's).
        With `split` u is this rank's x-slabs, and it takes its x rows of
        each wall's (Kx, Kz) action grid."""
        scales = self._split_action(action)
        if split is not None:
            scales = tuple(split.slab(a, a.ndim - 2) for a in scales)
        return channel.advance_rl_interval(u, *scales, self.cfg, split)

    def outcome(self, u: torch.Tensor, finite: torch.Tensor,
                t_step: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(obs, reward, done) of the guarded whole state u at `t_step`:
        the reward is floored at -1 where the advance was not finite."""
        cfg = self.cfg
        ops = cfg.operators(u.device)
        prof = channel.mean_velocity_profile(u, cfg, ops)
        ell = channel.profile_error(prof, self.u_ref(u.device), ops)
        reward = torch.where(finite, spectra.reward_from_error(ell, cfg.alpha),
                             torch.full_like(ell, -1.0))
        return (self.observe(EnvState(u, t_step)), reward,
                t_step >= cfg.n_actions)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One MDP transition with the blow-up guard: a non-finite advance
        reverts the state and floors the reward at -1."""
        u_next, finite = guard(self.advance(state.u, action), state.u, 7)
        t_next = state.t_step + 1
        return StepResult(EnvState(u_next, t_next),
                          *self.outcome(u_next, finite, t_next))

    def split_x(self, split) -> SplitEnv:
        """This env split by its x-slabs, axis 1 of (B, Kx, Ky, Kz, n, n,
        n, 5), over `split`'s ranks (`SplitEnv`): one gather of the state a
        step gives the observation and the reward's x-z mean profile of
        the whole channel."""
        return SplitEnv(self, split, self.cfg.n_elem[0], state_ndim=7)


_REDUCED = dict(n_elem=(2, 3, 2), t_end=0.3, dt_rl=0.1)
# Higher Re_tau (u_tau h / nu = 90 against the base 24): the matching point
# sits deep in the log layer, so the fixed-point budget rises with it, and a
# larger perturbation trips the stiffer profile.
_HRE = dict(nu=2e-3, u_tau=0.18, wm_iters=12, perturb=0.1)


def _channel_env(defaults: dict, overrides: dict, **flags) -> ChannelEnv:
    return ChannelEnv(cfg=ChannelConfig(**{**defaults, **overrides}), **flags)


@register("channel_wm")
def _channel_wm(**overrides) -> ChannelEnv:
    """Default scale: N=3, 3x4x3 elements, full-length episodes."""
    return _channel_env({}, overrides)


@register("channel_wm_reduced")
def _channel_reduced(**overrides) -> ChannelEnv:
    """CPU-friendly smoke scale: 2x3x2 elements, short episodes."""
    return _channel_env(_REDUCED, overrides)


@register("channel_wm_p")
def _channel_wm_p(**overrides) -> ChannelEnv:
    """4-channel variant: velocity + near-wall pressure observations."""
    return _channel_env({}, overrides, obs_pressure=True)


@register("channel_wm_p_reduced")
def _channel_wm_p_reduced(**overrides) -> ChannelEnv:
    """CPU-friendly smoke scale of the pressure variant."""
    return _channel_env(_REDUCED, overrides, obs_pressure=True)


@register("channel_wm_hre")
def _channel_wm_hre(**overrides) -> ChannelEnv:
    """Higher-Re_tau variant of `channel_wm` (Re_tau ~ 90)."""
    return _channel_env(_HRE, overrides)


@register("channel_wm_hre_reduced")
def _channel_wm_hre_reduced(**overrides) -> ChannelEnv:
    """CPU-friendly smoke scale of the higher-Re_tau variant."""
    return _channel_env({**_HRE, **_REDUCED}, overrides)


@register("channel_wm_t")
def _channel_wm_t(**overrides) -> ChannelEnv:
    """4-channel variant: velocity + near-wall temperature observations."""
    return _channel_env({}, overrides, obs_temperature=True)


@register("channel_wm_t_reduced")
def _channel_wm_t_reduced(**overrides) -> ChannelEnv:
    """CPU-friendly smoke scale of the temperature variant."""
    return _channel_env(_REDUCED, overrides, obs_temperature=True)
