"""Forced 1-D Burgers control scenario on the generic Env protocol (PyTorch
port of `repro.envs.burgers`): a 1-D solver with per-element eddy-viscosity
control that trains through the same runner, rollout and PPO stack as the
3-D scenarios.  Physics in `cfd/burgers1d.py`.

Observation: the single scalar field 'u' at every element node, normalized
by the forcing-scale rms velocity u_rms, (..., K, n, 1).

Registry overrides reach every `BurgersConfig` field, e.g.
`envs.make("burgers_reduced", t_end=1.0)`.

`BurgersEnv.split_x(split)` is the env split over the ranks of a group by
its elements (`base.SplitEnv`), as the orchestrator builds it for
`FleetConfig.elem_axis`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cfd import burgers1d, spectra, tables
from ..cfd.burgers1d import BurgersConfig
from .base import (ActionSpec, ChannelSpec, EnvState, ObsSpec, SplitEnv,
                   StepResult, guard)
from .registry import register


@dataclasses.dataclass(frozen=True)
class BurgersEnv:
    """Forced viscous Burgers LES, per-element eddy-viscosity control."""

    cfg: BurgersConfig

    @property
    def obs_spec(self) -> ObsSpec:
        return ObsSpec(n_elements=self.cfg.n_elem, spatial=(self.cfg.n,),
                       channel_specs=(ChannelSpec("u", scale=self.cfg.u_rms),))

    @property
    def action_spec(self) -> ActionSpec:
        return ActionSpec(n_elements=self.cfg.n_elem, low=0.0,
                          high=self.cfg.c_max)

    @property
    def n_actions(self) -> int:
        return self.cfg.n_actions

    def e_ref(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """Synthetic k^-2 target spectrum (config-time constant)."""
        return tables.table(burgers1d.reference_spectrum, self.cfg,
                            device=device)

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return burgers1d.make_state_bank(gen, self.cfg, n)

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]:
        u = bank[index]
        state = EnvState(u=u, t_step=torch.zeros(index.shape,
                                                 dtype=torch.int32,
                                                 device=u.device))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> torch.Tensor:
        return state.u / self.cfg.u_rms

    def advance(self, u: torch.Tensor, action: torch.Tensor,
                split=None) -> torch.Tensor:
        """u advanced by one RL interval under `action` (the whole env's).
        With `split` u is this rank's elements, and it takes their C."""
        c_elem = torch.clamp(action, 0.0, self.cfg.c_max)
        if split is not None:
            c_elem = split.slab(c_elem, c_elem.ndim - 1)
        return burgers1d.advance_rl_interval(u, c_elem, self.cfg, split)

    def outcome(self, u: torch.Tensor, finite: torch.Tensor,
                t_step: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(obs, reward, done) of the guarded whole state u at `t_step`:
        the reward is floored at -1 where the advance was not finite."""
        cfg = self.cfg
        e_les = burgers1d.les_spectrum(u, cfg)
        ell = spectra.spectral_error(e_les, self.e_ref(u.device), cfg.k_max)
        reward = torch.where(finite, spectra.reward_from_error(ell, cfg.alpha),
                             torch.full_like(ell, -1.0))
        return (self.observe(EnvState(u, t_step)), reward,
                t_step >= cfg.n_actions)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One MDP transition with the blow-up guard of the HIT scenario: a
        non-finite advance reverts the state and floors the reward at -1."""
        u_next, finite = guard(self.advance(state.u, action), state.u, 3)
        t_next = state.t_step + 1
        return StepResult(EnvState(u_next, t_next),
                          *self.outcome(u_next, finite, t_next))

    def split_x(self, split) -> SplitEnv:
        """This env split by its elements, axis 1 of (B, K, n, 1), over
        `split`'s ranks (`SplitEnv`): one gather of the state a step gives
        the observation and the reward's spectrum of the whole field."""
        return SplitEnv(self, split, self.cfg.n_elem, state_ndim=3)


@register("burgers_96dof")
def _burgers96(**overrides) -> BurgersEnv:
    """Production scale: N=7, 12 elements (96 DOF), full-length episodes."""
    return BurgersEnv(cfg=BurgersConfig(**overrides))


@register("burgers_reduced")
def _burgers_reduced(**overrides) -> BurgersEnv:
    """CPU-friendly smoke scale: N=3, 4 elements, short episodes."""
    defaults = dict(n_poly=3, n_elem=4, nu=2e-2, k_max=3, alpha=0.4,
                    t_end=0.3, dt_rl=0.1, k_eta=6.0)
    defaults.update(overrides)
    return BurgersEnv(cfg=BurgersConfig(**defaults))
