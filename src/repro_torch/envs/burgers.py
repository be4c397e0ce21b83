"""Forced 1-D Burgers control scenario on the generic Env protocol (PyTorch
port of `repro.envs.burgers`): a 1-D solver with per-element eddy-viscosity
control that trains through the same runner, rollout and PPO stack as the
3-D scenarios.  Physics in `cfd/burgers1d.py`.

Observation: the single scalar field 'u' at every element node, normalized
by the forcing-scale rms velocity u_rms, (..., K, n, 1).

Registry overrides reach every `BurgersConfig` field, e.g.
`envs.make("burgers_reduced", t_end=1.0)`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cfd import burgers1d, spectra
from ..cfd.burgers1d import BurgersConfig
from .base import ActionSpec, ChannelSpec, EnvState, ObsSpec, StepResult
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
        return torch.as_tensor(burgers1d.reference_spectrum(self.cfg),
                               dtype=torch.float32, device=device)

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

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        """One MDP transition with the blow-up guard of the HIT scenario: a
        non-finite advance reverts the state and floors the reward at -1."""
        cfg = self.cfg
        c_elem = torch.clamp(action, 0.0, cfg.c_max)
        u_next = burgers1d.advance_rl_interval(state.u, c_elem, cfg)
        finite = torch.isfinite(u_next).flatten(start_dim=u_next.ndim - 3
                                                ).all(-1)
        u_next = torch.where(finite[..., None, None, None], u_next, state.u)
        e_les = burgers1d.les_spectrum(u_next, cfg)
        ell = spectra.spectral_error(e_les, self.e_ref(u_next.device),
                                     cfg.k_max)
        reward = torch.where(finite, spectra.reward_from_error(ell, cfg.alpha),
                             torch.full_like(ell, -1.0))
        t_next = state.t_step + 1
        next_state = EnvState(u=u_next, t_step=t_next)
        return StepResult(next_state, self.observe(next_state), reward,
                          t_next >= cfg.n_actions)


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
