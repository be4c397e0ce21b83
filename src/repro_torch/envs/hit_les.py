"""HIT-LES scenario (paper Sec. 5.2) on the generic Env protocol (PyTorch
port of `repro.envs.hit_les`): a thin adapter over `repro_torch.cfd.env`
that declares the specs and owns the synthetic-DNS reference spectrum.

Registry overrides reach every `HITConfig` field, e.g.
`envs.make("hit_les_reduced", precision="bf16")` or `use_kernels=False`.

`HITLESEnv.split_x(split)` is the same env split over the ranks of a group
by its x-slabs (`SplitHITLESEnv`: the paper's several ranks per
environment), as the orchestrator builds it for `FleetConfig.elem_axis`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cfd import env as hit_kernel
from ..cfd import initial, spectra
from ..cfd.solver import HITConfig
from ..configs import relexi_hit
from .base import ActionSpec, EnvState, ObsSpec, StepResult, velocity_channels
from .registry import register


@dataclasses.dataclass(frozen=True)
class HITLESEnv:
    """Forced homogeneous isotropic turbulence LES, per-element C_s control."""

    cfg: HITConfig

    @property
    def obs_spec(self) -> ObsSpec:
        n = self.cfg.n_poly + 1
        return ObsSpec(n_elements=self.cfg.n_elem**3, spatial=(n, n, n),
                       channel_specs=velocity_channels(3, self.cfg.u_rms))

    @property
    def action_spec(self) -> ActionSpec:
        return ActionSpec(n_elements=self.cfg.n_elem**3, low=0.0,
                          high=self.cfg.cs_max)

    @property
    def n_actions(self) -> int:
        return self.cfg.n_actions

    def e_dns(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """Synthetic DNS target spectrum (config-time constant)."""
        return torch.as_tensor(spectra.reference_spectrum(self.cfg),
                               dtype=torch.float32, device=device)

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return initial.make_state_bank(gen, self.cfg, n)

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]:
        state, obs = hit_kernel.reset_from_bank(bank, index, self.cfg)
        return EnvState(*state), obs

    def observe(self, state: EnvState) -> torch.Tensor:
        return hit_kernel.observe(state.u, self.cfg)

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        res = hit_kernel.step(state, action, self.cfg,
                              self.e_dns(state.u.device))
        return StepResult(EnvState(*res.state), res.obs, res.reward, res.done)

    def split_x(self, split) -> SplitHITLESEnv:
        """This env split by its x-slabs over `split`'s ranks."""
        return SplitHITLESEnv(self, split)


class SplitHITLESEnv:
    """A `HITLESEnv` whose every env is split over the ranks of a group
    (`core.collectives.ElemSplit`) by its first element axis: each rank
    holds `Kx / size` contiguous x-slabs of every env's state, axis 1 of
    (B, Kx, Ky, Kz, n, n, n, 5).  `slab` cuts a rank's part out of whole
    bank rows.

    Observations and actions are the whole env's, so the specs, the
    policy, the trajectory and the PPO update are the unsplit ones: the
    policy runs replicated over the group and `step` takes the rank's
    slabs of the action.  One gather of the velocity a step gives both its
    reward and the next observation: `observe` of the state `step` just
    returned hands back that step's observation."""

    def __init__(self, env: HITLESEnv, split):
        if env.cfg.n_elem % split.size:
            raise ValueError(f"{split.size} ranks do not divide the "
                             f"{env.cfg.n_elem} x-slabs of {env.cfg}")
        self.env, self.cfg, self.split = env, env.cfg, split
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

    def e_dns(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return self.env.e_dns(device)

    def initial_state_bank(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """The whole env's bank: every rank holds all of it."""
        return self.env.initial_state_bank(gen, n)

    def slab(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's x-slabs of whole states (B, Kx, ...)."""
        return self.split.slab(u, dim=1)

    def reset_from_bank(self, bank: torch.Tensor, index: torch.Tensor
                        ) -> tuple[EnvState, torch.Tensor]:
        u = self.slab(bank[index])
        state = EnvState(u=u, t_step=torch.zeros(
            index.shape, dtype=torch.int32, device=u.device))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> torch.Tensor:
        u, obs = self._last
        if state.u is not u:
            obs = hit_kernel.observe(state.u, self.cfg, self.split)
        return obs

    def step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        res = hit_kernel.step(state, action, self.cfg,
                              self.e_dns(state.u.device), self.split)
        self._last = (res.state.u, res.obs)
        return StepResult(EnvState(*res.state), res.obs, res.reward, res.done)


@register("hit_les_24dof")
def _hit24(**overrides) -> HITLESEnv:
    """Paper Table 1, 24-DOF configuration (N=5, 4^3 elements)."""
    return HITLESEnv(cfg=dataclasses.replace(relexi_hit.HIT24, **overrides))


@register("hit_les_32dof")
def _hit32(**overrides) -> HITLESEnv:
    """Paper Table 1, 32-DOF configuration (N=7, 4^3 elements)."""
    return HITLESEnv(cfg=dataclasses.replace(relexi_hit.HIT32, **overrides))


@register("hit_les_reduced")
def _hit_reduced(**overrides) -> HITLESEnv:
    """CPU-friendly smoke scale (N=3, 2^3 elements, short episodes)."""
    return HITLESEnv(cfg=dataclasses.replace(relexi_hit.reduced(), **overrides))
