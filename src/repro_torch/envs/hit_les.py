"""HIT-LES scenario (paper Sec. 5.2) on the generic Env protocol (PyTorch
port of `repro.envs.hit_les`): a thin adapter over `repro_torch.cfd.env`
that declares the specs and owns the synthetic-DNS reference spectrum.

Registry overrides reach every `HITConfig` field, e.g.
`envs.make("hit_les_reduced", precision="bf16")` or `use_kernels=False`.

`HITLESEnv.split_x(split)` is the same env split over the ranks of a group
by its x-slabs (`SplitHITLESEnv`, a `SplitEnv`: the paper's several ranks
per environment), as the orchestrator builds it for `FleetConfig.elem_axis`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cfd import env as hit_kernel
from ..cfd import initial, spectra, tables
from ..cfd.solver import HITConfig
from ..configs import relexi_hit
from .base import (ActionSpec, EnvState, ObsSpec, SplitEnv, StepResult,
                   velocity_channels)
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
        return tables.table(spectra.reference_spectrum, self.cfg,
                            device=device)

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


class SplitHITLESEnv(SplitEnv):
    """A `HITLESEnv` split by its x-slabs, axis 1 of (B, Kx, Ky, Kz, n, n,
    n, 5) (`SplitEnv`).  It gathers the velocity, not the whole state: one
    gather a step gives both its reward and the next observation."""

    def __init__(self, env: HITLESEnv, split):
        super().__init__(env, split, env.cfg.n_elem, state_ndim=7)

    def e_dns(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return self.env.e_dns(device)

    def _observe(self, state: EnvState) -> torch.Tensor:
        return hit_kernel.observe(state.u, self.cfg, self.split)

    def _step(self, state: EnvState, action: torch.Tensor) -> StepResult:
        res = hit_kernel.step(state, action, self.cfg,
                              self.e_dns(state.u.device), self.split)
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
