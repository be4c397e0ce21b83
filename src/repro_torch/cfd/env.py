"""The HIT LES reinforcement-learning environment (paper Sec. 5.2), PyTorch
port of `repro.cfd.env`.

State  : coarse-scale conservative flow field on the DG mesh.
Obs    : per-element velocity nodal values, (K^3, n, n, n, 3), u_rms-normalized.
Action : per-element Smagorinsky coefficient C_s in [0, cs_max], (K^3,).
Reward : paper Eqs. (4)-(5) against the reference spectrum.

Functions of tensors; batching over environments is a leading axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import solver, spectra
from .equations import conservative_to_primitive
from .solver import HITConfig


class EnvState(NamedTuple):
    u: torch.Tensor       # conservative nodal state (..., K,K,K,n,n,n,5)
    t_step: torch.Tensor  # RL step counter (int32)


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def observe(u: torch.Tensor, cfg: HITConfig) -> torch.Tensor:
    """Element-local observations: (..., K^3, n, n, n, 3)."""
    _, vel, _, _ = conservative_to_primitive(u)
    batch = tuple(vel.shape[: vel.ndim - 7])
    k, n = cfg.n_elem, cfg.n_poly + 1
    return vel.reshape(batch + (k**3, n, n, n, 3)) / cfg.u_rms


def reset_from_bank(bank: torch.Tensor, index: torch.Tensor,
                    cfg: HITConfig) -> tuple[EnvState, torch.Tensor]:
    """Initialize from state `index` of the device-resident bank."""
    u = bank[index]
    state = EnvState(u=u, t_step=torch.zeros(index.shape, dtype=torch.int32,
                                             device=u.device))
    return state, observe(u, cfg)


def step(state: EnvState, action: torch.Tensor, cfg: HITConfig,
         e_dns: torch.Tensor) -> StepResult:
    """One MDP transition: apply per-element C_s, advance Delta t_RL, reward.

    Solver blow-up guard: if the advanced state goes non-finite (an
    under-resolved LES with an exploratory C_s can blow up), the transition
    reverts to the previous state and the agent receives the reward floor
    (-1), so NaN never reaches the gradient."""
    cs = torch.clamp(action, 0.0, cfg.cs_max).reshape(
        tuple(action.shape[:-1]) + (cfg.n_elem,) * 3)
    u_next = solver.advance_rl_interval(state.u, cs, cfg)
    finite = torch.isfinite(u_next).flatten(start_dim=u_next.ndim - 7).all(-1)
    u_next = torch.where(finite[..., None, None, None, None, None, None, None],
                         u_next, state.u)
    e_les = spectra.les_spectrum(u_next, cfg)
    ell = spectra.spectral_error(e_les, e_dns, cfg.k_max)
    reward = torch.where(finite, spectra.reward_from_error(ell, cfg.alpha),
                         torch.full_like(ell, -1.0))
    t_next = state.t_step + 1
    done = t_next >= cfg.n_actions
    return StepResult(EnvState(u=u_next, t_step=t_next),
                      observe(u_next, cfg), reward, done)
