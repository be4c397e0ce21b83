"""Compressible Navier-Stokes physics for the DGSEM solver (PyTorch port of
`repro.cfd.equations`).

Conservative state channels: [rho, rho*v1, rho*v2, rho*v3, E_total].
Non-dimensional setup matching the paper's HIT box: box length 2*pi,
target u_rms = 1, rho0 = 1; the Mach number sets the background pressure.
"""
from __future__ import annotations

import dataclasses

import torch

GAMMA = 1.4
R_GAS = 1.0
CP = GAMMA * R_GAS / (GAMMA - 1.0)
CV = R_GAS / (GAMMA - 1.0)


@dataclasses.dataclass(frozen=True)
class GasParams:
    mu: float  # dynamic viscosity (rho0=1 -> equals kinematic)
    prandtl: float = 0.72
    prandtl_turb: float = 0.9


def conservative_to_primitive(u: torch.Tensor):
    """-> (rho, vel[...,3], pressure, temperature)."""
    rho = u[..., 0]
    vel = u[..., 1:4] / rho[..., None]
    kinetic = 0.5 * rho * torch.sum(vel * vel, dim=-1)
    p = (GAMMA - 1.0) * (u[..., 4] - kinetic)
    temp = p / (rho * R_GAS)
    return rho, vel, p, temp


def primitive_to_conservative(rho: torch.Tensor, vel: torch.Tensor,
                              p: torch.Tensor) -> torch.Tensor:
    mom = rho[..., None] * vel
    e_tot = p / (GAMMA - 1.0) + 0.5 * rho * torch.sum(vel * vel, dim=-1)
    return torch.cat([rho[..., None], mom, e_tot[..., None]], dim=-1)


def sound_speed(rho: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(GAMMA * p / rho)


def _mom_columns(base: torch.Tensor, per_comp: torch.Tensor, p: torch.Tensor,
                 direction: int) -> torch.Tensor:
    """base * per_comp_i, with p added on the flux-direction component."""
    cols = [base * per_comp[..., i] for i in range(3)]
    cols[direction] = cols[direction] + p
    return torch.stack(cols, dim=-1)


def advective_flux(u: torch.Tensor, direction: int) -> torch.Tensor:
    """Euler flux F_d(u), channels like u."""
    _, vel, p, _ = conservative_to_primitive(u)
    vn = vel[..., direction]
    f_rho = u[..., 1 + direction]
    f_mom = _mom_columns(vn, u[..., 1:4], p, direction)
    f_e = (u[..., 4] + p) * vn
    return torch.cat([f_rho[..., None], f_mom, f_e[..., None]], dim=-1)


def lax_friedrichs_flux(u_l: torch.Tensor, u_r: torch.Tensor,
                        direction: int) -> torch.Tensor:
    """Local Lax-Friedrichs (Rusanov) numerical flux for the advective part."""
    rho_l, vel_l, p_l, _ = conservative_to_primitive(u_l)
    rho_r, vel_r, p_r, _ = conservative_to_primitive(u_r)
    lam = torch.maximum(
        torch.abs(vel_l[..., direction]) + sound_speed(rho_l, p_l),
        torch.abs(vel_r[..., direction]) + sound_speed(rho_r, p_r),
    )
    f_l = advective_flux(u_l, direction)
    f_r = advective_flux(u_r, direction)
    return 0.5 * (f_l + f_r) - 0.5 * lam[..., None] * (u_r - u_l)


def strain_rate(grad_v: torch.Tensor) -> torch.Tensor:
    """Symmetric rate-of-strain S_ij from velocity gradient (..., 3, 3);
    grad_v[..., i, j] = d v_i / d x_j."""
    return 0.5 * (grad_v + grad_v.transpose(-1, -2))


def strain_magnitude(s_ij: torch.Tensor) -> torch.Tensor:
    """|S| = sqrt(2 S_ij S_ij)  (paper Eq. 3)."""
    return torch.sqrt(2.0 * torch.sum(s_ij * s_ij, dim=(-1, -2)) + 1e-30)


def eddy_viscosity(cs: torch.Tensor, delta: float,
                   s_mag: torch.Tensor) -> torch.Tensor:
    """nu_t = (C_s * Delta)^2 |S|  with per-element C_s broadcast to nodes."""
    return (cs * delta) ** 2 * s_mag


def viscous_flux(u: torch.Tensor, grad_prim: torch.Tensor, nu_t: torch.Tensor,
                 gas: GasParams, direction: int) -> torch.Tensor:
    """Viscous + SGS flux F_v_d.

    grad_prim: gradients of (v1, v2, v3, T), shape (..., 4, 3) with the last
    axis the derivative direction.
    """
    rho, vel, _, _ = conservative_to_primitive(u)
    grad_v = grad_prim[..., 0:3, :]
    grad_t = grad_prim[..., 3, :]
    s_ij = strain_rate(grad_v)
    div_v = grad_v[..., 0, 0] + grad_v[..., 1, 1] + grad_v[..., 2, 2]
    mu_eff = gas.mu + rho * nu_t
    # tau_ij = 2 mu_eff (S_ij - 1/3 div(v) delta_ij)
    tau = 2.0 * mu_eff[..., None, None] * s_ij
    third = (2.0 / 3.0) * mu_eff * div_v
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    tau = tau - third[..., None, None] * eye
    k_eff = CP * (gas.mu / gas.prandtl + rho * nu_t / gas.prandtl_turb)
    q_d = -k_eff * grad_t[..., direction]
    tau_d = tau[..., :, direction]
    work = torch.sum(tau_d * vel, dim=-1)
    zero = torch.zeros_like(rho)
    return torch.cat([zero[..., None], tau_d, (work - q_d)[..., None]], dim=-1)


def kennedy_gruber_flux(prim_a: tuple, prim_b: tuple,
                        direction: int) -> torch.Tensor:
    """Kennedy & Gruber kinetic-energy-preserving two-point flux.

    prim_* = (rho, vel[...,3], p, e_spec) with e_spec = E/rho.

    f_rho = {rho}{u_d};  f_mom_i = {rho}{u_d}{u_i} + delta_id {p}
    f_E   = {rho}{u_d}{e} + {p}{u_d}
    """
    rho_a, vel_a, p_a, e_a = prim_a
    rho_b, vel_b, p_b, e_b = prim_b
    rho_m = 0.5 * (rho_a + rho_b)
    vel_m = 0.5 * (vel_a + vel_b)
    p_m = 0.5 * (p_a + p_b)
    e_m = 0.5 * (e_a + e_b)
    vn = vel_m[..., direction]
    f_rho = rho_m * vn
    f_mom = _mom_columns(f_rho, vel_m, p_m, direction)
    f_e = f_rho * e_m + p_m * vn
    return torch.cat([f_rho[..., None], f_mom, f_e[..., None]], dim=-1)
