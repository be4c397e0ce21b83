"""Forced 1-D viscous Burgers DGSEM, the second RL control scenario (PyTorch
port of `repro.cfd.burgers1d`).

An under-resolved Burgers LES needs an eddy viscosity to keep the k^-2 shock
spectrum from piling up at the grid cutoff, the role the Smagorinsky C_s
plays in the 3-D HIT case.  The RL action is a per-element eddy-viscosity
coefficient C with nu_t = (C * Delta)^2 |du/dx|; the reward is the spectral
error of paper Eqs. 4-5 against a synthetic k^-2 reference spectrum.

The discretization is the GLL machinery of the 3-D solver at 1-D:

  * nodal layout u.shape = (..., K, n, 1): element axis -3, GLL node axis
    -2, channel axis last; `...` carries the environment batch,
  * split-form volume terms with the entropy-conservative Burgers two-point
    flux f#(a, b) = (a^2 + a b + b^2) / 6, local Lax-Friedrichs surface
    fluxes, BR1 central viscous interfaces,
  * the HIT solver's Carpenter-Kennedy RK5(4) low-storage integrator,
  * linear forcing of the velocity fluctuations with a proportional energy
    controller, so the turbulence is statistically stationary.

No kernel of the TPU package lies on this path: the RHS is staged PyTorch,
about forty small operations a call, looped in Python over the substeps.

A field split over ranks by its elements (`core.collectives.ElemSplit`,
passed as `split`) takes its five element rolls through the split's `roll`
and its forcing's two quadrature sums through one all-reduce a row; with
`split=None` the code is the unsplit one.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import gll, tables
from .solver import _RK_A, _RK_B, _rounded


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    """Static configuration of one forced Burgers LES environment."""

    n_poly: int = 7
    n_elem: int = 12
    length: float = 2.0 * np.pi
    # flow
    nu: float = 5e-3
    u_rms: float = 1.0
    # forcing (linear forcing + energy proportional controller)
    forcing_a0: float = 0.3
    # time stepping
    cfl: float = 0.35
    dt_rl: float = 0.1
    t_end: float = 5.0
    # reward (same form as paper Table 1)
    k_max: int = 12
    alpha: float = 0.4
    c_max: float = 0.5        # per-element eddy-viscosity coefficient bound
    # synthetic reference spectrum: E(k) ~ k^-2 exp(-2 (k/k_eta)^2)
    k_eta: float = 24.0

    @property
    def n(self) -> int:
        return self.n_poly + 1

    @property
    def dx(self) -> float:
        return self.length / self.n_elem

    @property
    def jac(self) -> float:
        return 2.0 / self.dx

    @property
    def n_dof(self) -> int:
        return self.n_elem * self.n

    @property
    def k_energy(self) -> float:
        """Target energy 1/2 u_rms^2 (1-D: one velocity component)."""
        return 0.5 * self.u_rms**2

    @property
    def delta_filter(self) -> float:
        return self.dx / self.n

    @property
    def dt(self) -> float:
        """Fixed stable timestep (DG CFL ~ 1/(2N+1)) that divides dt_rl."""
        v_max = 4.0 * self.u_rms  # Burgers wave speed ~ max|u|
        dt_stable = self.cfl * self.dx / (v_max * (2 * self.n_poly + 1))
        n_sub = int(np.ceil(self.dt_rl / dt_stable))
        return self.dt_rl / n_sub

    @property
    def n_substeps(self) -> int:
        return int(round(self.dt_rl / self.dt))

    @property
    def n_actions(self) -> int:
        return int(round(self.t_end / self.dt_rl))

    def operators(self, device: torch.device | str = "cpu",
                  dtype: torch.dtype = torch.float32) -> dict:
        """Operator tensors on `device` in `dtype`: D (n, n), w (n,), made
        once per (config, device, dtype) (`tables.table`), and the
        endpoint inverse weights."""
        _, w = gll.gll_nodes_weights(self.n_poly)
        return {
            "D": tables.table(gll.lagrange_derivative_matrix, self.n_poly,
                              device=device, dtype=dtype),
            "inv_w_end": (float(1.0 / w[0]), float(1.0 / w[-1])),
            "w": tables.table(gll.gll_weights, self.n_poly, device=device,
                              dtype=dtype),
        }


# --- spectra ---------------------------------------------------------------
def nodal_to_uniform(u: torch.Tensor, cfg: BurgersConfig) -> torch.Tensor:
    """Interpolate the nodal field (..., K, n, 1) to the cell-centered
    uniform grid (..., K*n), the FFT-ready 1-D grid."""
    v = tables.table(gll.to_uniform_matrix, cfg.n_poly, device=u.device,
                     dtype=u.dtype)
    q = u[..., 0] @ v.T                                  # (..., K, n)
    return q.reshape(tuple(q.shape[:-2]) + (cfg.n_dof,))


def energy_spectrum(u_uniform: torch.Tensor) -> torch.Tensor:
    """Shell spectrum E(k) of (..., N) velocity, sum_k E(k) = 1/2 <u^2>."""
    n = u_uniform.shape[-1]
    uhat = torch.fft.rfft(u_uniform, dim=-1) / n
    return 0.5 * torch.abs(uhat) ** 2 * tables.table(
        _rfft_weights, n, device=u_uniform.device, dtype=u_uniform.dtype)


def _rfft_weights(n: int) -> np.ndarray:
    """Weights of the n // 2 + 1 rfft modes of n points in the spectrum:
    2 for the modes that stand for a conjugate pair too, 1 for the mean
    and, for even n, the Nyquist mode."""
    weight = np.full(n // 2 + 1, 2.0)
    weight[0] = 1.0
    if n % 2 == 0:
        weight[-1] = 1.0
    return weight


def reference_spectrum(cfg: BurgersConfig) -> np.ndarray:
    """Synthetic target E(k) ~ k^-2 exp(-2(k/k_eta)^2), normalized so the
    discrete shells integrate to 1/2 u_rms^2."""
    k = np.arange(cfg.n_dof // 2 + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        spec = np.where(k > 0, k**-2.0, 0.0) * np.exp(-2.0 * (k / cfg.k_eta) ** 2)
    spec = spec * (cfg.k_energy / max(np.sum(spec), 1e-300))
    return spec


def les_spectrum(u: torch.Tensor, cfg: BurgersConfig) -> torch.Tensor:
    return energy_spectrum(nodal_to_uniform(u, cfg))


# --- initial states --------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _fourier_to_gll_matrix(cfg: BurgersConfig) -> np.ndarray:
    """Complex (K*n, n_dof) matrix evaluating the uniform-grid Fourier series
    at the global GLL coordinates."""
    x_gll, _ = gll.gll_nodes_weights(cfg.n_poly)
    offsets = (np.arange(cfg.n_elem) + 0.5) * cfg.dx
    coords = (offsets[:, None] + 0.5 * cfg.dx * x_gll[None, :]).reshape(-1)
    return gll.fourier_eval_matrix(cfg.n_dof, coords, cfg.length)


def initial_states(theta: torch.Tensor, cfg: BurgersConfig) -> torch.Tensor:
    """States (N, K, n, 1) from random phases theta (N, n_dof//2 + 1) in
    [0, 2 pi): a field with the exact target spectrum on the uniform grid,
    evaluated at the GLL nodes (1-D Rogallo)."""
    n_grid = cfg.n_dof
    n_half = n_grid // 2 + 1
    dev = theta.device
    amp = torch.sqrt(torch.as_tensor(reference_spectrum(cfg),
                                     dtype=torch.float32, device=dev))
    # E(k) = |uhat_k/n|^2 for interior shells (weight 2) -> amplitude sqrt(E)
    amp[0] = 0.0
    if n_grid % 2 == 0:
        amp[-1] = 0.0  # drop the sign-ambiguous Nyquist mode
    vhat = amp * torch.exp(1j * theta.to(torch.complex64))
    # full FFT ordering with Hermitian symmetry; fourier_eval_matrix divides
    # by n, so scale back up to FFT convention
    full = torch.zeros((theta.shape[0], n_grid), dtype=torch.complex64,
                       device=dev)
    full[:, :n_half] = vhat * n_grid
    full[:, n_grid - torch.arange(1, n_half, device=dev)] = torch.conj(
        vhat[:, 1:] * n_grid)
    mat = torch.as_tensor(_fourier_to_gll_matrix(cfg), dtype=torch.complex64,
                          device=dev)
    u_gll = torch.real(full @ mat.T).to(torch.float32)
    return u_gll.reshape(theta.shape[0], cfg.n_elem, cfg.n, 1)


def make_state_bank(gen: torch.Generator, cfg: BurgersConfig,
                    n_states: int) -> torch.Tensor:
    """Bank of initial states (n_states, K, n, 1) on the generator's
    device, its phases drawn from `gen`."""
    theta = 2.0 * np.pi * torch.rand((n_states, cfg.n_dof // 2 + 1),
                                     generator=gen, device=gen.device)
    return initial_states(theta, cfg)


# --- solver ----------------------------------------------------------------
def _surface_lift(vol: torch.Tensor, jump_right: torch.Tensor,
                  jump_left: torch.Tensor,
                  inv_w_end: tuple[float, float]) -> torch.Tensor:
    """Strong-form DGSEM surface correction along the (last) node axis;
    writes into `vol`, a fresh tensor of the caller's."""
    inv_w0, inv_wn = inv_w_end
    vol[..., -1] += inv_wn * jump_right
    vol[..., 0] += -inv_w0 * jump_left
    return vol


def _roll(x: torch.Tensor, shifts: int, split) -> torch.Tensor:
    """The periodic roll of (..., K) along the element axis: through
    `split` on a split field, else `torch.roll`."""
    if split is not None:
        return split.roll(x, shifts, x.ndim - 1)
    return torch.roll(x, shifts=shifts, dims=-1)


def dg_gradient(us: torch.Tensor, cfg: BurgersConfig, ops: dict,
                split=None) -> torch.Tensor:
    """BR1 gradient du/dx of the nodal scalar field us (..., K, n)."""
    vol = us @ ops["D"].T
    lo, hi = us[..., 0], us[..., -1]
    u_right = _roll(lo, -1, split)  # neighbor across face e|e+1
    u_star_right = 0.5 * (hi + u_right)
    u_star_left = _roll(u_star_right, 1, split)
    du = _surface_lift(vol, u_star_right - hi, u_star_left - lo,
                       ops["inv_w_end"])
    return du * cfg.jac


def burgers_rhs(us: torch.Tensor, c_nodes: torch.Tensor, cfg: BurgersConfig,
                ops: dict, split=None) -> torch.Tensor:
    """-d/dx(u^2/2 - nu_eff du/dx) + forcing on the nodal field us
    (..., K, n); with `split` us and c_nodes are this rank's elements."""
    d_matrix = ops["D"]
    # --- advective: entropy-conservative split form + LLF surface ----------
    a, b = us[..., :, None], us[..., None, :]
    f_sharp = (a * a + a * b + b * b) / 6.0
    vol_adv = 2.0 * torch.sum(d_matrix * f_sharp, dim=-1)
    lo, hi = us[..., 0], us[..., -1]
    u_right = _roll(lo, -1, split)
    lam = torch.maximum(torch.abs(hi), torch.abs(u_right))
    f_star_adv = 0.25 * (hi**2 + u_right**2) - 0.5 * lam * (u_right - hi)
    # --- viscous: BR1 gradient, eddy viscosity, central surface ------------
    du = dg_gradient(us, cfg, ops, split)
    nu_t = (c_nodes * cfg.delta_filter) ** 2 * torch.abs(du)
    f_visc = (cfg.nu + nu_t) * du
    vol_visc = f_visc @ d_matrix.T
    fv_lo, fv_hi = f_visc[..., 0], f_visc[..., -1]
    f_star_visc = 0.5 * (fv_hi + _roll(fv_lo, -1, split))
    # --- combined strong-form divergence -----------------------------------
    vol = vol_adv - vol_visc
    f_nodes_lo = 0.5 * lo**2 - fv_lo
    f_nodes_hi = 0.5 * hi**2 - fv_hi
    f_star = f_star_adv - f_star_visc
    f_star_left = _roll(f_star, 1, split)
    div = _surface_lift(vol, f_star - f_nodes_hi, f_star_left - f_nodes_lo,
                        ops["inv_w_end"]) * cfg.jac
    rhs = -div
    # --- linear forcing on fluctuations with energy controller -------------
    # whole-domain quadrature sums: on a split field the ranks' sums, added
    # in one all-reduce; divided by the whole domain's element count
    w = ops["w"] * 0.5  # reference [-1, 1] -> unit mass
    u_sum = torch.sum(us * w, dim=(-2, -1))
    k_sum = 0.5 * torch.sum(us**2 * w, dim=(-2, -1))
    if split is not None:
        u_sum, k_sum = split.all_reduce_(torch.stack([u_sum, k_sum]))
    u_mean = u_sum / cfg.n_elem
    fluct = us - u_mean[..., None, None]
    k_now = k_sum / cfg.n_elem
    a_eff = cfg.forcing_a0 * torch.clamp(
        cfg.k_energy / torch.clamp_min(k_now, 0.1 * cfg.k_energy), 0.0, 3.0)
    return rhs + a_eff[..., None, None] * fluct


def rk_substep(us: torch.Tensor, c_nodes: torch.Tensor, cfg: BurgersConfig,
               ops: dict, split=None) -> torch.Tensor:
    """One Carpenter-Kennedy RK5(4) low-storage step of size cfg.dt."""
    dt = _rounded(cfg.dt, us.dtype)
    du = torch.zeros_like(us)
    for stage in range(5):
        rhs = burgers_rhs(us, c_nodes, cfg, ops, split)
        du = _rounded(_RK_A[stage], us.dtype) * du + dt * rhs
        us = us + _rounded(_RK_B[stage], us.dtype) * du
    return us


def advance_rl_interval(u: torch.Tensor, c_elem: torch.Tensor,
                        cfg: BurgersConfig, split=None) -> torch.Tensor:
    """Advance the Burgers LES by Delta t_RL under fixed per-element C (one
    MDP transition).  u: (..., K, n, 1), c_elem: (..., K); with `split`
    this rank's elements of both."""
    ops = cfg.operators(u.device)
    c_nodes = c_elem[..., None].expand(tuple(c_elem.shape) + (cfg.n,))
    us = u[..., 0]
    for _ in range(cfg.n_substeps):
        us = rk_substep(us, c_nodes, cfg, ops, split)
    return us[..., None]
