"""Energy spectra: nodal->uniform interpolation, shell-averaged FFT spectrum,
and the synthetic von Karman-Pao reference spectrum standing in for the
paper's DNS ground truth (PyTorch port of `repro.cfd.spectra`)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gll, tables
from .dgsem import DGParams
from .equations import conservative_to_primitive
from .solver import HITConfig


def nodal_to_uniform(q: torch.Tensor, dg: DGParams) -> torch.Tensor:
    """Interpolate nodal DG field (..., K,K,K, n,n,n, C) to the globally
    uniform (cell-centered) grid (..., K*n, K*n, K*n, C)."""
    v = tables.table(gll.to_uniform_matrix, dg.n_poly, device=q.device,
                     dtype=q.dtype)
    for axis_offset in range(3):
        axis = q.ndim - 4 + axis_offset
        q = torch.movedim(torch.movedim(q, axis, -1) @ v.T, -1, axis)
    nd = q.ndim
    perm = list(range(nd - 7)) + [nd - 7, nd - 4, nd - 6, nd - 3, nd - 5,
                                  nd - 2, nd - 1]
    q = q.permute(perm)
    batch = tuple(q.shape[: nd - 7])
    k, n, c = dg.n_elem, dg.n, q.shape[-1]
    return q.reshape(batch + (k * n, k * n, k * n, c))


@functools.lru_cache(maxsize=32)
def _shell_bins(n_grid: int) -> tuple[np.ndarray, int, np.ndarray]:
    """Integer shell index |k| for an rfft 3-D grid, and the number of shells."""
    k1 = np.fft.fftfreq(n_grid, d=1.0 / n_grid)
    kr = np.fft.rfftfreq(n_grid, d=1.0 / n_grid)
    kx, ky, kz = np.meshgrid(k1, k1, kr, indexing="ij")
    k_mag = np.sqrt(kx**2 + ky**2 + kz**2)
    shells = np.rint(k_mag).astype(np.int32)
    n_shells = int(shells.max()) + 1
    # rfft stores half the spectrum: weight interior kz planes twice.
    weight = np.where((kz == 0) | (2 * kz == n_grid), 1.0, 2.0)
    return shells, n_shells, weight


def _shell_weight(n_grid: int) -> np.ndarray:
    """The rfft half-spectrum weights of `_shell_bins`."""
    return _shell_bins(n_grid)[2]


@functools.lru_cache(maxsize=32)
def _shell_matrix(n_grid: int) -> np.ndarray:
    """(n_grid^2 * (n_grid//2+1), n_shells) one-hot shell membership."""
    shells, n_shells, _ = _shell_bins(n_grid)
    return np.eye(n_shells, dtype=np.float32)[shells.reshape(-1)]


def shell_sum(density: torch.Tensor, n_grid: int) -> torch.Tensor:
    """Sum an rfft-grid field (..., N, N, N//2+1) into integer |k| shells.

    A one-hot matmul, not `index_add_`: CUDA atomics would change the order
    of the sum from run to run."""
    onehot = tables.table(_shell_matrix, n_grid, device=density.device,
                          dtype=density.dtype)
    flat = density.reshape(density.shape[:-3] + (-1,))
    return flat @ onehot


def energy_spectrum(vel_uniform: torch.Tensor) -> torch.Tensor:
    """Shell-averaged kinetic-energy spectrum E(k) of (..., N,N,N,3) velocity,
    normalized such that sum_k E(k) = 0.5 <|v|^2> (TKE)."""
    n = vel_uniform.shape[-2]
    vhat = torch.fft.rfftn(vel_uniform, dim=(-4, -3, -2)) / (n**3)
    w = tables.table(_shell_weight, n, device=vel_uniform.device,
                     dtype=vel_uniform.dtype)
    e_density = 0.5 * torch.sum(torch.abs(vhat) ** 2, dim=-1) * w
    return shell_sum(e_density, n)


def vkp_spectrum(k: np.ndarray, u_rms: float, k_peak: float,
                 k_eta: float) -> np.ndarray:
    """von Karman-Pao model spectrum, normalized to sum (over the discrete
    shells) to 1.5 u_rms^2 — the synthetic E_DNS(k)."""
    k = np.asarray(k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        shape = (k / k_peak) ** 4 / (1.0 + (k / k_peak) ** 2) ** (17.0 / 6.0)
        spec = shape * np.exp(-2.0 * (k / k_eta) ** 2)
    spec = np.where(k > 0, spec, 0.0)
    tke = 1.5 * u_rms**2
    return spec * (tke / max(np.sum(spec), 1e-300))


def reference_spectrum(cfg: HITConfig) -> np.ndarray:
    """E_DNS(k) on the shells of the LES grid (index = integer wavenumber)."""
    _, n_shells, _ = _shell_bins(cfg.dg.n_dof_dir)
    k = np.arange(n_shells, dtype=np.float64)
    return vkp_spectrum(k, cfg.u_rms, cfg.k_peak, cfg.k_eta)


def les_spectrum(u: torch.Tensor, cfg: HITConfig) -> torch.Tensor:
    """Instantaneous E_LES(k) from a conservative nodal state."""
    _, vel, _, _ = conservative_to_primitive(u)
    return energy_spectrum(nodal_to_uniform(vel, cfg.dg))


def spectral_error(e_les: torch.Tensor, e_dns: torch.Tensor,
                   k_max: int) -> torch.Tensor:
    """Paper Eq. (4): mean relative squared spectrum error over k in [1, k_max]."""
    sl = slice(1, k_max + 1)
    rel = (e_dns[..., sl] - e_les[..., sl]) / e_dns[..., sl]
    return torch.mean(rel**2, dim=-1)


def reward_from_error(ell: torch.Tensor, alpha: float) -> torch.Tensor:
    """Paper Eq. (5) (sign-corrected): r = 2 exp(-l/alpha) - 1."""
    return 2.0 * torch.exp(-ell / alpha) - 1.0
