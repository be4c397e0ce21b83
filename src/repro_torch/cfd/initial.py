"""Initial-state generation for the HIT environment (PyTorch port of
`repro.cfd.initial`).

Divergence-free Gaussian velocity fields with the von Karman-Pao target
spectrum (Rogallo-style spectral sampling), evaluated exactly at the GLL
nodes via band-limited Fourier interpolation.  The Gaussian noise is drawn by
the caller from a `torch.Generator` (or fed in, so that a test can give both
packages the same draws).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gll, spectra, tables
from .dgsem import DGParams
from .equations import primitive_to_conservative
from .solver import HITConfig


def _wave_vectors(n_grid: int) -> np.ndarray:
    """The integer wave vectors (n, n, n//2+1, 3) of an rfft grid."""
    k1 = np.fft.fftfreq(n_grid, d=1.0 / n_grid)
    kr = np.fft.rfftfreq(n_grid, d=1.0 / n_grid)
    return np.stack(np.meshgrid(k1, k1, kr, indexing="ij"), axis=-1)


def _off_nyquist(n_grid: int) -> np.ndarray:
    """(n, n, n//2+1, 1): true on the modes off the rfft grid's Nyquist
    planes.  Those planes are zeroed: the Helmholtz projector is
    sign-ambiguous there and irfftn's Hermitian symmetrization would
    reintroduce divergence."""
    return np.all(np.abs(_wave_vectors(n_grid)) < n_grid // 2, axis=-1,
                  keepdims=True)


def _solenoidal_spectral_field(noise: torch.Tensor, n_grid: int,
                               e_target: torch.Tensor) -> torch.Tensor:
    """Divergence-free velocity field on a uniform n^3 grid with shell
    spectrum e_target (n_shells,), from Gaussian noise (..., n, n, n, 3).
    Returns (..., n, n, n, 3)."""
    shells, _, weight = spectra._shell_bins(n_grid)
    dev = noise.device
    vhat = torch.fft.rfftn(noise, dim=(-4, -3, -2))

    k_vec = tables.table(_wave_vectors, n_grid, device=dev)
    k_sq = torch.sum(k_vec**2, dim=-1, keepdim=True)
    k_sq = torch.where(k_sq == 0, torch.ones_like(k_sq), k_sq)
    vhat = vhat * tables.table(_off_nyquist, n_grid, device=dev,
                               dtype=vhat.dtype)
    # Helmholtz projection: remove the compressive component.
    proj = vhat - k_vec * torch.sum(k_vec * vhat, dim=-1, keepdim=True) / k_sq
    w = torch.as_tensor(weight, dtype=torch.float32, device=dev)
    e_density = 0.5 * torch.sum(torch.abs(proj) ** 2, dim=-1) * w / (n_grid**6)
    e_now = spectra.shell_sum(e_density, n_grid)
    scale = torch.sqrt(e_target / torch.clamp_min(e_now, 1e-30))
    scale = torch.where(e_target > 0, scale, torch.zeros_like(scale))
    idx = torch.as_tensor(shells, dtype=torch.long, device=dev)
    proj = proj * scale[..., idx][..., None]
    return torch.fft.irfftn(proj, s=(n_grid,) * 3, dim=(-4, -3, -2))


@functools.lru_cache(maxsize=16)
def _fourier_to_gll_matrix(n_grid: int, n_elem: int, n_poly: int,
                           length: float) -> np.ndarray:
    """Complex (K*n, n_grid) matrix evaluating the uniform-grid Fourier series
    at the global GLL coordinates of one direction."""
    x_gll = DGParams(n_poly, n_elem, length).node_coords().reshape(-1)
    return gll.fourier_eval_matrix(n_grid, x_gll, length)


def uniform_to_gll(field: torch.Tensor, cfg: HITConfig) -> torch.Tensor:
    """Band-limited interpolation (..., N,N,N, C) uniform -> GLL nodal layout
    (..., K,K,K, n,n,n, C)."""
    n_grid = field.shape[-2]
    mat = torch.as_tensor(
        _fourier_to_gll_matrix(n_grid, cfg.n_elem, cfg.n_poly, cfg.length),
        dtype=torch.complex64, device=field.device)
    fhat = torch.fft.fftn(field, dim=(-4, -3, -2))
    for axis_offset in range(3):
        axis = fhat.ndim - 4 + axis_offset
        fhat = torch.movedim(torch.movedim(fhat, axis, -1) @ mat.T, -1, axis)
    out = fhat.real
    batch = tuple(out.shape[: out.ndim - 4])
    k, n, c = cfg.n_elem, cfg.n_poly + 1, out.shape[-1]
    out = out.reshape(batch + (k, n, k, n, k, n, c))
    nd = out.ndim
    perm = list(range(nd - 7)) + [nd - 7, nd - 5, nd - 3, nd - 6, nd - 4,
                                  nd - 2, nd - 1]
    return out.permute(perm).contiguous()


def initial_states(noise: torch.Tensor, cfg: HITConfig) -> torch.Tensor:
    """Conservative initial states (..., K,K,K,n,n,n,5) from Gaussian noise
    (..., N, N, N, 3) with N = cfg.dg.n_dof_dir."""
    n_grid = cfg.dg.n_dof_dir
    e_target = torch.as_tensor(spectra.reference_spectrum(cfg),
                               dtype=torch.float32, device=noise.device)
    vel = uniform_to_gll(_solenoidal_spectral_field(noise, n_grid, e_target),
                         cfg)
    rho = torch.full(vel.shape[:-1], cfg.rho0, dtype=vel.dtype,
                     device=vel.device)
    p = torch.full(vel.shape[:-1], cfg.p0, dtype=vel.dtype, device=vel.device)
    return primitive_to_conservative(rho, vel, p)


def make_state_bank(gen: torch.Generator, cfg: HITConfig,
                    n_states: int) -> torch.Tensor:
    """Bank of initial states (n_states, K,K,K,n,n,n,5) on the generator's
    device; one is conventionally held out as the unseen test state
    (index -1, as in the paper)."""
    n_grid = cfg.dg.n_dof_dir
    noise = torch.randn((n_states, n_grid, n_grid, n_grid, 3), generator=gen,
                        device=gen.device, dtype=torch.float32)
    return initial_states(noise, cfg)
