"""Gauss-Lobatto-Legendre (GLL) quadrature machinery for the DGSEM solver.

Everything in this module is *config-time* numpy: nodes, weights, derivative
and interpolation operators are computed once per configuration and handed to
the solver as small constant tensors (they are tiny: (N+1)x(N+1)).  This is a
copy of `repro.cfd.gll`, kept so that the PyTorch package imports nothing of
the JAX one.

References: Kopriva, "Implementing Spectral Methods for PDEs" (2009);
FLEXI (Krais et al. 2021) uses the same collocated GLL-DGSEM operators.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "gll_nodes_weights",
    "lagrange_derivative_matrix",
    "lagrange_interpolation_matrix",
    "equispaced_nodes",
    "fourier_eval_matrix",
]


def _legendre_and_derivative(n: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Legendre polynomial P_n(x) and derivative P'_n(x) via recurrence."""
    p_nm2 = np.ones_like(x)
    p_nm1 = x.copy()
    if n == 0:
        return p_nm2, np.zeros_like(x)
    if n == 1:
        return p_nm1, np.ones_like(x)
    for k in range(2, n + 1):
        p_n = ((2 * k - 1) * x * p_nm1 - (k - 1) * p_nm2) / k
        p_nm2, p_nm1 = p_nm1, p_n
    dp_n = n * (x * p_nm1 - p_nm2) / (x**2 - 1.0 + 1e-300)
    return p_nm1, dp_n


@functools.lru_cache(maxsize=64)
def gll_nodes_weights(n_poly: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and quadrature weights of the (n_poly+1)-point GLL rule on [-1, 1].

    The interior nodes are the roots of P'_N; endpoints are +-1.
    Weights: w_i = 2 / (N(N+1) P_N(x_i)^2).
    """
    n = n_poly
    if n < 1:
        raise ValueError("polynomial degree must be >= 1")
    # Chebyshev-Gauss-Lobatto initial guess, then Newton on (1-x^2) P'_N(x).
    x = -np.cos(np.pi * np.arange(n + 1) / n)
    for _ in range(100):
        p, dp = _legendre_and_derivative(n, x)
        # q(x) = (1 - x^2) P'_N(x); roots of q are the GLL nodes.
        # q'(x) = -2x P'_N + (1-x^2) P''_N; use Legendre ODE:
        # (1-x^2) P''_N = 2x P'_N - N(N+1) P_N  =>  q' = -N(N+1) P_N
        q = (1.0 - x**2) * dp
        dq = -n * (n + 1) * p
        dx = np.where(np.abs(dq) > 0, q / dq, 0.0)
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[-1] = -1.0, 1.0
    x = np.sort(x)
    p, _ = _legendre_and_derivative(n, x)
    w = 2.0 / (n * (n + 1) * p**2)
    return x, w


def gll_weights(n_poly: int) -> np.ndarray:
    """The quadrature weights of `gll_nodes_weights` alone."""
    return gll_nodes_weights(n_poly)[1]


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    n = len(x)
    w = np.ones(n)
    for j in range(n):
        for i in range(n):
            if i != j:
                w[j] /= x[j] - x[i]
    return w


@functools.lru_cache(maxsize=64)
def lagrange_derivative_matrix(n_poly: int) -> np.ndarray:
    """D_ij = l'_j(x_i) for the Lagrange basis on the GLL nodes."""
    x, _ = gll_nodes_weights(n_poly)
    wb = _barycentric_weights(x)
    n = n_poly + 1
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                d[i, j] = wb[j] / wb[i] / (x[i] - x[j])
        d[i, i] = -np.sum(d[i, :])
    return d


def lagrange_interpolation_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """V_ij = l_j(x_to_i): interpolates nodal values on x_from to points x_to."""
    wb = _barycentric_weights(np.asarray(x_from, dtype=np.float64))
    x_from = np.asarray(x_from, dtype=np.float64)
    x_to = np.asarray(x_to, dtype=np.float64)
    v = np.zeros((len(x_to), len(x_from)))
    for i, xt in enumerate(x_to):
        diff = xt - x_from
        exact = np.where(np.abs(diff) < 1e-14)[0]
        if len(exact):
            v[i, exact[0]] = 1.0
        else:
            t = wb / diff
            v[i, :] = t / np.sum(t)
    return v


def equispaced_nodes(n_points: int) -> np.ndarray:
    """Cell-centered equispaced points on [-1, 1] (n_points of them).

    Cell-centered (not including endpoints) so that assembling K elements of
    n_points each gives a globally uniform, periodic-FFT-ready grid.
    """
    return -1.0 + (2.0 * np.arange(n_points) + 1.0) / n_points


def to_uniform_matrix(n_poly: int) -> np.ndarray:
    """(n, n) interpolation from the n = n_poly + 1 GLL nodes of an element
    to its n cell-centered equispaced points."""
    x_gll, _ = gll_nodes_weights(n_poly)
    return lagrange_interpolation_matrix(x_gll, equispaced_nodes(n_poly + 1))


def fourier_eval_matrix(n_modes: int, x_target: np.ndarray, length: float) -> np.ndarray:
    """Complex matrix E (len(x_target) x n_modes) evaluating a 1-D Fourier
    series with `n_modes` standard FFT-ordered modes at arbitrary points
    x_target in [0, length).  u(x) = sum_k uhat_k exp(2 pi i k x / L) / n.
    """
    k = np.fft.fftfreq(n_modes, d=1.0 / n_modes)  # integer wavenumbers
    phase = 2.0j * np.pi * np.outer(x_target, k) / length
    return np.exp(phase) / n_modes
