"""Gauss-Lobatto-Legendre tables for the plain HIT reference: nodes,
weights, the Lagrange derivative matrix and the interpolation matrices, in
float64 numpy.  A frozen copy of the port's `cfd/gll.py`: the reference
imports nothing of the program."""
from __future__ import annotations

import functools

import numpy as np


def _legendre_and_derivative(n: int, x: np.ndarray):
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


@functools.lru_cache(maxsize=16)
def nodes_weights(n_poly: int) -> tuple[np.ndarray, np.ndarray]:
    """The n_poly + 1 GLL nodes on [-1, 1] (roots of (1 - x^2) P'_N by
    Newton from Chebyshev-Gauss-Lobatto points) and their weights
    2 / (N (N + 1) P_N(x)^2)."""
    n = n_poly
    x = -np.cos(np.pi * np.arange(n + 1) / n)
    for _ in range(100):
        p, dp = _legendre_and_derivative(n, x)
        q = (1.0 - x**2) * dp
        dq = -n * (n + 1) * p
        dx = np.where(np.abs(dq) > 0, q / dq, 0.0)
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[-1] = -1.0, 1.0
    x = np.sort(x)
    p, _ = _legendre_and_derivative(n, x)
    return x, 2.0 / (n * (n + 1) * p**2)


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    w = np.ones(len(x))
    for j in range(len(x)):
        for i in range(len(x)):
            if i != j:
                w[j] /= x[j] - x[i]
    return w


@functools.lru_cache(maxsize=16)
def derivative_matrix(n_poly: int) -> np.ndarray:
    """D_ij = l'_j(x_i) on the GLL nodes."""
    x, _ = nodes_weights(n_poly)
    wb = _barycentric_weights(x)
    n = n_poly + 1
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                d[i, j] = wb[j] / wb[i] / (x[i] - x[j])
        d[i, i] = -np.sum(d[i, :])
    return d


def interpolation_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """V_ij = l_j(x_to_i)."""
    x_from = np.asarray(x_from, dtype=np.float64)
    wb = _barycentric_weights(x_from)
    v = np.zeros((len(x_to), len(x_from)))
    for i, xt in enumerate(np.asarray(x_to, dtype=np.float64)):
        diff = xt - x_from
        exact = np.where(np.abs(diff) < 1e-14)[0]
        if len(exact):
            v[i, exact[0]] = 1.0
        else:
            t = wb / diff
            v[i, :] = t / np.sum(t)
    return v


def to_uniform_matrix(n_poly: int) -> np.ndarray:
    """GLL nodes -> the element's n cell-centred equispaced points."""
    x_gll, _ = nodes_weights(n_poly)
    n = n_poly + 1
    return interpolation_matrix(x_gll, -1.0 + (2.0 * np.arange(n) + 1.0) / n)


def fourier_eval_matrix(n_modes: int, x_target: np.ndarray,
                        length: float) -> np.ndarray:
    """E (len(x_target), n_modes): a 1-D Fourier series of FFT-ordered
    modes evaluated at x_target, u(x) = sum_k uhat_k exp(2 pi i k x / L) / n."""
    k = np.fft.fftfreq(n_modes, d=1.0 / n_modes)
    return np.exp(2.0j * np.pi * np.outer(x_target, k) / length) / n_modes
