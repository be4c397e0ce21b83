"""Equilibrium wall model: Reichardt's law of the wall inverted for the wall
stress, as the CUDA kernel (`csrc/wall_model.cu`) and its plain PyTorch
version.

`wall_model_tau` replaces the Pallas TPU kernel
`repro/kernels/wall_model.py:wall_model_tau`; `wall_model_tau_plain` is the
port of its oracle `repro/kernels/ref.py:wall_model_tau`, in the same order
of operations.  The dispatch follows the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
`wall_model_tau.launches` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "wall_model.cu"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def reichardt_uplus(y_plus, kappa: float = 0.41, xp=torch):
    """Reichardt's composite law of the wall u+(y+): viscous sublayer
    (u+ = y+), buffer layer and log law in one formula.  `xp` is `torch`
    for tensors or `numpy` for the config-time reference profile."""
    return (xp.log1p(kappa * y_plus) / kappa
            + 7.8 * (1.0 - xp.exp(-y_plus / 11.0)
                     - (y_plus / 11.0) * xp.exp(-y_plus / 3.0)))


def wall_model_tau_plain(u_par: torch.Tensor, rho_w: torch.Tensor, *,
                         y_m: float, nu: float, kappa: float = 0.41,
                         iters: int = 8) -> torch.Tensor:
    """tau_w = rho u_tau^2 by inverting u_par/u_tau = u+(y_m u_tau / nu).

    Geometrically damped fixed point from the laminar guess: in the viscous
    limit (u+ ~ y+) it lands on the laminar stress mu u_par / y_m in one
    round, and in the log layer it contracts.  Float32 math; the result has
    u_par's dtype and shape (rho_w broadcasts against u_par)."""
    f32 = torch.float32
    up = u_par.to(f32)
    u_tau = torch.sqrt(nu * up / y_m + 1e-12)  # laminar initial guess
    for _ in range(iters):
        y_plus = y_m * u_tau / nu
        u_plus = torch.clamp_min(reichardt_uplus(y_plus, kappa), 1e-6)
        u_tau = torch.sqrt(u_tau * up / u_plus + 1e-14)
    return (rho_w.to(f32) * u_tau**2).to(u_par.dtype)


def _check_inputs(u_par: torch.Tensor, rho_w: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if u_par.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wall model kernel takes float32 or bfloat16, "
                        f"got {u_par.dtype}")
    if rho_w.dtype != u_par.dtype or rho_w.shape != u_par.shape:
        raise ValueError(f"rho_w must be {tuple(u_par.shape)} {u_par.dtype}, "
                         f"got {tuple(rho_w.shape)} {rho_w.dtype}")
    if rho_w.device != u_par.device:
        raise ValueError(f"rho_w is on {rho_w.device}, u_par on "
                         f"{u_par.device}")
    if not (u_par.is_contiguous() and rho_w.is_contiguous()):
        raise ValueError("u_par and rho_w must be contiguous")


def wall_model_tau(u_par: torch.Tensor, rho_w: torch.Tensor, *, y_m: float,
                   nu: float, kappa: float = 0.41,
                   iters: int = 8) -> torch.Tensor:
    """tau_w for any batch of wall-face points; same contract as the plain
    version, except that a CUDA rho_w must have u_par's shape and dtype and
    both must be contiguous (a strided view, e.g. rho = u[..., 0], raises:
    the caller copies with `.contiguous()`)."""
    if u_par.device.type == "cpu":
        return wall_model_tau_plain(u_par, rho_w, y_m=y_m, nu=nu, kappa=kappa,
                                    iters=iters)
    if u_par.device.type != "cuda":
        raise ValueError(f"no wall model kernel for device {u_par.device}")
    _check_inputs(u_par, rho_w)
    out = torch.empty_like(u_par)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(u_par.device).cuda_stream
    _build.launcher(_SOURCE, "wall_model", _ARGTYPES)(
        u_par.data_ptr(), rho_w.data_ptr(), out.data_ptr(), out.numel(),
        int(u_par.dtype == torch.bfloat16), float(y_m), float(nu),
        float(kappa), int(iters), stream)
    wall_model_tau.launches += 1
    return out


wall_model_tau.launches = 0
