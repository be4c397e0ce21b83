"""Smagorinsky eddy viscosity nu_t = (C_s Delta)^2 |S| (paper Eq. 3), as the
CUDA kernel (`csrc/smagorinsky.cu`) and its plain PyTorch version.

`smagorinsky_nut` replaces the Pallas TPU kernel
`repro/kernels/smagorinsky.py:smagorinsky_nut`; `smagorinsky_nut_plain`
composes the port's `equations.strain_rate` / `strain_magnitude` /
`eddy_viscosity`, which compute the formula of the oracle
`repro/kernels/ref.py:smagorinsky_nut`.  The dispatch follows the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.  `smagorinsky_nut.launches` counts the calls that launched
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..cfd import equations
from . import _build

_SOURCE = "smagorinsky.cu"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def smagorinsky_nut_plain(grad_v: torch.Tensor, cs: torch.Tensor,
                          delta: float) -> torch.Tensor:
    """grad_v (P, 3, 3) with grad_v[p, i, j] = d v_i / d x_j, cs (P,) ->
    nu_t (P,): float32 math, the result in grad_v's dtype.  Any views."""
    f32 = torch.float32
    s_mag = equations.strain_magnitude(equations.strain_rate(grad_v.to(f32)))
    return equations.eddy_viscosity(cs.to(f32), delta, s_mag).to(grad_v.dtype)


def _strides(grad_v: torch.Tensor, cs: torch.Tensor) -> tuple[int, int]:
    """(s_p, s_c), the point strides the kernel is handed; a single point
    has no stride of its own, and reads as a (3, 3) block."""
    if grad_v.shape[0] <= 1:
        return 9, 0
    return grad_v.stride(0), cs.stride(0)


def _check_inputs(grad_v: torch.Tensor, cs: torch.Tensor) -> None:
    """Raise on anything the kernel does not take.  grad_v is any (P, 3, 3)
    view with strides (s_p, 3, 1), s_p >= 9 (e.g. the velocity rows of a
    (P, 4, 3) gradient, s_p = 12); cs any (P,) view (stride 0 included) of
    grad_v's dtype."""
    if grad_v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Smagorinsky kernel takes float32 or bfloat16, "
                        f"got {grad_v.dtype}")
    if grad_v.ndim != 3 or tuple(grad_v.shape[1:]) != (3, 3):
        raise ValueError(f"grad_v must be (P, 3, 3), got "
                         f"{tuple(grad_v.shape)}")
    if tuple(cs.shape) != tuple(grad_v.shape[:1]) or cs.dtype != grad_v.dtype:
        raise ValueError(f"cs must be ({grad_v.shape[0]},) {grad_v.dtype}, "
                         f"got {tuple(cs.shape)} {cs.dtype}")
    if cs.device != grad_v.device:
        raise ValueError(f"cs is on {cs.device}, grad_v on {grad_v.device}")
    if grad_v.stride()[1:] != (3, 1) or _strides(grad_v, cs)[0] < 9:
        raise ValueError(f"grad_v must have strides (s_p, 3, 1) with "
                         f"s_p >= 9, got {grad_v.stride()}")


def smagorinsky_nut(grad_v: torch.Tensor, cs: torch.Tensor,
                    delta: float) -> torch.Tensor:
    """nu_t for point-flattened inputs; same contract as the plain version,
    except that a CUDA grad_v must be laid out as `_check_inputs` says (the
    velocity rows of a (P, 4, 3) gradient are read in place, no copy)."""
    if grad_v.device.type == "cpu":
        return smagorinsky_nut_plain(grad_v, cs, delta)
    if grad_v.device.type != "cuda":
        raise ValueError(f"no Smagorinsky kernel for device {grad_v.device}")
    _check_inputs(grad_v, cs)
    out = torch.empty(grad_v.shape[:1], dtype=grad_v.dtype,
                      device=grad_v.device)
    if out.numel() == 0:
        return out
    s_p, s_c = _strides(grad_v, cs)
    stream = torch.cuda.current_stream(grad_v.device).cuda_stream
    _build.launcher(_SOURCE, "smagorinsky", _ARGTYPES)(
        grad_v.data_ptr(), s_p, cs.data_ptr(), s_c, out.data_ptr(),
        out.numel(), int(grad_v.dtype == torch.bfloat16), float(delta),
        stream)
    smagorinsky_nut.launches += 1
    return out


smagorinsky_nut.launches = 0
