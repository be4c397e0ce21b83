"""Three-direction DGSEM volume derivative of an element batch, as the CUDA
kernel (`csrc/dg_derivative.cu`) and its plain PyTorch version.

`dg_derivative3` replaces the Pallas TPU kernel
`repro/kernels/dg_derivative.py:dg_derivative3`; `dg_derivative3_plain` is
three calls of the port's `dgsem.deriv_along`, which computes what the oracle
`repro/kernels/ref.py:dg_derivative3` computes.  The dispatch follows the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.  `dg_derivative3.launches` counts the calls that
launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..cfd import dgsem
from . import _build

_SOURCE = "dg_derivative.cu"
_ARGTYPES = ((ctypes.c_void_p,) * 5
             + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p))
# shared memory one block can use on Hopper (227 KB): D and one element
SMEM_BYTES = 232448


def dg_derivative3_plain(u: torch.Tensor, d_matrix: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u (B, n, n, n, C), d_matrix (n, n) -> (du0, du1, du2), du_d the
    derivative along node axis d.  Float32 math, results in u's dtype."""
    u32, d32 = u.to(torch.float32), d_matrix.to(torch.float32)
    return tuple(dgsem.deriv_along(u32, d32, d).to(u.dtype)
                 for d in range(3))


def _check_inputs(u: torch.Tensor, d_matrix: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dg_derivative3 kernel takes float32 or bfloat16, "
                        f"got {u.dtype}")
    if u.ndim != 5 or not u.shape[1] == u.shape[2] == u.shape[3]:
        raise ValueError(f"u must be (B, n, n, n, C), got {tuple(u.shape)}")
    n, c = u.shape[1], u.shape[4]
    if tuple(d_matrix.shape) != (n, n):
        raise ValueError(f"d_matrix must be ({n}, {n}), got "
                         f"{tuple(d_matrix.shape)}")
    if 4 * (n * n + n**3 * c) > SMEM_BYTES:
        raise ValueError(f"an element of n={n}, C={c} does not fit in the "
                         f"{SMEM_BYTES} bytes of shared memory of a block")
    if d_matrix.device != u.device:
        raise ValueError(f"d_matrix is on {d_matrix.device}, u on {u.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def dg_derivative3(u: torch.Tensor, d_matrix: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(du0, du1, du2) for an element batch; same contract as the plain
    version.  For a CUDA tensor D may have any float dtype (its values are
    read in float32) and an element must fit in one block's shared memory."""
    if u.device.type == "cpu":
        return dg_derivative3_plain(u, d_matrix)
    if u.device.type != "cuda":
        raise ValueError(f"no dg_derivative3 kernel for device {u.device}")
    _check_inputs(u, d_matrix)
    outs = tuple(torch.empty_like(u) for _ in range(3))
    if u.numel() == 0:
        return outs
    d32 = d_matrix.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    _build.launcher(_SOURCE, "dg_derivative3", _ARGTYPES)(
        u.data_ptr(), d32.data_ptr(), *(o.data_ptr() for o in outs),
        u.shape[0], u.shape[1], u.shape[4], int(u.dtype == torch.bfloat16),
        stream)
    dg_derivative3.launches += 1
    return outs


dg_derivative3.launches = 0
