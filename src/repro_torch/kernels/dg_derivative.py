"""Three-direction DGSEM volume derivative of an element batch, as two CUDA
kernels (`csrc/dg_derivative_tiled.cu`, `csrc/dg_derivative.cu`) and their
plain PyTorch version.

`dg_derivative3` replaces the Pallas TPU kernel
`repro/kernels/dg_derivative.py:dg_derivative3`; `dg_derivative3_plain` is
three calls of the port's `dgsem.deriv_along`, which computes what the oracle
`repro/kernels/ref.py:dg_derivative3` computes.  The dispatch follows the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor launches
a kernel or raises.

Two instances, picked by shape (`pick_instance`): "tiled"
(`dg_derivative_tiled.cu`, specialised on n, tiles of elements staged with
16-byte copies, a node's channels computed and stored together) for
2 <= n <= 8 wherever two of its element buffers fit a block's shared
memory, "generic" (`dg_derivative.cu`, runtime n) otherwise.
`dg_derivative3.launches` counts the calls that launched a kernel,
`dg_derivative3.instance_launches` the same by instance.
"""
from __future__ import annotations

import ctypes

import torch

from ..cfd import dgsem
from . import _build

SOURCES = {"tiled": "dg_derivative_tiled.cu", "generic": "dg_derivative.cu"}
_NAMES = {"tiled": "dg_derivative3_tiled", "generic": "dg_derivative3"}
_ARGTYPES = {
    "tiled": ((ctypes.c_void_p,) * 5
              + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p)),
    "generic": ((ctypes.c_void_p,) * 5
                + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p)),
}
# shared memory one block can use on Hopper (227 KB)
SMEM_BYTES = _build.SMEM_OPTIN_BYTES
# the tiled instance's range, as csrc/dg_derivative_tiled.cu has it
TILED_N = range(2, 9)
TILED_MAX_C = 64


def tiled_smem_bytes(n: int, c: int, itemsize: int) -> int:
    """Dynamic shared memory of the tiled instance's launch for n^3 nodes
    and C channels of `itemsize` bytes with two buffers, the most it asks
    for (`dg_derivative3_tiled_smem_bytes` in its source, which the kernel
    audit holds this to on the card): elements a tile from 128 target
    threads over C / V channel pieces a node, fewer while two buffers pass
    48 KB; two buffers of the tile, each rounded up to 16 bytes, and D in
    float32."""
    v = 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1
    elem_bytes = itemsize * n**3 * c
    elems = max(1, 128 // (n**3 * max(1, c // v)))

    def two_buffers(e: int) -> int:
        return 2 * (-(-(e * elem_bytes) // 16) * 16) + 4 * n * n

    while elems > 1 and two_buffers(elems) > 48 * 1024:
        elems -= 1
    return two_buffers(elems)


def generic_smem_bytes(n: int, c: int) -> int:
    """Dynamic shared memory of the generic instance's launch: D and the
    elements of a block of 256 threads (at least one) in float32
    (`dg_derivative3_smem_bytes` in its source)."""
    per_elem = n**3 * c
    elems = max(1, 256 // per_elem) if per_elem else 1
    return 4 * (n * n + elems * per_elem)


def pick_instance(n: int, c: int, dtype: torch.dtype) -> str:
    """"tiled" for 2 <= n <= 8 and C <= 64 where its launch fits one
    block's shared memory (every shape the paths run: the channel's n = 4,
    HIT's n = 6, 32-DOF's n = 8); "generic" otherwise."""
    return ("tiled" if n in TILED_N and c <= TILED_MAX_C
            and tiled_smem_bytes(n, c, dtype.itemsize) <= SMEM_BYTES
            else "generic")


def dg_derivative3_plain(u: torch.Tensor, d_matrix: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u (B, n, n, n, C), d_matrix (n, n) -> (du0, du1, du2), du_d the
    derivative along node axis d.  Float32 math, results in u's dtype."""
    u32, d32 = u.to(torch.float32), d_matrix.to(torch.float32)
    return tuple(dgsem.deriv_along(u32, d32, d).to(u.dtype)
                 for d in range(3))


def _check_inputs(u: torch.Tensor, d_matrix: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dg_derivative3 kernel takes float32 or bfloat16, "
                        f"got {u.dtype}")
    if u.ndim != 5 or not u.shape[1] == u.shape[2] == u.shape[3]:
        raise ValueError(f"u must be (B, n, n, n, C), got {tuple(u.shape)}")
    n, c = u.shape[1], u.shape[4]
    if tuple(d_matrix.shape) != (n, n):
        raise ValueError(f"d_matrix must be ({n}, {n}), got "
                         f"{tuple(d_matrix.shape)}")
    if generic_smem_bytes(n, c) > SMEM_BYTES:
        raise ValueError(f"an element of n={n}, C={c} does not fit in the "
                         f"{SMEM_BYTES} bytes of shared memory of a block")
    if d_matrix.device != u.device:
        raise ValueError(f"d_matrix is on {d_matrix.device}, u on {u.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def dg_derivative3(u: torch.Tensor, d_matrix: torch.Tensor, *,
                   instance: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(du0, du1, du2) for an element batch; same contract as the plain
    version.  For a CUDA tensor D may have any float dtype (the tiled
    instance reads float32 or bfloat16 D as stored, anything else and the
    generic instance take a float32 copy) and an element must fit in one
    block's shared memory.  `instance` forces "tiled" or "generic" (for
    comparisons); by default `pick_instance` chooses."""
    if u.device.type == "cpu":
        return dg_derivative3_plain(u, d_matrix)
    if u.device.type != "cuda":
        raise ValueError(f"no dg_derivative3 kernel for device {u.device}")
    _check_inputs(u, d_matrix)
    n, c = u.shape[1], u.shape[4]
    kind = pick_instance(n, c, u.dtype) if instance is None else instance
    if kind not in SOURCES:
        raise ValueError(f"no dg_derivative3 instance {kind!r}")
    if kind == "tiled" and pick_instance(n, c, u.dtype) != "tiled":
        raise ValueError(f"the tiled instance does not take n={n}, C={c} "
                         f"{u.dtype}")
    outs = tuple(torch.empty_like(u) for _ in range(3))
    if u.numel() == 0:
        return outs
    stream = torch.cuda.current_stream(u.device).cuda_stream
    launch = _build.launcher(SOURCES[kind], _NAMES[kind], _ARGTYPES[kind])
    is_bf16 = int(u.dtype == torch.bfloat16)
    if kind == "tiled":
        d = (d_matrix if d_matrix.dtype in (torch.float32, torch.bfloat16)
             else d_matrix.to(torch.float32)).contiguous()
        launch(u.data_ptr(), d.data_ptr(), *(o.data_ptr() for o in outs),
               u.shape[0], n, c, is_bf16, int(d.dtype == torch.bfloat16),
               stream)
    else:
        d = d_matrix.to(torch.float32).contiguous()
        launch(u.data_ptr(), d.data_ptr(), *(o.data_ptr() for o in outs),
               u.shape[0], n, c, is_bf16, stream)
    dg_derivative3.launches += 1
    dg_derivative3.instance_launches[kind] += 1
    return outs


dg_derivative3.launches = 0
dg_derivative3.instance_launches = dict.fromkeys(SOURCES, 0)
