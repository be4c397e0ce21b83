"""PyTorch/CUDA port of the Relexi reproduction, for NVIDIA Hopper (H100).

The package mirrors `repro`'s layout module for module (cfd, envs, core,
kernels, launch) so that each counterpart is easy to find.  It imports
`torch` and `numpy` only, never `jax` and never `repro`: the JAX package is
the reference the tests hold this one to.

Entry points take `device=None`, which means the GPU.  Without a GPU they
raise unless the caller asks for the CPU explicitly (`device="cpu"`, as the
tests do); no path falls back to the CPU on its own.

`CONV_ALLOW_TF32` is the package's choice of precision for the policy's
float32 convolutions (cuDNN's TF32 flag), False by default: full float32,
the precision of the reference and of every parity pin.  `conv_precision`
applies it around the rollout and each PPO epoch, forward and backward.
"""
from __future__ import annotations

import contextlib

import torch

CONV_ALLOW_TF32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> "cuda".  Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def conv_precision():
    """Set `torch.backends.cudnn.allow_tf32` to `CONV_ALLOW_TF32` (read at
    entry) inside the block and put the caller's value back after it.
    cuDNN reads the flag when each convolution launches, so the block must
    hold the backward pass too.  Usable as a decorator."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = CONV_ALLOW_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
