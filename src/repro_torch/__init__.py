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
applies it around the rollout and each PPO epoch, forward and backward,
with cuDNN's deterministic algorithms.
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
    entry) and `torch.backends.cudnn.deterministic` to True inside the
    block, and put the caller's values back after it.  cuDNN reads the
    flags when each convolution launches, so the block must hold the
    backward pass too.  Deterministic algorithms keep ranks that run the
    same update on the same trajectory bitwise equal: on an H100 the
    weight gradient of the 1-D policy's convolutions otherwise differed
    between ranks.  Usable as a decorator."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = CONV_ALLOW_TF32, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before
