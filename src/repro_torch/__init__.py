"""PyTorch/CUDA port of the Relexi reproduction, for NVIDIA Hopper (H100).

The package mirrors `repro`'s layout module for module (cfd, envs, core,
kernels, launch) so that each counterpart is easy to find.  It imports
`torch` and `numpy` only, never `jax` and never `repro`: the JAX package is
the reference the tests hold this one to.

Entry points take `device=None`, which means the GPU.  Without a GPU they
raise unless the caller asks for the CPU explicitly (`device="cpu"`, as the
tests do); no path falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> "cuda".  Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
