"""Constant tables built on the host (numpy) as tensors on a device, made
once per (table, arguments, device, dtype).

The solvers' operator matrices, the spectra's interpolation and shell
matrices and the envs' reference profiles and spectra depend on the
configuration only.  Copying one to the card on every call is a blocking
host-to-device copy on every RL step, in which the host waits for the
card, and such a copy cannot run inside a captured CUDA graph.  `table`
makes each tensor at its first use and hands the same tensor back after;
callers read it and never write to it.  `builds()` counts the tensors
made, which the trace audit pins (`repro_torch.analysis.trace_audit`).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def table(build: Callable[..., np.ndarray], *args,
          device: torch.device | str = "cpu",
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`build(*args)` as a `dtype` tensor on `device`, made at the first
    call for this key and shared after.  `build` and `args` are the key:
    a module-level function and values that compare equal when they mean
    the same table (numbers, frozen configs), never a bound method of an
    object made per call."""
    return _made(build, args, torch.device(device), dtype)


@functools.lru_cache(maxsize=None)
def _made(build, args: tuple, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(build(*args), dtype=dtype, device=device)


def builds() -> int:
    """Tables made so far in this process, one per distinct key."""
    return _made.cache_info().misses
