"""The LM kernels' implementation dispatch (port of
`repro/kernels/ops.py:attention` / `gated_linear_scan`).

`impl` picks the form:
  "kernel"   the kernel's wrapper: the CUDA kernel on a CUDA tensor (or an
             error), its plain version on a CPU tensor
  "chunked"  the plain chunked form on any device (`mha_chunked`,
             `linear_scan_chunked`)
  "naive"    attention through the whole logits matrix (`mha`)
  "scan"     the step-by-step recurrence (`linear_scan_sequential`)
As in the JAX package, the two plain scan forms return o in float32 and the
kernel returns it in q's dtype.
"""
from __future__ import annotations

import torch

from . import flash_attention as fa
from . import linear_scan as ls


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              impl: str = "kernel", block_k: int = 1024) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), kv (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if impl == "kernel":
        return fa.flash_attention(q, k, v, **kw)
    if impl == "chunked":
        return fa.mha_chunked(q, k, v, block_k=min(block_k, k.shape[2]), **kw)
    if impl == "naive":
        return fa.mha(q, k, v, **kw)
    raise ValueError(f"unknown attention impl: {impl}")


def gated_linear_scan(q, k, v, w, u=None, s0=None, *,
                      decay_before_read: bool = False, impl: str = "kernel",
                      chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, s_final) of the gated linear recurrence (see kernels.linear_scan)."""
    if impl == "kernel":
        return ls.linear_scan(q, k, v, w, u, s0,
                              decay_before_read=decay_before_read, chunk=chunk)
    if impl == "chunked":
        return ls.linear_scan_chunked(q, k, v, w, u, s0,
                                      decay_before_read=decay_before_read,
                                      chunk=chunk)
    if impl == "scan":
        return ls.linear_scan_sequential(q, k, v, w, u, s0,
                                         decay_before_read=decay_before_read)
    raise ValueError(f"unknown linear-scan impl: {impl}")
