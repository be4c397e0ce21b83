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

On a device mesh the operands are DTensors (`parallel.sharding`), and the
kernel runs under `local_map` on each rank's local batch rows and heads
(`sharding.local_map_roles`): attention's q, k and v keep a shard of
their batch or head dim, and any other layout (a sequence shard, q's
heads split where the KV heads cannot be) is replicated first.  The
scan's operands have their heads flattened into the batch, so the models
call it inside their own shard-local function (`models/ssm.py`,
`models/rwkv.py`).
"""
from __future__ import annotations

import torch

from ..parallel.sharding import Roles, local_map_roles, mesh_of
from . import flash_attention as fa
from . import linear_scan as ls


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              impl: str = "kernel", block_k: int = 1024) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), kv (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if mesh_of(q, k, v) is not None:
        roles = Roles(batch=0, heads=1)
        return local_map_roles(
            lambda q_, k_, v_: (attention(q_, k_, v_, impl=impl,
                                          block_k=block_k, **kw),),
            (q, k, v), (roles, roles, roles), (roles,))[0]
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
