"""Gradient compression for an all-reduce over slow links (PyTorch port of
`repro.core.compression`).

Between hosts, a gradient reduction crosses the data-center network, an
order of magnitude slower than the links inside one.  The classic
mitigation compresses only that reduction:

    grads --reduce(fast group)--> host-local sum --compress--> reduce(slow
          group) --decompress--> update

Two codecs:
  * bf16 : 2x volume, round-to-nearest-even truncation;
  * int8 : 4x volume, per-leaf absmax scaling + ERROR FEEDBACK: the
           quantization residual is carried to the next call, which keeps
           SGD/Adam convergence intact (Seide et al. 2014; Karimireddy et
           al. 2019).

Each takes a process group where the reference takes a mesh axis name, and
a tree of tensors (a tensor, a dict or a NamedTuple of them).  The
collectives go through `core/collectives.py`, which stages CUDA tensors
through the host on a gloo group.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..fleet.broker import tree_map
from . import collectives


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(tree: Any, group, *, method: str = "bf16",
                    error_state: Any = None) -> tuple[Any, Any]:
    """All-reduce (sum) `tree` over `group` with on-the-wire compression.

    Returns (reduced tree, new error state).  "none" keeps each leaf's
    dtype; "bf16" and "int8" return float32.  `error_state` (the tree's
    structure, float32) carries the int8 quantization residuals between
    calls; None starts from zero (for "none" and "bf16" it stays None)."""
    if method == "none":
        return tree_map(
            lambda g: collectives.all_reduce_(g.clone(), group), tree), None

    if method == "bf16":
        return tree_map(
            lambda g: collectives.all_reduce_(g.to(torch.bfloat16), group).to(
                torch.float32), tree), None

    if method == "int8":
        if error_state is None:
            error_state = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), tree)
        residuals = []

        def red(g, err):
            g = g.to(torch.float32) + err
            q, scale = _quantize_int8(g)
            residuals.append(g - _dequantize_int8(q, scale))
            # int8 sums overflow: the wire carries int32, as the reference's
            # psum does (the 4x volume is a real codec's, not this one's)
            total = collectives.all_reduce_(q.to(torch.int32), group)
            # one conservative scale shared by every rank
            scale = collectives.all_reduce_(scale.reshape(1), group,
                                         op=dist.ReduceOp.MAX)[0]
            return total.to(torch.float32) * scale

        reduced = tree_map(red, tree, error_state)
        it = iter(residuals)
        return reduced, tree_map(lambda _: next(it), tree)

    raise ValueError(f"unknown compression method: {method}")


def chunked_psum(tree: Any, group, *, n_chunks: int = 4) -> Any:
    """Split each leaf into `n_chunks` pieces and all-reduce them one by
    one: independent collectives that can overlap with compute."""
    def red(g):
        flat = g.reshape(-1)
        flat = F.pad(flat, (0, (-flat.shape[0]) % n_chunks))
        out = torch.cat([collectives.all_reduce_(c.clone(), group)
                         for c in torch.chunk(flat, n_chunks)])
        return out[: g.numel()].reshape(g.shape)

    return tree_map(red, tree)

