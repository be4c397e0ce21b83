"""Functional layers: dense, norms, embeddings, their initializers, and the
parameter container the LM modules use.

Port of `repro.nn.layers` (the parts the LM serving path needs).  On a
device mesh the tensors are DTensors; `dense` gathers a sequence split
over ranks before its product, and its output gradient's in the backward
(`gathered_rows`): DTensor refuses to flatten a split inner dim.  A layer is
a function of a parameter dict and an input, as in the JAX package, so the
model code reads like its reference.  Initializers draw from a
`torch.Generator` and create tensors on the default device, which the
caller sets with `with torch.device(...)` (the generator's own device, or
"meta" with a CPU generator to build shapes only).  JAX's threefry and
torch's Philox give other numbers from the same seed, so tests carry JAX's
parameters across (`models.lm.load_jax_params`) instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel.sharding import grad_layout

Initializer = Callable[[torch.Generator, tuple[int, ...]], torch.Tensor]


class ParamTree(torch.nn.Module):
    """A nested dict of tensors as an `nn.Module`.

    Dict keys become submodule and parameter names, lists become
    `ModuleList`s, so `named_parameters()` gives the JAX leaf paths
    (`layers.0.b0.mixer.attn.wq.w`).  `tree["wq"]["w"]` and `"b" in tree`
    work as on the JAX dicts, which lets the functional layers take either.
    Parameters are created with `requires_grad=False` unless asked: the
    LM's serving path needs no gradients (`lm.train_step` turns them on);
    the fleet's multitask policy trains.
    """

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, requires_grad))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, torch.nn.ModuleList(
                    ParamTree(v, requires_grad) for v in val))
            else:
                self.register_parameter(
                    key, torch.nn.Parameter(val, requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# --- initializers ----------------------------------------------------------
def _normal(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def lecun_normal(fan_in_axes: tuple[int, ...] = (-2,)) -> Initializer:
    def init(gen, shape):
        fan_in = math.prod(shape[a] for a in fan_in_axes)
        return _normal(gen, shape) / math.sqrt(max(fan_in, 1))

    return init


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape):
        return stddev * _normal(gen, shape)

    return init


# --- dense -----------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, w_init: Initializer | None = None) -> dict:
    w_init = w_init or lecun_normal((0,))
    p = {"w": w_init(gen, (d_in, d_out))}
    if bias:
        p["b"] = torch.zeros((d_out,))
    return p


def dense(p, x: torch.Tensor, *, dtype: torch.dtype | None = None
          ) -> torch.Tensor:
    """x @ w (+ b); w is (d_in, d_out) as in the JAX package.

    `dtype` casts the weight first.  Where x and w then differ, both go to
    their promoted type, as JAX promotes a mixed product (bf16 x against an
    f32 weight gives f32); `torch.matmul` would refuse the mix."""
    w = p["w"] if dtype is None else p["w"].to(dtype)
    if x.dtype != w.dtype:
        common = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(common), w.to(common)
    y = x @ w if not isinstance(x, DTensor) else \
        rows_gathered_grad(gathered_rows(x) @ w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def gathered_rows(x: torch.Tensor) -> torch.Tensor:
    """`x` with any shard of a dim between its first and its last gathered
    (a DTensor whose sequence is split over ranks, the stored residual
    stream): a product flattens the leading dims, and DTensor refuses to
    flatten a split inner dim (the all-gather of sequence parallelism).
    Anything else is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if isinstance(pl, Shard) and
                 0 < pl.dim < x.ndim - 1 else pl for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def rows_gathered_grad(y: torch.Tensor) -> torch.Tensor:
    """`y`, and in the backward its gradient with any split dim between its
    first and its last gathered (`gathered_rows`): for a product whose
    backward flattens the leading dims of its output's gradient."""
    return _RowsGatheredGrad.apply(y) if isinstance(y, DTensor) else y


class _RowsGatheredGrad(torch.autograd.Function):
    """Identity whose backward gathers a gradient's split inner dims (the
    product's backward flattens its output gradient as its forward
    flattened the input)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gathered_rows(g)


# --- norms -------------------------------------------------------------------
def rmsnorm_init(d: int) -> dict:
    return {"scale": torch.ones((d,))}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            scale_plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype (gemma: (1 + scale))."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = p["scale"] + 1.0 if scale_plus_one else p["scale"]
    return (x * scale).to(dt)


def layernorm_init(d: int, *, bias: bool = True) -> dict:
    p = {"scale": torch.ones((d,))}
    if bias:
        p["bias"] = torch.zeros((d,))
    return p


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * p["scale"]
    if "bias" in p:
        x = x + p["bias"]
    return x.to(dt)


# --- embedding ---------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   stddev: float | None = None) -> dict:
    stddev = 1.0 / math.sqrt(d) if stddev is None else stddev
    return {"table": stddev * _normal(gen, (vocab, d))}


def embedding(p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table for integer `tokens` (any shape).  On a mesh
    through `F.embedding`: torch 2.11's DTensor has no working rule for
    the backward of an index (an `index_put` of batch-split indices), and
    has one for the embedding's; its gradient comes back laid out as the
    table (`grad_layout`), so that a tied head's gradient adds to it (2.11
    cannot turn a shard into a pending sum)."""
    table = p["table"]
    if isinstance(table, DTensor) or isinstance(tokens, DTensor):
        return torch.nn.functional.embedding(tokens, grad_layout(table))
    return table[tokens]
