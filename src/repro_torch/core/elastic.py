"""Elastic restart: resume a checkpoint on another world size (PyTorch port
of `repro.core.elastic`).

The paper's framework is tied to its batch allocation (N nodes reserved for
the whole run); here the number of ranks may change between a checkpoint
and its restore.  The checkpointed state (policy, optimizer, broker) is
replicated and its shapes do not depend on the world size, so a restore
needs two things:

  * `reshard`      : place a state tree on a mesh: with specs (one for every
                     leaf, or a tree of them, as the reference's
                     PartitionSpecs), each leaf becomes a DTensor holding
                     the spec's shard on each rank; without, every rank of
                     the mesh holds its first rank's copy, by broadcast (the
                     fleet's replicated state);
  * `elastic_fleet`: the fleet size to run on the current mesh.  PPO is
    on-policy, experience never outlives an iteration, so the fleet size is
    a free knob: it changes the gradient estimator's variance (paper Sec.
    6.2), never correctness.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from ..parallel import sharding
from . import collectives


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [p.data for p in tree.parameters()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or isinstance(e, tuple) for e in x)


def _placed(tree: Any, mesh, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _placed(v, mesh, specs if _is_spec(specs) else specs[k])
                for k, v in tree.items()}
    return sharding.distribute(tree, specs, mesh)


def reshard(tree: Any, mesh, specs: Any = None) -> Any:
    """Place `tree` on `mesh`.

    With `specs` (one spec for every leaf, or a nested dict of them
    mirroring `tree`; a spec is a tuple of None / axis names per dim, as
    `parallel.sharding` makes them), returns a new tree of DTensors: each
    leaf, which every rank holds alike (a DTensor is redistributed), as
    the spec's shard on each rank.  Without specs, `tree` (a tensor, a
    module's parameters, or a nested dict of them) is placed replicated:
    every leaf becomes the mesh's first rank's, in place, on each rank's
    own device, and `tree` is returned.  Without a mesh `tree` is returned
    untouched."""
    if mesh is None:
        return tree
    if specs is not None:
        return _placed(tree, mesh, specs)
    group = collectives.mesh_group(mesh)
    with torch.no_grad():
        for x in _leaves(tree):
            collectives.broadcast_(x, group, src=dist.get_global_rank(group, 0))
    return tree


def replicate(make, mesh, device: torch.device) -> torch.Tensor:
    """The tensor `make()` returns on the mesh's first rank, on every rank
    of `mesh` (the other ranks never call `make`): that rank builds, its
    shape and dtype go out as objects, then its data by broadcast."""
    if mesh is None:
        return make()
    group = collectives.mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    x = make() if dist.get_rank() == src else None
    meta = [None if x is None else (tuple(x.shape), x.dtype)]
    dist.broadcast_object_list(meta, src=src, group=group)
    if x is None:
        shape, dtype = meta[0]
        x = torch.empty(shape, dtype=dtype, device=device)
    return collectives.broadcast_(x, group, src=src)


def validate_divisibility(shape: tuple[int, ...], spec: tuple, mesh) -> bool:
    """True iff every sharded dim of `shape` divides its mesh-axis product.
    `spec` has one entry per dim: None, an axis name or a tuple of them."""
    sizes = collectives.mesh_shape(mesh)
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if dim % math.prod(sizes[a] for a in axes):
            return False
    return True


def elastic_fleet(n_envs_ckpt: int, mesh,
                  env_axes: tuple[str, ...] = ("data",)) -> int:
    """Fleet size to run on the current mesh, given the checkpointed one.

    Keeps the checkpointed fleet when the env shards still divide it,
    otherwise rounds it to the nearest multiple of the env-shard count (at
    least one per shard)."""
    if mesh is None:
        return n_envs_ckpt
    shards = collectives.axes_size(mesh, env_axes)
    if n_envs_ckpt % shards == 0:
        return n_envs_ckpt
    return max(1, round(n_envs_ckpt / shards)) * shards
