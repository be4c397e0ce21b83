"""Mesh geometry and the collectives the fleet runs over a process group.

A mesh is a `torch.distributed.DeviceMesh` with named dims (built by
`launch/mesh.py`), or, for the pure geometry, any object whose `shape` is
an {axis name: size} dict.  The fleet's env batches split over the mesh
axes `FleetConfig.env_axes` (`core/orchestrator.py`).

Collectives use the backend of the tensors' device: NCCL for CUDA tensors
with one rank per card, gloo otherwise (CPU tensors, or several ranks
sharing one card, which NCCL refuses).  gloo's collectives are written for
host memory, so `all_gather_cat`, `broadcast_` and `all_reduce_` stage a
CUDA tensor through the host when the group is gloo, and say so once in the
log; nothing else falls back.  They send contiguous buffers: gloo sends a
strided view's storage, not its values.
"""
from __future__ import annotations

import logging
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

log = logging.getLogger(__name__)
_staging_logged = False


# --- mesh geometry -----------------------------------------------------------
def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object whose `shape`
    is such a dict (the reference's `Mesh.shape`)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axes_size(mesh, axes: tuple[str, ...]) -> int:
    """Product of the sizes of `axes` (1 without a mesh)."""
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def axes_group(mesh: DeviceMesh, axes: tuple[str, ...]):
    """The process group over `axes` of `mesh` and this rank's index in it:
    where at most one of `axes` is wider than 1, that axis's group; else
    every axis of a mesh that spans the world."""
    sizes = mesh_shape(mesh)
    wide = [a for a in axes if sizes[a] > 1]
    if len(wide) <= 1:
        axis = (wide or list(axes))[0]
        return mesh.get_group(axis), mesh.get_local_rank(axis)
    if set(axes) == set(mesh.mesh_dim_names) and \
            mesh.size() == dist.get_world_size():
        return dist.group.WORLD, dist.get_rank()
    raise NotImplementedError(
        f"env axes {axes}: at most one wider than 1, or all of a "
        f"world-spanning mesh")


def mesh_group(mesh):
    """The process group over every rank of `mesh`."""
    return axes_group(mesh, tuple(mesh.mesh_dim_names))[0]


def padded(n: int, n_shards: int) -> int:
    """`n` rounded up to a multiple of `n_shards`."""
    return -(-n // n_shards) * n_shards


# --- collectives -------------------------------------------------------------
def _staged(x: torch.Tensor, group) -> bool:
    """True when `x` must pass through the host: a CUDA tensor on a gloo
    group.  Logged once per process."""
    global _staging_logged
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    if stage and not _staging_logged:
        _staging_logged = True
        log.warning("gloo group on CUDA tensors: collectives are staged "
                    "through host memory")
    return stage


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated along `dim` in the
    group's rank order, on `x`'s device."""
    n = dist.get_world_size(group)
    stage = _staged(x, group)
    src = (x.cpu() if stage else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if stage else out


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """`x` overwritten in place with global rank `src`'s."""
    buf = (x.cpu() if _staged(x, group) else x).contiguous()
    dist.broadcast(buf, src=src, group=group)
    if buf is not x:
        x.copy_(buf)
    return x


def all_reduce_(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` overwritten in place with its reduction over the group."""
    buf = (x.cpu() if _staged(x, group) else x).contiguous()
    dist.all_reduce(buf, op=op, group=group)
    if buf is not x:
        x.copy_(buf)
    return x
