"""Mesh geometry and the collectives the fleet runs over a process group.

A mesh is a `torch.distributed.DeviceMesh` with named dims (built by
`launch/mesh.py`), or, for the pure geometry, any object whose `shape` is
an {axis name: size} dict.  The fleet's env batches split over the mesh
axes `FleetConfig.env_axes` (`core/orchestrator.py`); one env's element
axis splits over `FleetConfig.elem_axis` (`ElemSplit`, `roll`).

Collectives use the backend of the tensors' device: NCCL for CUDA tensors
with one rank per card, gloo otherwise (CPU tensors, or several ranks
sharing one card, which NCCL refuses).  gloo's collectives are written for
host memory, so `all_gather_cat`, `broadcast_`, `all_reduce_` and `roll`
stage a CUDA tensor through the host when the group is gloo, and say so
once in the log; nothing else falls back.  They send contiguous buffers:
gloo sends a strided view's storage, not its values.
"""
from __future__ import annotations

import logging
import math
import time

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


def roll(x: torch.Tensor, shifts: int, dim: int, group) -> torch.Tensor:
    """`torch.roll` of the array whose slabs along `dim` are split over the
    group's ranks in rank order (equal slabs; `x` is this rank's): the
    local roll, with the `|shifts|` wrapped slabs taken from the
    neighbouring rank (the previous one for shifts > 0, the next one for
    shifts < 0), sent and received in the group.  A group of one rank (or
    None) is `torch.roll` itself."""
    if group is None or dist.get_world_size(group) == 1:
        return torch.roll(x, shifts=shifts, dims=dim)
    dim, n = dim % x.ndim, x.shape[dim % x.ndim]
    s = abs(shifts)
    if not 0 < s <= n:
        raise ValueError(f"a split roll moves 1 to {n} slabs, got {shifts}")
    size, me = dist.get_world_size(group), dist.get_rank(group)
    if shifts > 0:  # out[:s] = the previous rank's last s slabs
        send, kept = x.narrow(dim, n - s, s), x.narrow(dim, 0, n - s)
        to, frm = me + 1, me - 1
    else:           # out[n-s:] = the next rank's first s slabs
        send, kept = x.narrow(dim, 0, s), x.narrow(dim, s, n - s)
        to, frm = me - 1, me + 1
    stage = _staged(x, group)
    buf = (send.cpu() if stage else send).contiguous()
    halo = torch.empty_like(buf)
    reqs = [dist.isend(buf, dist.get_global_rank(group, to % size),
                       group=group),
            dist.irecv(halo, dist.get_global_rank(group, frm % size),
                       group=group)]
    for req in reqs:
        req.wait()
    halo = halo.to(x.device) if stage else halo
    return torch.cat([halo, kept] if shifts > 0 else [kept, halo], dim=dim)


class ElemSplit:
    """One env's state split over the ranks of a group by its first element
    axis (x): this rank holds slabs `rank * L:(rank + 1) * L` of the
    global `size * L`.  The solver's face exchanges go through `roll`, its
    box sums through `all_reduce_`, the reward's and the observation's
    whole field through `gather`.  `ElemSplit()` is a group of one rank:
    the split assembly with no exchange.

    It counts the host seconds spent in its exchanges (a staged exchange
    first waits for the device to reach it) and the bytes of the other
    ranks' slabs or sums each brings this rank: `halo_s` / `halo_bytes`
    for the face rolls and the box sums, `gather_s` / `gather_bytes` for
    the gathers."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        if size > 1 and group is None:
            raise ValueError(f"a split over {size} ranks needs their group")
        self.group = group if size > 1 else None
        self.rank, self.size = rank, size
        self.halo_s = self.gather_s = 0.0
        self.halo_bytes = self.gather_bytes = 0

    def slab(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slabs of the whole array `x` along
        `dim`."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"{self.size} ranks do not divide {n} slabs")
        step = n // self.size
        return x.narrow(dim, self.rank * step, step).contiguous()

    def roll(self, x: torch.Tensor, shifts: int, dim: int) -> torch.Tensor:
        if self.group is None:
            return torch.roll(x, shifts=shifts, dims=dim)
        t0 = time.perf_counter()
        out = roll(x, shifts, dim, self.group)
        self.halo_s += time.perf_counter() - t0
        self.halo_bytes += x.element_size() * x.numel() * abs(shifts) \
            // x.shape[dim]
        return out

    def all_reduce_(self, x: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.group is None:
            return x
        t0 = time.perf_counter()
        all_reduce_(x, self.group, op)
        self.halo_s += time.perf_counter() - t0
        self.halo_bytes += x.element_size() * x.numel() * (self.size - 1)
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slabs of `x` concatenated along `dim`: the whole
        array."""
        if self.group is None:
            return x
        t0 = time.perf_counter()
        out = all_gather_cat(x, self.group, dim=dim)
        self.gather_s += time.perf_counter() - t0
        self.gather_bytes += x.element_size() * x.numel() * (self.size - 1)
        return out
