"""Mesh geometry and the collectives the fleet runs over a process group.

A mesh is a `torch.distributed.DeviceMesh` with named dims (built by
`launch/mesh.py`), or, for the pure geometry, any object whose `shape` is
an {axis name: size} dict.  The fleet's env batches split over the mesh
axes `FleetConfig.env_axes` (`core/orchestrator.py`); one env's element
axis splits over `FleetConfig.elem_axis` (`ElemSplit`, `roll`), or over
two mesh axes at once, x-slabs over one and y-slabs over the other
(`PencilSplit`, the dry run's HIT cell and its counterpart on ranks).

Collectives use the backend of the tensors' device: NCCL for CUDA tensors
with one rank per card, gloo otherwise (CPU tensors, or several ranks
sharing one card, which NCCL refuses).  gloo's collectives are written for
host memory, so `all_gather_cat`, `broadcast_`, `all_reduce_` and `roll`
stage a CUDA tensor through the host when the group is gloo, and say so
once in the log; the LM's mesh on such ranks is made of `StagedGroup`s,
which stage every collective and record it.  They send contiguous buffers:
gloo sends a strided view's storage, not its values.
"""
from __future__ import annotations

import logging
import math
import time

import torch
import torch._C._distributed_c10d as c10d
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.sharding import mesh_axis_sizes

log = logging.getLogger(__name__)
_staging_logged = False


# --- mesh geometry -----------------------------------------------------------
def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object whose `shape`
    is such a dict (the reference's `Mesh.shape`)."""
    return mesh_axis_sizes(mesh)


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
    the gathers; and its face rolls, `rolls`.  A group of one rank counts
    none."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        if size > 1 and group is None:
            raise ValueError(f"a split over {size} ranks needs their group")
        self.group = group if size > 1 else None
        self.rank, self.size = rank, size
        self.reset()

    def reset(self) -> None:
        """Zero the counters."""
        self.halo_s = self.gather_s = 0.0
        self.halo_bytes = self.gather_bytes = 0
        self.rolls = 0

    def along(self, direction: int) -> "ElemSplit | None":
        """The split of element direction `direction` (0 x, 1 y, 2 z):
        this one for x, None (not split) for the others."""
        return self if direction == 0 else None

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
        self.rolls += 1
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


class PencilSplit:
    """One env's state split over two groups at once: its x-slabs over
    the ranks of `x` and its y-slabs over those of `y` (each an
    `ElemSplit`; this rank holds one block of x-slabs by y-slabs), the
    reference's (mx, my) pencil.  The solver routes each direction's face
    rolls through `along(direction)`; a sum over the whole pencil is an
    all-reduce over `x`, then one over `y` (no group spans both axes);
    the whole env is a gather over `y`, then over `x`.  Either split may
    be a group of one rank, which exchanges nothing.

    `halo_s`, `halo_bytes`, `gather_s` and `gather_bytes` count both axes
    (each axis's exchanges stay on its `ElemSplit`, with its `rolls`)."""

    def __init__(self, x: ElemSplit, y: ElemSplit):
        self.x, self.y = x, y

    @property
    def size(self) -> int:
        return self.x.size * self.y.size

    def along(self, direction: int) -> ElemSplit | None:
        """The split of element direction `direction`: `x` for 0, `y` for
        1, None (not split) for 2."""
        return {0: self.x, 1: self.y}.get(direction)

    def reset(self) -> None:
        self.x.reset()
        self.y.reset()

    def slab(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the whole array `t`: its x-slabs along
        `dim`, its y-slabs along `dim + 1`."""
        return self.y.slab(self.x.slab(t, dim), dim + 1)

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """`t` overwritten in place with its reduction over the pencil."""
        return self.y.all_reduce_(self.x.all_reduce_(t, op), op)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of `t` in place: the whole array, x along
        `dim` and y along `dim + 1`."""
        return self.x.gather(self.y.gather(t, dim + 1), dim)

    @property
    def halo_s(self) -> float:
        return self.x.halo_s + self.y.halo_s

    @property
    def halo_bytes(self) -> int:
        return self.x.halo_bytes + self.y.halo_bytes

    @property
    def gather_s(self) -> float:
        return self.x.gather_s + self.y.gather_s

    @property
    def gather_bytes(self) -> int:
        return self.x.gather_bytes + self.y.gather_bytes


def pencil_split(mesh: DeviceMesh, x_axis: str = "mx",
                 y_axis: str = "my") -> PencilSplit:
    """The pencil of `mesh`'s dims `x_axis` (x-slabs) and `y_axis`
    (y-slabs), each over its dim's group."""
    def over(axis: str) -> ElemSplit:
        return ElemSplit(mesh.get_group(axis), mesh.get_local_rank(axis),
                         mesh_shape(mesh)[axis])

    return PencilSplit(over(x_axis), over(y_axis))


# --- a gloo group for DTensor on ranks that share a card ---------------------
STAGED_BACKEND = "hoststage"


class StagedGroup(dist.ProcessGroup):
    """A process group that runs each collective through a gloo group on
    host copies of its tensors, and records it.

    Ranks that share one card cannot use NCCL, and gloo's collectives are
    written for host memory; DTensor issues its collectives (all-gathers,
    reduce-scatters, all-reduces, all-to-alls) through the mesh's groups,
    so the LM's mesh on such ranks is made of these groups
    (`launch/mesh.make_host_mesh`), and so are the flash decode combine's
    all-reduces.  Each call copies CUDA inputs to the host, runs gloo
    there, waits, and copies the results back into the CUDA outputs; CPU
    tensors go to gloo as they are.  Every call appends (op, bytes,
    seconds) to `records`: the bytes of this rank's input payload and the
    host seconds of the whole call, staging included.  All-to-all runs as
    an all-gather and a chunk (gloo has none for host tensors).  Those are
    the collectives the mesh issues; any other is refused by c10d.
    """

    def __init__(self, inner, rank: int, size: int):
        super().__init__(rank, size)
        self._inner = inner
        self._rank, self._size = rank, size
        self.records: list[tuple[str, int, float]] = []

    def size(self) -> int:
        return self._size

    def getBackendName(self) -> str:
        return STAGED_BACKEND

    @property
    def group_name(self):
        return dist.distributed_c10d._world.pg_names[self]

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        return (t.cpu() if t.is_cuda else t).contiguous()

    @staticmethod
    def _empty(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype)

    @staticmethod
    def _back(dst: torch.Tensor, src: torch.Tensor) -> None:
        if src is not dst:
            dst.copy_(src)

    def _record(self, op: str, tensors, t0: float) -> None:
        self.records.append((op, sum(t.numel() * t.element_size()
                                     for t in tensors),
                             time.perf_counter() - t0))

    @staticmethod
    def _done(result):
        fut = torch.futures.Future()
        fut.set_result(result)
        return c10d._create_work_from_future(fut)

    # in-place collectives: the tensors are inputs and outputs
    def _inplace(self, op: str, call, tensors, opts):
        t0 = time.perf_counter()
        host = [self._host(t) for t in tensors]
        call(host, opts).wait()
        for t, h in zip(tensors, host):
            self._back(t, h)
        self._record(op, tensors, t0)
        return self._done(tensors)

    def allreduce(self, tensors, opts=c10d.AllreduceOptions()):
        return self._inplace("all_reduce", self._inner.allreduce, tensors,
                             opts)

    def barrier(self, opts=c10d.BarrierOptions()):
        self._inner.barrier(opts).wait()
        return self._done([])

    # out-of-place collectives
    def all_gather_single(self, out, inp, opts=c10d.AllgatherOptions()):
        t0 = time.perf_counter()
        h_in, h_out = self._host(inp), self._empty(out)
        self._inner._allgather_base(h_out, h_in, opts).wait()
        self._back(out, h_out)
        self._record("all_gather", [inp], t0)
        return self._done([out])

    _allgather_base = all_gather_single

    def allgather_into_tensor_coalesced(self, outs, inps,
                                        opts=c10d.AllgatherOptions()):
        """The entry c10d's functional all-gather (DTensor's) calls."""
        for out, inp in zip(outs, inps):
            self.all_gather_single(out, inp, opts)
        return self._done(outs)

    def reduce_scatter_single(self, out, inp,
                              opts=c10d.ReduceScatterOptions()):
        t0 = time.perf_counter()
        h_in, h_out = self._host(inp), self._empty(out)
        self._inner._reduce_scatter_base(h_out, h_in, opts).wait()
        self._back(out, h_out)
        self._record("reduce_scatter", [inp], t0)
        return self._done([out])

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_tensor_coalesced(self, outs, inps,
                                        opts=c10d.ReduceScatterOptions()):
        """The entry c10d's functional reduce-scatter calls."""
        for out, inp in zip(outs, inps):
            self.reduce_scatter_single(out, inp, opts)
        return self._done(outs)

    def all_to_all_single(self, out, inp, out_splits, in_splits,
                          opts=c10d.AllToAllOptions()):
        if (out_splits and len(set(out_splits)) > 1) or \
                (in_splits and len(set(in_splits)) > 1):
            raise NotImplementedError("uneven all-to-all splits")
        t0 = time.perf_counter()
        h_in = self._host(inp)
        every = torch.empty((self._size * h_in.shape[0],) +
                            tuple(h_in.shape[1:]), dtype=h_in.dtype)
        self._inner._allgather_base(every, h_in, c10d.AllgatherOptions()
                                    ).wait()
        # rank r's block for this rank is chunk `rank` of r's input
        mine = [blk.chunk(self._size, dim=0)[self._rank]
                for blk in every.chunk(self._size, dim=0)]
        self._back(out, torch.cat(mine, dim=0))
        self._record("all_to_all", [inp], t0)
        return self._done([out])

    alltoall_base = all_to_all_single


def _create_staged_group(store, rank: int, size: int, timeout):
    return StagedGroup(dist.ProcessGroupGloo(store, rank, size, timeout),
                       rank, size)


def register_staged_backend() -> None:
    """Make `STAGED_BACKEND` a backend name `new_group` and
    `init_device_mesh(backend_override=...)` accept (once per process)."""
    if STAGED_BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED_BACKEND, _create_staged_group,
                                      devices=["cpu", "cuda"])


def collective_records(mesh) -> list[tuple[str, str, int, float]]:
    """(mesh dim, op, bytes, seconds) of every collective the staged groups
    of `mesh` ran, in order within each dim."""
    out = []
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        for rec in getattr(group, "records", ()):
            out.append((name,) + tuple(rec))
    return out
