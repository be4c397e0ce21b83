"""Process groups and device meshes (PyTorch port of `repro.launch.mesh`).

A rank is one process driving one device.  `init_distributed` is the
guarded `torch.distributed.init_process_group`: it reads torchrun's
variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) or explicit arguments, does nothing for a single process, and
keeps the first init on re-entry.  Its backend is NCCL when every rank of
the host has a card of its own, gloo otherwise (`backend_for`).
`make_fleet_mesh` lays every rank out as a `DeviceMesh` with dims ("data",
"model"): the fleet's env batches split over "data"
(`core/orchestrator.py`; the geometry and the collectives over a mesh are
`core/collectives.py`).

The dry run's meshes (`launch/dryrun.py`) are `fake_mesh`es: a
`DeviceMesh` over a fake-backend default group of which this process is
rank 0, which holds meta shards and issues no communication.
`make_production_mesh` is the reference's (16, 16) ("data", "model") mesh,
or (2, 16, 16) ("pod", "data", "model") over two clusters, as such a mesh.
The H100 constants below replace the reference's TPU v5e ones in the dry
run's roofline terms.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device
from ..core import collectives

log = logging.getLogger(__name__)


def _split_data_model(n: int) -> tuple[int, int]:
    """(data, model) factorization of `n` ranks: the largest model width
    in {4, 2, 1} that divides evenly; the rest is data parallelism."""
    for model in (4, 2, 1):
        if n % model == 0:
            return n // model, model
    return n, 1


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo."""
    if device.type == "cuda" and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(*, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     local_rank: int | None = None,
                     device: str | torch.device | None = None) -> bool:
    """Guarded `torch.distributed.init_process_group`, the multi-process
    entry point.

    Arguments left None are read from torchrun's variables.  Returns False
    without touching `torch.distributed` for a single process (WORLD_SIZE
    unset or 1), True once the default group is up, and True without a
    second init when it already is.  `init_method` defaults to
    tcp://MASTER_ADDR:MASTER_PORT; tests pass a file:// store.  The backend
    follows `device` (None: the GPU) and the ranks per host
    (`backend_for`), and with CUDA the rank's card is LOCAL_RANK modulo
    the cards present."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    if rank is None:
        rank = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    dev = resolve_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    log.info("rank %d of %d: %s process group", rank, world_size, backend)
    return True


def make_host_mesh(*, device: str | torch.device | None = None,
                   shape: tuple[int, int] | None = None) -> DeviceMesh:
    """Every rank as a (data, model) mesh, split by `_split_data_model`
    unless `shape` gives it (needs `init_distributed` first): the LM's
    mesh.  On a gloo world (ranks that share a card, or the CPU) its
    groups are `core.collectives.StagedGroup`s, which stage DTensor's
    collectives through the host and record them."""
    n = dist.get_world_size()
    data, model = shape or _split_data_model(n)
    if data * model != n:
        raise ValueError(f"mesh {data} x {model} for {n} ranks")
    override = None
    if dist.get_backend() == "gloo":
        collectives.register_staged_backend()
        override = {"data": collectives.STAGED_BACKEND,
                    "model": collectives.STAGED_BACKEND}
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"),
                            backend_override=override)


def make_fleet_mesh(*, model: int = 1,
                    device: str | torch.device | None = None
                    ) -> DeviceMesh:
    """Process-spanning (data, model) mesh over every rank, data-major: the
    fleet shards env batches over "data" only, so every rank goes to data
    parallelism unless a model width is asked for.  On CUDA unless
    `device` asks for the CPU; every rank must call it (needs
    `init_distributed` first)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return init_device_mesh(resolve_device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_local_mesh(*, model: int = 1,
                    device: str | torch.device | None = None
                    ) -> DeviceMesh:
    """This rank alone as a (1, 1) mesh: the shard one process runs of the
    collective-free rollout region.  Every rank must call it (the one-rank
    groups are made together)."""
    if model != 1:
        raise ValueError(f"model={model}: a rank drives one device")
    group, _ = dist.new_subgroups(group_size=1)
    return DeviceMesh.from_group(
        [group, group], resolve_device(device).type,
        mesh=torch.tensor([[dist.get_rank()]]),
        mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with dims `names` over a fake-backend
    default group of prod(shape) ranks, this process rank 0: every rank's
    group exists, and no collective moves a byte.  The default group is
    made on entry and destroyed on exit (a fake world left behind would
    turn this process's next `init_distributed` into a no-op); entry
    raises if a default group already exists.  `device_type` is the
    device the mesh stands for: DTensor picks its collectives by it
    ("cuda" moves a shard between dims by all-to-all, "cpu" by all-gather
    and chunk), and meta tensors need no card of either kind."""
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs a process with no default "
                           "process group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh(device_type, tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh as a `fake_mesh` (a context
    manager): (data 16, model 16), 256 ranks, or (pod 2, data 16, model
    16), 512 ranks, with `multi_pod`.  "pod" is the slow axis between two
    clusters: only data parallelism and gradient sums cross it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device_type)


# Roofline constants of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet, dense rates), replacing the reference's TPU v5e ones.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s per card
HBM_BYTES = 80e9                # bytes of HBM per card
# bytes/s each way per card on the link a 16-wide axis crosses: with 8
# cards a host, such an axis spans two hosts, and each card has one
# 400 Gb/s NDR InfiniBand port.  An assumption about a cluster that was
# never measured here; NVLink's 450 GB/s each way holds only inside a
# host.  The reference has one link rate too (its ICI_BW).
LINK_BW = 50e9
