"""Device-resident experience broker (PyTorch port of `repro.fleet.broker`):
the paper's SmartSim/KeyDB in-memory exchange taken onto the GPU.

Per-scenario ring buffers of whole `Trajectory` items and per-iteration
metric records live in device memory, preallocated at their full capacity,
with a device-side write head:

  * decoupling: rollout (producer) and PPO update (consumer) communicate
    only through ring slots; capacity 2 is double buffering, so the slot
    that rollout k+1 writes never aliases the one update k reads,
  * metrics off the critical path: stats are pushed into a metrics ring
    and the host reads them only at a drain (`drain_host`), never inside
    the iteration loop,
  * durability: a ring is tensors plus an int64 write head, so the broker
    drops into the checkpoint state tree (`state_tree`) and the in-flight
    trajectory survives a restart bit for bit.

An item is a tensor, a dict of items or a NamedTuple of items.
`push_donated` writes into the ring's own buffers, the counterpart of the
reference's donating jitted push; it does not read the head on the host:
the slot index stays on the device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the tensor leaves of `tree` (and the matching leaves of
    `rest`): dicts and NamedTuples recurse, tensors are leaves."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class RingBuffer(NamedTuple):
    """A fixed-capacity ring of items on the device.

    `data` holds the items stacked on a leading slot axis of length
    `capacity`; `head` counts ALL pushes (monotonic, int64, on the device):
    the write slot is `head % capacity`, and `head` is the logical clock
    that makes resume deterministic."""

    data: Any              # tree; every leaf (capacity, *item_shape)
    head: torch.Tensor     # () int64, number of pushes so far


def capacity(ring: RingBuffer) -> int:
    return tree_leaves(ring.data)[0].shape[0]


def size(ring: RingBuffer) -> torch.Tensor:
    """Number of valid items currently held (<= capacity), on the device."""
    return torch.clamp(ring.head, max=capacity(ring))


def ring_init(template: Any, cap: int,
              device: torch.device | str | None = None) -> RingBuffer:
    """An empty ring whose slots have the shapes and dtypes of `template`
    (an example item; its leaves may be on the "meta" device), allocated
    in full on `device` (default: the template's)."""
    def alloc(x):
        return torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device if device is None else device)

    data = tree_map(alloc, template)
    return RingBuffer(data=data, head=torch.zeros(
        (), dtype=torch.int64, device=tree_leaves(data)[0].device))


def _slot(ring: RingBuffer, offset: int) -> torch.Tensor:
    return ((ring.head + offset) % capacity(ring)).reshape(1)


def push_donated(ring: RingBuffer, item: Any) -> RingBuffer:
    """Write `item` at the head slot in place (the ring's buffers and head
    are updated and the same ring is returned)."""
    slot = _slot(ring, 0)
    tree_map(lambda buf, x: buf.index_copy_(0, slot, x.to(buf.dtype)[None]),
             ring.data, item)
    ring.head.add_(1)
    return ring


def peek(ring: RingBuffer, age: int = 0) -> Any:
    """A copy of the item pushed `age` slots ago (0 = newest).  Reading an
    empty ring returns the zero template (callers gate on `size`)."""
    slot = _slot(ring, -1 - age)
    return tree_map(lambda buf: buf.index_select(0, slot)[0], ring.data)


class Broker(NamedTuple):
    """Per-scenario trajectory rings + per-stream metrics rings."""

    traj: dict[str, RingBuffer]
    metrics: dict[str, RingBuffer]


def broker_init(traj_templates: dict[str, Any], *, traj_capacity: int = 2,
                metric_templates: dict[str, Any] | None = None,
                metrics_capacity: int = 256,
                device: torch.device | str | None = None) -> Broker:
    """Build the broker from per-scenario example items (see `ring_init`).
    traj_capacity=2 is the double-buffering minimum the pipeline needs."""
    traj = {name: ring_init(t, traj_capacity, device)
            for name, t in traj_templates.items()}
    metrics = {name: ring_init(t, metrics_capacity, device)
               for name, t in (metric_templates or {}).items()}
    return Broker(traj=traj, metrics=metrics)


def latest_traj(broker: Broker, name: str) -> Any:
    return peek(broker.traj[name])


def state_tree(broker: Broker) -> dict:
    """The broker as a nested dict of its own tensors (NamedTuple items as
    dicts), for the checkpoint state tree: copying into it restores the
    broker in place."""
    def as_dict(x):
        if isinstance(x, torch.Tensor):
            return x
        items = x._asdict() if hasattr(x, "_fields") else x
        return {k: as_dict(v) for k, v in items.items()}

    return {kind: {name: {"data": as_dict(ring.data), "head": ring.head}
                   for name, ring in rings.items()}
            for kind, rings in (("traj", broker.traj),
                                ("metrics", broker.metrics))}


def drain_host(broker: Broker) -> dict[str, list]:
    """Host-side read of every metrics ring, oldest first: the ONLY place
    the broker syncs with the host (at checkpoint boundaries and at the end
    of training).  Every drained leaf is a plain host value, a Python
    float or int for a scalar metric and a nested list for a vector one,
    so records are JSON-ready as drained."""
    out: dict[str, list] = {}
    for name, ring in broker.metrics.items():
        n = int(size(ring))
        head = int(ring.head)
        cap = capacity(ring)
        data = tree_map(lambda buf: buf.cpu(), ring.data)
        records = []
        for i in range(n):
            slot = (head - n + i) % cap
            records.append(tree_map(
                lambda buf: buf[slot].item() if buf[slot].ndim == 0
                else buf[slot].tolist(), data))
        out[name] = records
    return out
