"""Request batcher: heterogeneous per-scenario queues -> fixed batch
shapes (PyTorch port of `repro.serve.batcher`, host code only).

Serving traffic arrives one observation at a time, from many callers,
across scenarios with incompatible obs shapes, but each captured CUDA graph
replays one fixed batch shape, and each distinct shape costs a capture.
The batcher bridges the two with a bucket ladder (host-side; nothing here
touches the device):

  * requests enqueue FIFO per scenario, each stamped with a monotonically
    increasing uid (the global arrival order) and a recycled slot id;
  * `flush()` drains every queue into `PendingBatch`es: each batch's rows
    are the pending requests IN ARRIVAL ORDER, padded up to the smallest
    bucket that fits (`bucket_for`, a pure function of the pending count,
    so bucket selection is deterministic), with queues longer than the
    largest bucket chunked into max-bucket batches first;
  * padding rows repeat the batch's LAST real row (in-distribution
    values), and the consumer slices `[:n_valid]` so they can never reach
    a caller;
  * slot recycling: a bounded pool of `max_slots` streaming slots; submit
    acquires the lowest free slot, `release` (called by the service once a
    result is delivered) returns it.  A full pool refuses new requests
    loudly instead of queueing unboundedly: the back-pressure contract.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable

import numpy as np

# Powers of two up to 16: a capture per (scenario, bucket) for the whole
# ladder is cheap, and doubling wastes less than half a batch of padding
# on any pending count.  Callers tune it per deployment.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def bucket_for(n: int, buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (counts above the largest bucket are chunked by
    the batcher before this is asked).  Pure and deterministic."""
    if n <= 0:
        raise ValueError(f"bucket_for needs a positive count, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"pending count {n} exceeds the largest bucket "
                     f"{buckets[-1]}; chunk first")


@dataclasses.dataclass(frozen=True)
class _Request:
    uid: int
    slot: int
    obs: np.ndarray


@dataclasses.dataclass(frozen=True)
class PendingBatch:
    """One fixed-shape unit of work: `obs` is (bucket, *obs_shape) with
    rows [0:n_valid] the real requests (arrival order) and the rest
    padding; `uids`/`slots` identify the real rows only."""

    scenario: str
    uids: tuple[int, ...]
    slots: tuple[int, ...]
    obs: np.ndarray
    n_valid: int

    @property
    def bucket(self) -> int:
        return self.obs.shape[0]


class RequestBatcher:
    """FIFO per-scenario request queues with bucket padding + slot pool."""

    def __init__(self, scenarios: Iterable[str], *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_slots: int = 64):
        self.scenarios = tuple(scenarios)
        if not self.scenarios:
            raise ValueError("batcher needs at least one scenario")
        if list(buckets) != sorted(set(buckets)) or buckets[0] < 1:
            raise ValueError(f"buckets must be strictly increasing positive "
                             f"ints, got {buckets}")
        self.buckets = tuple(int(b) for b in buckets)
        self.max_slots = int(max_slots)
        self._queues: dict[str, list[_Request]] = {n: []
                                                   for n in self.scenarios}
        self._free_slots: list[int] = list(range(self.max_slots))
        heapq.heapify(self._free_slots)   # lowest free slot first: recycling
        self._next_uid = 0                # is deterministic and observable

    # --- introspection --------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    # --- submit / release -----------------------------------------------------
    def submit(self, scenario: str, obs: np.ndarray) -> int:
        """Enqueue one observation; returns the request uid.  Refuses
        unknown scenarios and an exhausted slot pool."""
        if scenario not in self._queues:
            raise KeyError(f"unknown scenario {scenario!r}; serving "
                           f"{self.scenarios}")
        if not self._free_slots:
            raise RuntimeError(
                f"no free request slots (max_slots={self.max_slots}); "
                "flush pending work before submitting more")
        slot = heapq.heappop(self._free_slots)
        uid = self._next_uid
        self._next_uid += 1
        self._queues[scenario].append(
            _Request(uid=uid, slot=slot, obs=np.asarray(obs)))
        return uid

    def release(self, slot: int) -> None:
        """Return a completed request's slot to the pool."""
        if not 0 <= slot < self.max_slots or slot in self._free_slots:
            raise ValueError(f"slot {slot} is not an outstanding slot")
        heapq.heappush(self._free_slots, slot)

    # --- flush ----------------------------------------------------------------
    def _pad(self, scenario: str, chunk: list[_Request]) -> PendingBatch:
        bucket = bucket_for(len(chunk), self.buckets)
        rows = [r.obs for r in chunk]
        rows.extend([rows[-1]] * (bucket - len(chunk)))
        return PendingBatch(
            scenario=scenario,
            uids=tuple(r.uid for r in chunk),
            slots=tuple(r.slot for r in chunk),
            obs=np.stack(rows, axis=0),
            n_valid=len(chunk))

    def flush(self) -> list[PendingBatch]:
        """Drain every queue into padded batches, scenarios in declared
        order, each queue chunked FIFO (full max-bucket chunks first, then
        one bucket-rounded remainder)."""
        batches: list[PendingBatch] = []
        cap = self.buckets[-1]
        for scenario in self.scenarios:
            queue = self._queues[scenario]
            self._queues[scenario] = []
            for start in range(0, len(queue), cap):
                batches.append(self._pad(scenario, queue[start:start + cap]))
        return batches
