"""The serving dispatch layer: scenario-routed, bucketed inference (PyTorch
port of `repro.serve.service`).

`ControllerService` is what a solver talks to: submit observations by
registered scenario name, flush, get greedy actions back.  Internals:

  * ONE CUDA graph per (scenario, batch bucket): `serve_step` below,
    captured at that pair's first dispatch and replayed after, with static
    observation, `n_valid` and output buffers; each batch's observations
    are copied in from pinned host memory.  The graph holds the addresses
    of the parameters, so the service owns a copy of them and never
    rebinds it.  On the CPU the same `serve_step` runs eagerly.  There is
    no other fallback: on a CUDA device a capture that fails raises.
  * the deterministic greedy-action path: `multitask.actor_mean`, the
    function the training-time deterministic evaluation uses, so served
    actions equal the trained policy's greedy actions on the same padded
    batch, bit for bit;
  * a per-scenario `[requests, batches]` int32 counter on the device,
    updated in place inside the graph; nothing on the hot path reads it
    back, `stats()` does;
  * padding discipline: the batcher pads rows up to the bucket, the
    service slices every output back to `[:n_valid]` before a caller sees
    it.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .. import nn, resolve_device
from ..fleet import multitask
from .batcher import DEFAULT_BUCKETS, PendingBatch, RequestBatcher
from .loader import LoadedPolicy, load_policy


def serve_step(params, mcfg: multitask.MultiTaskConfig, name: str,
               obs: torch.Tensor, n_valid: torch.Tensor,
               stats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One serving dispatch for scenario `name` at one bucket shape.

    obs: (bucket, E, *spatial, C) padded observation batch; n_valid: int32
    scalar on obs's device.  Returns (actions (bucket, E), values
    (bucket,)): actions by the deterministic greedy path (`actor_mean`),
    values from the critic head.  `stats` ([requests, batches], int32) is
    advanced in place by (n_valid, 1)."""
    actions = multitask.actor_mean(params, mcfg, name, obs)
    values = multitask.value(params, mcfg, name, obs)
    stats[0].add_(n_valid)
    stats[1].add_(1)
    return actions, values


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's answer: the greedy per-element action and the critic's
    value estimate for the submitted observation."""

    uid: int
    scenario: str
    action: np.ndarray
    value: float


class _Graph:
    """One captured `serve_step` for a (scenario, bucket): its static
    device buffers, the pinned host buffers its inputs come from, and the
    graph."""

    def __init__(self, svc: "ControllerService", name: str, bucket: int):
        head = svc.mcfg.head(name)
        shape = (bucket, head.n_elements, *head.spatial, head.channels)
        dev = svc.device
        self.obs = torch.zeros(shape, device=dev)
        self.n_valid = torch.zeros((), dtype=torch.int32, device=dev)
        self.host_obs = torch.zeros(shape, pin_memory=True)
        self.host_n = torch.zeros((), dtype=torch.int32, pin_memory=True)
        self.copied = torch.cuda.Event()  # the host buffers may be rewritten
        # warm up on a side stream (cuBLAS handles, the gains tensor) with
        # a scratch counter, then capture on the service's counter
        scratch = torch.zeros((2,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                serve_step(svc.params, svc.mcfg, name, self.obs,
                           self.n_valid, scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.actions, self.values = serve_step(
                svc.params, svc.mcfg, name, self.obs, self.n_valid,
                svc._stats[name])

    def run(self, batch: PendingBatch) -> tuple[torch.Tensor, torch.Tensor]:
        self.copied.synchronize()  # the last copy out of them is done
        self.host_obs.numpy()[...] = batch.obs
        self.host_n.fill_(batch.n_valid)
        self.obs.copy_(self.host_obs, non_blocking=True)
        self.n_valid.copy_(self.host_n, non_blocking=True)
        self.copied.record()
        self.graph.replay()
        return self.actions, self.values


class ControllerService:
    """Batched low-latency serving front-end over one trained policy tree.

    `params` (an `nn.ParamTree` or the nested dict it is built from) is
    copied: the service owns its parameters (the captured graphs read them
    by address).  They are served on their own device.  `capture=False`
    dispatches eagerly on a CUDA device too, for comparison with the
    graphs."""

    def __init__(self, params, mcfg: multitask.MultiTaskConfig, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_slots: int = 64, capture: bool = True):
        if not isinstance(params, torch.nn.Module):
            params = nn.ParamTree(params)
        self.params = copy.deepcopy(params)
        self.mcfg = mcfg
        self.device = next(self.params.parameters()).device
        self.capture = capture and self.device.type == "cuda"
        self.batcher = RequestBatcher(mcfg.names, buckets=buckets,
                                      max_slots=max_slots)
        self._stats = {name: torch.zeros((2,), dtype=torch.int32,
                                         device=self.device)
                       for name in mcfg.names}
        self._graphs: dict[tuple[str, int], _Graph] = {}
        # (scenario, bucket) -> graphs captured for it
        self.captures: dict[tuple[str, int], int] = {}

    @classmethod
    def from_policy(cls, policy: LoadedPolicy, **kwargs
                    ) -> "ControllerService":
        return cls(policy.params, policy.mcfg, **kwargs)

    @property
    def scenarios(self) -> tuple[str, ...]:
        return self.mcfg.names

    # --- request path ---------------------------------------------------------
    def submit(self, scenario: str, obs: np.ndarray) -> int:
        """Enqueue one observation (E, *spatial, C); returns the uid its
        result will carry.  Shape-checked here, so a malformed request
        fails at submit time, not inside a graph."""
        head = self.mcfg.head(scenario)   # raises on unknown scenarios
        want = (head.n_elements, *head.spatial, head.channels)
        obs = np.asarray(obs, dtype=np.float32)
        if obs.shape != want:
            raise ValueError(
                f"{scenario!r} observation shape {obs.shape} != declared "
                f"{want}")
        return self.batcher.submit(scenario, obs)

    @torch.no_grad()
    def dispatch(self, batch: PendingBatch
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Serve one padded batch: (actions (bucket, E), values (bucket,))
        on the device, padding rows included.  On the graph path these are
        the graph's static outputs, valid until the next dispatch of the
        same (scenario, bucket)."""
        if not self.capture:
            obs = torch.from_numpy(batch.obs).to(self.device)
            n_valid = torch.tensor(batch.n_valid, dtype=torch.int32,
                                   device=self.device)
            return serve_step(self.params, self.mcfg, batch.scenario, obs,
                              n_valid, self._stats[batch.scenario])
        key = (batch.scenario, batch.bucket)
        if key not in self._graphs:
            self._graphs[key] = _Graph(self, *key)
            self.captures[key] = self.captures.get(key, 0) + 1
        return self._graphs[key].run(batch)

    def flush(self) -> dict[int, ServeResult]:
        """Serve everything pending: batch, dispatch, slice padding, free
        the slots.  Returns {uid: ServeResult}."""
        results: dict[int, ServeResult] = {}
        for batch in self.batcher.flush():
            actions, values = self.dispatch(batch)
            acts = actions[: batch.n_valid].cpu().numpy()
            vals = values[: batch.n_valid].cpu().numpy()
            for i, (uid, slot) in enumerate(zip(batch.uids, batch.slots)):
                results[uid] = ServeResult(
                    uid=uid, scenario=batch.scenario, action=acts[i],
                    value=float(vals[i]))
                self.batcher.release(slot)
        return results

    def serve_batch(self, scenario: str, obs_batch: np.ndarray) -> np.ndarray:
        """One-shot convenience: serve (B, E, *spatial, C) rows, returning
        (B, E) greedy actions in row order (B may exceed the largest
        bucket: the batcher chunks)."""
        uids = [self.submit(scenario, row) for row in np.asarray(obs_batch)]
        results = self.flush()
        return np.stack([results[uid].action for uid in uids], axis=0)

    # --- telemetry ------------------------------------------------------------
    def stats(self) -> dict[str, dict[str, int]]:
        """Host read of the per-scenario serving counters (syncs)."""
        return {name: {"requests": int(c[0]), "batches": int(c[1])}
                for name, c in ((n, s.cpu()) for n, s in self._stats.items())}


def load_service(checkpoint_dir: str, step: int | None = None, *,
                 device: str | torch.device | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_slots: int = 64, **load_kwargs) -> ControllerService:
    """checkpoint directory -> ready service (loader and dispatch in one),
    on `device` (None: the GPU)."""
    policy = load_policy(checkpoint_dir, step, device=resolve_device(device),
                         **load_kwargs)
    return ControllerService.from_policy(policy, buckets=buckets,
                                         max_slots=max_slots)
