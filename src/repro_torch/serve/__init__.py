"""Trained-controller serving: batched low-latency inference for fleet
checkpoints (PyTorch port of `repro.serve`).

Training (`fleet/pipeline.py`) produces one multitask parameter tree
(shared trunk, per-scenario adapters and heads) and checkpoints it with the
optimizer and broker state.  This package is the other half of the
system's HPC story: a solver anywhere calls the trained eddy-viscosity
controllers as a service.

    from repro_torch import serve
    svc = serve.load_service(fleet_checkpoint_dir)   # device None -> "cuda"
    uid = svc.submit("hit_les_24dof", obs)           # (E, *spatial, C) row
    action = svc.flush()[uid].action                 # (E,) greedy action

Three layers:

  * `loader`  restores ONLY the policy subtree of a fleet checkpoint (the
              optimizer moments and broker rings are never read) and
              rebuilds the `MultiTaskConfig` from the checkpoint's own
              metadata;
  * `batcher` pads heterogeneous per-scenario request queues to a fixed
              ladder of batch buckets, preserving per-request order, with
              slot recycling for streaming callers;
  * `service` routes requests by registered scenario name through one
              CUDA graph of `serve_step` per (scenario, bucket): the
              deterministic greedy actions of `multitask.actor_mean`, with
              an on-device request counter.
"""
from .batcher import (DEFAULT_BUCKETS, PendingBatch, RequestBatcher,
                      bucket_for)
from .loader import LoadedPolicy, load_policy
from .service import ControllerService, ServeResult, load_service

__all__ = [
    "DEFAULT_BUCKETS",
    "PendingBatch",
    "RequestBatcher",
    "bucket_for",
    "LoadedPolicy",
    "load_policy",
    "ControllerService",
    "ServeResult",
    "load_service",
]
