"""Multi-scenario fleet: heterogeneous sub-fleets trained against one
shared multitask policy (PyTorch port of `repro.fleet`).

    from repro_torch import fleet

    runner = fleet.make_fleet_runner(
        ("hit_les_24dof", "channel_wm", "burgers_96dof"),
        total_envs=32, min_envs=8)       # device None -> "cuda"
    history = runner.train(1)

  broker      device-resident per-scenario trajectory/metric ring buffers
  scheduler   cost-weighted partition of the env budget into per-scenario
              sub-fleets + the fleet's seed bookkeeping
  multitask   shared-trunk policy with per-scenario adapters and heads,
              built from each env's declared ObsSpec/ActionSpec, and the
              joint update with its non-finite guard
  pipeline    double-buffered rollout/update pipeline (FleetRunner), with
              the core Runner's checkpoint/restore contract

The reference's `superbatch` (the iteration as one program, its rollout
sharded over a device mesh) has no counterpart yet: on one GPU each
sub-fleet is one batch dispatched in turn, and the mesh comes with the
port of distribution.
"""
from . import broker, multitask, pipeline, scheduler
from .multitask import MultiTaskConfig, fleet_update
from .pipeline import FleetOrchestrator, FleetRunner, FleetRunnerConfig, \
    make_fleet_runner
from .scheduler import FleetSchedule, SubFleet, build_schedule

__all__ = [
    "FleetOrchestrator",
    "FleetRunner",
    "FleetRunnerConfig",
    "FleetSchedule",
    "MultiTaskConfig",
    "SubFleet",
    "broker",
    "build_schedule",
    "fleet_update",
    "make_fleet_runner",
    "multitask",
    "pipeline",
    "scheduler",
]
