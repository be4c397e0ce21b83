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
              the core Runner's checkpoint/restore contract; over a mesh
              every rank advances its rows of every scenario's padded
              batch (the reference's super-batch layout), the rows are
              gathered, the update runs on every rank

The reference's `superbatch` compiles that iteration into one XLA
program; the port runs eagerly, so the layout has no module of its own.
Over ranks (under torchrun):

    from repro_torch.launch import mesh
    mesh.init_distributed()
    runner = fleet.make_fleet_runner(names, total_envs=32, min_envs=8,
                                     mesh=mesh.make_fleet_mesh())
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
