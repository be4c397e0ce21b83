"""Pipelined heterogeneous-fleet training (PyTorch port of
`repro.fleet.pipeline`).

`FleetOrchestrator` lays the environment budget out as per-scenario
sub-fleets (one core `Orchestrator` each, with the scenario's head of the
shared multitask policy plugged in), and `FleetRunner` drives them through
a double-buffered rollout/update pipeline brokered by `fleet/broker.py`.
Each sub-fleet is one env batch, rolled out by its
`Orchestrator.sample_fleet` in scenario order.  Over a `mesh` this is the
reference's super-batch layout: every rank advances its rows of every
scenario's padded batch, each scenario's rows are gathered over "data"
and sliced back to the real count, and every rank runs the same update,
so params and Adam state stay bitwise equal across ranks:

    iteration k (pipelined):
        traj_k        <- broker slot k % 2        (rolled last iteration)
        rollout_{k+1}(params_k)                   (all sub-fleets)
        update_k(params_k, traj_k)                -> params_{k+1}
        push traj_{k+1} -> slot (k+1) % 2, push stats_k -> metrics ring

    Nothing in the loop reads a device value on the host: metrics stay on
    the device until the drain at the end of `train`.  The price is the
    one-iteration policy lag (traj_k was rolled with params_{k-1});
    `pipelined=False` gives the paper's synchronous semantics and the
    per-iteration timings.  The rollout precedes the update in program
    order because the optimizer steps the parameters in place.

Determinism: iteration k of scenario i is a function of (seed, i, k,
params): rollout generators are seeded with `scheduler.rollout_seed(seed,
i, k)`, banks with `scheduler.scenario_seed(seed, i)`, and the checkpoint
state tree carries params + optimizer + THE BROKER (the in-flight
trajectory included), so a restored pipelined run replays bit for bit.
The tree does not depend on the world size: a run checkpointed over one
mesh resumes over another.  Global rank 0 alone writes checkpoints and the
metrics log.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import resolve_device
from ..core import ppo as ppo_lib
from ..core import elastic
from ..core.orchestrator import FleetConfig, Orchestrator
from ..core.runner import RunnerBase, RunnerConfig, _copy_into
from . import broker as broker_lib
from . import multitask, scheduler as sched_lib
from .scheduler import FleetSchedule


@dataclasses.dataclass(frozen=True)
class FleetRunnerConfig(RunnerConfig):
    """RunnerConfig + the fleet-specific knobs."""

    checkpoint_dir: str = "checkpoints/fleet"
    pipelined: bool = True        # False -> paper-synchronous semantics
    bank_size: int = 17           # per-scenario initial-state bank
    traj_capacity: int = 2        # 2 == double buffering (pipeline minimum)
    metrics_capacity: int = 512   # device-resident metric history
    d_embed: int = 32             # shared-trunk width (multitask policy)
    n_shared_layers: int = 2


def _host_record(rec: dict) -> dict:
    """Drained metric record -> JSON-ready host values: scalars as Python
    floats, vector metrics (nested lists from `drain_host`) unchanged."""
    return {key: v if isinstance(v, list) else float(v)
            for key, v in rec.items()}


def traj_template(env, n_envs: int) -> ppo_lib.Trajectory:
    """Shapes and dtypes of one rollout of `n_envs` envs, on the "meta"
    device (no memory), from the env's specs."""
    t, b = env.n_actions, n_envs

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return ppo_lib.Trajectory(
        obs=meta((t, b) + env.obs_spec.shape),
        actions=meta((t, b) + env.action_spec.shape),
        log_probs=meta((t, b)), rewards=meta((t, b)),
        dones=meta((t, b), torch.bool), values=meta((t, b)),
        last_value=meta((b,)))


def stats_template(names) -> dict[str, torch.Tensor]:
    """The scalar stats of `multitask.guarded_fleet_update` for scenarios
    `names`, on the "meta" device."""
    keys = [f"{n}/{k}" for n in names for k in ppo_lib.LOSS_STATS]
    keys += ["loss", "grad_norm"] + [f"{n}/mean_return" for n in names]
    keys += ["update_ok", "iteration"]
    return {k: torch.empty((), device="meta") for k in keys}


class FleetOrchestrator:
    """Per-scenario sub-fleet orchestrators + the shared multitask policy
    (its weights drawn on the CPU from `seed`, then moved to the device);
    each orchestrator is driven by its scenario's head.  With a `mesh`,
    each sub-fleet splits over its "data" axis and rank 0's weights are
    broadcast to every rank."""

    def __init__(self, schedule: FleetSchedule, *, mesh=None, seed: int = 0,
                 bank_size: int = 17, d_embed: int = 32,
                 n_shared_layers: int = 2,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.schedule = schedule
        self.mcfg = multitask.MultiTaskConfig.from_envs(
            [(m.name, m.env) for m in schedule.members],
            d_embed=d_embed, n_shared_layers=n_shared_layers)
        self.policy = multitask.MultiTaskPolicy(
            self.mcfg, torch.Generator().manual_seed(seed)).to(self.device)
        elastic.reshard(self.policy, mesh)
        self.orchs = {
            m.name: Orchestrator(
                m.env, FleetConfig(n_envs=m.n_envs, bank_size=bank_size),
                mesh=mesh, seed=sched_lib.scenario_seed(seed, i),
                device=self.device)
            for i, m in enumerate(schedule.members)
        }

    @property
    def names(self) -> tuple[str, ...]:
        return self.schedule.names

    def sample_all(self, seeds: dict[str, int]
                   ) -> dict[str, ppo_lib.Trajectory]:
        """Every sub-fleet's rollout with its own head, each from a
        generator seeded with `seeds[name]`."""
        return {name: self.orchs[name].sample_fleet(
                    self.policy.head(name),
                    torch.Generator(device=self.device).manual_seed(
                        seeds[name]))
                for name in self.names}

    def evaluate_all(self) -> dict[str, float]:
        """Deterministic held-out-state episode per scenario (syncs)."""
        return {name: self.orchs[name].evaluate(self.policy.head(name))
                for name in self.names}


class FleetRunner(RunnerBase):
    """Heterogeneous-fleet training with the Runner durability contract,
    on one device or over a `mesh` (`launch.mesh.make_fleet_mesh`)."""

    def __init__(self, schedule: FleetSchedule,
                 ppo_cfg: ppo_lib.PPOConfig | None = None,
                 run_cfg: FleetRunnerConfig | None = None, *, mesh=None,
                 device: str | torch.device | None = None):
        super().__init__(run_cfg or FleetRunnerConfig(), mesh=mesh)
        cfg = self.run_cfg
        self.ppo_cfg = ppo_cfg or ppo_lib.PPOConfig()
        self.schedule = schedule
        self.forch = FleetOrchestrator(
            schedule, mesh=mesh, seed=cfg.seed, bank_size=cfg.bank_size,
            d_embed=cfg.d_embed, n_shared_layers=cfg.n_shared_layers,
            device=device)
        self.device = self.forch.device
        self.policy = self.forch.policy
        self.weights = {m.name: m.weight for m in schedule.members}
        self.opt = ppo_lib.make_optimizer(self.policy, self.ppo_cfg)
        # the rings are allocated in full up front, from the specs
        self.broker = broker_lib.broker_init(
            {m.name: traj_template(m.env, m.n_envs)
             for m in schedule.members},
            traj_capacity=cfg.traj_capacity,
            metric_templates={"fleet": stats_template(self.forch.names)},
            metrics_capacity=cfg.metrics_capacity, device=self.device)

    def _update(self, trajs: dict, k: int) -> dict:
        return multitask.guarded_fleet_update(
            self.policy, self.opt, self.ppo_cfg, trajs, self.weights, k)

    # --- checkpoint hooks ----------------------------------------------------
    def _state_tree(self) -> dict:
        params = dict(self.policy.named_parameters())
        return {"params": params,
                "opt": {name: self.opt.state[p] for name, p in params.items()},
                "broker": broker_lib.state_tree(self.broker)}

    def _load_state(self, tree: dict, manifest: dict) -> None:
        _copy_into(self._state_tree(), tree)
        self.iteration = int(manifest["meta"]["iteration"])

    def _checkpoint_meta(self) -> dict:
        # scenarios + trunk hyperparameters make the checkpoint
        # self-describing for a serving loader
        return {**super()._checkpoint_meta(),
                "scenarios": list(self.forch.names),
                "n_envs": {m.name: m.n_envs for m in self.schedule.members},
                "pipelined": self.run_cfg.pipelined,
                "d_embed": self.run_cfg.d_embed,
                "n_shared_layers": self.run_cfg.n_shared_layers}

    # --- seed bookkeeping ----------------------------------------------------
    def _seeds(self, k: int) -> dict[str, int]:
        return {name: sched_lib.rollout_seed(self.run_cfg.seed, i, k)
                for i, name in enumerate(self.forch.names)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gathered(self) -> tuple[float, int]:
        """(host seconds, bytes received) of every sub-fleet's gathers so
        far."""
        orchs = self.forch.orchs.values()
        return (sum(o.gather_s for o in orchs),
                sum(o.gather_bytes for o in orchs))

    # --- iteration bodies ----------------------------------------------------
    def _push_all(self, trajs: dict, stats: dict | None) -> None:
        for name, traj in trajs.items():
            broker_lib.push_donated(self.broker.traj[name], traj)
        if stats is not None:
            broker_lib.push_donated(self.broker.metrics["fleet"], stats)

    def run_iteration_pipelined(self, k: int) -> None:
        """Consume traj_k from the broker, roll out k+1 on params_k, update
        k, and park the results in the broker; reads nothing on the host."""
        next_trajs = self.forch.sample_all(self._seeds(k + 1))
        trajs_k = {name: broker_lib.latest_traj(self.broker, name)
                   for name in self.forch.names}
        stats = self._update(trajs_k, k)
        self._push_all(next_trajs, stats)

    def run_iteration_sync(self, k: int) -> dict:
        """Paper-synchronous iteration: sample -> sync -> update -> read the
        stats, with the per-iteration host timings."""
        t0 = time.perf_counter()
        gather = self._gathered()
        trajs = self.forch.sample_all(self._seeds(k))
        self._sync()
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = self._update(trajs, k)
        host_stats = {name: float(v) for name, v in stats.items()}  # syncs
        t_update = time.perf_counter() - t0
        self._push_all(trajs, stats)
        timings = {"t_sample_s": t_sample, "t_update_s": t_update}
        if self.mesh is not None:
            after = self._gathered()
            timings["t_gather_s"] = after[0] - gather[0]
            timings["gather_bytes"] = after[1] - gather[1]
        return {"iteration": k, **timings, **host_stats}

    # --- training ------------------------------------------------------------
    def train(self, n_iterations: int | None = None, *,
              resume: bool = True) -> list[dict]:
        """Run until `n_iterations`; returns this call's per-iteration
        metric records (drained from the device ring at the end)."""
        cfg = self.run_cfg
        total = n_iterations or cfg.n_iterations
        if resume:
            self.restore()
        head_start = int(self.broker.metrics["fleet"].head)
        timings: list[dict] = []

        # pipeline prologue: the broker must hold traj_0 before update 0
        if cfg.pipelined and int(
                self.broker.traj[self.forch.names[0]].head) == 0:
            self._push_all(self.forch.sample_all(self._seeds(0)), None)

        while self.iteration < total:
            k = self.iteration
            if cfg.pipelined:
                self.run_iteration_pipelined(k)
            else:
                timings.append(self.run_iteration_sync(k))
            self.iteration = k + 1
            if (k + 1) % cfg.eval_every == 0:
                evals = self.forch.evaluate_all()
                self._log({"iteration": k,
                           **{f"{n}/eval_return_norm": v
                              for n, v in evals.items()}})
            if (k + 1) % cfg.checkpoint_every == 0:
                self.save_checkpoint()
        self.save_checkpoint(block=True)
        self.join_pending_checkpoint()

        # drain this call's device-resident metrics into the jsonl stream
        n_new = int(self.broker.metrics["fleet"].head) - head_start
        drained = broker_lib.drain_host(self.broker)["fleet"]
        # the ring holds only metrics_capacity records: a longer call loses
        # the oldest ones; say so instead of silently under-reporting
        records = drained[-n_new:] if n_new > 0 else []
        if n_new > len(records):
            self._log({"dropped_metric_records": n_new - len(records),
                       "metrics_capacity": cfg.metrics_capacity})
        timing_by_iter = {t["iteration"]: t for t in timings}
        history = []
        for rec in records:
            rec = _host_record(rec)
            for name in self.forch.names:
                n_steps = self.forch.orchs[name].env.n_actions
                rec[f"{name}/return_norm"] = (
                    rec[f"{name}/mean_return"] / n_steps)
            # sync-mode host timings, matched by iteration
            rec.update(timing_by_iter.get(int(rec["iteration"]), {}))
            self._log(rec)
            history.append(rec)
        return history


def make_fleet_runner(names, total_envs: int = 6, *,
                      ppo_cfg: ppo_lib.PPOConfig | None = None,
                      run_cfg: FleetRunnerConfig | None = None,
                      costs: dict[str, float] | None = None, mesh=None,
                      device: str | torch.device | None = None,
                      **schedule_kwargs) -> FleetRunner:
    """Registry names -> schedule -> FleetRunner on `device` (None: the
    GPU; without one this raises unless device="cpu" is asked for), over
    `mesh` if one is given."""
    from .. import envs

    device = resolve_device(device)
    schedule = sched_lib.build_schedule(
        [(n, envs.make(n)) for n in names], total_envs, costs=costs,
        **schedule_kwargs)
    return FleetRunner(schedule, ppo_cfg=ppo_cfg, run_cfg=run_cfg, mesh=mesh,
                       device=device)
