"""Training traffic: whole PPO iterations through the program's
`Runner.run_iteration` (sample the fleet, then the full-batch epochs), as
its training loop runs them without the periodic evaluation and
checkpoints.

The traffic file gives `n_envs`, `bank_size`, `epochs`,
`checked_iterations` and `policy` (how the runner's seeded weights are
shaped before its first iteration, `policy_shape`).  From the seed the
runner makes its bank, its policy and, for iteration k, its generator.  Set-up builds one runner and drives it through its first
`checked_iterations` iterations, which are also the warm-up: the
benchmark keeps their trajectories, the first clipped gradient (from
Adam's state after its first step) and the parameters before and after,
for the reference.  The same runner then runs the window, iterations
`checked_iterations`, ..., which ends at the first iteration boundary
after `seconds`."""
from __future__ import annotations

import os
import time

import torch

from .. import checks
from . import policy_shape
from ..harness import OUT
from ..recorder import StepRecorder
from ..reference import hit


def _params(policy) -> dict:
    return {k: v.detach().clone() for k, v in policy.named_parameters()}


class Loop:
    def __init__(self, cell, *, seed: int, device: torch.device,
                 overrides: dict):
        from repro_torch import envs
        from repro_torch.core import orchestrator, ppo, runner

        self.cell, self.seed, self.device = cell, seed, device
        self.fields = dict(cell.config["hit_config"], **overrides)
        self.n_envs = cell.traffic["n_envs"]
        self.bank_size = cell.traffic["bank_size"]
        checked = cell.traffic["checked_iterations"]
        env = envs.make(cell.config["env"], **self.fields)
        self.n_steps = env.n_actions
        self.runner = runner.Runner(
            env, orchestrator.FleetConfig(n_envs=self.n_envs,
                                          bank_size=self.bank_size),
            ppo.PPOConfig(n_epochs=cell.traffic["epochs"]),
            runner.RunnerConfig(seed=seed, checkpoint_dir=os.path.join(
                OUT, "runner", cell.workload["name"])),
            device=device)
        policy_shape.shape(self.runner.policy, cell.traffic["policy"])
        orch = self.runner.orch
        self.recorder = StepRecorder(orch.env)
        orch.env = self.recorder
        # what the reference judges: each checked iteration's trajectory
        # (moved to the host until the window has closed), the sampled
        # rows, the first gradient as Adam got it, the parameters
        trajs: list = []
        sample_fleet = orch.sample_fleet

        def kept_sample_fleet(policy, gen):
            traj = sample_fleet(policy, gen)
            trajs.append(traj)
            return traj

        orch.sample_fleet = kept_sample_fleet
        opt = self.runner.opt
        grad1: dict = {}
        names = {id(p): k for k, p in self.runner.policy.named_parameters()}

        def first_step(optimizer, args, kwargs):
            if not grad1:
                beta1 = optimizer.param_groups[0]["betas"][0]
                for p, state in optimizer.state.items():
                    grad1[names[id(p)]] = state["exp_avg"].detach() / (
                        1.0 - beta1)

        hook = opt.register_step_post_hook(first_step)
        self.p0 = _params(self.runner.policy)
        self.samples: list = []
        self.losses: list = []
        for k in range(checked):
            plan = checks.plan(self.seed, k, self.n_envs, self.n_steps,
                               cell.spec["samples_per_iteration"])
            self.recorder.begin(checks.by_step(plan))
            record = self.runner.run_iteration(k)
            self.losses.append(record["ppo/loss"])
            self.samples += checks.take(trajs[-1], self.recorder.kept, k,
                                        plan, tag=k)
            trajs[-1] = {f: x.to("cpu") for f, x in trajs[-1]._asdict().items()}
        self.recorder.begin({})
        hook.remove()
        del orch.sample_fleet
        self.trajs = trajs
        self.grad1 = {k: v.clone() for k, v in grad1.items()}
        self.p_end = _params(self.runner.policy)
        self.next_k = checked
        self.spans = {"t_sample_s": [], "t_update_s": []}

    def iteration(self) -> None:
        record = self.runner.run_iteration(self.next_k)
        self.next_k += 1
        self.spans["t_sample_s"].append(record["t_sample_s"])
        self.spans["t_update_s"].append(record["t_update_s"])

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        n = 0
        while True:
            self.iteration()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.counts = {"iterations": n, "rl_steps": n * self.n_steps,
                       "env_steps": n * self.n_steps * self.n_envs}
        self.attempted = n
        self.failed = 0

    def end_to_end(self) -> dict:
        return {"iteration_s": self.window_s / self.counts["iterations"]}

    def trace_segment(self):
        """One more iteration (its spans not in the window's) and its work."""
        def one():
            self.runner.run_iteration(self.next_k)
            self.next_k += 1

        return one, {"iterations": 1, "rl_steps": self.n_steps,
                     "env_steps": self.n_steps * self.n_envs}

    def free(self) -> None:
        del self.runner, self.recorder
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, dict]:
        case = hit.Case.from_fields(self.fields)
        ops = hit.Operators(case, self.device)
        trajs = [{f: x.to(self.device) for f, x in t.items()}
                 for t in self.trajs]
        program = {"losses": self.losses, "grad1": self.grad1,
                   "p0": self.p0, "p_end": self.p_end}
        numbers, where, before = checks.ppo_numbers(
            case, program, trajs, self.seed, self.cell.traffic["epochs"],
            self.cell.traffic["policy"], self.device)
        del trajs
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        bank = hit.bank(gen, case, ops, self.bank_size)

        def draws_of(k):
            g = torch.Generator(device=self.device).manual_seed(
                hit.mixed_seed(self.seed, k))
            return hit.episode_draws(g, self.n_envs, self.bank_size,
                                     case.n_actions, case.n_elem**3)

        numbers.update(checks.rollout_numbers(
            case, ops, self.samples, lambda k: before[k], draws_of, bank))
        return numbers, dict(where, samples=len(self.samples))
