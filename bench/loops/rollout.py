"""Sampling traffic: stochastic episodes of the whole fleet, back to back,
through the program's `Orchestrator.sample_fleet`, under a fixed policy.

The traffic file gives `n_envs`, `bank_size` and `policy` (how the
seeded weights are shaped, `policy_shape`).  From the seed: the program's
bank of initial states (made on the device by the orchestrator), its
policy's initial weights, and for episode e a device
generator seeded from (seed, e), from which the orchestrator draws bank
rows and action noise as training draws them.  Episode 0 is the warm-up;
the window runs episodes 1, 2, ... and ends at the first episode boundary
after `seconds`.  Each trajectory is dropped once the sampled rows are
copied out of it."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks
from . import policy_shape
from ..recorder import Stamps, StepRecorder
from ..reference import hit


class Loop:
    def __init__(self, cell, *, seed: int, device: torch.device,
                 overrides: dict):
        from repro_torch import envs
        from repro_torch.core import orchestrator, policy

        self.cell, self.seed, self.device = cell, seed, device
        self.fields = dict(cell.config["hit_config"], **overrides)
        self.n_envs = cell.traffic["n_envs"]
        self.bank_size = cell.traffic["bank_size"]
        self.per_episode = cell.spec["samples_per_episode"]
        env = envs.make(cell.config["env"], **self.fields)
        self.orch = orchestrator.Orchestrator(
            env, orchestrator.FleetConfig(n_envs=self.n_envs,
                                          bank_size=self.bank_size),
            seed=seed, device=device)
        self.recorder = StepRecorder(self.orch.env)
        self.orch.env = self.recorder
        self.policy = policy.Policy(
            self.orch.pcfg, torch.Generator().manual_seed(seed)).to(device)
        policy_shape.shape(self.policy, cell.traffic["policy"])
        self.n_steps = env.n_actions
        self.samples: list = []
        self.episodes = 0
        self.episode(0, keep=False)         # warm-up: every shape once
        self.spans: dict = {}

    def episode(self, e: int, keep: bool = True) -> None:
        gen = torch.Generator(device=self.device).manual_seed(
            hit.mixed_seed(self.seed, e))
        plan = checks.plan(self.seed, e, self.n_envs, self.n_steps,
                           self.per_episode) if keep else []
        self.recorder.begin(checks.by_step(plan))
        traj = self.orch.sample_fleet(self.policy, gen)
        if keep:
            self.samples += checks.take(traj, self.recorder.kept, e, plan)
        self.recorder.begin({})

    def window(self, seconds: float) -> None:
        self.recorder.stamps = Stamps(self.device)
        self.recorder.stamps.stamp()
        t0 = time.perf_counter()
        stats0 = self._alloc_stats()
        ends = []
        e = 1
        while True:
            self.episode(e)
            e += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.episodes = e - 1
        self.step_ms = self.recorder.stamps.intervals_ms()
        self.recorder.stamps = None
        stats1 = self._alloc_stats()
        # where the window's time went, for the record (not compared)
        self.notes = {
            "episode_host_s": [round(b - a, 4) for a, b in
                               zip([0.0] + ends, ends)],
            "step_ms_max": max(self.step_ms),
            "steps_over_100ms": sum(x > 100 for x in self.step_ms),
            **{k: stats1[k] - stats0[k] for k in stats0}}
        self.counts = {"episodes": self.episodes,
                       "rl_steps": self.episodes * self.n_steps,
                       "env_steps": self.episodes * self.n_steps * self.n_envs}
        self.attempted = self.episodes * self.n_envs
        self.failed = 0

    def _alloc_stats(self) -> dict:
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        return {k: stats.get(k, 0) for k in ("num_alloc_retries",
                                              "num_device_alloc",
                                              "num_device_free")}

    def end_to_end(self) -> dict:
        return {"env_steps_per_s": self.counts["env_steps"] / self.window_s,
                "rl_step_p95_ms": float(np.percentile(self.step_ms, 95))}

    def trace_segment(self):
        """One more episode, not sampled, and the work it does."""
        e = self.episodes + 1
        return (lambda: self.episode(e, keep=False),
                {"episodes": 1, "rl_steps": self.n_steps,
                 "env_steps": self.n_steps * self.n_envs})

    def free(self) -> None:
        del self.orch, self.recorder, self.policy
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, dict]:
        from ..reference import policy as ref_policy

        case = hit.Case.from_fields(self.fields)
        ops = hit.Operators(case, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        bank = hit.bank(gen, case, ops, self.bank_size)
        params = {k: v.to(self.device) for k, v in ref_policy.init_params(
            self.seed, case.n, 3, self.cell.traffic["policy"],
            case.cs_max).items()}
        draws: dict = {}

        def draws_of(e):
            if e not in draws:
                g = torch.Generator(device=self.device).manual_seed(
                    hit.mixed_seed(self.seed, e))
                draws[e] = hit.episode_draws(g, self.n_envs, self.bank_size,
                                             case.n_actions, case.n_elem**3)
            return draws[e]

        numbers = checks.rollout_numbers(case, ops, self.samples,
                                         lambda tag: params, draws_of, bank)
        return numbers, dict(self.notes, samples=len(self.samples))
