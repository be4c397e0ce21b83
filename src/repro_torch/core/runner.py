"""Fault-tolerant RL training runner (PyTorch port of `repro.core.runner`;
paper Algorithm 1).

Determinism contract: iteration k is a function of (seed, k, params_k,
opt_k).  Its random draws (bank rows, action noise) come from a generator
seeded from (seed, k), so a run resumed from a checkpoint re-executes the
same iterations.  Checkpoints are written by a background thread from host
copies; a `failure_injector` hook (tests) raises mid-iteration to exercise
the recovery path.

Over a `mesh` (`launch/mesh.py`) the fleet's env batch splits over the
ranks (`core/orchestrator.py`) and every rank runs the same update on the
gathered trajectories.  Global rank 0 alone writes checkpoints and the
metrics log; every rank restores the step rank 0 finds, so a run
checkpointed at one world size resumes at another (the state tree does
not depend on it).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..envs.base import Env
from . import checkpoints, collectives, elastic
from . import policy as policy_lib, ppo as ppo_lib
from .orchestrator import FleetConfig, Orchestrator


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    n_iterations: int = 100
    eval_every: int = 10          # paper: test state evaluated every 10 iters
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints/relexi"
    metrics_path: str | None = None  # jsonl; default <ckpt_dir>/metrics.jsonl
    keep_checkpoints: int = 3
    seed: int = 0
    async_checkpoint: bool = True


def iteration_seed(seed: int, k: int) -> int:
    """A 63-bit generator seed mixed from (seed, k)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(
        1, np.uint64)[0]) >> 1


class RunnerBase:
    """Checkpoint + metrics plumbing shared by training loops: atomic
    versioned checkpoints written off the critical path by a background
    thread, template-based restore, and a jsonl metrics stream.  Subclasses
    define `_state_tree` / `_load_state` / `_checkpoint_meta`.  Over a
    `mesh` only global rank 0 writes."""

    run_cfg: RunnerConfig

    def __init__(self, run_cfg: RunnerConfig | None, *, mesh=None):
        self.run_cfg = run_cfg or RunnerConfig()
        self.mesh = mesh
        self.writer = mesh is None or dist.get_rank() == 0
        self.iteration = 0
        self._ckpt_thread: threading.Thread | None = None
        self.metrics_path = self.run_cfg.metrics_path or os.path.join(
            self.run_cfg.checkpoint_dir, "metrics.jsonl")

    def _state_tree(self) -> dict:
        """The checkpointed state (template for restore)."""
        raise NotImplementedError

    def _load_state(self, tree: dict, manifest: dict) -> None:
        """Install a restored state tree + manifest onto self."""
        raise NotImplementedError

    def _checkpoint_meta(self) -> dict:
        return {"iteration": self.iteration, "seed": self.run_cfg.seed}

    def save_checkpoint(self, block: bool = False) -> None:
        if not self.writer:
            return
        tree = _host_copy(self._state_tree())  # host copy off critical path
        meta = self._checkpoint_meta()
        step = self.iteration

        def write():
            checkpoints.save(self.run_cfg.checkpoint_dir, step, tree,
                             meta=meta, keep=self.run_cfg.keep_checkpoints)

        self.join_pending_checkpoint()  # never two concurrent writers
        if self.run_cfg.async_checkpoint and not block:
            self._ckpt_thread = threading.Thread(target=write, daemon=True)
            self._ckpt_thread.start()
        else:
            write()

    def join_pending_checkpoint(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    def restore(self) -> bool:
        """Resume from the newest complete checkpoint; returns True if found.
        Over a mesh every rank restores the step its first rank finds."""
        step = checkpoints.latest_step(self.run_cfg.checkpoint_dir)
        if self.mesh is not None:
            box, group = [step], collectives.mesh_group(self.mesh)
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group)
            step = box[0]
        if step is None:
            return False
        tree, manifest = checkpoints.restore(
            self.run_cfg.checkpoint_dir, step, self._state_tree())
        self._load_state(tree, manifest)
        return True

    def _log(self, record: dict) -> None:
        if not self.writer:
            return
        os.makedirs(os.path.dirname(self.metrics_path) or ".", exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def _host_copy(tree: dict) -> dict:
    return {k: _host_copy(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _copy_into(dst: dict, src: dict) -> None:
    with torch.no_grad():
        for k, v in dst.items():
            if isinstance(v, dict):
                _copy_into(v, src[k])
            else:
                v.copy_(src[k])


class Runner(RunnerBase):
    def __init__(self, env: Env, fleet: FleetConfig,
                 ppo_cfg: ppo_lib.PPOConfig | None = None,
                 run_cfg: RunnerConfig | None = None, *, mesh=None,
                 device: str | torch.device | None = None,
                 failure_injector: Callable[[int], None] | None = None):
        super().__init__(run_cfg, mesh=mesh)
        self.ppo_cfg = ppo_cfg or ppo_lib.PPOConfig()
        self.orch = Orchestrator(env, fleet, mesh=mesh,
                                 seed=self.run_cfg.seed, device=device)
        self.device = self.orch.device
        self.failure_injector = failure_injector
        # weights drawn on the CPU, so a seed gives the same policy anywhere
        init_gen = torch.Generator().manual_seed(self.run_cfg.seed)
        self.policy = policy_lib.Policy(self.orch.pcfg, init_gen).to(self.device)
        elastic.reshard(self.policy, mesh)
        self.opt = ppo_lib.make_optimizer(self.policy, self.ppo_cfg)

    # --- checkpoint hooks -----------------------------------------------------
    def _state_tree(self) -> dict:
        params = dict(self.policy.named_parameters())
        return {"params": params,
                "opt": {name: self.opt.state[p] for name, p in params.items()}}

    def _load_state(self, tree: dict, manifest: dict) -> None:
        _copy_into(self._state_tree(), tree)
        self.iteration = int(manifest["meta"]["iteration"])

    def _checkpoint_meta(self) -> dict:
        return {**super()._checkpoint_meta(), "n_envs": self.orch.fleet.n_envs}

    # --- training ---------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_iteration(self, k: int) -> dict:
        """One synchronous PPO iteration (sample fleet -> n_epochs updates)."""
        gen = torch.Generator(device=self.device).manual_seed(
            iteration_seed(self.run_cfg.seed, k))
        t0 = time.perf_counter()
        traj = self.orch.sample_fleet(self.policy, gen)
        self._sync()
        t_sample = time.perf_counter() - t0
        if self.failure_injector is not None:
            self.failure_injector(k)  # may raise — exercised by tests
        t0 = time.perf_counter()
        backup = _host_copy(self._state_tree())
        try:
            stats = ppo_lib.update(self.policy, self.opt, self.ppo_cfg, traj)
        except BaseException:
            # epochs that stepped before the failure leave params and Adam
            # state half-updated: put back the state of before the update,
            # as the reference's functional update never assigned it, so
            # that a retry starts from there
            _copy_into(self._state_tree(), backup)
            raise
        stats = {n: float(v) for n, v in stats.items()}
        # never let a non-finite update poison the params / checkpoints:
        # restore the previous state and record the skip
        if not all(np.isfinite(v) for v in stats.values()):
            _copy_into(self._state_tree(), backup)
            self._log({"iteration": k, "skipped_nonfinite_update": True})
        t_update = time.perf_counter() - t0
        return {
            "iteration": k,
            "t_sample_s": t_sample,
            "t_update_s": t_update,
            "return_norm": stats["mean_return"] / traj.rewards.shape[0],
            **{f"ppo/{n}": v for n, v in stats.items()},
        }

    def train(self, n_iterations: int | None = None, *, resume: bool = True,
              max_retries: int = 2) -> list[dict]:
        """The full loop with crash recovery.  Returns per-iteration records."""
        total = n_iterations or self.run_cfg.n_iterations
        if resume:
            self.restore()
        history: list[dict] = []
        while self.iteration < total:
            k = self.iteration
            for attempt in range(max_retries + 1):
                try:
                    record = self.run_iteration(k)
                    break
                except RuntimeError as e:  # injected / transient failure
                    if attempt == max_retries:
                        raise
                    # deterministic replay: params/opt are those of before
                    # the update (`run_iteration` restores them on failure)
                    self.restore()
                    record = {"iteration": k, "retry": attempt + 1,
                              "error": str(e)}
                    self._log(record)
            if (k + 1) % self.run_cfg.eval_every == 0:
                record["eval_return_norm"] = self.orch.evaluate(self.policy)
            self._log(record)
            history.append(record)
            self.iteration = k + 1
            if (k + 1) % self.run_cfg.checkpoint_every == 0:
                self.save_checkpoint()
        self.save_checkpoint(block=True)
        self.join_pending_checkpoint()
        return history
