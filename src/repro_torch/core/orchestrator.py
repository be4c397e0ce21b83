"""Environment orchestrator (PyTorch port of `repro.core.orchestrator`).

It owns the fleet size and the initial-state bank, which lives on the device
(generated once by the env's `initial_state_bank` hook, indexed per episode:
the RAM-disk trick of the paper's Relexi taken to its endpoint).  Episode i
of iteration k is determined by (seed, k, bank index), so a failed iteration
can be re-run from the same inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..envs.base import Env
from . import policy as policy_lib
from . import ppo as ppo_lib
from . import rollout as rollout_lib


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_envs: int = 16          # parallel environments (paper: 16/32/64...1024)
    bank_size: int = 17       # initial states; last one is the held-out test


class Orchestrator:
    """Owns the env fleet, the state bank and the fleet programs."""

    def __init__(self, env: Env, fleet: FleetConfig, *, seed: int = 0,
                 device: str | torch.device | None = None):
        self.env = env
        self.fleet = fleet
        self.device = resolve_device(device)
        self.pcfg = policy_lib.PolicyConfig.from_specs(env.obs_spec,
                                                       env.action_spec)
        bank_gen = torch.Generator(device=self.device).manual_seed(seed)
        # index -1 is the unseen test state
        self.bank = env.initial_state_bank(bank_gen, fleet.bank_size)

    def draw_initial_states(self, gen: torch.Generator,
                            n_envs: int | None = None) -> torch.Tensor:
        """Random bank rows (excluding the held-out test state), (B, ...)."""
        if n_envs is not None and n_envs <= 0:
            raise ValueError(
                f"n_envs must be a positive environment count, got {n_envs} "
                "(pass None for the configured fleet size)")
        n = self.fleet.n_envs if n_envs is None else n_envs
        idx = torch.randint(0, self.fleet.bank_size - 1, (n,), generator=gen,
                            device=self.device)
        return self.bank[idx]

    def test_state(self) -> torch.Tensor:
        """The single held-out initial state, batched to (1, ...)."""
        return self.bank[-1:]

    def sample_fleet(self, policy: policy_lib.Policy,
                     gen: torch.Generator) -> ppo_lib.Trajectory:
        """One synchronous sampling pass over the whole fleet."""
        u0 = self.draw_initial_states(gen)
        return rollout_lib.rollout(policy, self.env, u0, gen=gen)

    def evaluate(self, policy: policy_lib.Policy) -> float:
        """Deterministic (mean-action) episode on the held-out state ->
        normalized return, as the paper's test-state curve in Fig. 5."""
        traj = rollout_lib.rollout(policy, self.env, self.test_state(),
                                   deterministic=True)
        return float(rollout_lib.normalized_return(traj)[0])
