"""Synchronous fleet rollout (PyTorch port of `repro.core.rollout`; paper
Algorithm 1, lines 4-13).

The environment batch is one tensor program: a Python loop over the episode
steps observe -> policy -> Gaussian action -> `env.step` over all B envs at
once.  Generic over any registered `Env`.
"""
from __future__ import annotations

import torch

from ..envs.base import Env, EnvState
from . import policy as policy_lib
from .ppo import Trajectory


@torch.no_grad()
def rollout(policy: policy_lib.Policy, env: Env, u0: torch.Tensor, *,
            gen: torch.Generator | None = None,
            noise: torch.Tensor | None = None,
            deterministic: bool = False) -> Trajectory:
    """Roll a batch of environments for one full episode (T = env.n_actions).

    u0: (B, *state_shape) initial solver states (bank rows).  The per-step
    action noise (T, B, *action_shape) is drawn from `gen` before the loop,
    as the reference draws it before its scan, or fed in as `noise` (the
    tests feed the reference's draws).  A deterministic rollout takes the
    mean action and draws nothing.  Returns a time-major Trajectory.
    """
    n_steps = env.n_actions
    batch = u0.shape[0]
    state = EnvState(u=u0, t_step=torch.zeros((batch,), dtype=torch.int32,
                                              device=u0.device))
    if not deterministic and noise is None:
        if gen is None:
            raise ValueError("a stochastic rollout needs `gen` or `noise`")
        noise = torch.randn((n_steps, batch) + env.action_spec.shape,
                            generator=gen, device=u0.device)
    out = {k: [] for k in ("obs", "actions", "log_probs", "rewards", "dones",
                           "values")}
    for t in range(n_steps):
        obs = env.observe(state)
        mean, std = policy.distribution(obs)
        action = mean if deterministic else mean + std * noise[t]
        out["obs"].append(obs)
        out["actions"].append(action)
        out["log_probs"].append(policy_lib.log_prob(mean, std, action))
        out["values"].append(policy.value(obs))
        res = env.step(state, action)
        out["rewards"].append(res.reward)
        out["dones"].append(res.done)
        state = res.state
    last_value = policy.value(env.observe(state))
    return Trajectory(**{k: torch.stack(v) for k, v in out.items()},
                      last_value=last_value)


def episode_return(traj: Trajectory) -> torch.Tensor:
    """Undiscounted per-environment episode return (B,)."""
    return torch.sum(traj.rewards, dim=0)


def normalized_return(traj: Trajectory) -> torch.Tensor:
    """Return normalized by the maximum achievable (+1 per step), as Fig. 5."""
    return episode_return(traj) / traj.rewards.shape[0]
