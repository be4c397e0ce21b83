"""Synchronous fleet rollout (PyTorch port of `repro.core.rollout`; paper
Algorithm 1, lines 4-13).

The environment batch is one tensor program: a Python loop over the episode
steps observe -> policy -> Gaussian action -> `env.step` over all B envs at
once.  Generic over any registered `Env`.
"""
from __future__ import annotations

import torch

from .. import conv_precision
from ..envs.base import Env, EnvState
from . import collectives, policy as policy_lib
from .ppo import Trajectory


@torch.no_grad()
@conv_precision()
def rollout(policy: policy_lib.Policy, env: Env, u0: torch.Tensor, *,
            gen: torch.Generator | None = None,
            noise: torch.Tensor | None = None,
            deterministic: bool = False) -> Trajectory:
    """Roll a batch of environments for one full episode (T = env.n_actions).

    u0: (B, *state_shape) initial solver states (bank rows).  The per-step
    action noise (T, B, *action_shape) is drawn from `gen` before the loop,
    as the reference draws it before its scan, or fed in as `noise` (the
    tests feed the reference's draws).  A deterministic rollout takes the
    mean action and draws nothing.  The policy's convolutions run in the
    package's precision (`repro_torch.conv_precision`).  Returns a
    time-major Trajectory.
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


@torch.no_grad()
def constant_action_return(env: Env, u0: torch.Tensor, value: float) -> float:
    """Normalized episode return of a constant-action policy on initial
    states u0 (B, *state_shape): the mean reward over envs, summed over
    the `env.n_actions` steps, over `n_actions`.  The paper's static
    baselines (Fig. 5 bottom: Smagorinsky C_s = 0.17, implicit LES
    C_s = 0), for any Env.  Draws no random numbers; the step means stay
    on the device until the episode ends and are summed on the host in
    step order, as the reference sums them."""
    state = EnvState(u=u0, t_step=torch.zeros((u0.shape[0],),
                                              dtype=torch.int32,
                                              device=u0.device))
    action = torch.full((u0.shape[0],) + env.action_spec.shape, value,
                        dtype=torch.float32, device=u0.device)
    means = []
    for _ in range(env.n_actions):
        res = env.step(state, action)
        state = res.state
        means.append(torch.mean(res.reward))
    total = 0.0
    for m in torch.stack(means).tolist():
        total += m
    return total / env.n_actions


def slice_traj(traj: Trajectory, n_envs: int) -> Trajectory:
    """Drop the padding rows: (T, B_pad, ...) -> (T, n_envs, ...)."""
    return Trajectory(
        obs=traj.obs[:, :n_envs], actions=traj.actions[:, :n_envs],
        log_probs=traj.log_probs[:, :n_envs],
        rewards=traj.rewards[:, :n_envs], dones=traj.dones[:, :n_envs],
        values=traj.values[:, :n_envs], last_value=traj.last_value[:n_envs])


def gather_traj(traj: Trajectory, group) -> Trajectory:
    """Every rank's rows of a trajectory, concatenated along the batch axis
    in the group's rank order (equal row counts on every rank)."""
    return Trajectory(**{
        field: collectives.all_gather_cat(x, group,
                                       dim=0 if field == "last_value" else 1)
        for field, x in traj._asdict().items()})
