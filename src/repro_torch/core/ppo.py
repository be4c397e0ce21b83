"""Clip-PPO (Schulman et al. 2017) with GAE, the paper's RL algorithm
(PyTorch port of `repro.core.ppo`).

Synchronous on-policy training as in the paper (Sec. 5.3): sample a batch of
complete episodes with the current policy, then run `n_epochs` full-batch
gradient steps.  Defaults are the paper's: gamma=0.995, lr=1e-4, Adam,
5 epochs, clip 0.2, entropy coefficient 0.  Trajectories are time-major,
(T, B, ...).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import policy as policy_lib


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.995          # paper Sec. 5.3
    lam: float = 0.95             # GAE lambda (TF-Agents default)
    clip: float = 0.2             # paper Sec. 5.3
    entropy_coef: float = 0.0     # paper Sec. 5.3
    value_coef: float = 0.5
    n_epochs: int = 5             # paper Sec. 5.3
    lr: float = 1e-4              # paper Sec. 5.3
    grad_clip: float | None = 1.0
    normalize_advantages: bool = True


class Trajectory(NamedTuple):
    """Time-major rollout batch; episodes end at t_end, so dones[-1] = True."""

    obs: torch.Tensor        # (T, B, E, n, n, n, C)
    actions: torch.Tensor    # (T, B, E)
    log_probs: torch.Tensor  # (T, B)
    rewards: torch.Tensor    # (T, B)
    dones: torch.Tensor      # (T, B) bool, True where the episode ends at t
    values: torch.Tensor     # (T, B) V(s_t) under the behavior policy
    last_value: torch.Tensor  # (B,) V(s_T)


def make_optimizer(policy: policy_lib.Policy,
                   cfg: PPOConfig) -> torch.optim.Adam:
    """Adam(lr, eps=1e-8) with its state made up front (step 0, zero
    moments), so that checkpoints have the same tree before the first step;
    the first step is the same as with lazily made state."""
    opt = torch.optim.Adam(policy.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for p in policy.parameters():
        opt.state[p] = {"step": torch.tensor(0.0),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
    return opt


def gae(traj: Trajectory, gamma: float, lam: float):
    """Generalized advantage estimation; returns (advantages, returns), (T, B).

    delta_t = r_{t+1} + gamma V(s_{t+1}) (1-done) - V(s_t)
    A_t     = delta_t + gamma lam (1-done) A_{t+1}
    """
    not_done = 1.0 - traj.dones.to(torch.float32)
    next_values = torch.cat([traj.values[1:], traj.last_value[None]], dim=0)
    deltas = traj.rewards + gamma * next_values * not_done - traj.values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[-1])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        advs[t] = carry
    return advs, advs + traj.values


def flatten_batch(traj: Trajectory, advantages: torch.Tensor,
                  returns: torch.Tensor, *, normalize: bool):
    """Flatten a time-major batch to the (T*B) tensors (obs, actions,
    log_probs, advantages, returns), optionally normalizing the advantages."""
    obs_f, act_f, lp_f, adv_f, ret_f = (
        x.reshape((-1,) + tuple(x.shape[2:]))
        for x in (traj.obs, traj.actions, traj.log_probs, advantages, returns))
    if normalize:  # population std, as jnp.std
        adv_f = (adv_f - adv_f.mean()) / (adv_f.std(correction=0) + 1e-8)
    return obs_f, act_f, lp_f, adv_f, ret_f


def ppo_loss(policy: policy_lib.Policy, cfg: PPOConfig, obs: torch.Tensor,
             actions: torch.Tensor, old_log_probs: torch.Tensor,
             advantages: torch.Tensor, returns: torch.Tensor):
    """Clipped surrogate + value loss + entropy bonus on a flat batch."""
    mean, std = policy.distribution(obs)
    new_log_probs = policy_lib.log_prob(mean, std, actions)
    ratio = torch.exp(new_log_probs - old_log_probs)
    clipped = torch.clamp(ratio, 1.0 - cfg.clip, 1.0 + cfg.clip)
    surrogate = -torch.mean(torch.minimum(ratio * advantages,
                                          clipped * advantages))
    value_loss = 0.5 * torch.mean((policy.value(obs) - returns) ** 2)
    ent = torch.mean(policy_lib.entropy(std))
    loss = surrogate + cfg.value_coef * value_loss - cfg.entropy_coef * ent
    stats = {
        "loss": loss,
        "surrogate": surrogate,
        "value_loss": value_loss,
        "entropy": ent,
        "approx_kl": torch.mean(old_log_probs - new_log_probs),
        "clip_frac": torch.mean(
            (torch.abs(ratio - 1.0) > cfg.clip).to(torch.float32)),
    }
    return loss, stats


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2)
                          for t in tensors))


def update_epoch(policy: policy_lib.Policy, opt: torch.optim.Adam,
                 cfg: PPOConfig, traj: Trajectory, advantages: torch.Tensor,
                 returns: torch.Tensor) -> dict:
    """One full-batch gradient step over the flattened (T*B) experience."""
    batch = flatten_batch(traj, advantages, returns,
                          normalize=cfg.normalize_advantages)
    opt.zero_grad(set_to_none=False)
    loss, stats = ppo_loss(policy, cfg, *batch)
    loss.backward()
    grads = [p.grad for p in policy.parameters()]
    norm = global_norm(grads)
    if cfg.grad_clip is not None:
        # scale = min(1, c / max(|g|, 1e-12)), as the reference's clip
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(norm, 1e-12),
                            max=1.0)
        for g in grads:
            g.mul_(scale)
    opt.step()
    stats = {k: v.detach() for k, v in stats.items()}
    stats["grad_norm"] = norm.detach()
    return stats


def update(policy: policy_lib.Policy, opt: torch.optim.Adam, cfg: PPOConfig,
           traj: Trajectory) -> dict:
    """Full PPO update: GAE once, then n_epochs gradient steps; the stats are
    the last epoch's plus the mean episode return."""
    advantages, returns = gae(traj, cfg.gamma, cfg.lam)
    for _ in range(cfg.n_epochs):
        stats = update_epoch(policy, opt, cfg, traj, advantages, returns)
    stats["mean_return"] = torch.mean(torch.sum(traj.rewards, dim=0))
    return stats
