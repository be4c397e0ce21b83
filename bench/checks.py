"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`bench/reference/`), which works the bank,
the draws and the initial weights out again from the seed.

A rollout is followed step by step from the program's own state: a sample
(episode, env row r, step t) drawn from the seed holds the program's state
row before and after step t and the trajectory's rows at t and t + 1.  The
reference starts from the program's state before step t (at t = 0 from its
own bank row, which checks the start), draws its own action from its own
policy and the regenerated noise, advances one RL interval, and gives the
reward, the next observation and the policy's outputs at t + 1.  So each
number below covers the fused RHS, RK5(4), the forcing, the guard, the
reward, the observation and the policy, and the bank at t = 0.

A PPO update is followed from the program's trajectories: the reference
starts from its own initial weights and runs its own update on each."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .reference import hit, policy as ref_policy

# each number's reading is the largest over the samples of a run
ROLLOUT_NUMBERS = ("state", "obs", "reward", "policy")
BLOCK = 32  # samples the reference advances at once


def plan(seed: int, episode: int, n_envs: int, n_steps: int,
         count: int) -> list[tuple[int, int]]:
    """`count` (row, step) samples of one episode, drawn from the seed: the
    first at step 0, the others at steps 1 to n_steps - 2, rows distinct."""
    rng = np.random.default_rng([seed, episode, 0x5A])
    rows = rng.choice(n_envs, size=min(count, n_envs), replace=False)
    steps = [0] + ([int(x) for x in rng.integers(1, n_steps - 1,
                                                 size=len(rows) - 1)]
                   if n_steps > 2 else [0] * (len(rows) - 1))
    return [(int(r), t) for r, t in zip(rows, steps)]


def by_step(samples: list[tuple[int, int]]) -> dict[int, tuple[int, ...]]:
    out: dict[int, tuple[int, ...]] = {}
    for r, t in samples:
        out[t] = out.get(t, ()) + (r,)
    return out


def take(traj, kept: dict, episode: int, samples, tag=None) -> list[dict]:
    """The program's outputs at each sample: its state rows before and
    after step t, and rows t and t + 1 of the trajectory."""
    out = []
    for r, t in samples:
        out.append({
            "episode": episode, "row": r, "t": t, "tag": tag,
            "u_in": kept[(r, t)], "u_out": kept[(r, t + 1)],
            "obs": traj.obs[t:t + 2, r].clone(),
            "act": traj.actions[t:t + 2, r].clone(),
            "lp": traj.log_probs[t:t + 2, r].clone(),
            "val": traj.values[t:t + 2, r].clone(),
            "rew": traj.rewards[t, r].clone()})
    return out


def _gap(got, want, scale) -> float:
    g = float(torch.max(torch.abs(got.float() - want.float())) / scale)
    return g if math.isfinite(g) else math.inf


def rollout_numbers(case: hit.Case, ops: hit.Operators, samples: list,
                    params_of, draws_of, bank) -> dict:
    """The four rollout numbers over `samples`: `params_of(tag)` the
    reference's policy leaves for a sample's tag, `draws_of(episode)` the
    regenerated (bank rows, noise) of an episode, `bank` the reference's
    bank."""
    refs = []
    for tag in dict.fromkeys(s["tag"] for s in samples):
        group = [s for s in samples if s["tag"] == tag]
        params = params_of(tag)
        for i in range(0, len(group), BLOCK):
            refs += _reference_block(case, ops, group[i:i + BLOCK], params,
                                     draws_of, bank)
    v_scale = max([float(torch.max(torch.abs(r["val"]))) for r in refs]
                  + [1e-6])
    lp_scale = max([float(torch.max(torch.abs(r["lp"]))) for r in refs]
                   + [1e-6])
    out = dict.fromkeys(ROLLOUT_NUMBERS, 0.0)
    for s, r in zip(samples, refs):
        state = max(_gap(s["u_out"][..., c], r["u_out"][..., c],
                         torch.max(torch.abs(r["u_out"][..., c])))
                    for c in range(5))
        obs = _gap(s["obs"], r["obs"], torch.max(torch.abs(r["obs"])))
        pol = max(_gap(s["act"], r["act"], case.cs_max),
                  _gap(s["val"], r["val"], v_scale),
                  _gap(s["lp"], r["lp"], lp_scale))
        for key, x in (("state", state), ("obs", obs), ("policy", pol),
                       ("reward", _gap(s["rew"], r["rew"], 1.0))):
            out[key] = max(out[key], x)
    return out


def _reference_block(case, ops, group, params, draws_of, bank) -> list:
    n = case.n
    u, noise0, noise1 = [], [], []
    for s in group:
        idx, noise = draws_of(s["episode"])
        r, t = s["row"], s["t"]
        u.append(bank[idx[r]] if t == 0 else s["u_in"])
        noise0.append(noise[t, r])
        noise1.append(noise[t + 1, r])
    u = torch.stack(u).float()
    noise0, noise1 = torch.stack(noise0), torch.stack(noise1)
    with torch.no_grad(), ref_policy.exact_float32():
        obs0 = hit.observe(u, case)
        mean0, std = ref_policy.distribution(params, obs0, n, case.cs_max)
        act0 = mean0 + std * noise0
        lp0 = ref_policy.log_prob(mean0, std, act0)
        val0 = ref_policy.value(params, obs0, n)
        u1, rew, obs1 = hit.step(u, act0, case, ops)
        mean1, _ = ref_policy.distribution(params, obs1, n, case.cs_max)
        act1 = mean1 + std * noise1
        lp1 = ref_policy.log_prob(mean1, std, act1)
        val1 = ref_policy.value(params, obs1, n)
    return [{"u_out": u1[i], "obs": torch.stack([obs0[i], obs1[i]]),
             "act": torch.stack([act0[i], act1[i]]),
             "lp": torch.stack([lp0[i], lp1[i]]),
             "val": torch.stack([val0[i], val1[i]]), "rew": rew[i]}
            for i in range(len(group))]


def leaf_gaps(got: dict, want: dict, keep) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; (gap, leaf)."""
    norms = {k: float(torch.linalg.vector_norm(want[k].float()))
             for k in keep}
    median = statistics.median(norms.values())
    worst, leaf = 0.0, ""
    for k in keep:
        g = abs(float(torch.linalg.vector_norm(got[k].float())) - norms[k]) \
            / max(norms[k], median, 1e-30)
        g = g if math.isfinite(g) else math.inf
        if g >= worst:
            worst, leaf = g, k
    return worst, leaf


def ppo_numbers(case: hit.Case, program: dict, trajs: list, seed: int,
                epochs: int, shape: dict, device) -> tuple[dict, dict, list]:
    """The three PPO numbers of the first len(trajs) iterations, from the
    program's {losses (each iteration's last epoch), grad1 (the first
    clipped gradient, from Adam's state after one step), p0, p_end} and
    its trajectories; also the reference's parameters before each
    iteration (for the rollout samples) and the leaves left out of the
    change."""
    params = {k: v.to(device) for k, v in ref_policy.init_params(
        seed, case.n, 3, shape, case.cs_max).items()}
    adam = ref_policy.init_adam(params)
    before, losses, grad1 = [], [], None
    p0 = params
    with ref_policy.exact_float32():
        for traj in trajs:
            before.append(params)
            params, epoch_losses, grads = ref_policy.update(
                params, adam, traj, case.n, case.cs_max, epochs)
            losses.append(epoch_losses[-1])
            grad1 = grads[0] if grad1 is None else grad1
    loss = max((abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(program["losses"], losses)), default=0.0)
    loss = loss if math.isfinite(loss) else math.inf
    g_norms = {k: float(torch.linalg.vector_norm(v)) for k, v in grad1.items()}
    median = statistics.median(g_norms.values())
    moved = [k for k in grad1 if g_norms[k] >= 1e-3 * median]
    still = sorted(set(grad1) - set(moved))
    grad, grad_leaf = leaf_gaps(program["grad1"], grad1, list(grad1))
    update, update_leaf = leaf_gaps(
        {k: program["p_end"][k] - program["p0"][k] for k in moved},
        {k: params[k] - p0[k] for k in moved}, moved)
    numbers = {"loss": loss, "grad": grad, "update": update}
    where = {"grad_leaf": grad_leaf, "update_leaf": update_leaf,
             "still_leaves": still}
    return numbers, where, before
