"""Plain PyTorch reference of the paper's policy (Table 2) and its PPO
update (Sec. 5.3): two convolution trunks (actor, critic), a
state-independent log-std, clipped PPO with GAE, global-norm gradient
clipping and Adam, written out as plain functional PyTorch over a dict of
leaves named as the program names its parameters.  Float32 with TF32 off
(`exact_float32`).  Imports nothing of the program."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LOG_STD_INIT = -1.6
# PPO as the paper runs it (Sec. 5.3) with the GAE lambda and value
# coefficient of TF-Agents, and Adam's defaults
GAMMA, LAM, CLIP, VALUE_COEF, ENTROPY_COEF = 0.995, 0.95, 0.2, 0.5, 0.0
N_EPOCHS, LR, GRAD_CLIP = 5, 1e-4, 1.0
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, deterministic cuDNN; the
    caller's flags restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32
    cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32 = False, True, \
        False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32 = before


def conv_plan(n: int) -> list[tuple[int, int, int]]:
    """[(kernel, filters, padding)] taking n nodes a direction down to 1: a
    padded k3 layer of 8 filters, then unpadded k3 layers (the last of 4
    filters) until 2 or 1 nodes are left, then a k2 layer of 1 filter (for
    an odd n the last k3 layer emits the 1 filter)."""
    plan = [(3, 8, 1)]
    size = n
    n_valid = max((size - 1) // 2, 0)
    for i in range(n_valid):
        plan.append((3, 4 if i == n_valid - 1 else 8, 0))
        size -= 2
    if size == 2:
        plan.append((2, 1, 0))
    else:
        k, _, pad = plan.pop()
        plan.append((k, 1, pad))
    return plan


def init_params(seed: int, n: int, channels: int, shape: dict | None = None,
                cs_max: float = 0.5) -> dict:
    """He-normal weights and zero biases drawn on the host from a generator
    seeded with `seed`: the actor's layers, then the critic's.  `shape`
    (the traffic's `policy`) then scales the actor's last weights by
    `actor_out_scale`, sets its last bias so that a zero input gives the
    mean action `mean_cs`, and sets `log_std`."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    trunks = {}
    for trunk in ("actor", "critic"):
        c_in = channels
        layers = []
        for i, (k, f, _) in enumerate(conv_plan(n)):
            w = torch.randn((f, c_in, k, k, k), generator=gen) * math.sqrt(
                2.0 / (k**3 * c_in))
            layers.append((f"{trunk}.{i}.weight", w))
            layers.append((f"{trunk}.{i}.bias", torch.zeros(f)))
            c_in = f
        trunks[trunk] = layers
    params["log_std"] = torch.tensor(LOG_STD_INIT)
    for trunk in ("actor", "critic"):
        params.update(trunks[trunk])
    if shape is not None:
        last = len(conv_plan(n)) - 1
        p = shape["mean_cs"] / cs_max
        params[f"actor.{last}.weight"] = params[f"actor.{last}.weight"] \
            * shape["actor_out_scale"]
        params[f"actor.{last}.bias"] = torch.full_like(
            params[f"actor.{last}.bias"], math.log(p / (1.0 - p)))
        params["log_std"] = torch.tensor(float(shape["log_std"]))
    return params


def trunk(params: dict, name: str, obs, n: int):
    """obs (..., E, n, n, n, C) -> per-element scalar (..., E)."""
    batch = obs.shape[:-4]
    x = torch.movedim(obs.reshape((-1,) + tuple(obs.shape[-4:])), -1, 1)
    plan = conv_plan(n)
    for i, (_, _, pad) in enumerate(plan):
        x = F.conv3d(x, params[f"{name}.{i}.weight"],
                     params[f"{name}.{i}.bias"], padding=pad)
        if i < len(plan) - 1:
            x = torch.relu(x)
    return x.reshape(batch)


def distribution(params: dict, obs, n: int, cs_max: float):
    """(mean in [0, cs_max], std) of the per-element Gaussian."""
    mean = cs_max * torch.sigmoid(trunk(params, "actor", obs, n))
    return mean, torch.exp(params["log_std"]).expand(mean.shape)


def value(params: dict, obs, n: int):
    return torch.mean(trunk(params, "critic", obs, n), dim=-1)


def log_prob(mean, std, action):
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - torch.log(std)
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gae(rewards, values, dones, last_value):
    not_done = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + GAMMA * next_values * not_done - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[-1])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + GAMMA * LAM * not_done[t] * carry
        advs[t] = carry
    return advs, advs + values


def ppo_loss(params, obs, actions, old_lp, advs, returns, n, cs_max):
    mean, std = distribution(params, obs, n, cs_max)
    ratio = torch.exp(log_prob(mean, std, actions) - old_lp)
    clipped = torch.clamp(ratio, 1.0 - CLIP, 1.0 + CLIP)
    surrogate = -torch.mean(torch.minimum(ratio * advs, clipped * advs))
    value_loss = 0.5 * torch.mean((value(params, obs, n) - returns) ** 2)
    entropy = torch.mean(torch.sum(
        0.5 * math.log(2.0 * math.pi * math.e) + torch.log(std), dim=-1))
    return surrogate + VALUE_COEF * value_loss - ENTROPY_COEF * entropy


def init_adam(params: dict) -> dict:
    return {"step": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def update(params: dict, adam: dict, traj: dict, n: int, cs_max: float,
           epochs: int = N_EPOCHS) -> tuple[dict, list, list]:
    """One PPO update (GAE once, `epochs` full-batch steps) on a
    time-major trajectory {obs, actions, log_probs, rewards, dones, values,
    last_value}.  Returns (params, each epoch's loss, each epoch's clipped
    gradient); `adam` is updated in place."""
    advs, rets = gae(traj["rewards"], traj["values"], traj["dones"],
                     traj["last_value"])
    flat = [x.reshape((-1,) + tuple(x.shape[2:])) for x in (
        traj["obs"], traj["actions"], traj["log_probs"], advs, rets)]
    obs, act, old_lp, adv, ret = flat
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    losses, grads = [], []
    for _ in range(epochs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = ppo_loss(leaves, obs, act, old_lp, adv, ret, n, cs_max)
        names = list(leaves)
        g = torch.autograd.grad(loss, [leaves[k] for k in names])
        norm = torch.sqrt(sum(torch.sum(x**2) for x in g))
        scale = torch.clamp(GRAD_CLIP / torch.clamp_min(norm, 1e-12), max=1.0)
        g = {k: x * scale for k, x in zip(names, g)}
        adam["step"] += 1
        t = adam["step"]
        new = {}
        for k in names:
            m = adam["m"][k] = BETA1 * adam["m"][k] + (1 - BETA1) * g[k]
            v = adam["v"][k] = BETA2 * adam["v"][k] + (1 - BETA2) * g[k] ** 2
            denom = torch.sqrt(v) / math.sqrt(1 - BETA2**t) + EPS
            new[k] = params[k] - LR / (1 - BETA1**t) * m / denom
        params = new
        losses.append(float(loss.detach()))
        grads.append({k: x.detach() for k, x in g.items()})
    return params, losses, grads
