"""Multi-scenario policy: shared trunk, per-scenario adapters and heads
(PyTorch port of `repro.fleet.multitask`).

One parameter tree serves every scenario of a heterogeneous fleet.  The
scenarios disagree on spatial rank (3-D HIT vs 1-D Burgers), node count,
channel count and action bounds, so the sharing happens in a rank-free
embedding space:

    obs (..., E, *spatial, C)
      -> declared per-channel gains (ObsSpec.channel_specs)
      -> flatten per-element nodes to F = prod(spatial) * C features
      -> per-scenario ADAPTER: dense F -> d_embed            (scenario)
      -> shared TRUNK: n_shared_layers x [dense d -> d, ReLU] (shared)
      -> per-scenario HEAD: dense d -> 1                      (scenario)
    actor:  mean = low + (high - low) * sigmoid(head) per element, with a
            per-scenario learnable log_std
    critic: mean over elements of the per-element head scalar

`MultiTaskPolicy.head(name)` is scenario `name` as a `Policy`-like object
(`actor_mean`, `distribution`, `value`), so the UNCHANGED rollout and PPO
loss of `core/` drive it; `fleet_update` is the joint PPO step, one Adam
update of the whole tree from the weighted sum of per-scenario losses,
which trains the shared trunk on all scenarios at once, and
`guarded_fleet_update` wraps it in the non-finite guard.  Dense weights are
(d_in, d_out) as in the JAX package (`nn.layers.dense`), so
`load_jax_params` carries the reference's tree across unchanged.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import nn
from ..core import ppo as ppo_lib
from ..envs.base import Env


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Static per-scenario head declaration, derived from the env specs."""

    name: str
    n_elements: int
    spatial: tuple[int, ...]
    channels: int
    gains: tuple[float, ...]
    act_low: float
    act_high: float

    @classmethod
    def from_env(cls, name: str, env: Env) -> "HeadSpec":
        obs, act = env.obs_spec, env.action_spec
        return cls(name=name, n_elements=obs.n_elements,
                   spatial=tuple(obs.spatial), channels=obs.channels,
                   gains=tuple(obs.channel_gains),
                   act_low=act.low, act_high=act.high)

    @property
    def in_features(self) -> int:
        """F: flattened per-element feature width."""
        return int(np.prod(self.spatial)) * self.channels


@dataclasses.dataclass(frozen=True)
class MultiTaskConfig:
    """Hashable static configuration of the multitask policy."""

    heads: tuple[HeadSpec, ...]
    d_embed: int = 32
    n_shared_layers: int = 2
    log_std_init: float = -1.6

    def __post_init__(self):
        names = self.names
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate head names: {names}")

    @classmethod
    def from_envs(cls, named_envs, **kwargs) -> "MultiTaskConfig":
        """Build from [(name, env), ...], each head from the env's specs."""
        return cls(heads=tuple(HeadSpec.from_env(n, e) for n, e in named_envs),
                   **kwargs)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(h.name for h in self.heads)

    def head(self, name: str) -> HeadSpec:
        for h in self.heads:
            if h.name == name:
                return h
        raise KeyError(f"unknown scenario head {name!r}; have {self.names}")


# --- parameters --------------------------------------------------------------
def init(gen: torch.Generator, cfg: MultiTaskConfig) -> dict:
    """The parameter tree (CPU tensors) drawn from `gen`."""
    d = cfg.d_embed
    shared = {trunk: [nn.dense_init(gen, d, d)
                      for _ in range(cfg.n_shared_layers)]
              for trunk in ("actor", "critic")}
    heads = {h.name: {
        "actor_in": nn.dense_init(gen, h.in_features, d),
        "critic_in": nn.dense_init(gen, h.in_features, d),
        "actor_out": nn.dense_init(gen, d, 1),
        "critic_out": nn.dense_init(gen, d, 1),
        "log_std": torch.full((), cfg.log_std_init),
    } for h in cfg.heads}
    return {"shared": shared, "heads": heads}


# --- forward -----------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _gains(gains: tuple[float, ...], dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The declared channel gains as a tensor, made once per (gains, dtype,
    device): a host-to-device copy on every forward would break the
    serving path's CUDA graph capture."""
    return torch.tensor(gains, dtype=dtype, device=device)


def _features(head: HeadSpec, obs: torch.Tensor) -> torch.Tensor:
    """(..., E, *spatial, C) -> (..., E, F) with declared gains applied."""
    x = obs
    if any(g != 1.0 for g in head.gains):
        x = x * _gains(head.gains, x.dtype, x.device)
    lead = tuple(x.shape[: x.ndim - (len(head.spatial) + 1)])
    return x.reshape(lead + (head.in_features,))


def _head_scalar(shared, adapter, out, head: HeadSpec,
                 obs: torch.Tensor) -> torch.Tensor:
    """Adapter -> shared trunk -> head: per-element scalar (..., E)."""
    x = torch.relu(nn.dense(adapter, _features(head, obs)))
    for layer in shared:
        x = torch.relu(nn.dense(layer, x))
    return nn.dense(out, x)[..., 0]


def actor_mean(params, cfg: MultiTaskConfig, name: str,
               obs: torch.Tensor) -> torch.Tensor:
    h = cfg.head(name)
    p = params["heads"][name]
    logits = _head_scalar(params["shared"]["actor"], p["actor_in"],
                          p["actor_out"], h, obs)
    return h.act_low + (h.act_high - h.act_low) * _logistic(logits)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), elementwise.  Written out because `torch.sigmoid`
    on the CPU computes the elements past the last full vector another way,
    so a row's action would depend (by an ulp) on its place in the batch,
    and served batch-1 and batch-N rows would differ.  exp only ever sees
    -|x|, so neither branch overflows and the gradient stays finite at any
    logit."""
    e = torch.exp(-x.abs())
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def value(params, cfg: MultiTaskConfig, name: str,
          obs: torch.Tensor) -> torch.Tensor:
    h = cfg.head(name)
    p = params["heads"][name]
    per_elem = _head_scalar(params["shared"]["critic"], p["critic_in"],
                            p["critic_out"], h, obs)
    return torch.mean(per_elem, dim=-1)


def distribution(params, cfg: MultiTaskConfig, name: str,
                 obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mean = actor_mean(params, cfg, name, obs)
    std = torch.exp(params["heads"][name]["log_std"]).to(mean.dtype)
    return mean, std.expand(mean.shape)


class MultiTaskPolicy(torch.nn.Module):
    """The trainable parameter tree (`params`, an `nn.ParamTree` whose
    `named_parameters()` are the JAX leaf paths) with its config."""

    def __init__(self, cfg: MultiTaskConfig,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.params = nn.ParamTree(init(gen, cfg), requires_grad=True)

    def head(self, name: str) -> "ScenarioHead":
        self.cfg.head(name)  # fail fast on unknown scenarios
        return ScenarioHead(self, name)


class ScenarioHead:
    """Scenario `name` of a `MultiTaskPolicy` with the `Policy` interface
    that `core/rollout.py` and `core/ppo.py` call.  It holds no parameters
    of its own: every call reads the policy's current tree."""

    def __init__(self, policy: MultiTaskPolicy, name: str):
        self.policy, self.name = policy, name

    def actor_mean(self, obs: torch.Tensor) -> torch.Tensor:
        return actor_mean(self.policy.params, self.policy.cfg, self.name, obs)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return value(self.policy.params, self.policy.cfg, self.name, obs)

    def distribution(self, obs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        return distribution(self.policy.params, self.policy.cfg, self.name,
                            obs)


def load_jax_params(policy: MultiTaskPolicy, params: dict) -> None:
    """Copy a reference parameter tree (numpy leaves, same layout) into
    `policy`."""
    def load(mod, tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                load(mod[key], val)
            elif isinstance(val, (list, tuple)):
                for sub, item in zip(mod[key], val):
                    load(sub, item)
            else:
                mod[key].copy_(torch.tensor(np.asarray(val, np.float32)))

    with torch.no_grad():
        load(policy.params, params)


# --- joint PPO update --------------------------------------------------------
def fleet_update(policy: MultiTaskPolicy, opt: torch.optim.Adam,
                 cfg: ppo_lib.PPOConfig,
                 trajs: dict[str, ppo_lib.Trajectory],
                 weights: dict[str, float]) -> dict[str, torch.Tensor]:
    """One joint PPO update over every scenario's trajectory batch.

    GAE, flattening and advantage normalization run PER SCENARIO (each
    scenario's reward scale normalizes against itself); the clipped losses
    combine as sum_s w_s * L_s with w_s the scheduler's env-share weights,
    and `n_epochs` full-batch Adam steps, each after the global-norm clip
    of `core/ppo.py`, train adapters, heads and the shared trunk together.
    Scenarios are taken in the declared head order.  Returns the last
    epoch's stats (detached, on the device) plus `<name>/mean_return`."""
    names = [n for n in policy.cfg.names if n in trajs]
    flat = {}
    for name in names:
        adv, ret = ppo_lib.gae(trajs[name], cfg.gamma, cfg.lam)
        flat[name] = ppo_lib.flatten_batch(
            trajs[name], adv, ret, normalize=cfg.normalize_advantages)
    params = list(policy.parameters())
    for p in params:  # a head no loss reaches steps on a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for _ in range(cfg.n_epochs):
        opt.zero_grad(set_to_none=False)
        total = 0.0
        stats: dict[str, torch.Tensor] = {}
        for name in names:
            loss_s, st = ppo_lib.ppo_loss(policy.head(name), cfg, *flat[name])
            total = total + weights[name] * loss_s
            stats.update({f"{name}/{k}": v for k, v in st.items()})
        stats["loss"] = total
        total.backward()
        norm = ppo_lib.clip_grads(params, cfg.grad_clip)
        opt.step()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["grad_norm"] = norm
    for name in names:
        stats[f"{name}/mean_return"] = torch.mean(
            torch.sum(trajs[name].rewards, dim=0))
    return stats


# --- the non-finite guard ----------------------------------------------------
def _state_tensors(policy, opt) -> list[torch.Tensor]:
    """Every parameter and its optimizer state tensors (Adam's step count
    included), in a fixed order."""
    out = []
    for p in policy.parameters():
        out.append(p)
        out.extend(opt.state[p][k] for k in sorted(opt.state[p]))
    return out


def _keep_where(ok: torch.Tensor, policy, opt, before: list) -> None:
    """Every parameter and optimizer state tensor becomes its new value
    where `ok`, else its snapshot, in place, with no host sync on CUDA
    (the optimizer keeps its step on the device there)."""
    with torch.no_grad():
        for t, old in zip(_state_tensors(policy, opt), before):
            t.copy_(torch.where(ok.to(t.device), t, old))


def guarded_fleet_update(policy: MultiTaskPolicy, opt: torch.optim.Adam,
                         cfg: ppo_lib.PPOConfig, trajs: dict,
                         weights: dict[str, float],
                         k: int) -> dict[str, torch.Tensor]:
    """`fleet_update` + the non-finite guard.  If any stat is non-finite
    the parameters AND the whole optimizer state (moments and step count)
    keep their values of before the update; the decision stays on the
    device (`update_ok`), since the pipelined loop never syncs to inspect
    stats.  If the update raises, the state of before it is put back
    first."""
    before = [t.detach().clone() for t in _state_tensors(policy, opt)]
    try:
        stats = fleet_update(policy, opt, cfg, trajs, weights)
    except BaseException:
        _keep_where(torch.zeros((), dtype=torch.bool), policy, opt, before)
        raise
    ok = torch.stack([torch.isfinite(v).all() for v in stats.values()]).all()
    _keep_where(ok, policy, opt, before)
    stats["update_ok"] = ok.to(torch.float32)
    stats["iteration"] = torch.full((), float(k), device=ok.device)
    return stats
