"""The paper's policy network (Table 2), generalized over env specs (PyTorch
port of `repro.core.policy`).

Input : per-element nodal observations (..., E, *spatial, C), channels last
        as the env declares them; the trunk input width is the declared
        channel count and each channel's declared `gain` scales its input.
Output: Gaussian policy over the per-element bounded scalar action,
        mean = low + (high-low) * sigmoid(conv(x)), state-independent
        learnable log-std.

For the paper's N=5 HIT case (n=6, 3-D, 3 velocity channels) the stack is
Table 2 exactly (3,293 actor parameters + log_std):

    Conv3D k3 f8 zero-pad -> 6^3 x 8   ReLU
    Conv3D k3 f8 no-pad   -> 4^3 x 8   ReLU
    Conv3D k3 f4 no-pad   -> 2^3 x 4   ReLU
    Conv3D k2 f1 no-pad   -> 1^3 x 1
    Scale  y = cs_max * sigmoid(x)

The critic is an identical, separately parameterized trunk whose
per-element outputs are averaged over elements: the state value.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    n_nodes: int = 6          # GLL nodes per direction = N+1
    channels: int = 3         # observation channels (trunk input width)
    cs_max: float = 0.5       # action upper bound (Table-2 name kept)
    log_std_init: float = -1.6  # std ~ 0.2 in sigmoid-space
    n_dims: int = 3           # spatial rank of per-element obs
    act_low: float = 0.0      # action lower bound
    in_gains: tuple[float, ...] | None = None  # declared per-channel gains

    def __post_init__(self):
        if self.in_gains is not None and len(self.in_gains) != self.channels:
            raise ValueError(f"{len(self.in_gains)} input gains declared "
                             f"for {self.channels} channels")

    @classmethod
    def from_specs(cls, obs_spec, action_spec, *,
                   log_std_init: float = -1.6) -> "PolicyConfig":
        """Head configuration from an env's declarative specs."""
        spatial = tuple(obs_spec.spatial)
        if len(set(spatial)) != 1:
            raise ValueError(f"anisotropic per-element grids unsupported: {spatial}")
        gains = tuple(obs_spec.channel_gains)
        return cls(n_nodes=spatial[0], channels=obs_spec.channels,
                   cs_max=action_spec.high, act_low=action_spec.low,
                   n_dims=len(spatial), log_std_init=log_std_init,
                   in_gains=gains or None)

    @property
    def active_gains(self) -> tuple[float, ...] | None:
        """The input-gain vector, or None when it would be the identity."""
        if self.in_gains and any(g != 1.0 for g in self.in_gains):
            return self.in_gains
        return None


def _conv_plan(n: int) -> list[tuple[int, int, str]]:
    """[(kernel, filters, padding)] reducing spatial size n -> 1."""
    plan: list[tuple[int, int, str]] = [(3, 8, "SAME")]
    size = n
    n_valid = max((size - 2 + 1) // 2, 0)  # k3-VALID layers until size <= 2
    for i in range(n_valid):
        plan.append((3, 4 if i == n_valid - 1 else 8, "VALID"))
        size -= 2
    if size == 2:
        plan.append((2, 1, "VALID"))
    else:  # size == 1 after the loop (odd n): the last layer emits 1 filter
        k, _, pad = plan.pop()
        plan.append((k, 1, pad))
    return plan


_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class _Trunk(nn.ModuleList):
    """Conv stack of `_conv_plan`: "SAME" k3 pads 1, "VALID" pads 0."""

    def __init__(self, cfg: PolicyConfig, gen: torch.Generator):
        plan = _conv_plan(cfg.n_nodes)
        layers = []
        c_in = cfg.channels
        for ksize, f, pad in plan:
            conv = _CONV[cfg.n_dims](c_in, f, ksize,
                                     padding=(ksize // 2 if pad == "SAME" else 0))
            fan_in = ksize**cfg.n_dims * c_in
            with torch.no_grad():  # He-normal weights, zero bias
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  * math.sqrt(2.0 / fan_in))
                conv.bias.zero_()
            layers.append(conv)
            c_in = f
        super().__init__(layers)
        self.n_dims = cfg.n_dims
        gains = cfg.active_gains
        self.register_buffer(
            "gains", None if gains is None else torch.tensor(gains),
            persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., E, *spatial, C) -> per-element scalar (..., E)."""
        nd = self.n_dims
        batch = obs.shape[: -(nd + 1)]
        x = obs.reshape((-1,) + tuple(obs.shape[-(nd + 1):]))
        if self.gains is not None:
            x = x * self.gains.to(x.dtype)
        x = torch.movedim(x, -1, 1)  # channels-last -> channels-first
        for i, conv in enumerate(self):
            x = conv(x)
            if i < len(self) - 1:
                x = torch.relu(x)
        return x.reshape(batch)


class Policy(nn.Module):
    """Actor and critic trunks plus a state-independent log-std."""

    def __init__(self, cfg: PolicyConfig, gen: torch.Generator | None = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.actor = _Trunk(cfg, gen)
        self.log_std = nn.Parameter(torch.tensor(cfg.log_std_init))
        self.critic = _Trunk(cfg, gen)

    def actor_mean(self, obs: torch.Tensor) -> torch.Tensor:
        """Mean action per element, in [act_low, cs_max]."""
        cfg = self.cfg
        return cfg.act_low + (cfg.cs_max - cfg.act_low) * torch.sigmoid(
            self.actor(obs))

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        """State value: mean of the per-element critic outputs (..., E) -> (...)."""
        return torch.mean(self.critic(obs), dim=-1)

    def distribution(self, obs: torch.Tensor):
        """(mean, std) of the per-element Gaussian action distribution."""
        mean = self.actor_mean(obs)
        std = torch.exp(self.log_std).to(mean.dtype)
        return mean, std.expand(mean.shape)


def log_prob(mean: torch.Tensor, std: torch.Tensor,
             action: torch.Tensor) -> torch.Tensor:
    """Joint log-density of the element-wise independent Gaussian (sum over E)."""
    z = (action - mean) / std
    per_elem = -0.5 * z * z - torch.log(std) - 0.5 * math.log(2.0 * math.pi)
    return torch.sum(per_elem, dim=-1)


def entropy(std: torch.Tensor) -> torch.Tensor:
    """Joint entropy (sum over the element axis)."""
    per_elem = 0.5 * math.log(2.0 * math.pi * math.e) + torch.log(std)
    return torch.sum(per_elem, dim=-1)


def param_count(policy: Policy) -> int:
    """Actor + log_std parameters (the Table-2 scope)."""
    return sum(p.numel() for p in policy.actor.parameters()) + 1


def load_jax_params(policy: Policy, params: dict) -> None:
    """Load a JAX-layout parameter tree (numpy leaves) into `policy`.

    `params[trunk][i]['w']` is (k,...,k, Cin, Cout) channels-last and becomes
    `trunk.i.weight` (Cout, Cin, k,...,k); `b` becomes `bias`; `log_std` is
    a scalar.
    """
    nd = policy.cfg.n_dims
    perm = (nd + 1, nd) + tuple(range(nd))
    with torch.no_grad():
        for trunk in ("actor", "critic"):
            for conv, leaf in zip(getattr(policy, trunk), params[trunk]):
                w = np.transpose(np.asarray(leaf["w"], np.float32), perm)
                conv.weight.copy_(torch.tensor(w))
                conv.bias.copy_(torch.tensor(np.asarray(leaf["b"],
                                                        np.float32)))
        policy.log_std.copy_(torch.tensor(float(np.asarray(params["log_std"]))))
