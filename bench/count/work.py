"""The counted work of a HIT configuration, from its shapes: RHS calls and
floating-point operations per env and RL step, per PPO iteration."""
from __future__ import annotations

from ..reference.hit import Case
from . import policy, rhs

RHS_KERNELS = ("ns_rhs_cluster_kernel", "grad_pass", "div_pass")
CHANNELS = 3  # the observation's velocity channels


def case(config: dict) -> Case:
    return Case.from_fields(config["hit_config"])


def rhs_calls_per_step(c: Case) -> int:
    """Five RK stages per substep."""
    return 5 * c.n_substeps


def flop_per_env_step(c: Case) -> float:
    """One env's RL step: its RHS calls, the actor and critic on its
    observation, and the episode's last critic call spread over its
    steps."""
    k = c.n_elem
    fwd = policy.forward(c.n, CHANNELS, k**3)
    return (rhs.operations(1, k, k, k, c.n) * rhs_calls_per_step(c)
            + fwd + 0.5 * fwd / c.n_actions)


def flop_per_iteration(c: Case, n_envs: int, epochs: int) -> float:
    """Sampling n_envs episodes, then `epochs` full-batch passes forward and
    backward over every (step, env) observation."""
    samples = c.n_actions * n_envs
    return (flop_per_env_step(c) * samples
            + epochs * samples * policy.forward_backward(c.n, CHANNELS,
                                                         c.n_elem**3))
