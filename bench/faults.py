"""Faults planted under the timed path, for the checks' own tests and for
the readings that set the limits (`bench.control`).  Each is a context
manager that patches the program where the fault would arise and puts it
back after.  None of them is used by a benchmark run."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, make):
    before = getattr(module, name)
    setattr(module, name, make(before))
    try:
        yield
    finally:
        setattr(module, name, before)


def state_unchanged():
    """Every RL interval hands back the state it was given."""
    from repro_torch.cfd import solver

    return _patched(solver, "advance_rl_interval",
                    lambda f: lambda u, cs, cfg, split=None: u.clone())


def half_batch_rollout():
    """The solver advances the first half of the envs and leaves the rest
    as they were."""
    from repro_torch.cfd import solver

    def make(f):
        def advance(u, cs, cfg, split=None):
            half = u.shape[0] // 2 or 1
            return torch.cat([f(u[:half], cs[:half], cfg, split), u[half:]])
        return advance

    return _patched(solver, "advance_rl_interval", make)


def half_batch_update():
    """The PPO loss is the mean over the first half of the flat batch."""
    from repro_torch.core import ppo

    def make(f):
        def flatten(*args, **kwargs):
            out = f(*args, **kwargs)
            return tuple(x[: x.shape[0] // 2] for x in out)
        return flatten

    return _patched(ppo, "flatten_batch", make)


def update_unchanged():
    """A PPO update that leaves the parameters as they were."""
    from repro_torch.core import ppo

    def make(f):
        def update(policy, opt, cfg, traj):
            before = [p.detach().clone() for p in policy.parameters()]
            stats = f(policy, opt, cfg, traj)
            with torch.no_grad():
                for p, b in zip(policy.parameters(), before):
                    p.copy_(b)
            return stats
        return update

    return _patched(ppo, "update", make)


def reward_altered(delta: float = 1e-3):
    """The reward of every env's step comes out `delta` high where the env
    produces it."""
    from repro_torch.cfd import env

    def make(f):
        def step(state, action, cfg, e_dns, split=None):
            res = f(state, action, cfg, e_dns, split)
            return res._replace(reward=res.reward + delta)
        return step

    return _patched(env, "step", make)


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch_rollout": half_batch_rollout,
          "half_batch_update": half_batch_update,
          "update_unchanged": update_unchanged,
          "reward_altered": reward_altered}
