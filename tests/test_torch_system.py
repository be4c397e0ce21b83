"""PyTorch port vs JAX reference: the paper's full loop end to end, and its
static baselines (`core.rollout.constant_action_return`, Fig. 5 bottom:
Smagorinsky C_s = 0.17 and implicit LES C_s = 0).

The baselines draw no random numbers, so both packages run them on the
reference's held-out test state (`Orchestrator.test_state()`), fed to the
port.  The channel's episode is cut to one RL interval in both packages
(`t_end` 0.1): its 300 staged RHS calls an episode take ~6 s on the CPU.
Pinned, absolute on the normalized return (in [-1, 1]), with the largest
reading beside each: PIN_RETURN 1e-5 (HIT 9.9e-8, channel 0, Burgers
2.8e-7).  The two RL tests are the port of tests/test_system.py's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro.core import rollout as jrollout
from repro.core.orchestrator import FleetConfig as JaxFleetConfig
from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro_torch import envs as tenvs
from repro_torch.core.orchestrator import FleetConfig, Orchestrator
from repro_torch.core.ppo import PPOConfig
from repro_torch.core.rollout import constant_action_return
from repro_torch.core.runner import Runner, RunnerConfig

PIN_RETURN = 1e-5
# scenario -> (the overrides both packages take, the constant actions): HIT
# the paper's two baselines; the channel its unscaled wall model (1.0),
# Burgers the Smagorinsky value
SCENARIOS = {"hit_les_reduced": ({}, (0.17, 0.0)),
             "channel_wm_reduced": ({"t_end": 0.1}, (1.0,)),
             "burgers_reduced": ({}, (0.17,))}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_constant_action_return_equals_the_reference(name):
    """Each constant action's normalized return from the reference's test
    state, against the reference's."""
    overrides, values = SCENARIOS[name]
    jenv = jenvs.make(name, **overrides)
    u0 = JaxOrchestrator(jenv, JaxFleetConfig(n_envs=1, bank_size=3),
                         seed=1).test_state()
    env = tenvs.make(name, **overrides)
    for value in values:
        want = jrollout.constant_action_return(jenv, u0, value)
        got = constant_action_return(env, torch.from_numpy(np.array(u0)),
                                     value)
        assert isinstance(got, float) and -1.0 <= got <= 1.0
        assert abs(got - want) <= PIN_RETURN, (value, got, want)


def test_full_rl_training_loop(tmp_path):
    """Three synchronous PPO iterations: finite metrics, eval runs,
    checkpoints are written, metrics.jsonl is append-only structured."""
    runner = Runner(
        tenvs.make("hit_les_reduced"), FleetConfig(n_envs=2, bank_size=4),
        ppo_cfg=PPOConfig(),
        run_cfg=RunnerConfig(n_iterations=3, eval_every=2,
                             checkpoint_every=2,
                             checkpoint_dir=str(tmp_path / "rl"),
                             async_checkpoint=False),
        device="cpu")
    history = runner.train()
    assert len(history) == 3
    for rec in history:
        assert np.isfinite(rec["return_norm"])
        assert np.isfinite(rec["ppo/loss"])
        assert -1.0 <= rec["return_norm"] <= 1.0  # reward bounds propagate
    assert any("eval_return_norm" in r for r in history)
    lines = [json.loads(line) for line in open(runner.metrics_path)]
    assert len(lines) >= 3
    assert sorted(os.listdir(tmp_path / "rl")) != ["metrics.jsonl"]


def test_reward_improves_with_good_actions():
    """Against the synthetic DNS target, a reasonable constant C_s beats an
    absurd one: the reward surface the agent climbs is real."""
    env = tenvs.make("hit_les_reduced")
    orch = Orchestrator(env, FleetConfig(n_envs=1, bank_size=3),
                        device="cpu")
    u0 = orch.test_state()
    # an over-dissipative model (C_s = 0.5 everywhere) must score worse
    # than a moderate one on the spectral reward
    assert constant_action_return(env, u0, 0.1) > \
        constant_action_return(env, u0, 0.5)
