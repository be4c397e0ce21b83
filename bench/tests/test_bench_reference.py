"""The plain reference against the port's plain path at
`hit_les_reduced` on the CPU: the bank, the draws, one MDP transition, the
policy's initial weights and outputs, and a PPO update."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.reference import hit, policy as ref_policy

SEED = 2**31 + 11


def _port():
    from repro_torch.configs import relexi_hit

    cfg = relexi_hit.reduced()
    return cfg, hit.Case.from_fields(dataclasses.asdict(cfg))


def _close(a, b, rtol=2e-6):
    scale = float(torch.max(torch.abs(b))) or 1.0
    assert float(torch.max(torch.abs(a - b))) <= rtol * scale


def test_bank_and_draws():
    from repro_torch.cfd import initial
    from repro_torch.core import orchestrator
    from repro_torch.envs import hit_les

    cfg, case = _port()
    ops = hit.Operators(case, "cpu")
    want = initial.make_state_bank(torch.Generator().manual_seed(SEED), cfg, 5)
    got = hit.bank(torch.Generator().manual_seed(SEED), case, ops, 5)
    _close(got, want)
    orch = orchestrator.Orchestrator(
        hit_les.HITLESEnv(cfg), orchestrator.FleetConfig(n_envs=3,
                                                         bank_size=5),
        seed=SEED, device="cpu")
    u0, noise = orch.draw_padded_inputs(torch.Generator().manual_seed(7))
    idx, ref_noise = hit.episode_draws(torch.Generator().manual_seed(7), 3,
                                       5, case.n_actions, case.n_elem**3)
    assert torch.equal(noise, ref_noise)
    assert torch.equal(u0, orch.bank[idx])


def test_one_transition():
    from repro_torch.cfd import env, initial
    from repro_torch.envs import hit_les

    cfg, case = _port()
    ops = hit.Operators(case, "cpu")
    u = initial.make_state_bank(torch.Generator().manual_seed(3), cfg, 3)
    action = 0.5 * torch.rand((3, case.n_elem**3),
                              generator=torch.Generator().manual_seed(4))
    e_dns = hit_les.HITLESEnv(cfg).e_dns()
    res = env.step(env.EnvState(u, torch.zeros(3, dtype=torch.int32)),
                   action, cfg, e_dns)
    u1, reward, obs1 = hit.step(u, action, case, ops)
    for c in range(5):
        _close(u1[..., c], res.state.u[..., c])
    _close(obs1, res.obs)
    assert float(torch.max(torch.abs(reward - res.reward))) < 1e-6
    _close(hit.observe(u, case), env.observe(u, cfg))


def _policy(cfg, seed):
    from repro_torch.core import policy as policy_lib
    from repro_torch.envs import hit_les

    e = hit_les.HITLESEnv(cfg)
    pcfg = policy_lib.PolicyConfig.from_specs(e.obs_spec, e.action_spec)
    return policy_lib.Policy(pcfg, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shape", [None, {
    "mean_cs": 0.17, "actor_out_scale": 0.1, "log_std": -3.912023005428146}])
def test_policy_weights_and_outputs(shape):
    from bench.loops import policy_shape

    cfg, case = _port()
    pol = _policy(cfg, SEED)
    if shape is not None:
        policy_shape.shape(pol, shape)
    params = ref_policy.init_params(SEED, case.n, 3, shape, case.cs_max)
    got = dict(pol.named_parameters())
    assert list(got) == list(params)
    for k in params:
        assert torch.equal(got[k].detach(), params[k]), k
    obs = torch.randn((2, case.n_elem**3, case.n, case.n, case.n, 3))
    with torch.no_grad():
        mean, std = pol.distribution(obs)
        rmean, rstd = ref_policy.distribution(params, obs, case.n,
                                              case.cs_max)
        _close(rmean, mean)
        _close(ref_policy.value(params, obs, case.n), pol.value(obs))
        act = mean + std * 0.3
        _close(ref_policy.log_prob(rmean, rstd, act),
               __import__("repro_torch.core.policy", fromlist=["x"])
               .log_prob(mean, std, act))


def test_ppo_update():
    from repro_torch.core import ppo

    cfg, case = _port()
    pol = _policy(cfg, SEED)
    opt = ppo.make_optimizer(pol, ppo.PPOConfig(n_epochs=3))
    gen = torch.Generator().manual_seed(5)
    t, b, e, n = 3, 4, case.n_elem**3, case.n
    traj = ppo.Trajectory(
        obs=torch.randn((t, b, e, n, n, n, 3), generator=gen),
        actions=0.5 * torch.rand((t, b, e), generator=gen),
        log_probs=torch.randn((t, b), generator=gen),
        rewards=torch.rand((t, b), generator=gen),
        dones=torch.tensor([False, False, True])[:, None].expand(t, b),
        values=torch.randn((t, b), generator=gen),
        last_value=torch.randn((b,), generator=gen))
    stats = ppo.update(pol, opt, ppo.PPOConfig(n_epochs=3), traj)
    params = ref_policy.init_params(SEED, case.n, 3)
    new, losses, _ = ref_policy.update(
        params, ref_policy.init_adam(params), traj._asdict(), n,
        case.cs_max, epochs=3)
    assert abs(losses[-1] - float(stats["loss"])) <= 1e-5 * abs(losses[-1])
    for k, p in pol.named_parameters():
        moved = new[k] - params[k]
        assert float(torch.max(torch.abs(p.detach() - params[k] - moved))) \
            <= 1e-3 * float(torch.max(torch.abs(moved))) + 1e-9, k
