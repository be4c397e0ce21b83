"""PyTorch port vs JAX reference: policy, PPO, rollout, and the training loop.

The JAX parameter tree is carried into the port's `nn.Module`
(`policy.load_jax_params`), and the JAX package's own initial states and
action noise are fed in, so that both packages see the same inputs.
Tolerances are pinned with their reason and the measured error beside them.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro import optim as joptim
from repro.core import policy as jpolicy
from repro.core import ppo as jppo
from repro.core import rollout as jrollout
import repro_torch
from repro_torch import envs as tenvs
from repro_torch import resolve_device
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import policy as tpolicy
from repro_torch.core import ppo as tppo
from repro_torch.core import rollout as trollout
from repro_torch.core.orchestrator import FleetConfig
from repro_torch.core.runner import Runner, RunnerConfig
from repro_torch.kernels import rhs as trhs
from repro_torch.launch import rl_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(policy):
    """Port parameters in the JAX tree's leaf order, as JAX layout."""
    out = {}
    for trunk in ("actor", "critic"):
        for i, conv in enumerate(getattr(policy, trunk)):
            out[(trunk, i, "w")] = np.transpose(_np(conv.weight), (2, 3, 4, 1, 0))
            out[(trunk, i, "b")] = _np(conv.bias)
    out[("log_std",)] = _np(policy.log_std)
    return out


def _jax_leaves(params):
    out = {}
    for trunk in ("actor", "critic"):
        for i, leaf in enumerate(params[trunk]):
            out[(trunk, i, "w")] = np.asarray(leaf["w"])
            out[(trunk, i, "b")] = np.asarray(leaf["b"])
    out[("log_std",)] = np.asarray(params["log_std"])
    return out


def _port_grads(policy):
    out = {}
    for trunk in ("actor", "critic"):
        for i, conv in enumerate(getattr(policy, trunk)):
            out[(trunk, i, "w")] = np.transpose(_np(conv.weight.grad),
                                                (2, 3, 4, 1, 0))
            out[(trunk, i, "b")] = _np(conv.bias.grad)
    out[("log_std",)] = _np(policy.log_std.grad)
    return out


@pytest.fixture(scope="module")
def setup():
    env_j = jenvs.make("hit_les_reduced")
    env_t = tenvs.make("hit_les_reduced")
    pcfg_j = jpolicy.PolicyConfig.from_specs(env_j.obs_spec, env_j.action_spec)
    pcfg_t = tpolicy.PolicyConfig.from_specs(env_t.obs_spec, env_t.action_spec)
    params = jpolicy.init(jax.random.PRNGKey(0), pcfg_j)
    params = jax.tree.map(np.asarray, params)
    return dict(env_j=env_j, env_t=env_t, pcfg_j=pcfg_j, pcfg_t=pcfg_t,
                params=params)


def _port_policy(setup):
    pol = tpolicy.Policy(setup["pcfg_t"])
    tpolicy.load_jax_params(pol, setup["params"])
    return pol


def test_policy_outputs_on_carried_weights(setup):
    """mean, std, value and log_prob with the JAX weights loaded.  float32
    convolutions summed in another order: rtol 1e-5 (measured 1.5e-7)."""
    pol = _port_policy(setup)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((3,) + setup["env_t"].obs_spec.shape)
    obs = obs.astype(np.float32)
    action = rng.uniform(0.0, 0.5, size=(3, 8)).astype(np.float32)
    mean_j, std_j = jpolicy.distribution(setup["params"], setup["pcfg_j"], obs)
    with torch.no_grad():
        mean_t, std_t = pol.distribution(torch.from_numpy(obs))
        value_t = pol.value(torch.from_numpy(obs))
    np.testing.assert_allclose(_np(mean_t), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(_np(std_t), np.asarray(std_j), rtol=1e-6)
    np.testing.assert_allclose(
        _np(value_t), np.asarray(jpolicy.value(setup["params"],
                                               setup["pcfg_j"], obs)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(tpolicy.log_prob(mean_t, std_t, torch.from_numpy(action))),
        np.asarray(jpolicy.log_prob(mean_j, std_j, action)), rtol=1e-5)
    # the paper's Table-2 parameter count at 24-DOF width
    env24 = tenvs.make("hit_les_24dof")
    pol24 = tpolicy.Policy(tpolicy.PolicyConfig.from_specs(
        env24.obs_spec, env24.action_spec))
    assert tpolicy.param_count(pol24) == 3293 + 1


@pytest.fixture(scope="module")
def fixed_traj(setup):
    """A fixed random time-major trajectory (T=4, B=3) on the reduced shapes."""
    rng = np.random.default_rng(7)
    t, b = 4, 3
    obs = rng.standard_normal((t, b) + setup["env_t"].obs_spec.shape)
    dones = np.zeros((t, b), bool)
    dones[-1] = True
    fields = dict(
        obs=obs.astype(np.float32),
        actions=rng.uniform(0.0, 0.5, size=(t, b, 8)).astype(np.float32),
        log_probs=rng.normal(3.0, 0.5, size=(t, b)).astype(np.float32),
        rewards=rng.uniform(-1.0, 1.0, size=(t, b)).astype(np.float32),
        dones=dones,
        values=rng.normal(0.0, 0.3, size=(t, b)).astype(np.float32),
        last_value=rng.normal(0.0, 0.3, size=(b,)).astype(np.float32))
    return fields


def test_gae_loss_and_gradients(setup, fixed_traj):
    """GAE, the PPO loss with its stats, and the gradients of one
    update_epoch, tight: rtol 1e-4 on float32 sums of ~1e3 terms in another
    order (measured: GAE 1.5e-7, loss stats 1.0e-5 relative on a surrogate
    of 9e-3, gradients 1.1e-6)."""
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    traj_j = jppo.Trajectory(**{k: jnp.asarray(v) for k, v in
                                fixed_traj.items()})
    traj_t = tppo.Trajectory(**{k: torch.from_numpy(v) for k, v in
                                fixed_traj.items()})
    adv_j, ret_j = jppo.gae(traj_j, cfg_j.gamma, cfg_j.lam)
    adv_t, ret_t = tppo.gae(traj_t, cfg_t.gamma, cfg_t.lam)
    np.testing.assert_allclose(_np(adv_t), np.asarray(adv_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(ret_t), np.asarray(ret_j), rtol=1e-5,
                               atol=1e-6)

    batch_j = jppo.flatten_batch(traj_j, adv_j, ret_j, normalize=True)
    (_, stats_j), grads_j = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        setup["params"], cfg_j, setup["pcfg_j"], *batch_j)
    pol = _port_policy(setup)
    batch_t = tppo.flatten_batch(traj_t, adv_t, ret_t, normalize=True)
    loss_t, stats_t = tppo.ppo_loss(pol, cfg_t, *batch_t)
    loss_t.backward()
    for k, v in stats_j.items():
        np.testing.assert_allclose(_np(stats_t[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got, want = _port_grads(pol), _jax_leaves(grads_j)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(k))


def test_update_epoch_and_update(setup, fixed_traj):
    """One update_epoch (clip + Adam step) and the full 5-epoch update.
    After one step the params agree tightly; after 5 Adam steps within atol
    2 * n_epochs * lr, since Adam moves a near-zero gradient component by
    ~lr either way (measured max |d| 1.5e-8 after one step, 6.0e-8 after
    five)."""
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    traj_j = jppo.Trajectory(**{k: jnp.asarray(v) for k, v in
                                fixed_traj.items()})
    traj_t = tppo.Trajectory(**{k: torch.from_numpy(v) for k, v in
                                fixed_traj.items()})
    adv_j, ret_j = jppo.gae(traj_j, cfg_j.gamma, cfg_j.lam)
    adv_t, ret_t = tppo.gae(traj_t, cfg_t.gamma, cfg_t.lam)
    p_j, _, stats_j = jppo.update_epoch(
        setup["params"], joptim.adam_init(setup["params"]), cfg_j,
        setup["pcfg_j"], traj_j, adv_j, ret_j)
    pol = _port_policy(setup)
    stats_t = tppo.update_epoch(pol, tppo.make_optimizer(pol, cfg_t), cfg_t,
                                traj_t, adv_t, ret_t)
    np.testing.assert_allclose(float(stats_t["grad_norm"]),
                               float(stats_j["grad_norm"]), rtol=1e-4)
    got, want = _leaves(pol), _jax_leaves(p_j)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=str(k))

    p_j, _, stats_j = jax.jit(functools.partial(
        jppo.update, cfg=cfg_j, pcfg=setup["pcfg_j"]))(
        setup["params"], joptim.adam_init(setup["params"]), traj=traj_j)
    pol = _port_policy(setup)
    stats_t = tppo.update(pol, tppo.make_optimizer(pol, cfg_t), cfg_t, traj_t)
    got, want = _leaves(pol), _jax_leaves(p_j)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 * cfg_t.n_epochs * cfg_t.lr,
                                   err_msg=str(k))
    for k in ("loss", "value_loss", "grad_norm", "mean_return", "entropy"):
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_slice_rollout_and_update_match_reference(setup):
    """The slice as a whole on `hit_les_reduced`: one fleet rollout (2 envs,
    3 RL steps of 5 substeps) from the same JAX bank rows with the JAX
    package's action noise fed in, then one PPO update on each side.
    Tolerances: per-step quantities 1e-4 relative (measured <= 4.0e-7; the
    solver's float32 differences pass through 75 RHS calls and the FFT);
    update stats 1e-3 (measured <= 4.3e-6)."""
    env_j, env_t = setup["env_j"], setup["env_t"]
    u0 = np.array(env_j.initial_state_bank(jax.random.PRNGKey(2), 2))
    key = jax.random.PRNGKey(5)
    traj_j = jax.jit(lambda p, u, k: jrollout.rollout(
        p, setup["pcfg_j"], env_j, u, k))(setup["params"], jnp.asarray(u0),
                                          key)
    step_keys = jax.random.split(key, env_j.n_actions)
    noise = np.array(jax.vmap(lambda kk: jax.random.normal(
        kk, (2,) + env_j.action_spec.shape))(step_keys))
    pol = _port_policy(setup)
    before = trhs.fused_navier_stokes_rhs.launches
    traj_t = trollout.rollout(pol, env_t, torch.from_numpy(u0),
                              noise=torch.from_numpy(noise))
    assert trhs.fused_navier_stokes_rhs.launches == before  # CPU: plain
    for name in ("obs", "actions", "log_probs", "rewards", "values",
                 "last_value"):
        got, want = _np(getattr(traj_t, name)), np.asarray(getattr(traj_j, name))
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    np.testing.assert_array_equal(_np(traj_t.dones), np.asarray(traj_j.dones))

    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    _, _, stats_j = jax.jit(functools.partial(
        jppo.update, cfg=cfg_j, pcfg=setup["pcfg_j"]))(
        setup["params"], joptim.adam_init(setup["params"]), traj=traj_j)
    stats_t = tppo.update(pol, tppo.make_optimizer(pol, cfg_t), cfg_t, traj_t)
    for k in ("loss", "surrogate", "value_loss", "entropy", "grad_norm",
              "mean_return"):
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_runner_trains_and_checkpoints_round_trip(tmp_path):
    """Two iterations on the CPU with an evaluation, an injected failure
    that is retried, and a checkpoint that restores params, Adam state and
    the iteration count exactly."""
    failed = []

    def inject(k):
        if k == 1 and not failed:
            failed.append(k)
            raise RuntimeError("injected")

    run_cfg = RunnerConfig(n_iterations=2, eval_every=2, checkpoint_every=1,
                           checkpoint_dir=str(tmp_path), seed=3)
    runner = Runner(tenvs.make("hit_les_reduced"),
                    FleetConfig(n_envs=2, bank_size=3), run_cfg=run_cfg,
                    device="cpu", failure_injector=inject)
    history = runner.train()
    assert failed == [1] and len(history) == 2
    for rec in history:
        assert {"t_sample_s", "t_update_s", "return_norm",
                "ppo/loss", "ppo/grad_norm"} <= set(rec)
        assert -1.0 <= rec["return_norm"] <= 1.0
    assert -1.0 <= history[-1]["eval_return_norm"] <= 1.0
    assert tckpt.latest_step(str(tmp_path)) == 2

    fresh = Runner(tenvs.make("hit_les_reduced"),
                   FleetConfig(n_envs=2, bank_size=3), run_cfg=run_cfg,
                   device="cpu")
    assert fresh.restore() and fresh.iteration == 2
    want, got = runner._state_tree(), fresh._state_tree()
    for name, p in want["params"].items():
        torch.testing.assert_close(got["params"][name], p, rtol=0, atol=0)
        for slot, v in want["opt"][name].items():
            torch.testing.assert_close(got["opt"][name][slot], v, rtol=0,
                                       atol=0)
    # iteration k depends only on (seed, k) and the restored state
    rec_a = runner.run_iteration(2)
    rec_b = fresh.run_iteration(2)
    assert rec_a["ppo/loss"] == rec_b["ppo/loss"]
    assert rec_a["return_norm"] == rec_b["return_norm"]


def _record_conv_flag(policy, seen: list, name: str = "allow_tf32"):
    """Record cuDNN's flag `name` as each first conv of the two trunks runs
    forward and as its weight gradient is computed in backward."""
    flag = lambda: getattr(torch.backends.cudnn, name)  # noqa: E731
    for trunk in (policy.actor, policy.critic):
        trunk[0].register_forward_hook(
            lambda *_: seen.append(("forward", flag())))
        trunk[0].weight.register_hook(
            lambda g: seen.append(("backward", flag())))


@pytest.mark.parametrize("package_tf32", [False, True])
def test_policy_convs_run_in_the_package_conv_precision(
        setup, fixed_traj, monkeypatch, package_tf32):
    """The package's conv-precision setting (float32 by default) is in
    force inside the rollout's forward pass and inside both passes of
    `update_epoch`, whatever the process-wide flag is, and the caller's
    flag is back after each call."""
    monkeypatch.setattr(repro_torch, "CONV_ALLOW_TF32", package_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        not package_tf32)
    pol = _port_policy(setup)
    seen = []
    _record_conv_flag(pol, seen)
    env = setup["env_t"]
    u0 = np.array(setup["env_j"].initial_state_bank(jax.random.PRNGKey(2), 1))
    trollout.rollout(pol, env, torch.from_numpy(u0), deterministic=True)
    assert seen and {kind for kind, _ in seen} == {"forward"}
    assert all(v == package_tf32 for _, v in seen), seen
    assert torch.backends.cudnn.allow_tf32 is (not package_tf32)

    seen.clear()
    cfg = tppo.PPOConfig()
    traj = tppo.Trajectory(**{k: torch.from_numpy(v) for k, v in
                              fixed_traj.items()})
    adv, ret = tppo.gae(traj, cfg.gamma, cfg.lam)
    tppo.update_epoch(pol, tppo.make_optimizer(pol, cfg), cfg, traj, adv, ret)
    assert {kind for kind, _ in seen} == {"forward", "backward"}, seen
    assert all(v == package_tf32 for _, v in seen), seen
    assert torch.backends.cudnn.allow_tf32 is (not package_tf32)


def test_policy_convs_run_cudnn_deterministic(setup, fixed_traj,
                                              monkeypatch):
    """cuDNN's deterministic algorithms are in force inside the rollout's
    forward pass and inside both passes of `update_epoch`, whatever the
    process-wide flag is, and the caller's flag is back after each call:
    ranks that run the same update on the same trajectory stay bitwise
    equal (on an H100 the 1-D policy's conv weight gradient differed
    between the ranks of a split burgers_96dof without it)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    pol = _port_policy(setup)
    seen = []
    _record_conv_flag(pol, seen, "deterministic")
    u0 = np.array(setup["env_j"].initial_state_bank(jax.random.PRNGKey(2), 1))
    trollout.rollout(pol, setup["env_t"], torch.from_numpy(u0),
                     deterministic=True)
    cfg = tppo.PPOConfig()
    traj = tppo.Trajectory(**{k: torch.from_numpy(v) for k, v in
                              fixed_traj.items()})
    adv, ret = tppo.gae(traj, cfg.gamma, cfg.lam)
    tppo.update_epoch(pol, tppo.make_optimizer(pol, cfg), cfg, traj, adv, ret)
    assert {kind for kind, _ in seen} == {"forward", "backward"}, seen
    assert all(v for _, v in seen), seen
    assert torch.backends.cudnn.deterministic is False


@pytest.mark.cuda
def test_cuda_updates_from_one_state_are_bitwise_equal():
    """Three PPO updates (5 epochs each) of burgers_96dof's 1-D policy from
    one state on one random trajectory (5 steps x 16 envs) on the GPU give
    params and Adam state equal bit for bit: what every rank of a split
    env runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = tenvs.make("burgers_96dof")
    pcfg = tpolicy.PolicyConfig.from_specs(env.obs_spec, env.action_spec)
    gen = torch.Generator().manual_seed(4)
    t, b, e = 5, 16, env.action_spec.n_elements
    traj = tppo.Trajectory(
        obs=torch.randn((t, b) + env.obs_spec.shape, generator=gen),
        actions=0.5 * torch.rand((t, b, e), generator=gen),
        log_probs=torch.randn((t, b), generator=gen),
        rewards=torch.rand((t, b), generator=gen) * 2 - 1,
        dones=torch.arange(t)[:, None].expand(t, b) == t - 1,
        values=torch.randn((t, b), generator=gen),
        last_value=torch.randn((b,), generator=gen))
    traj = tppo.Trajectory(*(x.cuda() for x in traj))
    cfg = tppo.PPOConfig()
    states = []
    for _ in range(3):
        pol = tpolicy.Policy(pcfg, torch.Generator().manual_seed(0)).cuda()
        opt = tppo.make_optimizer(pol, cfg)
        tppo.update(pol, opt, cfg, traj)
        states.append([p.detach().cpu() for p in pol.parameters()]
                      + [v.detach().cpu() for st in opt.state.values()
                         for v in st.values() if torch.is_tensor(v)])
    for other in states[1:]:
        assert all(torch.equal(a, b) for a, b in zip(states[0], other))


@pytest.mark.cuda
def test_cuda_policy_matches_cpu_at_the_float32_pin(setup, fixed_traj):
    """The policy's outputs and one update_epoch's parameter gradients on
    the GPU, with the process-wide cuDNN TF32 flag left at torch's default,
    against the CPU: the package runs the convs in float32, so the float32
    pin of `test_gae_loss_and_gradients` holds (TF32's 10-bit mantissa
    would miss it by about an order of magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    rng = np.random.default_rng(11)
    obs = rng.standard_normal((64,) + setup["env_t"].obs_spec.shape)
    obs = torch.from_numpy(obs.astype(np.float32))
    cfg = tppo.PPOConfig()
    traj = tppo.Trajectory(**{k: torch.from_numpy(v) for k, v in
                              fixed_traj.items()})
    adv, ret = tppo.gae(traj, cfg.gamma, cfg.lam)
    out = {}
    for dev in ("cpu", "cuda"):
        pol = _port_policy(setup).to(dev)
        with torch.no_grad(), repro_torch.conv_precision():
            mean, std = pol.distribution(obs.to(dev))
            value = pol.value(obs.to(dev))
        traj_d = tppo.Trajectory(*(x.to(dev) for x in traj))
        tppo.update_epoch(pol, tppo.make_optimizer(pol, cfg), cfg, traj_d,
                          adv.to(dev), ret.to(dev))
        out[dev] = ([mean.cpu(), std.cpu(), value.cpu()],
                    {n: p.grad.cpu() for n, p in pol.named_parameters()})
    assert torch.backends.cudnn.allow_tf32
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for name, want in out["cpu"][1].items():
        scale = max(want.abs().max().item(), 1e-6)
        torch.testing.assert_close(out["cuda"][1][name], want, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)


def test_failure_inside_the_update_is_retried_from_the_state_before_it(
        tmp_path, monkeypatch):
    """A RuntimeError raised inside `update_epoch` after the third of 5
    epochs has stepped: `Runner.train` retries the iteration from the params
    and Adam state of before the update, so params, Adam state and the
    iteration record are bitwise those of a clean run (hit_les_reduced, 2
    envs, seed 3; without the restore the retry ends at Adam step 8)."""
    def run(ckpt_dir, fail_at):
        calls = []
        epoch = tppo.update_epoch

        def update_epoch(*args, **kwargs):
            calls.append(1)
            if len(calls) == fail_at:
                raise RuntimeError("injected inside the update")
            return epoch(*args, **kwargs)

        monkeypatch.setattr(tppo, "update_epoch", update_epoch)
        runner = Runner(tenvs.make("hit_les_reduced"),
                        FleetConfig(n_envs=2, bank_size=3),
                        run_cfg=RunnerConfig(n_iterations=1, eval_every=5,
                                             checkpoint_dir=str(ckpt_dir),
                                             seed=3),
                        device="cpu")
        history = runner.train()
        return runner, history, len(calls)

    clean, clean_hist, clean_calls = run(tmp_path / "clean", fail_at=None)
    retried, retried_hist, retried_calls = run(tmp_path / "retried",
                                               fail_at=4)
    assert clean_calls == 5 and retried_calls == 4 + 5
    timing = {"t_sample_s", "t_update_s"}
    assert [{k: v for k, v in rec.items() if k not in timing}
            for rec in retried_hist] == [
        {k: v for k, v in rec.items() if k not in timing}
        for rec in clean_hist]
    want, got = clean._state_tree(), retried._state_tree()
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
        for slot, v in want["opt"][name].items():
            assert torch.equal(got["opt"][name][slot], v), (name, slot)
    assert all(float(s["step"]) == 5.0 for s in got["opt"].values())


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path):
    """Without `device=` the entry points take the GPU; with no GPU they
    raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(tenvs.make("hit_les_reduced"), FleetConfig(n_envs=1,
                                                          bank_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rl_train.main(["--reduced", "--n-envs", "1", "--iterations", "1",
                       "--checkpoint-dir", str(tmp_path)])
    history = rl_train.main(["--reduced", "--n-envs", "1", "--iterations",
                             "1", "--eval-every", "5", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path)])
    assert len(history) == 1 and np.isfinite(history[0]["return_norm"])


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch imports without `jax` or `repro`."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
