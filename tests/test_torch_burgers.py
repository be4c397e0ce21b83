"""PyTorch port vs JAX reference: the forced 1-D Burgers scenario
(`cfd/burgers1d.py`, `envs/burgers.py`).

Inputs come from a seed (numpy, or the JAX package's own bank rows and
phase draws) and go through both packages; states pass between them as
numpy arrays.  Tolerances are stated with each test, with the measured
error beside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro.cfd import burgers1d as jb
from repro_torch import envs as tenvs
from repro_torch.cfd import burgers1d as tb
from repro_torch.core.orchestrator import FleetConfig, Orchestrator
from repro_torch.envs.base import EnvState, as_env, init_state

NAMES = ("burgers_reduced", "burgers_96dof")


def _envs(name):
    return jenvs.make(name), tenvs.make(name)


def _bank(env_j, n, seed=0):
    return np.array(env_j.initial_state_bank(jax.random.PRNGKey(seed), n))


def _close(got, want, rel, what):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("name", NAMES)
def test_config_tables_equal_the_reference(name):
    """The reference spectrum, the Fourier->GLL matrix and the step counts
    are config-time numpy: equal, exactly."""
    env_j, env_t = _envs(name)
    np.testing.assert_array_equal(tb.reference_spectrum(env_t.cfg),
                                  jb.reference_spectrum(env_j.cfg))
    np.testing.assert_array_equal(tb._fourier_to_gll_matrix(env_t.cfg),
                                  jb._fourier_to_gll_matrix(env_j.cfg))
    for attr in ("n_substeps", "n_actions", "dt", "n_dof", "delta_filter"):
        assert getattr(env_t.cfg, attr) == getattr(env_j.cfg, attr), attr
    assert env_t.obs_spec.shape == env_j.obs_spec.shape
    assert env_t.obs_spec.channel_names == env_j.obs_spec.channel_names
    assert env_t.action_spec == tenvs.base.ActionSpec(
        env_j.action_spec.n_elements, env_j.action_spec.low,
        env_j.action_spec.high)


@pytest.mark.parametrize("name", NAMES)
def test_initial_state_from_the_reference_phases(name):
    """The Fourier->GLL initial draw: the port's `initial_states` fed the
    reference's own phase draw gives the reference's state.  float32
    complex matmul of ~100 terms in another order: 1e-6 of max (measured
    <= 2.6e-7)."""
    env_j, _ = _envs(name)
    cfg = env_j.cfg
    n_half = cfg.n_dof // 2 + 1
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        theta = jax.random.uniform(key, (n_half,), jnp.float32, 0.0,
                                   2.0 * np.pi)
        want = np.asarray(jb.sample_initial_state(key, cfg))
        got = tb.initial_states(torch.from_numpy(np.array(theta))[None],
                                tenvs.make(name).cfg)[0]
        _close(got.numpy(), want, 1e-6, f"initial state seed {seed}")
    bank = tenvs.make(name).initial_state_bank(
        torch.Generator().manual_seed(3), 4)
    assert bank.shape == (4,) + (cfg.n_elem, cfg.n, 1)
    assert bool(torch.isfinite(bank).all())


@pytest.mark.parametrize("name", NAMES)
def test_spectrum_rhs_and_substep_match_the_reference(name):
    """energy_spectrum and one rk_substep on one bank state with random
    per-node C within 1e-6 of max (measured <= 1.9e-7 and 1.1e-7).
    burgers_rhs within 1e-5: at 96 DOF its volume terms cancel to a tenth
    of their size, so each package's float32 RHS lies ~2.4e-6 of max from
    a float64 evaluation of the same formulas (checked here within 5e-6;
    measured 2.3e-6 and 2.5e-6), and the two differ by up to twice that
    (measured 3.0e-6; 9.6e-8 at the reduced size)."""
    env_j, env_t = _envs(name)
    cfg_j, cfg_t = env_j.cfg, env_t.cfg
    u = _bank(env_j, 2)
    rng = np.random.default_rng(0)
    c_nodes = rng.uniform(0.0, 0.5, (2, cfg_j.n_elem, cfg_j.n)).astype(
        np.float32)
    ops_j, ops_t = cfg_j.operators(), cfg_t.operators()
    _close(tb.les_spectrum(torch.from_numpy(u), cfg_t).numpy(),
           jb.les_spectrum(jnp.asarray(u), cfg_j), 1e-6, "spectrum")
    us = u[..., 0]
    rhs_t = tb.burgers_rhs(torch.from_numpy(us), torch.from_numpy(c_nodes),
                           cfg_t, ops_t).numpy()
    rhs_j = jb.burgers_rhs(jnp.asarray(us), jnp.asarray(c_nodes), cfg_j,
                           ops_j)
    _close(rhs_t, rhs_j, 1e-5, "rhs")
    # the reason for that pin: each float32 RHS against float64
    ops_64 = dict(ops_t, D=ops_t["D"].double(), w=ops_t["w"].double())
    rhs_64 = tb.burgers_rhs(torch.from_numpy(us).double(),
                            torch.from_numpy(c_nodes).double(), cfg_t,
                            ops_64).numpy()
    for got, what in ((rhs_t, "port"), (rhs_j, "reference")):
        _close(got, rhs_64, 5e-6, f"{what} float32 RHS vs float64")
    _close(tb.rk_substep(torch.from_numpy(us), torch.from_numpy(c_nodes),
                         cfg_t, ops_t).numpy(),
           jb.rk_substep(jnp.asarray(us), jnp.asarray(c_nodes), cfg_j,
                         ops_j), 1e-6, "substep")


@pytest.mark.parametrize("name", NAMES)
def test_rl_interval_and_env_step_match_the_reference(name):
    """One advance_rl_interval (6 / 33 substeps) and one BurgersEnv.step of
    4 envs from the reference's bank rows and actions, one env's state
    poisoned with NaN so that the guard reverts it and floors its reward
    at -1.  State 1e-5 of max (measured <= 6.4e-7 after 165 RHS calls),
    reward 1e-5 absolute (measured <= 4.8e-7)."""
    env_j, env_t = _envs(name)
    n_el = env_j.cfg.n_elem
    u = _bank(env_j, 4, seed=1)
    rng = np.random.default_rng(1)
    action = rng.uniform(-0.1, 0.6, (4, n_el)).astype(np.float32)
    c = np.clip(action, 0.0, env_j.cfg.c_max)
    _close(tb.advance_rl_interval(torch.from_numpy(u), torch.from_numpy(c),
                                  env_t.cfg).numpy(),
           jb.advance_rl_interval(jnp.asarray(u), jnp.asarray(c), env_j.cfg),
           1e-5, "interval")

    u[3, 0, 0, 0] = np.nan
    st_j, obs_j = env_j.reset_from_bank(jnp.asarray(u), jnp.arange(4))
    st_t, obs_t = env_t.reset_from_bank(torch.from_numpy(u), torch.arange(4))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    res_j = env_j.step(st_j, jnp.asarray(action))
    res_t = env_t.step(st_t, torch.from_numpy(action))
    rew_t, rew_j = res_t.reward.numpy(), np.asarray(res_j.reward)
    np.testing.assert_allclose(rew_t, rew_j, rtol=0, atol=1e-5)
    assert rew_t[3] == -1.0 and np.all(rew_t[:3] > -1.0)
    np.testing.assert_array_equal(res_t.state.u[3].numpy(), u[3])  # reverted
    _close(res_t.state.u[:3].numpy(), np.asarray(res_j.state.u)[:3], 1e-5,
           "step state")
    np.testing.assert_array_equal(res_t.done.numpy(), np.asarray(res_j.done))
    np.testing.assert_array_equal(res_t.state.t_step.numpy(), [1] * 4)


def test_registry_init_state_and_as_env():
    """Both names are registered; overrides reach the config; init_state
    wraps bank rows at t = 0; as_env coerces a bare HITConfig to the HIT
    adapter (the orchestrator does it on entry) and passes an env
    through."""
    assert {"burgers_96dof", "burgers_reduced"} <= set(tenvs.registered())
    env = tenvs.make("burgers_96dof", t_end=1.0)
    assert env.cfg.n_dof == 96 and env.n_actions == 10
    rows = torch.zeros((3, 12, 8, 1))
    state = init_state(rows, (3,))
    assert isinstance(state, EnvState) and state.t_step.dtype == torch.int32
    assert state.t_step.shape == (3,) and not state.t_step.any()
    hit = tenvs.make("hit_les_reduced")
    assert isinstance(as_env(hit.cfg), tenvs.HITLESEnv)
    assert as_env(hit.cfg).cfg == hit.cfg and as_env(env) is env
    orch = Orchestrator(hit.cfg, FleetConfig(n_envs=1, bank_size=2),
                        device="cpu")
    assert orch.env == hit and orch.bank.shape[0] == 2
