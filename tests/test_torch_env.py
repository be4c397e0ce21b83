"""PyTorch port vs JAX reference: the HIT-LES environment on `hit_les_reduced`
states from the JAX package's own initial-state bank.

Covered: one RL interval of the solver (float32 and bfloat16), spectra and
reward, a full env step with its blow-up guard, and the initial-state
generator fed the JAX package's Gaussian noise.  Tolerances are relative to
the largest reference value and pinned with the measured error beside them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro.cfd import initial as jinitial
from repro.cfd import solver as jsolver
from repro.cfd import spectra as jspectra
from repro_torch import envs as tenvs
from repro_torch.cfd import initial as tinitial
from repro_torch.cfd import solver as tsolver
from repro_torch.cfd import spectra as tspectra
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def bank():
    """Three `hit_les_reduced` initial states from the JAX package's bank."""
    env = jenvs.make("hit_les_reduced")
    return np.array(env.initial_state_bank(jax.random.PRNGKey(9), 3))


@pytest.fixture(scope="module")
def cs_elem():
    rng = np.random.default_rng(1)
    return rng.uniform(0.0, 0.5, size=(3, 2, 2, 2)).astype(np.float32)


def test_advance_rl_interval_fp32(bank, cs_elem):
    """One RL interval (5 substeps x 5 RK stages) in float32: the JAX
    reference assembly vs the port's default (fused) path."""
    cfg_j = jenvs.make("hit_les_reduced", use_kernels=False).cfg
    want = jsolver.advance_rl_interval(jnp.asarray(bank), jnp.asarray(cs_elem),
                                       cfg_j)
    cfg_t = tenvs.make("hit_les_reduced").cfg
    got = tsolver.advance_rl_interval(torch.from_numpy(bank),
                                      torch.from_numpy(cs_elem), cfg_t)
    assert got.dtype == torch.float32 and got.shape == bank.shape
    assert _rel_err(got, want) <= 2e-5  # measured 1.9e-7


def test_advance_rl_interval_bf16(bank, cs_elem):
    """bfloat16 rollout precision on the main path's semantics: the JAX
    Pallas kernel (interpret mode) vs the port's fused path, both carrying
    the state in bf16 with float32 RHS math.  Tolerance: the JAX package's
    bf16 gate 4e-2; both sides round the carry to bf16 25 times, so a
    one-ulp difference (2^-8 relative) may appear and propagate."""
    cfg_j = jenvs.make("hit_les_reduced", precision="bf16",
                       use_kernels=True).cfg
    want = jsolver.advance_rl_interval(jnp.asarray(bank), jnp.asarray(cs_elem),
                                       cfg_j)
    cfg_t = tenvs.make("hit_les_reduced", precision="bf16").cfg
    got = tsolver.advance_rl_interval(torch.from_numpy(bank),
                                      torch.from_numpy(cs_elem), cfg_t)
    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= 4e-2  # measured 1.5e-6


def test_spectra_and_reward(bank):
    cfg_j = jenvs.make("hit_les_reduced").cfg
    cfg_t = tenvs.make("hit_les_reduced").cfg
    e_j = jspectra.les_spectrum(jnp.asarray(bank), cfg_j)
    e_t = tspectra.les_spectrum(torch.from_numpy(bank), cfg_t)
    assert _rel_err(e_t, e_j) <= 1e-5  # measured 1.2e-7
    np.testing.assert_array_equal(jspectra.reference_spectrum(cfg_j),
                                  tspectra.reference_spectrum(cfg_t))
    e_dns_j = jnp.asarray(jspectra.reference_spectrum(cfg_j), jnp.float32)
    e_dns_t = torch.as_tensor(tspectra.reference_spectrum(cfg_t),
                              dtype=torch.float32)
    ell_j = jspectra.spectral_error(e_j, e_dns_j, cfg_j.k_max)
    ell_t = tspectra.spectral_error(e_t, e_dns_t, cfg_t.k_max)
    np.testing.assert_allclose(ell_t.numpy(), np.asarray(ell_j), rtol=1e-5)
    np.testing.assert_allclose(
        tspectra.reward_from_error(ell_t, cfg_t.alpha).numpy(),
        np.asarray(jspectra.reward_from_error(ell_j, cfg_j.alpha)),
        rtol=1e-5, atol=1e-6)


def test_env_step_and_blowup_guard(bank):
    """A full env transition, one env of the batch poisoned with a NaN: the
    healthy env matches the reference, the poisoned one reverts to its
    previous state and gets the reward floor -1 on both sides."""
    env_j = jenvs.make("hit_les_reduced")
    env_t = tenvs.make("hit_les_reduced")
    u = bank[:2].copy()
    u[1, 0, 1, 0, 2, 1, 3, 4] = np.nan
    action = np.full((2, env_t.action_spec.n_elements), 0.17, np.float32)
    st_j, obs_j = env_j.reset_from_bank(jnp.asarray(u), jnp.arange(2))
    st_t, obs_t = env_t.reset_from_bank(torch.from_numpy(u), torch.arange(2))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    res_j = env_j.step(st_j, jnp.asarray(action))
    res_t = env_t.step(st_t, torch.from_numpy(action))
    assert res_t.reward[1].item() == -1.0 == float(res_j.reward[1])
    np.testing.assert_array_equal(res_t.state.u[1].numpy(), u[1])  # NaN-equal
    assert _rel_err(res_t.state.u[0], res_j.state.u[0]) <= 2e-5  # measured 1.8e-7
    assert _rel_err(res_t.obs[0], res_j.obs[0]) <= 2e-5  # measured 3.0e-7
    np.testing.assert_allclose(res_t.reward[0].item(), float(res_j.reward[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(res_t.done.numpy(), np.asarray(res_j.done))
    np.testing.assert_array_equal(res_t.state.t_step.numpy(),
                                  np.asarray(res_j.state.t_step))


def test_initial_field_from_fed_noise():
    """The initial-state generator fed the JAX package's Gaussian draws
    reproduces the JAX states (RNG streams differ, so the noise is fed)."""
    cfg_j = jenvs.make("hit_les_reduced").cfg
    cfg_t = tenvs.make("hit_les_reduced").cfg
    n_grid = cfg_j.dg.n_dof_dir
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    want = jinitial.make_state_bank(jax.random.PRNGKey(4), cfg_j, 2)
    noise = np.stack([np.asarray(jax.random.normal(k, (n_grid,) * 3 + (3,),
                                                   jnp.float32))
                      for k in keys])
    got = tinitial.initial_states(torch.from_numpy(noise), cfg_t)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5  # measured 7.0e-8
    e_target = jnp.asarray(jspectra.reference_spectrum(cfg_j), jnp.float32)
    field_j = jinitial._solenoidal_spectral_field(keys[0], n_grid, e_target)
    field_t = tinitial._solenoidal_spectral_field(
        torch.from_numpy(noise[0]), n_grid,
        torch.as_tensor(np.array(e_target)))
    assert _rel_err(field_t, field_j) <= 1e-5  # measured 1.8e-7


def test_bank_from_generator_is_seeded_and_on_spectrum():
    """The port's own bank (torch.Generator draws) is reproducible from its
    seed, and its uniform-grid fields carry the target shell spectrum."""
    env = tenvs.make("hit_les_reduced")
    a = env.initial_state_bank(torch.Generator().manual_seed(3), 2)
    b = env.initial_state_bank(torch.Generator().manual_seed(3), 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()
    n_grid = env.cfg.dg.n_dof_dir
    e_target = torch.as_tensor(tspectra.reference_spectrum(env.cfg),
                               dtype=torch.float32)
    noise = torch.randn((2, n_grid, n_grid, n_grid, 3),
                        generator=torch.Generator().manual_seed(5))
    field = tinitial._solenoidal_spectral_field(noise, n_grid, e_target)
    sl = slice(1, n_grid // 2)  # shells wholly inside the Nyquist box
    torch.testing.assert_close(tspectra.energy_spectrum(field)[:, sl],
                               e_target[sl].expand(2, -1), rtol=1e-4,
                               atol=1e-7)


def test_registry_and_specs_match_reference():
    for name in ("hit_les_24dof", "hit_les_32dof", "hit_les_reduced"):
        ej, et = jenvs.make(name), tenvs.make(name)
        assert et.obs_spec.shape == ej.obs_spec.shape
        assert et.obs_spec.channel_names == ej.obs_spec.channel_names
        assert et.action_spec == dataclasses.replace(
            et.action_spec, **dataclasses.asdict(ej.action_spec))
        assert et.n_actions == ej.n_actions
        assert et.cfg.n_substeps == ej.cfg.n_substeps
        assert et.cfg.dt == ej.cfg.dt
    # the port registers every env of the reference: the HIT, channel and
    # Burgers families
    assert tenvs.registered() == jenvs.registered()
    assert len(tenvs.registered()) == 3 + 8 + 2
    # the paper's 24-DOF episode: 50 RL steps of 13 substeps of 5 stages
    cfg = tenvs.make("hit_les_24dof").cfg
    assert (cfg.n_actions, cfg.n_substeps) == (50, 13)
