"""PyTorch port vs JAX reference: the wall-modeled channel scenario.

States come from the JAX package's own initial-state bank (or its random
draws fed in), actions and noise from numpy or from the JAX package, so both
packages see the same inputs.  The JAX side runs its staged assembly
(`use_kernels=False`) unless a test names its kernel path (`True`: the
Pallas kernels in interpret mode).  Tolerances are relative to the largest
reference value unless stated, pinned with the measured error beside them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro import optim as joptim
from repro.cfd import channel as jch
from repro.core import policy as jpolicy
from repro.core import ppo as jppo
from repro.core import rollout as jrollout
from repro.envs.base import EnvState as JEnvState
from repro_torch import envs as tenvs
from repro_torch.cfd import channel as tch
from repro_torch.cfd import dgsem, initial, solver
from repro_torch.cfd.channel import ChannelConfig
from repro_torch.cfd.solver import HITConfig
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import policy as tpolicy
from repro_torch.core import ppo as tppo
from repro_torch.core import rollout as trollout
from repro_torch.envs.base import EnvState
from repro_torch.kernels import dg_derivative, smagorinsky, wall_model
from repro_torch.launch import rl_train
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ("channel_wm", "channel_wm_reduced", "channel_wm_p",
         "channel_wm_p_reduced", "channel_wm_hre", "channel_wm_hre_reduced",
         "channel_wm_t", "channel_wm_t_reduced")
REDUCED = tuple(n for n in NAMES if n.endswith("_reduced"))
REDUCED_CFG = ChannelConfig(n_elem=(2, 3, 2), t_end=0.3, dt_rl=0.1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scales(rng, batch, cfg, per_node=True):
    kx, _, kz = cfg.n_elem
    shape = (batch, kx, kz) + ((cfg.n, cfg.n) if per_node else ())
    return (rng.uniform(0.5, 1.5, shape).astype(np.float32),
            rng.uniform(0.5, 1.5, shape).astype(np.float32))


@pytest.fixture(scope="module")
def bank():
    """Two `channel_wm_reduced` initial states from the JAX package."""
    env = jenvs.make("channel_wm_reduced")
    return np.array(env.initial_state_bank(jax.random.PRNGKey(2), 2))


# --- configuration, registry, initial states --------------------------------
def test_registry_lists_the_channel_family():
    names = tenvs.registered()
    assert set(NAMES) <= set(names)
    assert {"hit_les_24dof", "hit_les_32dof", "hit_les_reduced"} <= set(names)
    assert set(NAMES) <= set(jenvs.registered())


@pytest.mark.parametrize("name", NAMES)
def test_config_specs_and_reference_profile_match(name):
    """Every derived quantity, the specs, and the reference profile (numpy
    float64 then rounded, on both sides): exact."""
    ej, et = jenvs.make(name), tenvs.make(name)
    cj, ct = ej.cfg, et.cfg
    for attr in ("n", "dxs", "jacs", "half_height", "f_x", "sound_speed0",
                 "p0", "delta_filter", "dt", "n_substeps", "n_actions",
                 "n_wall_elements", "tau_wall", "t0", "t_tau", "wm_iters"):
        assert getattr(ct, attr) == getattr(cj, attr), attr
    assert et.obs_spec.shape == ej.obs_spec.shape
    assert et.obs_spec.channel_names == ej.obs_spec.channel_names
    assert et.obs_spec.channel_gains == ej.obs_spec.channel_gains
    assert (et.action_spec.n_elements, et.action_spec.high) == (
        ej.action_spec.n_elements, ej.action_spec.high)
    np.testing.assert_array_equal(tch.reference_profile(ct),
                                  jch.reference_profile(cj))
    ops_t, ops_j = ct.operators(), cj.operators()
    np.testing.assert_array_equal(ops_t["D"].numpy(), np.asarray(ops_j["D"]))
    np.testing.assert_array_equal(ops_t["w"].numpy(), np.asarray(ops_j["w"]))
    assert ops_t["inv_w_end"] == ops_j["inv_w_end"]


def test_initial_states_from_jax_draws_match_jax_bank():
    """The port's state builder fed the JAX package's bulk factors and phases
    reproduces its bank: 1e-6 of max |u| (measured 1.4e-9; sin and cos of the
    two libraries may differ in the last bit)."""
    cfg_j = jenvs.make("channel_wm_reduced").cfg
    key = jax.random.PRNGKey(4)
    want = np.array(jch.make_state_bank(key, cfg_j, 3))
    bulk, phases = [], []
    for k in jax.random.split(key, 3):  # as sample_initial_state splits
        k, k_amp = jax.random.split(k)
        bulk.append(float(jax.random.uniform(k_amp, (), jnp.float32, 0.75,
                                             1.25)))
        phases.append(np.array(jax.random.uniform(k, (4, 3), jnp.float32,
                                                  0.0, 2.0 * np.pi)))
    got = tch.initial_states(torch.tensor(bulk), torch.from_numpy(
        np.stack(phases)), REDUCED_CFG)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel_err(got, want) <= 1e-6


def test_port_bank_statistics():
    """The port's own bank (torch.Generator draws) by its statistics: density
    rho0 and pressure p0 everywhere, no flow through the walls, and a mean
    profile that is the reference profile times one bulk factor in
    [0.75, 1.25]: the x-z quadrature integrates the periodic perturbation
    modes to zero (deviation 1e-5 of the bulk factor, measured 2.0e-7)."""
    cfg = tenvs.make("channel_wm").cfg
    gen = torch.Generator().manual_seed(0)
    bank = tch.make_state_bank(gen, cfg, 8)
    assert bank.shape == (8,) + cfg.n_elem + (cfg.n,) * 3 + (5,)
    rho, vel, p, _ = tch.equations.conservative_to_primitive(bank)
    torch.testing.assert_close(rho, torch.full_like(rho, cfg.rho0),
                               rtol=0, atol=0)
    torch.testing.assert_close(p, torch.full_like(p, cfg.p0), rtol=1e-5,
                               atol=0)
    # wall nodes: y = 0 and y = 2h are GLL end nodes, where u vanishes
    assert float(vel[:, :, 0, :, :, 0].abs().max()) <= 1e-6
    assert float(vel[:, :, -1, :, :, -1].abs().max()) <= 1e-6
    ops = cfg.operators()
    prof = tch.mean_velocity_profile(bank, cfg, ops)
    ref = torch.as_tensor(tch.reference_profile(cfg))
    interior = ref > 0.1 * ref.max()
    ratio = prof[:, interior] / ref[interior]
    bulk = ratio.mean(dim=1)
    assert float(bulk.min()) >= 0.75 and float(bulk.max()) <= 1.25
    assert float((ratio - bulk[:, None]).abs().max()) <= 1e-5 * float(
        bulk.max())
    assert len(set(np.round(bulk.numpy(), 4))) == 8  # 8 distinct draws


# --- observations -------------------------------------------------------------
@pytest.mark.parametrize("field", ["velocity", "pressure", "temperature"])
def test_wall_observations_match(bank, field):
    """Mirrored wall-layer fields of a JAX state one RL interval past the
    bank (so that p - p0 and T - T0 are not zero): velocity exact, p - p0
    and T - T0 within atol 1e-6, two float32 steps of p0 ~ 7.9 (measured 0:
    the same float32 operations in the same order)."""
    cfg_j, cfg_t = jenvs.make("channel_wm_reduced").cfg, REDUCED_CFG
    ones = jnp.ones((2, 2, 2))
    u = np.array(jch.advance_rl_interval(
        jnp.asarray(bank), ones, ones,
        dataclasses.replace(cfg_j, use_kernels=False)))
    fj = getattr(jch, f"wall_{field}_observation")
    ft = getattr(tch, f"wall_{field}_observation")
    want = np.asarray(fj(jnp.asarray(u), cfg_j))
    got = ft(torch.from_numpy(u), cfg_t)
    assert got.shape == want.shape == (2, 8, 4, 4, 4,
                                       3 if field == "velocity" else 1)
    if field == "velocity":
        np.testing.assert_array_equal(_np(got), want)
    else:
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)


# --- one RHS --------------------------------------------------------------------
@pytest.fixture(scope="module")
def rhs_inputs(bank):
    rng = np.random.default_rng(3)
    return bank, *_scales(rng, 2, REDUCED_CFG)


@pytest.mark.parametrize("port_path,jax_path", [
    ("kernels", "staged"), ("kernels", "kernels"), ("staged", "staged")])
def test_channel_rhs_with_walls(rhs_inputs, port_path, jax_path):
    """One wall-bounded RHS on JAX bank states with non-uniform wall-stress
    scaling.  The port's kernel path runs the plain versions on CPU
    tensors; the JAX kernel path runs the Pallas kernels in interpret mode.
    2e-5 (measured 1.03e-7 for each of the three pairs)."""
    u, sb, st = rhs_inputs
    cfg_j = dataclasses.replace(jenvs.make("channel_wm_reduced").cfg,
                                use_kernels=jax_path == "kernels")
    cfg_t = dataclasses.replace(REDUCED_CFG,
                                use_kernels=port_path == "kernels")
    want = jch.channel_rhs(jnp.asarray(u), jnp.asarray(sb), jnp.asarray(st),
                           cfg_j, cfg_j.operators())
    got = tch.channel_rhs(torch.from_numpy(u), torch.from_numpy(sb),
                          torch.from_numpy(st), cfg_t, cfg_t.operators())
    assert got.shape == u.shape and got.dtype == torch.float32
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("use_kernels", [True, False])
def test_channel_rhs_without_walls_is_the_periodic_hit_rhs(use_kernels):
    """`wall=False` on a cubic box is the port's periodic HIT RHS with the
    forcing off, bit for bit (the same helpers in the same order), on both
    assemblies, as the JAX package pins for itself."""
    length = 2.0 * np.pi
    hit = HITConfig(n_poly=3, n_elem=2, forcing_a0=0.0, nu=5e-3,
                    use_kernels=use_kernels)
    ch = ChannelConfig(n_poly=3, n_elem=(2, 2, 2),
                       lengths=(length, length, length), nu=5e-3,
                       mach=hit.mach, u_bulk=hit.u_rms, wall=False,
                       u_tau=0.0, cs_sgs=0.17, use_kernels=use_kernels)
    gen = torch.Generator().manual_seed(0)
    u = initial.make_state_bank(gen, hit, 2)
    cs_nodes = torch.full(u.shape[:-1], 0.17)
    r_hit = solver.navier_stokes_rhs(u, cs_nodes, hit, hit.operators())
    ones = torch.ones((2, 2, 2, 4, 4))
    r_ch = tch.channel_rhs(u, ones, ones, ch, ch.operators())
    torch.testing.assert_close(r_ch, r_hit, rtol=0, atol=0)


def test_kernel_path_calls_each_component_kernel(rhs_inputs, monkeypatch):
    """Per RHS the kernel path calls dg_derivative3, smagorinsky_nut and
    wall_model_tau once each, the wall model on both walls' points in one
    batch (the arithmetic chip_smoke.py's launch counts rest on); the
    staged path calls none of them."""
    calls = {"dg": 0, "smag": 0, "wm": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(solver.dg_derivative, "dg_derivative3",
                        spy("dg", dg_derivative.dg_derivative3))
    monkeypatch.setattr(solver.smagorinsky, "smagorinsky_nut",
                        spy("smag", smagorinsky.smagorinsky_nut))
    monkeypatch.setattr(tch.wall_model, "wall_model_tau",
                        spy("wm", wall_model.wall_model_tau))
    u, sb, st = (torch.from_numpy(x) for x in rhs_inputs)
    tch.channel_rhs(u, sb, st, REDUCED_CFG, REDUCED_CFG.operators())
    assert calls == {"dg": 1, "smag": 1, "wm": 1}
    staged = dataclasses.replace(REDUCED_CFG, use_kernels=False)
    tch.channel_rhs(u, sb, st, staged, staged.operators())
    assert calls == {"dg": 1, "smag": 1, "wm": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_hands_the_kernels_views_without_copies(rhs_inputs,
                                                            monkeypatch,
                                                            dtype):
    """Per RHS, smagorinsky_nut reads the velocity rows of the gradient that
    `dg_gradient` returned in place: a non-contiguous (P, 3, 3) view (point
    stride 12) of the same storage, which the CUDA wrapper's checks take,
    and C_s as a view too; dg_derivative3 gets D in the state's dtype as the
    rollout holds it (bf16 in bf16 rollouts: no cast on the kernel path) and
    the tiled instance is picked.  The RHS is the same as with copies."""
    seen = {}
    dg_gradient = solver.dgsem.dg_gradient
    smag, dg3 = smagorinsky.smagorinsky_nut, dg_derivative.dg_derivative3

    def grad_spy(*a, **k):
        seen["grad_prim"] = dg_gradient(*a, **k)
        return seen["grad_prim"]

    def smag_spy(grad_v, cs, delta):
        smagorinsky._check_inputs(grad_v, cs)
        seen["smag"] = (grad_v, cs)
        return smag(grad_v, cs, delta)

    def dg_spy(u, d):
        dg_derivative._check_inputs(u, d)
        seen["dg"] = (u, d)
        return dg3(u, d)

    monkeypatch.setattr(solver.dgsem, "dg_gradient", grad_spy)
    monkeypatch.setattr(solver.smagorinsky, "smagorinsky_nut", smag_spy)
    monkeypatch.setattr(solver.dg_derivative, "dg_derivative3", dg_spy)
    tdt = getattr(torch, dtype)
    u, sb, st = (torch.from_numpy(x).to(tdt) for x in rhs_inputs)
    ops = REDUCED_CFG.operators()
    ops = dict(ops, D=ops["D"].to(tdt), w=ops["w"].to(tdt))
    got = tch.channel_rhs(u, sb, st, REDUCED_CFG, ops)

    grad_v, cs = seen["smag"]
    grad_prim = seen["grad_prim"]
    assert not grad_v.is_contiguous() and grad_v.stride() == (12, 3, 1)
    assert grad_v.untyped_storage().data_ptr() == \
        grad_prim.untyped_storage().data_ptr()
    assert grad_v.data_ptr() == grad_prim.data_ptr()
    assert cs.stride() == (1,) and cs.shape == grad_v.shape[:1]
    u_dg, d = seen["dg"]
    assert d.dtype == tdt and d.data_ptr() == ops["D"].data_ptr()
    assert dg_derivative.pick_instance(u_dg.shape[1], u_dg.shape[4],
                                       u_dg.dtype) == "tiled"
    # the same RHS as with the rows copied first, bit for bit
    monkeypatch.setattr(solver.smagorinsky, "smagorinsky_nut",
                        lambda g, c, dl: smag(g.contiguous(), c.contiguous(),
                                              dl))
    want = tch.channel_rhs(u, sb, st, REDUCED_CFG, ops)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["channel_wm_reduced",
                                  "channel_wm_hre_reduced"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_batched_wall_fluxes_match_reference(name, dtype, use_kernels):
    """Both walls' fluxes from one batch (the two wall slabs stacked on an
    axis of size 2) against the JAX package's per-wall loop, on JAX bank
    states with non-uniform scaling; the JAX side runs its staged assembly.
    float32: the RHS pin of 2e-5 (measured <= 1.9e-9 of max |want|);
    bfloat16 (states, scales and the quadrature weights in bf16, as
    `advance_rl_interval` hands them): the bf16 interval pin of 4e-2
    (measured 3.9e-3, one bf16 ulp)."""
    cfg_j = jenvs.make(name).cfg
    cfg_t = dataclasses.replace(tenvs.make(name).cfg, use_kernels=use_kernels)
    u = np.array(jenvs.make(name).initial_state_bank(jax.random.PRNGKey(4),
                                                     2))
    sb, st = _scales(np.random.default_rng(5), 2, cfg_t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ops_j, ops_t = cfg_j.operators(), cfg_t.operators()
    ops_j = dict(ops_j, w=ops_j["w"].astype(jdt))
    ops_t = dict(ops_t, w=ops_t["w"].to(tdt))
    want = jch.wall_fluxes(*(jnp.asarray(x, jdt) for x in (u, sb, st)),
                           cfg_j, ops_j)
    got = tch.wall_fluxes(*(torch.from_numpy(x).to(tdt) for x in (u, sb, st)),
                          cfg_t, ops_t)
    tol = {"float32": 2e-5, "bfloat16": 4e-2}[dtype]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == tdt
        assert _rel_err(g, np.asarray(w, np.float32)) <= tol


# --- one RL interval --------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_advance_rl_interval(bank, precision):
    """One RL interval (20 substeps x 5 RK stages) on the port's kernel path.
    fp32 against the JAX staged path: 2e-5 (measured 3.2e-7).  bf16 against
    the JAX kernel path (Pallas in interpret mode): most of the channel RHS
    is bfloat16 math on both sides, and XLA fuses elementwise chains in
    float32 where PyTorch rounds every op, so the two differ by a few bf16
    steps: max 4e-2, the JAX bf16 gate (measured 2.1e-2), and relative L2
    1e-2 (measured 3.1e-3, against 2.2e-2 between JAX's bf16 and fp32)."""
    rng = np.random.default_rng(5)
    sb, st = _scales(rng, 2, REDUCED_CFG, per_node=False)
    cfg_j = dataclasses.replace(jenvs.make("channel_wm_reduced").cfg,
                                precision=precision,
                                use_kernels=precision == "bf16")
    cfg_t = dataclasses.replace(REDUCED_CFG, precision=precision)
    want = np.asarray(jch.advance_rl_interval(
        jnp.asarray(bank), jnp.asarray(sb), jnp.asarray(st), cfg_j))
    got = tch.advance_rl_interval(torch.from_numpy(bank),
                                  torch.from_numpy(sb), torch.from_numpy(st),
                                  cfg_t)
    assert got.dtype == torch.float32 and got.shape == bank.shape
    if precision == "fp32":
        assert _rel_err(got, want) <= 2e-5
    else:
        assert _rel_err(got, want) <= 4e-2
        rel_l2 = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert rel_l2 <= 1e-2


# --- env steps ----------------------------------------------------------------
@pytest.mark.parametrize("name", REDUCED)
def test_env_step_matches_reference(name):
    """One env step of 2 envs from the JAX bank: the next state within 2e-5
    of max |u| (measured <= 5.0e-7); the obs within 2e-5 of max |obs|
    (measured <= 6.0e-6), except T_wall, (T - T0) / t_tau with t_tau =
    4.1e-3, where one float32 step of T ~ 7.9 is 8e-6 of max |obs|: 1e-4
    (measured 2.7e-5); reward atol 1e-5 (measured <= 2.4e-7); done exact."""
    ej, et = jenvs.make(name), tenvs.make(name)
    bank = np.array(ej.initial_state_bank(jax.random.PRNGKey(8), 2))
    action = np.random.default_rng(6).uniform(
        0.3, 1.7, (2, ej.action_spec.n_elements)).astype(np.float32)
    obs_j = ej.observe(JEnvState(jnp.asarray(bank), jnp.zeros((2,),
                                                             jnp.int32)))
    res_j = ej.step(JEnvState(jnp.asarray(bank), jnp.zeros((2,), jnp.int32)),
                    jnp.asarray(action))
    state_t, obs_t = et.reset_from_bank(torch.from_numpy(bank),
                                        torch.arange(2))
    assert _rel_err(obs_t, obs_j) <= 2e-5
    res_t = et.step(state_t, torch.from_numpy(action))
    assert _rel_err(res_t.state.u, res_j.state.u) <= 2e-5
    assert res_t.obs.shape == res_j.obs.shape == (2,) + et.obs_spec.shape
    assert _rel_err(res_t.obs, res_j.obs) <= (1e-4 if name.startswith(
        "channel_wm_t") else 2e-5)
    np.testing.assert_allclose(_np(res_t.reward), np.asarray(res_j.reward),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res_t.done.numpy(),
                                  np.asarray(res_j.done))
    assert res_t.state.t_step.tolist() == [1, 1]


def test_blowup_guard_reverts_state_and_floors_reward(bank):
    """A non-finite state is reverted and rewarded -1; its neighbour in the
    batch steps normally."""
    env = tenvs.make("channel_wm_reduced")
    u = torch.from_numpy(bank).clone()
    u[1, 0, 1, 0, 2, 2, 2, 4] = float("nan")
    state = EnvState(u=u, t_step=torch.zeros((2,), dtype=torch.int32))
    res = env.step(state, torch.ones((2, 8)))
    assert bool(torch.isfinite(res.state.u[0]).all())
    assert not torch.equal(res.state.u[0], u[0])
    torch.testing.assert_close(res.state.u[1], u[1], rtol=0, atol=0,
                               equal_nan=True)
    assert float(res.reward[1]) == -1.0
    assert -1.0 < float(res.reward[0]) <= 1.0


# --- physics checks -----------------------------------------------------------
def _box_mean(u: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    return dgsem.quadrature_mean(u, dgsem.DGParams(cfg.n_poly, 1))


def test_wall_bc_conserves_mass():
    """The wall mass flux is zero and the split form conservative: total
    mass survives 3 RL intervals to rtol 1e-6 (measured 1.8e-7)."""
    gen = torch.Generator().manual_seed(1)
    u0 = tch.sample_initial_state(gen, REDUCED_CFG)
    u = u0
    ones = torch.ones((2, 2))
    for _ in range(3):
        u = tch.advance_rl_interval(u, ones, ones, REDUCED_CFG)
    assert bool(torch.isfinite(u).all())
    np.testing.assert_allclose(float(_box_mean(u, REDUCED_CFG)[0]),
                               float(_box_mean(u0, REDUCED_CFG)[0]),
                               rtol=1e-6)


def test_wall_stress_decelerates_unforced_flow():
    """With the forcing off the modeled wall stress is the only x-momentum
    sink: the bulk momentum falls, and faster under a larger stress
    scaling.  The state is sampled with the flow on (u_tau = 0.12) and
    advanced with u_tau = 0, which zeroes f_x while the wall model uses only
    nu, kappa and wm_iters."""
    gen = torch.Generator().manual_seed(2)
    u0 = tch.sample_initial_state(gen, REDUCED_CFG)
    unforced = dataclasses.replace(REDUCED_CFG, u_tau=0.0)
    assert unforced.f_x == 0.0
    mom0 = float(_box_mean(u0, REDUCED_CFG)[1])
    assert mom0 > 0.0
    moms = {}
    for a in (0.5, 2.0):
        scale = torch.full((2, 2), a)
        u = tch.advance_rl_interval(u0, scale, scale, unforced)
        moms[a] = float(_box_mean(u, REDUCED_CFG)[1])
    assert moms[0.5] < mom0
    assert moms[2.0] < moms[0.5]


def test_wall_model_laminar_limit():
    """In the viscous sublayer the inverted wall law is the laminar stress
    mu u_par / y_m (1%)."""
    cfg = REDUCED_CFG
    tau = tch.wall_stress_magnitude(torch.tensor([0.01]), torch.tensor(
        cfg.rho0), 1e-3, cfg)
    np.testing.assert_allclose(float(tau[0]), cfg.rho0 * cfg.nu * 0.01 / 1e-3,
                               rtol=1e-2)


# --- policy, rollout, PPO, runner -------------------------------------------
def test_load_jax_params_into_the_pressure_policy():
    """The JAX parameter tree of the 4-channel `channel_wm_p` policy (input
    gains 1, 1, 1, 0.5) loads into the port; mean, value and log-prob agree
    to rtol 1e-5 (measured <= 7.6e-8 of max |want|)."""
    ej, et = jenvs.make("channel_wm_p"), tenvs.make("channel_wm_p")
    pcfg_j = jpolicy.PolicyConfig.from_specs(ej.obs_spec, ej.action_spec)
    pcfg_t = tpolicy.PolicyConfig.from_specs(et.obs_spec, et.action_spec)
    assert pcfg_t.active_gains == (1.0, 1.0, 1.0, 0.5) == pcfg_j.active_gains
    params = jax.tree.map(np.asarray, jpolicy.init(jax.random.PRNGKey(1),
                                                   pcfg_j))
    pol = tpolicy.Policy(pcfg_t)
    tpolicy.load_jax_params(pol, params)
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((2,) + et.obs_spec.shape).astype(np.float32)
    action = rng.uniform(0.0, 2.0, (2, 18)).astype(np.float32)
    mean_j, std_j = jpolicy.distribution(params, pcfg_j, obs)
    with torch.no_grad():
        mean_t, std_t = pol.distribution(torch.from_numpy(obs))
        value_t = pol.value(torch.from_numpy(obs))
    np.testing.assert_allclose(_np(mean_t), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(value_t), np.asarray(
        jpolicy.value(params, pcfg_j, obs)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(tpolicy.log_prob(mean_t, std_t, torch.from_numpy(action))),
        np.asarray(jpolicy.log_prob(mean_j, std_j, action)), rtol=1e-5)


def test_rollout_and_update_match_reference():
    """The slice as a whole on `channel_wm_reduced`: one fleet rollout (2
    envs, 3 RL steps of 20 substeps) from the same JAX bank rows with the
    JAX package's action noise fed in, then one PPO update on each side.
    Per-step quantities 1e-4 of their scale (measured <= 8.6e-7); update
    stats rtol 1e-3 (measured <= 9.3e-6)."""
    env_j, env_t = jenvs.make("channel_wm_reduced"), tenvs.make(
        "channel_wm_reduced")
    pcfg_j = jpolicy.PolicyConfig.from_specs(env_j.obs_spec,
                                             env_j.action_spec)
    params = jax.tree.map(np.asarray, jpolicy.init(jax.random.PRNGKey(0),
                                                   pcfg_j))
    u0 = np.array(env_j.initial_state_bank(jax.random.PRNGKey(3), 2))
    key = jax.random.PRNGKey(5)
    traj_j = jax.jit(lambda p, u, k: jrollout.rollout(p, pcfg_j, env_j, u,
                                                      k))(params,
                                                          jnp.asarray(u0), key)
    step_keys = jax.random.split(key, env_j.n_actions)
    noise = np.array(jax.vmap(lambda kk: jax.random.normal(
        kk, (2,) + env_j.action_spec.shape))(step_keys))
    pol = tpolicy.Policy(tpolicy.PolicyConfig.from_specs(env_t.obs_spec,
                                                         env_t.action_spec))
    tpolicy.load_jax_params(pol, params)
    traj_t = trollout.rollout(pol, env_t, torch.from_numpy(u0),
                              noise=torch.from_numpy(noise))
    for name in ("obs", "actions", "log_probs", "rewards", "values",
                 "last_value"):
        got, want = _np(getattr(traj_t, name)), np.asarray(getattr(traj_j,
                                                                   name))
        assert got.shape == want.shape, name
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    np.testing.assert_array_equal(traj_t.dones.numpy(),
                                  np.asarray(traj_j.dones))

    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    _, _, stats_j = jax.jit(functools.partial(
        jppo.update, cfg=cfg_j, pcfg=pcfg_j))(
        params, joptim.adam_init(params), traj=traj_j)
    stats_t = tppo.update(pol, tppo.make_optimizer(pol, cfg_t), cfg_t, traj_t)
    for k in ("loss", "surrogate", "value_loss", "entropy", "grad_norm",
              "mean_return"):
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_rl_train_entry_point_trains_channel_on_cpu(tmp_path):
    """The entry point a user calls, unchanged, on the CPU: 2 iterations of
    `channel_wm_reduced` with 2 envs and an evaluation, finite normalized
    returns in [-1, 1], and a checkpoint of step 2."""
    history = rl_train.main([
        "--env", "channel_wm_reduced", "--n-envs", "2", "--iterations", "2",
        "--eval-every", "2", "--device", "cpu", "--checkpoint-dir",
        str(tmp_path)])
    assert len(history) == 2
    for rec in history:
        assert np.isfinite(rec["return_norm"])
        assert -1.0 <= rec["return_norm"] <= 1.0
    assert -1.0 <= history[-1]["eval_return_norm"] <= 1.0
    assert tckpt.latest_step(str(tmp_path)) == 2
