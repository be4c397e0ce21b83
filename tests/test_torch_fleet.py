"""PyTorch port vs JAX reference: the heterogeneous fleet (`fleet/`).

The scheduler, the broker, the multitask policy and the joint update are
held to the JAX package (the reference's parameter tree carried across with
`multitask.load_jax_params`, trajectories made from a numpy seed); the
fleet's replay, guard and policy-lag rules are held within the port, bit
for bit, at reduced sizes on the CPU; the `cuda`-marked tests hold the
guard and the fleet's evaluation on the GPU.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro import optim as joptim
from repro.core import ppo as jppo
from repro.fleet import broker as jbroker
from repro.fleet import multitask as jmt
from repro.fleet import scheduler as jsched
from repro_torch import envs as tenvs
from repro_torch import fleet, resolve_device
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import ppo as tppo
from repro_torch.fleet import broker, multitask, scheduler
from repro_torch.fleet.pipeline import (FleetRunner, FleetRunnerConfig,
                                        _host_record)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLEET_NAMES = ("hit_les_reduced", "channel_wm_reduced", "burgers_reduced")
PRODUCTION = ("hit_les_24dof", "channel_wm", "burgers_96dof")


def _item(v: float) -> dict:
    return {"a": torch.full((), v), "b": torch.full((2, 3), v)}


def _run_cfg(tmp, **kw) -> FleetRunnerConfig:
    base = dict(n_iterations=3, eval_every=100, checkpoint_every=100,
                checkpoint_dir=str(tmp), async_checkpoint=False, bank_size=4)
    return FleetRunnerConfig(**{**base, **kw})


def _short_runner(tmp, **kw) -> FleetRunner:
    """HIT (one RL step an episode) + Burgers (three), 2 + 3 envs: the
    fleet's rules at a size that trains an iteration in about a second."""
    named = [("hit_les_reduced", tenvs.make("hit_les_reduced", t_end=0.1)),
             ("burgers_reduced", tenvs.make("burgers_reduced"))]
    sched = scheduler.build_schedule(named, 5, costs={
        "hit_les_reduced": 3.0, "burgers_reduced": 2.0})
    assert [m.n_envs for m in sched.members] == [2, 3]
    return FleetRunner(sched, run_cfg=_run_cfg(tmp, **kw), device="cpu")


def _state(runner) -> dict:
    """Params, optimizer state and broker as flat host copies."""
    return {k: v for k, v in tckpt._flatten(runner._state_tree())}


def _assert_state_equal(a, b, keys=None):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in keys or sa:
        assert torch.equal(sa[k], sb[k]), k


# --- scheduler ------------------------------------------------------------------
@pytest.mark.parametrize("weights,total,min_envs", [
    ([100.0, 1.0, 1.0], 6, 2),           # min_envs floors overshoot: shaved
    ([1.0, 1.0, 1.0], 7, 1),             # ties: remainder to the earliest
    ([1.0, 1.0, 1.0, 1.0], 6, 1),
    ([2.0, 1.0], 5, 1),
    ([1 / 898560, 1 / 299520, 1 / 3168], 32, 8),   # the production fleet
    ([1 / 898560, 1 / 299520, 1 / 3168], 32, 1),
])
def test_partition_equals_the_reference(weights, total, min_envs):
    got = scheduler._partition(weights, total, min_envs)
    assert got == jsched._partition(weights, total, min_envs)
    assert sum(got) == total and min(got) >= min_envs
    with pytest.raises(ValueError, match="total_envs"):
        scheduler._partition(weights, min_envs * len(weights) - 1, min_envs)


def test_static_costs_and_schedules_equal_the_reference():
    """static_step_cost for every env registered in both packages, and the
    schedules built from those costs, equal the reference's."""
    names = sorted(set(tenvs.registered()) & set(jenvs.registered()))
    assert len(names) == 13, names
    for name in names:
        assert scheduler.static_step_cost(tenvs.make(name)) == \
            jsched.static_step_cost(jenvs.make(name)), name
    for fleet_names, total, kw in ((PRODUCTION, 32, {"min_envs": 8}),
                                   (PRODUCTION, 32, {}),
                                   (FLEET_NAMES, 6, {}),
                                   (tuple(names), 40, {"min_envs": 2})):
        got = scheduler.build_schedule(
            [(n, tenvs.make(n)) for n in fleet_names], total,
            use_artifacts=False, **kw)
        want = jsched.build_schedule(
            [(n, jenvs.make(n)) for n in fleet_names], total,
            use_artifacts=False, **kw)
        assert [(m.name, m.n_envs, m.weight, m.cost) for m in got.members] \
            == [(m.name, m.n_envs, m.weight, m.cost) for m in want.members]
    prod = scheduler.build_schedule([(n, tenvs.make(n)) for n in PRODUCTION],
                                    32, min_envs=8)
    assert [(m.n_envs, m.cost) for m in prod.members] == [
        (8, 898560.0), (8, 299520.0), (16, 3168.0)]


def test_dryrun_cost_reads_artifacts_as_the_reference(tmp_path):
    """Exact-scenario matching, the legacy HIT arch tag, a record without
    a measurement skipped for an older one, and a measured zero raising:
    both packages read the same directory the same way."""
    def write(name, rec, age):
        with open(tmp_path / name, "w") as f:
            json.dump(rec, f)
        now = time.time() - age
        os.utime(tmp_path / name, (now, now))

    write("single_channel-wm_fleet_256.json", {
        "status": "ok", "arch": "channel-wm",
        "variant": "channel_wm_reduced", "flops_per_env": 2.0e6}, 300)
    write("single_relexi-hit24_fleet_256.json", {
        "status": "ok", "arch": "relexi-hit24", "flops_per_env": 1.0e6}, 200)
    write("new_fleet_1.json", {"status": "ok",
                               "variant": "channel_wm_reduced"}, 100)
    d = str(tmp_path)
    for name in ("channel_wm_reduced", "hit_les_24dof", "channel_wm",
                 "burgers_reduced"):
        assert scheduler.dryrun_step_cost(name, artifact_dir=d) == \
            jsched.dryrun_step_cost(name, artifact_dir=d), name
    assert scheduler.dryrun_step_cost("channel_wm_reduced",
                                      artifact_dir=d) == 2.0e6
    assert scheduler.dryrun_step_cost("channel_wm", artifact_dir=d) is None
    measured = scheduler.build_schedule(
        [("channel_wm_reduced", tenvs.make("channel_wm_reduced")),
         ("hit_les_24dof", tenvs.make("hit_les_24dof"))], 9, artifact_dir=d)
    assert [m.cost for m in measured.members] == [2.0e6, 1.0e6]
    write("a_fleet_1.json", {"status": "ok", "variant": "burgers_reduced",
                             "flops_per_env": 0.0}, 0)
    for pkg in (scheduler, jsched):
        with pytest.raises(ValueError, match="non-positive"):
            pkg.dryrun_step_cost("burgers_reduced", artifact_dir=d)


def test_scenario_and_rollout_seeds_distinct_and_stable():
    seeds = {scheduler.scenario_seed(s, i) for s in range(4) for i in range(4)}
    assert len(seeds) == 16
    # the former additive stride's collisions stay apart
    assert scheduler.scenario_seed(0, 1) != scheduler.scenario_seed(7919, 0)
    assert scheduler.scenario_seed(3, 2) != scheduler.scenario_seed(7926, 1)
    # and so do a trailing zero word and a seed beyond 32 bits
    assert scheduler.scenario_seed(5, 0) != scheduler.scenario_seed(5, 2**32)
    assert scheduler.scenario_seed(5, 2) == scheduler.scenario_seed(5, 2)
    rolls = {scheduler.rollout_seed(7, i, k) for i in range(3)
             for k in range(5)}
    assert len(rolls) == 15 and not rolls & seeds
    assert scheduler.rollout_seed(7, 1, 3) == scheduler.rollout_seed(7, 1, 3)
    assert all(0 <= s < 2**63 for s in rolls | seeds)
    with pytest.raises(ValueError):
        scheduler.scenario_seed(-1, 0)


# --- broker ---------------------------------------------------------------------
def test_ring_wraparound():
    ring = broker.ring_init(_item(0.0), 3)
    assert broker.capacity(ring) == 3 and int(broker.size(ring)) == 0
    for v in range(1, 6):  # five pushes through a capacity-3 ring
        assert broker.push_donated(ring, _item(float(v))) is ring
    assert int(ring.head) == 5 and int(broker.size(ring)) == 3
    for age, want in ((0, 5.0), (1, 4.0), (2, 3.0)):
        got = broker.peek(ring, age)
        assert float(got["a"]) == want
        assert torch.equal(got["b"], torch.full((2, 3), want))


def test_push_donated_writes_in_place_what_the_reference_push_holds():
    """Pushes write into the ring's own buffers (no new allocation) and
    leave the slots, head and peeks of the reference's ring."""
    ring = broker.ring_init(_item(0.0), 2)
    jring = jbroker.ring_init({"a": jnp.zeros(()), "b": jnp.zeros((2, 3))}, 2)
    bufs = [t.data_ptr() for t in broker.tree_leaves(ring.data)]
    for v in (1.0, 2.0, 3.0):
        broker.push_donated(ring, _item(v))
        jring = jbroker.push(jring, {"a": jnp.float32(v),
                                     "b": jnp.full((2, 3), v, jnp.float32)})
    assert [t.data_ptr() for t in broker.tree_leaves(ring.data)] == bufs
    assert int(ring.head) == int(jring.head) == 3
    for key in ("a", "b"):
        np.testing.assert_array_equal(ring.data[key].numpy(),
                                      np.asarray(jring.data[key]))
        for age in (0, 1):
            np.testing.assert_array_equal(
                broker.peek(ring, age)[key].numpy(),
                np.asarray(jbroker.peek(jring, age)[key]))


def test_drain_order_and_vector_metrics_json_ready():
    """Oldest first and capacity-bounded, as the reference drains; a
    vector metric comes back as a list and survives `_host_record`."""
    b = broker.broker_init({}, metric_templates={"m": torch.zeros(())},
                           metrics_capacity=4)
    jb = jbroker.broker_init({}, metric_templates={"m": jnp.zeros(())},
                             metrics_capacity=4)
    for v in range(1, 7):
        broker.push_donated(b.metrics["m"], torch.tensor(float(v)))
        jb = jbroker.push_metrics(jb, "m", jnp.float32(v))
    assert broker.drain_host(b)["m"] == jbroker.drain_host(jb)["m"] == [
        3.0, 4.0, 5.0, 6.0]
    template = {"loss": torch.zeros(()), "per_scenario": torch.zeros((3,))}
    b = broker.broker_init({}, metric_templates={"fleet": template},
                           metrics_capacity=4)
    broker.push_donated(b.metrics["fleet"], {
        "loss": torch.tensor(0.5), "per_scenario": torch.tensor([1., 2., 3.])})
    (rec,) = broker.drain_host(b)["fleet"]
    assert isinstance(rec["loss"], float) and rec["loss"] == 0.5
    assert rec["per_scenario"] == [1.0, 2.0, 3.0]
    json.dumps(rec)
    host = _host_record(rec)
    assert host["per_scenario"] == [1.0, 2.0, 3.0]
    assert isinstance(host["loss"], float)


# --- multitask policy -----------------------------------------------------------
@pytest.fixture(scope="module")
def multitask_pair():
    mcfg_j = jmt.MultiTaskConfig.from_envs(
        [(n, jenvs.make(n)) for n in FLEET_NAMES])
    mcfg_t = multitask.MultiTaskConfig.from_envs(
        [(n, tenvs.make(n)) for n in FLEET_NAMES])
    params = jax.tree.map(np.asarray, jmt.init(jax.random.PRNGKey(0), mcfg_j))
    return mcfg_j, mcfg_t, params


def _port_policy(mcfg_t, params):
    pol = multitask.MultiTaskPolicy(mcfg_t)
    multitask.load_jax_params(pol, params)
    return pol


def test_multitask_heads_match_the_reference(multitask_pair):
    """actor_mean, value and distribution of the three reduced heads with
    the reference's weights carried across: float32 dense layers of <= 192
    inputs summed in another order, rtol 1e-5 (measured <= 2e-7)."""
    mcfg_j, mcfg_t, params = multitask_pair
    assert mcfg_t.heads == tuple(multitask.HeadSpec(**vars(h))
                                 for h in mcfg_j.heads)
    pol = _port_policy(mcfg_t, params)
    assert sum(p.numel() for p in pol.parameters()) == jmt.param_count(params)
    assert all(p.requires_grad for p in pol.parameters())
    rng = np.random.default_rng(0)
    for h in mcfg_t.heads:
        obs = rng.standard_normal((3, h.n_elements) + h.spatial
                                  + (h.channels,)).astype(np.float32)
        head = pol.head(h.name)
        with torch.no_grad():
            mean_t, std_t = head.distribution(torch.from_numpy(obs))
            value_t = head.value(torch.from_numpy(obs))
            am_t = head.actor_mean(torch.from_numpy(obs))
        mean_j, std_j = jmt.distribution(params, mcfg_j, h.name, obs)
        for got, want in ((mean_t, mean_j), (std_t, std_j), (am_t, mean_j),
                          (value_t, jmt.value(params, mcfg_j, h.name, obs))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=h.name)
        assert mean_t.shape == (3, h.n_elements)
        assert bool(((mean_t >= h.act_low) & (mean_t <= h.act_high)).all())


def _fixed_trajs(mcfg_t, t=3, b=2, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for h in mcfg_t.heads:
        dones = np.zeros((t, b), bool)
        dones[-1] = True
        out[h.name] = dict(
            obs=rng.standard_normal((t, b, h.n_elements) + h.spatial
                                    + (h.channels,)).astype(np.float32),
            actions=rng.uniform(0.0, h.act_high, (t, b, h.n_elements)
                                ).astype(np.float32),
            log_probs=rng.normal(3.0, 0.5, (t, b)).astype(np.float32),
            rewards=rng.uniform(-1.0, 1.0, (t, b)).astype(np.float32),
            dones=dones,
            values=rng.normal(0.0, 0.3, (t, b)).astype(np.float32),
            last_value=rng.normal(0.0, 0.3, (b,)).astype(np.float32))
    return out


def _jax_leaves(tree, prefix="params"):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _jax_leaves(sub, f"{prefix}.{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _jax_leaves(sub, f"{prefix}.{i}").items()}
    return {prefix: np.asarray(tree)}


def test_fleet_update_matches_the_reference(multitask_pair):
    """One joint update (5 epochs of Adam, the global-norm clip) on the
    same trajectories of the three heads, weights 1/6, 1/6, 4/6: the
    params after the 5 epochs and the last epoch's stats at the pin of
    test_torch_training.py::test_gae_loss_and_gradients, rtol 1e-4 with an
    absolute floor of 1e-4 of each leaf's max (measured: params <= 1.2e-7
    absolute, stats <= 1.7e-7)."""
    mcfg_j, mcfg_t, params = multitask_pair
    fixed = _fixed_trajs(mcfg_t)
    weights = {"hit_les_reduced": 1 / 6, "channel_wm_reduced": 1 / 6,
               "burgers_reduced": 4 / 6}
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    trajs_j = {n: jppo.Trajectory(**{k: jnp.asarray(v) for k, v in d.items()})
               for n, d in fixed.items()}
    trajs_t = {n: tppo.Trajectory(**{k: torch.from_numpy(v)
                                     for k, v in d.items()})
               for n, d in fixed.items()}
    p_j, _, stats_j = jax.jit(lambda p, o, t: jmt.fleet_update(
        p, o, cfg_j, mcfg_j, t, weights))(params, joptim.adam_init(params),
                                          trajs_j)
    pol = _port_policy(mcfg_t, params)
    opt = tppo.make_optimizer(pol, cfg_t)
    stats_t = multitask.fleet_update(pol, opt, cfg_t, trajs_t, weights)
    want = _jax_leaves(p_j)
    got = {k: v.detach().numpy() for k, v in pol.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
        assert not np.array_equal(want[k], _jax_leaves(params)[k]), k
    assert stats_t.keys() == stats_j.keys()
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats_t[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert all(float(s["step"]) == cfg_t.n_epochs for s in opt.state.values())


def test_shared_trunk_is_shared(multitask_pair):
    """One scenario's loss reaches the shared trunk and its own head, and
    no other scenario's head."""
    _, mcfg_t, params = multitask_pair
    pol = _port_policy(mcfg_t, params)
    obs = torch.from_numpy(_fixed_trajs(mcfg_t)["burgers_reduced"]["obs"][0])
    pol.head("burgers_reduced").actor_mean(obs).sum().backward()
    grads = {k: p.grad for k, p in pol.named_parameters()}
    assert all(float(grads[f"params.shared.actor.{i}.w"].abs().max()) > 0
               for i in range(mcfg_t.n_shared_layers))
    assert float(grads["params.heads.burgers_reduced.actor_in.w"].abs().max()
                 ) > 0
    assert grads["params.heads.hit_les_reduced.actor_in.w"] is None
    assert grads["params.shared.critic.0.w"] is None


# --- the fleet --------------------------------------------------------------------
def test_mixed_fleet_trains_and_logs(tmp_path):
    """hit_les_reduced + channel_wm_reduced + burgers_reduced (1 / 1 / 4
    envs, the reference's schedule) through `make_fleet_runner`: one
    pipelined iteration, an evaluation and a checkpoint whose meta names
    what a serving loader needs."""
    runner = fleet.make_fleet_runner(
        FLEET_NAMES, total_envs=6, device="cpu", use_artifacts=False,
        run_cfg=_run_cfg(tmp_path, n_iterations=1, eval_every=1))
    assert [m.n_envs for m in runner.schedule.members] == [1, 1, 4]
    (rec,) = runner.train(resume=False)
    assert rec["update_ok"] == 1.0 and rec["iteration"] == 0.0
    for name in FLEET_NAMES:
        assert -1.0 <= rec[f"{name}/return_norm"] <= 1.0
    with open(runner.metrics_path) as f:
        logged = [json.loads(line) for line in f]
    for name in FLEET_NAMES:
        assert any(-1.0 <= r.get(f"{name}/eval_return_norm", 9) <= 1.0
                   for r in logged)
    _, manifest = tckpt.restore_arrays(str(tmp_path), 1)
    meta = manifest["meta"]
    assert meta["scenarios"] == list(FLEET_NAMES)
    assert meta["n_envs"] == {"hit_les_reduced": 1, "channel_wm_reduced": 1,
                              "burgers_reduced": 4}
    assert (meta["pipelined"], meta["d_embed"], meta["n_shared_layers"]) == \
        (True, 32, 2)


def test_restored_pipelined_run_replays_bit_for_bit(tmp_path):
    """Same seed => same params, optimizer state and broker, straight
    through a checkpoint restore of the fleet's state tree (the in-flight
    trajectory included)."""
    a = _short_runner(tmp_path / "a")
    a.train(resume=False)
    b = _short_runner(tmp_path / "b", checkpoint_every=2)
    b.train(2, resume=False)
    b2 = _short_runner(tmp_path / "b")
    assert b2.restore() and b2.iteration == 2
    b2.train(3, resume=False)
    _assert_state_equal(a, b2)


def test_sync_mode_returns_timings(tmp_path):
    runner = _short_runner(tmp_path, n_iterations=2, pipelined=False)
    history = runner.train(resume=False)
    assert [rec["iteration"] for rec in history] == [0, 1]
    for rec in history:
        assert rec["t_sample_s"] > 0.0 and rec["t_update_s"] > 0.0
        assert rec["update_ok"] == 1.0
        assert -1.0 <= rec["burgers_reduced/return_norm"] <= 1.0


def test_nonfinite_guard_keeps_params_and_all_of_adam(tmp_path):
    """A poisoned trajectory advances nothing: params, Adam's moments and
    its step count keep the values of after the previous (good) update."""
    runner = _short_runner(tmp_path)
    trajs = runner.forch.sample_all(runner._seeds(0))
    stats = runner._update(trajs, 0)
    assert float(stats["update_ok"]) == 1.0
    before = _state(runner)
    steps = [float(s["step"]) for s in runner.opt.state.values()]
    assert steps and set(steps) == {5.0}
    trajs["burgers_reduced"].rewards[0, 0] = float("nan")
    stats = runner._update(trajs, 1)
    assert float(stats["update_ok"]) == 0.0
    assert float(stats["iteration"]) == 1.0
    after = _state(runner)
    for k, v in before.items():
        if "['broker']" not in k:
            assert torch.equal(after[k], v), k
    assert [float(s["step"]) for s in runner.opt.state.values()] == steps


def test_rollout_k_plus_1_reads_params_k(tmp_path):
    """After pipelined iteration k the broker holds traj_{k+1}, rolled with
    the params of BEFORE update k (the reference's one-iteration lag),
    though update k did change them."""
    runner = _short_runner(tmp_path / "run")
    runner.train(1, resume=False)          # prologue + iteration 0
    twin = _short_runner(tmp_path / "twin")  # same seed: params_0, banks
    assert not all(torch.equal(p, q) for p, q in zip(
        runner.policy.parameters(), twin.policy.parameters()))
    want = twin.forch.sample_all(runner._seeds(1))
    for name in runner.forch.names:
        got = broker.latest_traj(runner.broker, name)
        for g, w in zip(got, want[name]):
            assert torch.equal(g, w.to(g.dtype)), name


def test_hit_24dof_exploration_blows_up_as_in_the_reference():
    """The fleet's HIT sub-fleet sits at the reward floor at the start of
    training because the guard reverts its exploratory steps: at
    hit_les_24dof, the initial multitask head's mean C_s plus the rollout's
    per-element noise (std exp(-1.6) ~ 0.2) makes one RL interval
    non-finite, in the reference as in the port, while the mean action
    alone advances, within 1e-5 of max of the reference."""
    import dataclasses

    from repro.cfd import solver as jsolver
    from repro_torch.cfd import solver as tsolver
    from repro_torch.core.orchestrator import FleetConfig, Orchestrator

    env = tenvs.make("hit_les_24dof", use_kernels=False)
    cfg = env.cfg
    jcfg = dataclasses.replace(jenvs.make("hit_les_24dof").cfg,
                               use_kernels=False)
    pol = multitask.MultiTaskPolicy(multitask.MultiTaskConfig.from_envs(
        [(n, tenvs.make(n)) for n in PRODUCTION]),
        torch.Generator().manual_seed(0))
    orch = Orchestrator(env, FleetConfig(n_envs=1, bank_size=2),
                        seed=scheduler.scenario_seed(0, 0), device="cpu")
    u0 = orch.bank[:1]
    with torch.no_grad():
        mean = pol.head("hit_les_24dof").actor_mean(env.observe(
            env.reset_from_bank(orch.bank, torch.zeros(1, dtype=torch.long)
                                )[0]))
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.standard_normal(mean.shape).astype(
        np.float32))
    std = float(np.exp(multitask.MultiTaskConfig.log_std_init))
    interval = jax.jit(lambda u, c: jsolver.advance_rl_interval(u, c, jcfg))
    for action, finite in ((mean, True), (mean + std * noise, False)):
        cs = torch.clamp(action, 0.0, cfg.cs_max).reshape(
            (1,) + (cfg.n_elem,) * 3)
        got = tsolver.advance_rl_interval(u0, cs, cfg)
        want = np.asarray(interval(jnp.asarray(u0.numpy()),
                                   jnp.asarray(cs.numpy())))
        assert bool(torch.isfinite(got).all()) is finite
        assert bool(np.isfinite(want).all()) is finite
        if finite:
            scale = float(np.abs(want).max())
            assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_nonfinite_guard_keeps_state_without_a_host_sync(tmp_path):
    """On the GPU (capturable Adam, step count on the device) a poisoned
    trajectory leaves params, both moments and the step count as they
    were, and the guarded update runs with torch's sync debug mode set to
    raise on any host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    named = [("burgers_reduced", tenvs.make("burgers_reduced"))]
    sched = scheduler.build_schedule(named, 3)
    runner = FleetRunner(sched, run_cfg=_run_cfg(tmp_path), device="cuda")
    assert runner.opt.defaults["capturable"]
    trajs = runner.forch.sample_all(runner._seeds(0))
    stats = runner._update(trajs, 0)
    assert float(stats["update_ok"]) == 1.0
    state = list(runner.opt.state.values())
    assert all(s["step"].device.type == "cuda" for s in state)
    assert {float(s["step"]) for s in state} == {5.0}
    before = {k: v.clone() for k, v in _state(runner).items()
              if "['broker']" not in k}
    trajs["burgers_reduced"].rewards[0, 0] = float("nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stats = runner._update(trajs, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(stats["update_ok"]) == 0.0
    after = _state(runner)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert {float(s["step"]) for s in state} == {5.0}


@pytest.mark.cuda
def test_cuda_fleet_trains_and_evaluates(tmp_path):
    """The reduced mixed fleet on the GPU: one pipelined iteration, then the
    evaluation episode of every scenario (`FleetOrchestrator.evaluate_all`
    through the runner's cadence), all within [-1, 1]."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runner = fleet.make_fleet_runner(
        FLEET_NAMES, total_envs=6, use_artifacts=False,
        run_cfg=_run_cfg(tmp_path, n_iterations=1, eval_every=1))
    assert runner.device.type == "cuda"
    (rec,) = runner.train(resume=False)
    assert rec["update_ok"] == 1.0
    with open(runner.metrics_path) as f:
        logged = [json.loads(line) for line in f]
    (evals,) = [r for r in logged if "hit_les_reduced/eval_return_norm" in r]
    for name in FLEET_NAMES:
        assert -1.0 <= rec[f"{name}/return_norm"] <= 1.0
        assert -1.0 <= evals[f"{name}/eval_return_norm"] <= 1.0


def test_fleet_entry_point_needs_a_gpu_unless_cpu_is_asked(tmp_path):
    """`make_fleet_runner` and `FleetRunner` given no device take the GPU;
    with no GPU they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.make_fleet_runner(("burgers_reduced",), total_envs=1,
                                run_cfg=_run_cfg(tmp_path))
    sched = scheduler.build_schedule(
        [("burgers_reduced", tenvs.make("burgers_reduced"))], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRunner(sched, run_cfg=_run_cfg(tmp_path))
