"""PyTorch port: one environment split over ranks by its first element axis
(`FleetConfig(elem_axis="model")`, `core.collectives.ElemSplit`): HIT and
the channel by their x-slabs, Burgers by its elements.

A split env has no counterpart in the reference's numbers (sharding changes
nothing in what the reference computes), so the split run is held to the
port's own run in one process, and through it to the JAX package.

Ranks are gloo processes on the CPU with a file:// store under tmp_path:
this file, run as a script, is the worker (`_worker`).  Two worlds start
together when the module's first test sets up: "m2", two ranks on a
(data 1, model 2) mesh, which runs the cases `k2_m2` (hit_les_reduced,
2^3 elements: one x-slab a rank), `k4_m2` (`n_elem=4`: two a rank),
`chan_m2` (channel_wm_reduced, Kx = 2: one x-slab a rank; RL intervals
of a quarter of the registered length, 5 substeps, for time) and `burg_m2`
(burgers_reduced, K = 4: two elements a rank); and "d2m2", four ranks on a
(data 2, model 2) mesh, which runs `k2_d2m2`.  Workers set
`torch.set_num_threads(1)` (ROADMAP C3).  Each case's ranks report their
gathered results; this process computes the one-process runs on the same
inputs while the ranks run: the same assembly over a group of one rank
(`ElemSplit()`, no exchange) and the unsplit default path.  The PPO
iteration runs one-step episodes (`t_end` = one RL interval).

Pins, relative to the largest reference value, each with the largest
reading over the cases beside it:
  * PIN_SAME 2e-6 against the same assembly in one process (RHS 2.0e-8,
    interval 2.4e-7, guard 3.1e-7, step-0 rows 3.7e-7): only the order of
    the box sums differs (HIT's forcing and Burgers': the slabs' sums are
    added over the ranks), and a slab's matmuls run at another batch
    width; the channel's split has no sum (its body force is local) and
    reads 0 everywhere;
  * PIN_BURGERS_REWARDS 1e-5 for Burgers' step-0 rewards against one
    process's (1.4e-6): the spectral error amplifies the forcing sums'
    order (the state after the interval reads 6.3e-8);
  * PIN_UNSPLIT 2e-5 against the unsplit path and the JAX package, the
    pin of tests/test_torch_rhs.py and tests/test_torch_env.py (JAX: HIT
    RHS 4.7e-7, interval 2.9e-7; channel RHS 5.6e-7; Burgers interval
    1.3e-7);
  * PIN_STATE 1e-4 for params and Adam state after one update against one
    process's (5.5e-5, k2_d2m2), as tests/test_torch_distributed.py pins
    them;
  * PIN_BF16 for bf16 on a split mesh (`test_split_bf16_interval`);
  * the distributed roll is `torch.roll` bit for bit (it only moves
    values); params and Adam state are bitwise equal on every rank.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import envs as jenvs
from repro.cfd import burgers1d as jburgers
from repro.cfd import channel as jchannel
from repro.cfd import solver as jsolver
from repro.cfd.solver import HITConfig as JaxHITConfig
from repro_torch import envs as tenvs
from repro_torch.cfd import burgers1d as tburgers
from repro_torch.cfd import channel as tchannel
from repro_torch.cfd import solver as tsolver
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import collectives
from repro_torch.core.orchestrator import FleetConfig
from repro_torch.core.runner import Runner, RunnerConfig
from repro_torch.envs.base import EnvState
from repro_torch.envs.burgers import BurgersEnv
from repro_torch.envs.channel import ChannelEnv
from repro_torch.launch import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_SAME = 2e-6
PIN_UNSPLIT = 2e-5
PIN_STATE = 1e-4
PIN_BURGERS_REWARDS = 1e-5
# bf16 on a split mesh, relative to max |u| and in relative L2: against the
# same assembly in one process and the port's unsplit staged bf16 path;
# HIT also against the JAX package's staged bf16 path.  Every op rounds to
# bf16, and the split path's kernels (their plain versions here) compute
# in float32 where the staged path rounds each op, so the paths differ by
# a few bf16 steps (2^-8 = 3.9e-3 of a value).  Largest readings (max /
# L2): HIT k4_m2 1.9e-2 / 6.4e-3 (the forcing's bf16 sums over ranks:
# 1.9e-2 / 5.8e-3 from one process); the channel 5.9e-3 / 4.2e-4 (from one
# process: 0, the split adds no sum).  The channel's unsplit bf16 interval
# is held to the JAX package's by
# tests/test_torch_channel.py::test_advance_rl_interval[bf16].  Each
# control, the split state one env off against the unsplit staged path,
# must exceed both pins: HIT 5.3e-1 / 2.5e-1, the channel 6.5e-2 / 1.2e-2
# (its bank rows differ only in a bulk factor and small modes).
PIN_BF16 = {"k4_m2": {"max": 4e-2, "l2": 1e-2},
            "chan_m2": {"max": 2e-2, "l2": 4e-3}}
# case -> (world, registered name, overrides); the worlds' meshes are
# (data, model)
CASES = {"k2_m2": ("m2", "hit_les_reduced", {"n_elem": 2}),
         "k4_m2": ("m2", "hit_les_reduced", {"n_elem": 4}),
         "chan_m2": ("m2", "channel_wm_reduced", {"dt_rl": 0.025}),
         "burg_m2": ("m2", "burgers_reduced", {}),
         "k2_d2m2": ("d2m2", "hit_les_reduced", {"n_elem": 2})}
BF16_CASES = tuple(PIN_BF16)
WORLDS = {"m2": (1, 2), "d2m2": (2, 2)}
N_ENVS = 3       # the rollout's envs: padded to 4 over a data axis of 2
BANK_ROWS = 2    # the rows of the RHS, interval and guard checks


def _env(case: str, **kw):
    _, name, overrides = CASES[case]
    return tenvs.make(name, **overrides, **kw)


def _key(case: str) -> tuple:
    """Cases that share an env share their one-process training run."""
    _, name, overrides = CASES[case]
    return name, tuple(sorted(overrides.items()))


def _inputs(case: str) -> dict[str, torch.Tensor]:
    """The same inputs in every process: bank rows from a CPU generator,
    an action of the whole env and a tensor to roll from numpy."""
    env = _env(case)
    spec = env.action_spec
    rng = np.random.default_rng(5)
    u = env.initial_state_bank(torch.Generator().manual_seed(3), BANK_ROWS)
    return {
        "u": u,
        "action": torch.from_numpy(rng.uniform(
            spec.low, spec.high, (BANK_ROWS, spec.n_elements)
        ).astype(np.float32)),
        "x": torch.from_numpy(rng.standard_normal(
            (BANK_ROWS, u.shape[1], 3, 5)).astype(np.float32)),
    }


def _rhs(env, u: torch.Tensor, action: torch.Tensor, split=None):
    """One RHS of u (this rank's slabs with `split`) under the whole env's
    action, by the env's assembly."""
    cfg = env.cfg
    ops = cfg.operators()
    if isinstance(env, ChannelEnv):
        n = cfg.n
        scales = env._split_action(action)
        if split is not None:
            scales = [split.slab(a, 1) for a in scales]
        sb, st = (a[..., None, None].expand(a.shape + (n, n))
                  for a in scales)
        return tchannel.channel_rhs(u, sb, st, cfg, ops, split)
    if isinstance(env, BurgersEnv):
        c = torch.clamp(action, 0.0, cfg.c_max)
        if split is not None:
            c = split.slab(c, 1)
        c_nodes = c[..., None].expand(c.shape + (cfg.n,))
        return tburgers.burgers_rhs(u[..., 0], c_nodes, cfg, ops, split)
    cs = action.reshape((-1,) + (cfg.n_elem,) * 3)
    if split is not None:
        cs = split.slab(cs, 1)
    return tsolver.navier_stokes_rhs(
        u, tsolver.broadcast_cs(cs, cfg).contiguous(), cfg, ops, split)


def _advance(env, u: torch.Tensor, action: torch.Tensor, split=None):
    """One RL interval of u under the whole env's action."""
    if isinstance(env, (ChannelEnv, BurgersEnv)):
        return env.advance(u, action, split)
    cfg = env.cfg
    cs = action.reshape((-1,) + (cfg.n_elem,) * 3)
    if split is not None:
        cs = split.slab(cs, 1)
    return tsolver.advance_rl_interval(u, cs, cfg, split)


def _solver(env):
    """The solver module whose `advance_rl_interval` the env's step calls
    (looked up at call time)."""
    if isinstance(env, ChannelEnv):
        return tchannel
    return tburgers if isinstance(env, BurgersEnv) else tsolver


def _poisoned(advance):
    """`advance_rl_interval` with row 0 of the last rank's result made
    non-finite: the guard must revert row 0 on every rank."""
    def wrapped(*args):
        split = args[-1]
        out = advance(*args)
        if split is None or split.rank == split.size - 1:
            out[0, -1] = float("nan")
        return out
    return wrapped


def _checks(case: str, inp: dict, split) -> dict:
    """One RHS (HIT and the channel: both assemblies), one RL interval
    (and one in bf16 for `BF16_CASES`) and one guarded env step of the
    inputs, through `split` (this rank's slabs), gathered whole; for the
    channel also its wall observation and mean profile of its own slab."""
    out = {}
    env = _env(case)
    u = split.slab(inp["u"], 1)
    assemblies = (True,) if isinstance(env, BurgersEnv) else (True, False)
    for kernels in assemblies:
        e = _env(case, use_kernels=kernels) if len(assemblies) > 1 else env
        out[f"rhs_{kernels}"] = split.gather(
            _rhs(e, u, inp["action"], split), 1)
    out["interval"] = split.gather(_advance(env, u, inp["action"], split), 1)
    if case in BF16_CASES:
        out["interval_bf16"] = split.gather(
            _advance(_env(case, precision="bf16"), u, inp["action"], split),
            1)
    solver = _solver(env)
    advance = solver.advance_rl_interval
    solver.advance_rl_interval = _poisoned(advance)
    try:
        res = env.split_x(split).step(EnvState(u=u, t_step=torch.zeros(
            (BANK_ROWS,), dtype=torch.int32)), inp["action"])
    finally:
        solver.advance_rl_interval = advance
    out["guard"] = (split.gather(res.state.u, 1), res.reward, res.obs)
    if isinstance(env, ChannelEnv):
        # what a rank would compute from its own slab alone: its wall
        # observation (elements in the slab's order) and its x-z mean
        # profile (divided by its own Kx), gathered along the flat axis
        kx, ky, kz = env.cfg.n_elem
        local = dataclasses.replace(env.cfg, n_elem=(kx // split.size, ky,
                                                     kz))
        obs = tchannel.wall_velocity_observation(u, local)
        out["flat_obs"] = split.gather(obs, 1)
        out["profiles"] = split.gather(tchannel.mean_velocity_profile(
            u, local, local.operators())[:, None], 1)
    return out


def _jax_hit() -> dict[str, np.ndarray]:
    """The JAX package's staged RHS, RL interval and bf16 RL interval of
    the HIT 4^3 inputs."""
    out = {}
    cfg, inp = _env("k4_m2").cfg, _inputs("k4_m2")
    jcfg = JaxHITConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JaxHITConfig)
                           if f.name != "use_kernels"}, use_kernels=False)
    u = jnp.asarray(inp["u"].numpy())
    cs_elem = inp["action"].reshape((-1,) + (cfg.n_elem,) * 3)
    cs, cs_nodes = (jnp.asarray(x.numpy()) for x in (
        cs_elem, tsolver.broadcast_cs(cs_elem, cfg)))
    rhs = jax.jit(lambda u, c: jsolver.navier_stokes_rhs(
        u, c, jcfg, jcfg.operators()))
    out["hit_rhs"] = np.array(rhs(u, cs_nodes))
    out["hit_interval"] = np.array(jsolver.advance_rl_interval(u, cs, jcfg))
    out["k4_m2_bf16"] = np.array(jsolver.advance_rl_interval(
        u, cs, dataclasses.replace(jcfg, precision="bf16")))
    return out


def _jax_channel_burgers() -> dict[str, np.ndarray]:
    """The JAX package's staged RHS of the channel's inputs and its RL
    interval of Burgers'."""
    out = {}
    env, inp = _env("chan_m2"), _inputs("chan_m2")
    _, name, overrides = CASES["chan_m2"]
    jcfg = dataclasses.replace(jenvs.make(name).cfg, **overrides,
                               use_kernels=False)
    u = jnp.asarray(inp["u"].numpy())
    sb, st = (x.numpy() for x in env._split_action(inp["action"]))
    n = jcfg.n
    nodes = [jnp.asarray(np.broadcast_to(a[..., None, None], a.shape
                                         + (n, n))) for a in (sb, st)]
    rhs = jax.jit(lambda u, sb, st: jchannel.channel_rhs(
        u, sb, st, jcfg, jcfg.operators()))
    out["chan_rhs"] = np.array(rhs(u, *nodes))

    env, inp = _env("burg_m2"), _inputs("burg_m2")
    c = np.clip(inp["action"].numpy(), 0.0, env.cfg.c_max)
    out["burg_interval"] = np.array(jburgers.advance_rl_interval(
        jnp.asarray(inp["u"].numpy()), jnp.asarray(c),
        jenvs.make("burgers_reduced").cfg))
    return out


def _train(case: str, mesh, ckpt: str) -> dict:
    """One PPO iteration with an evaluation, of one-step episodes, split
    over the mesh's "model" axis: the gathered trajectory's step-0 rows,
    params, Adam state and the record."""
    env = _env(case, t_end=_env(case).cfg.dt_rl)
    runner = Runner(env, FleetConfig(n_envs=N_ENVS, bank_size=4,
                                     elem_axis="model"),
                    run_cfg=RunnerConfig(eval_every=1, checkpoint_dir=ckpt,
                                         async_checkpoint=False),
                    mesh=mesh, device="cpu")
    trajs = []
    sample = runner.orch.sample_fleet

    def kept(policy, gen):
        trajs.append(sample(policy, gen))
        return trajs[-1]

    runner.orch.sample_fleet = kept
    (record,) = runner.train(1, resume=False)
    split = runner.orch.split
    return {"rows": tuple(x[0] for x in (trajs[0].obs, trajs[0].actions,
                                         trajs[0].rewards)),
            "state": dict(tckpt._flatten(runner._state_tree())),
            "record": record, "b_pad": runner.orch.b_pad,
            "exchanged": (split.halo_bytes, split.gather_bytes)}


# --- the worker (this file run as a script) ----------------------------------
def _worker(world: str, tmp: str, rank: int) -> None:
    torch.set_num_threads(1)
    data, model = WORLDS[world]
    os.environ.update(WORLD_SIZE=str(data * model), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh_lib.init_distributed(init_method=f"file://{tmp}/{world}_store",
                              device="cpu")
    mesh = mesh_lib.make_fleet_mesh(model=model, device="cpu")
    group, m = collectives.axes_group(mesh, ("model",))
    split = collectives.ElemSplit(group, m, model)
    out = {}
    for case, (w, _, _) in CASES.items():
        if w != world:
            continue
        inp = _inputs(case)
        x = split.slab(inp["x"], 1)
        res = {"roll": {s: split.gather(split.roll(x, s, 1), 1)
                        for s in (-1, 1)}}
        res.update(_checks(case, inp, split))
        res["train"] = _train(case, mesh, f"{tmp}/{case}_ckpt")
        res["model_rank"] = m
        out[case] = res
    dist.destroy_process_group()
    torch.save(out, f"{tmp}/{world}_{rank}.pt")


def _start(world: str, tmp: str) -> list[subprocess.Popen]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    procs = []
    for r in range(math.prod(WORLDS[world])):
        with open(f"{tmp}/{world}_{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), world, tmp,
                 str(r)], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


class _Runs:
    """Both worlds, started at setup and awaited at first read:
    runs[case] is the list of that case's ranks' results.  Meanwhile this
    process computes each case's one-process runs: `alone[case]` the
    checks over a group of one rank, `trained[_key(case)]` the PPO
    iteration; and, in two threads beside them (XLA compiles without the
    interpreter lock), the JAX package's references, `jax`."""

    def __init__(self, tmp: str):
        self.tmp, self.out = tmp, None
        self.procs = {w: _start(w, tmp) for w in WORLDS}
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            refs = [pool.submit(f) for f in (_jax_hit, _jax_channel_burgers)]
            self._one_process(tmp)
            self.jax = {k: v for f in refs for k, v in f.result().items()}

    def _one_process(self, tmp: str) -> None:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as the ranks run, and beside them
        try:
            self.alone = {case: _checks(case, _inputs(case),
                                        collectives.ElemSplit())
                          for case in CASES}
            self.trained = {}
            for case in CASES:
                if _key(case) not in self.trained:
                    self.trained[_key(case)] = _train(
                        case, None, f"{tmp}/alone_{case}")
        finally:
            torch.set_num_threads(threads)

    def __getitem__(self, case: str) -> list[dict]:
        if self.out is None:
            self.out = {}
            try:
                for procs in self.procs.values():
                    for p in procs:
                        p.wait(timeout=240)
            finally:
                self.kill()
            for world, procs in self.procs.items():
                for r, p in enumerate(procs):
                    with open(f"{self.tmp}/{world}_{r}.log") as log:
                        assert p.returncode == 0, log.read()[-4000:]
                    for c, res in torch.load(f"{self.tmp}/{world}_{r}.pt",
                                             weights_only=False).items():
                        self.out.setdefault(c, []).append(res)
        return self.out[case]

    def kill(self) -> None:
        for procs in self.procs.values():
            for p in procs:
                p.kill()


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("split")))
    yield r
    r.kill()


def _rel(got: torch.Tensor, want) -> float:
    want = want.detach() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(want)
    return float((got.detach() - want).abs().max() / want.abs().max())


def _rel_l2(got: torch.Tensor, want) -> float:
    want = want.detach() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(want)
    return float(torch.linalg.vector_norm(got.detach() - want)
                 / torch.linalg.vector_norm(want))


# --- in this process ----------------------------------------------------------
def test_a_group_of_one_rank_is_torch_roll_and_the_unsplit_assembly():
    """`ElemSplit()` rolls by `torch.roll` and its staged assembly is the
    unsplit staged one bit for bit (`use_kernels=False`)."""
    inp = _inputs("k2_m2")
    one = collectives.ElemSplit()
    for s in (-1, 1, 2):
        assert torch.equal(one.roll(inp["x"], s, 1),
                           torch.roll(inp["x"], s, 1))
    assert torch.equal(collectives.roll(inp["x"], 1, 1, None),
                       torch.roll(inp["x"], 1, 1))
    staged = _env("k2_m2", use_kernels=False)
    assert torch.equal(_rhs(staged, inp["u"], inp["action"], one),
                       _rhs(staged, inp["u"], inp["action"]))
    assert one.halo_bytes == one.gather_bytes == 0


@pytest.mark.parametrize("name", [
    "channel_wm_reduced", "channel_wm_p_reduced", "channel_wm_t_reduced",
    "channel_wm_hre_reduced", "burgers_reduced"])
def test_split_env_over_one_rank_steps_as_the_env(name):
    """Every channel variant and Burgers split over a group of one rank
    (`split_x(ElemSplit())`: the split code, no exchange) resets and steps
    bit for bit as the env itself, whole specs, and `observe` hands back
    the step's observation.  One RL interval of a quarter of the
    registered length (fewer substeps; the same code)."""
    dt_rl = tenvs.make(name).cfg.dt_rl / 4
    env = tenvs.make(name, dt_rl=dt_rl, t_end=dt_rl)
    split_env = env.split_x(collectives.ElemSplit())
    assert split_env.obs_spec == env.obs_spec
    assert split_env.action_spec == env.action_spec
    bank = env.initial_state_bank(torch.Generator().manual_seed(0), 3)
    action = torch.rand((3,) + env.action_spec.shape,
                        generator=torch.Generator().manual_seed(1)
                        ) * env.action_spec.high
    want_state, want_obs = env.reset_from_bank(bank, torch.arange(3))
    got_state, got_obs = split_env.reset_from_bank(bank, torch.arange(3))
    assert torch.equal(got_obs, want_obs)
    want, got = env.step(want_state, action), split_env.step(got_state,
                                                             action)
    for field in ("obs", "reward", "done"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert torch.equal(got.state.u, want.state.u)
    assert split_env.observe(got.state) is got.obs


def test_split_refuses_what_it_cannot_split():
    """Ranks that do not divide the split axis: ValueError (HIT 2^3 and
    `channel_wm`'s Kx = 3 over 3 and 2 ranks, `burgers_96dof`'s 12
    elements over 5); an env axis that is also the element axis:
    ValueError."""
    for name, size in (("hit_les_reduced", 3), ("channel_wm", 2),
                       ("burgers_96dof", 5)):
        with pytest.raises(ValueError, match="do not divide"):
            tenvs.make(name).split_x(collectives.ElemSplit(object(), 0,
                                                           size))
    with pytest.raises(ValueError, match="also an env axis"):
        Runner(_env("k2_m2"), FleetConfig(n_envs=2, elem_axis="data"),
               device="cpu")


# --- the ranks against one process --------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_roll_equals_torch_roll(runs, case):
    x = _inputs(case)["x"]
    for r in runs[case]:
        for s, got in r["roll"].items():
            assert torch.equal(got, torch.roll(x, s, 1)), (r["model_rank"], s)


@pytest.mark.parametrize("case", list(CASES))
def test_rhs_equals_one_process(runs, case):
    """One RHS of each assembly (the component kernels' plain versions;
    HIT and the channel also the staged plain one) against the same
    assembly over one rank, and against the unsplit default path (HIT's
    fused one)."""
    env, inp = _env(case), _inputs(case)
    unsplit = _rhs(env, inp["u"], inp["action"])
    keys = [k for k in runs.alone[case] if k.startswith("rhs_")]
    for r in runs[case]:
        for key in keys:
            got = r[key].reshape(unsplit.shape)
            assert _rel(got, runs.alone[case][key].reshape(
                unsplit.shape)) <= PIN_SAME, key
            assert _rel(got, unsplit) <= PIN_UNSPLIT, key


@pytest.mark.parametrize("case", list(CASES))
def test_rl_interval_equals_one_process(runs, case):
    env, inp = _env(case), _inputs(case)
    unsplit = _advance(env, inp["u"], inp["action"])
    for r in runs[case]:
        assert _rel(r["interval"], runs.alone[case]["interval"]) <= PIN_SAME
        assert _rel(r["interval"], unsplit) <= PIN_UNSPLIT
        # control: the state one env off must exceed the pin
        assert _rel(r["interval"].roll(1, 0), runs.alone[case]["interval"]) \
            > PIN_SAME


@pytest.mark.parametrize("case", list(CASES))
def test_guard_reverts_a_row_non_finite_on_one_rank_only(runs, case):
    """Row 0 goes non-finite on the last rank alone: every rank reverts it
    (the whole row equals its initial state, reward -1), row 1 advances
    as in one process."""
    env, inp = _env(case), _inputs(case)
    want_u, want_r, want_obs = runs.alone[case]["guard"]
    whole0 = env.observe(EnvState(inp["u"], None))
    for r in runs[case]:
        u, reward, obs = r["guard"]
        assert torch.equal(u[0], inp["u"][0]) and reward[0].item() == -1.0
        assert torch.equal(obs[0], whole0[0])
        assert torch.isfinite(u[1]).all()
        assert _rel(u[1], want_u[1]) <= PIN_SAME
        assert abs(reward[1].item() - want_r[1].item()) <= PIN_SAME
        assert _rel(obs, want_obs) <= PIN_SAME


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_step0_rows_equal_one_process(runs, case):
    """The gathered trajectory's step-0 observations, actions and rewards
    (every rank holds all rows) against one process's."""
    want = runs.trained[_key(case)]["rows"]
    burgers = isinstance(_env(case), BurgersEnv)
    for r in runs[case]:
        for field, got, w in zip(("obs", "actions", "rewards"),
                                 r["train"]["rows"], want):
            pin = PIN_BURGERS_REWARDS if burgers and field == "rewards" \
                else PIN_SAME
            assert got.shape == w.shape
            assert _rel(got, w) <= pin, field


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_adam_state_bitwise_across_ranks(runs, case):
    """After one update every rank holds the same params and Adam state
    bit for bit, within PIN_STATE of one process's; the evaluation
    return is finite and equal on every rank, and the ranks exchanged
    halo faces and gathered the field."""
    ranks = runs[case]
    want = runs.trained[_key(case)]
    first = ranks[0]["train"]
    for r in ranks:
        assert r["train"]["state"].keys() == first["state"].keys()
        for key, x in r["train"]["state"].items():
            assert torch.equal(x, first["state"][key]), key
            assert _rel(x, want["state"][key]) <= PIN_STATE, key
        assert r["train"]["record"]["eval_return_norm"] == \
            first["record"]["eval_return_norm"]
        assert math.isfinite(r["train"]["record"]["eval_return_norm"])
        assert r["train"]["exchanged"][0] > 0 and \
            r["train"]["exchanged"][1] > 0


def test_channel_observation_orders_the_walls_elements_as_unsplit(runs):
    """The split channel's observation (one gather of the state, then the
    unsplit `observe`) is the whole channel's: bottom wall first, then
    top, each x-major.  The ranks' own wall observations gathered along
    the flat element axis interleave the walls (bottom of rank 0, top of
    rank 0, bottom of rank 1, ...): the same values in another order,
    which the check must refuse."""
    env, inp = _env("chan_m2"), _inputs("chan_m2")
    whole = tchannel.wall_velocity_observation(inp["u"], env.cfg)
    for r in runs["chan_m2"]:
        # the guard's row 0 was reverted to its initial state
        assert torch.equal(r["guard"][2][0], whole[0] / env.cfg.u_bulk)
        flat = r["flat_obs"]
        assert flat.shape == whole.shape
        assert torch.equal(flat.flatten().sort().values,
                           whole.flatten().sort().values)
        assert _rel(flat, whole) > PIN_SAME


def test_channel_reward_profile_is_the_whole_channels_x_z_mean(runs):
    """The reward's mean velocity profile is the x-z mean of the whole
    channel: the mean of the ranks' slab profiles (equal slabs), and none
    of them alone.  A rank that divided its own slab's sum by the whole
    Kx, or took its slab's mean as the channel's, would be off by the
    other slabs' part."""
    env, inp = _env("chan_m2"), _inputs("chan_m2")
    cfg = env.cfg
    whole = tchannel.mean_velocity_profile(inp["u"], cfg, cfg.operators())
    for r in runs["chan_m2"]:
        profiles = r["profiles"]
        assert _rel(profiles.mean(1), whole) <= PIN_SAME
        for part in profiles.unbind(1):
            assert _rel(part, whole) > PIN_SAME
        # the split step's reward (row 1 advanced) is one process's
        assert abs(r["guard"][1][1].item()
                   - runs.alone["chan_m2"]["guard"][1][1].item()) <= PIN_SAME


@pytest.mark.parametrize("case", BF16_CASES)
def test_split_bf16_interval(runs, case):
    """One bf16 RL interval on a split mesh (HIT k4_m2 on B2 and B3, the
    staged divergence and forcing; the channel on its kernels' plain
    versions) against the same assembly over one rank, the port's unsplit
    staged bf16 path (`use_kernels=False`) and, for HIT, the JAX package's
    staged bf16 path: within the case's PIN_BF16, max and relative L2; the
    split state one env off exceeds both."""
    env, inp = _env(case), _inputs(case)
    staged = _advance(_env(case, precision="bf16", use_kernels=False),
                      inp["u"], inp["action"])
    wants = {"one process": runs.alone[case]["interval_bf16"],
             "unsplit staged": staged}
    if case == "k4_m2":
        wants["jax staged"] = runs.jax["k4_m2_bf16"]
    pin = PIN_BF16[case]
    for r in runs[case]:
        got = r["interval_bf16"]
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        for label, want in wants.items():
            assert _rel(got, want) <= pin["max"], label
            assert _rel_l2(got, want) <= pin["l2"], label
        assert _rel(got.roll(1, 0), staged) > pin["max"]
        assert _rel_l2(got.roll(1, 0), staged) > pin["l2"]


# --- against the JAX package ---------------------------------------------------
def test_split_rhs_matches_jax(runs):
    """One split RHS (k4_m2: two x-slabs a rank) of both assemblies
    against the JAX package's staged `navier_stokes_rhs`."""
    for r in runs["k4_m2"]:
        assert _rel(r["rhs_True"], runs.jax["hit_rhs"]) <= PIN_UNSPLIT
        assert _rel(r["rhs_False"], runs.jax["hit_rhs"]) <= PIN_UNSPLIT


def test_split_rl_interval_matches_jax(runs):
    """One split RL interval (k4_m2) against the JAX package's
    `advance_rl_interval` with `use_kernels=False`."""
    for r in runs["k4_m2"]:
        assert _rel(r["interval"], runs.jax["hit_interval"]) <= PIN_UNSPLIT


def test_split_channel_rhs_matches_jax(runs):
    """One split channel RHS (chan_m2: one x-slab a rank, walls in y) of
    both assemblies against the JAX package's staged `channel_rhs`."""
    for r in runs["chan_m2"]:
        assert _rel(r["rhs_True"], runs.jax["chan_rhs"]) <= PIN_UNSPLIT
        assert _rel(r["rhs_False"], runs.jax["chan_rhs"]) <= PIN_UNSPLIT


def test_split_burgers_rl_interval_matches_jax(runs):
    """One split Burgers RL interval (burg_m2: two elements a rank) against
    the JAX package's `advance_rl_interval`."""
    for r in runs["burg_m2"]:
        assert _rel(r["interval"], runs.jax["burg_interval"]) <= PIN_UNSPLIT


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
