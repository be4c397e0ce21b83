"""PyTorch port: one HIT environment split over ranks by its x-slabs
(`FleetConfig(elem_axis="model")`, `core.collectives.ElemSplit`).

Split HIT has no counterpart in the reference's numbers (sharding changes
nothing in what the reference computes), so the split run is held to the
port's own run in one process, and through it to the JAX package.

Ranks are gloo processes on the CPU with a file:// store under tmp_path:
this file, run as a script, is the worker (`_worker`).  Two worlds start
together when the module's first test sets up: "m2", two ranks on a
(data 1, model 2) mesh, which runs the cases `k2_m2` (hit_les_reduced,
2^3 elements: one x-slab a rank) and `k4_m2` (`n_elem=4`: two a rank);
and "d2m2", four ranks on a (data 2, model 2) mesh, which runs `k2_d2m2`.
Workers set `torch.set_num_threads(1)` (ROADMAP C3).  Each case's ranks
report their gathered results; this process computes the one-process runs
on the same inputs while the ranks run: the same assembly over a group of
one rank (`ElemSplit()`, no exchange) and the unsplit default path.  The
PPO iteration runs one-step episodes (`t_end` = one RL interval).

Pins, relative to the largest reference value, each with the largest
reading over the cases beside it:
  * PIN_SAME 2e-6 against the same assembly in one process (RHS 2.0e-8,
    interval 2.4e-7, guard 2.4e-7, step-0 rows 2.4e-7): only the order of
    the forcing's box sums differs (the slabs' sums are added over the
    ranks), and a slab's matmuls run at another batch width;
  * PIN_UNSPLIT 2e-5 against the unsplit path and the JAX package, the
    pin of tests/test_torch_rhs.py and tests/test_torch_env.py;
  * PIN_STATE 1e-4 for params and Adam state after one update against one
    process's (8.8e-6), as tests/test_torch_distributed.py pins them;
  * the distributed roll is `torch.roll` bit for bit (it only moves
    values); params and Adam state are bitwise equal on every rank.
"""
from __future__ import annotations

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

from repro.cfd import solver as jsolver
from repro.cfd.solver import HITConfig as JaxHITConfig
from repro_torch import envs as tenvs
from repro_torch.cfd import solver as tsolver
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import collectives
from repro_torch.core.orchestrator import FleetConfig
from repro_torch.core.runner import Runner, RunnerConfig
from repro_torch.envs.base import EnvState
from repro_torch.launch import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_SAME = 2e-6
PIN_UNSPLIT = 2e-5
PIN_STATE = 1e-4
# case -> (world, n_elem); the worlds' meshes are (data, model)
CASES = {"k2_m2": ("m2", 2), "k4_m2": ("m2", 4), "k2_d2m2": ("d2m2", 2)}
WORLDS = {"m2": (1, 2), "d2m2": (2, 2)}
N_ENVS = 3       # the rollout's envs: padded to 4 over a data axis of 2
BANK_ROWS = 2    # the rows of the RHS, interval and guard checks


def _env(n_elem: int, **kw):
    return tenvs.make("hit_les_reduced", n_elem=n_elem, **kw)


def _inputs(n_elem: int) -> dict[str, torch.Tensor]:
    """The same inputs in every process: bank rows from a CPU generator,
    per-element C_s and a tensor to roll from numpy."""
    env = _env(n_elem)
    rng = np.random.default_rng(5)
    k = n_elem
    return {
        "u": env.initial_state_bank(torch.Generator().manual_seed(3),
                                    BANK_ROWS),
        "cs": torch.from_numpy(rng.uniform(
            0.0, 0.5, (BANK_ROWS, k, k, k)).astype(np.float32)),
        "x": torch.from_numpy(rng.standard_normal(
            (BANK_ROWS, k, 3, 5)).astype(np.float32)),
    }


def _poisoned(advance):
    """`advance_rl_interval` with row 0 of the last rank's result made
    non-finite: the guard must revert row 0 on every rank."""
    def wrapped(u, cs_elem, cfg, split=None):
        out = advance(u, cs_elem, cfg, split)
        if split is None or split.rank == split.size - 1:
            out[0, -1] = float("nan")
        return out
    return wrapped


def _checks(cfg, inp: dict, split) -> dict:
    """One RHS (both assemblies), one RL interval and one guarded env step
    of the inputs, through `split` (this rank's x-slabs), gathered whole."""
    out = {}
    u, cs = split.slab(inp["u"], 1), split.slab(inp["cs"], 1)
    cs_nodes = tsolver.broadcast_cs(cs, cfg).contiguous()
    ops = cfg.operators()
    for kernels in (True, False):
        c = dataclasses.replace(cfg, use_kernels=kernels)
        out[f"rhs_{kernels}"] = split.gather(
            tsolver.navier_stokes_rhs(u, cs_nodes, c, ops, split), 1)
    out["interval"] = split.gather(
        tsolver.advance_rl_interval(u, cs, cfg, split), 1)
    env = tenvs.hit_les.HITLESEnv(cfg).split_x(split)
    advance = tsolver.advance_rl_interval
    tsolver.advance_rl_interval = _poisoned(advance)
    try:
        res = env.step(EnvState(u=u, t_step=torch.zeros(
            (BANK_ROWS,), dtype=torch.int32)), inp["cs"].flatten(1))
    finally:
        tsolver.advance_rl_interval = advance
    out["guard"] = (split.gather(res.state.u, 1), res.reward, res.obs)
    return out


def _jax_references() -> dict[str, np.ndarray]:
    """The JAX package's staged RHS and RL interval of the 4^3 inputs."""
    cfg, inp = _env(4).cfg, _inputs(4)
    jcfg = JaxHITConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JaxHITConfig)
                           if f.name != "use_kernels"}, use_kernels=False)
    u, cs = jnp.asarray(inp["u"].numpy()), jnp.asarray(inp["cs"].numpy())
    cs_nodes = jnp.asarray(tsolver.broadcast_cs(inp["cs"], cfg).numpy())
    rhs = jax.jit(lambda u, c: jsolver.navier_stokes_rhs(
        u, c, jcfg, jcfg.operators()))
    return {"rhs": np.array(rhs(u, cs_nodes)),
            "interval": np.array(jsolver.advance_rl_interval(u, cs, jcfg))}


def _train(n_elem: int, mesh, ckpt: str) -> dict:
    """One PPO iteration with an evaluation, of one-step episodes, split
    over the mesh's "model" axis: the gathered trajectory's step-0 rows,
    params, Adam state and the record."""
    env = _env(n_elem, t_end=_env(n_elem).cfg.dt_rl)
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
    for case, (w, n_elem) in CASES.items():
        if w != world:
            continue
        inp = _inputs(n_elem)
        x = split.slab(inp["x"], 1)
        res = {"roll": {s: split.gather(split.roll(x, s, 1), 1)
                        for s in (-1, 1)}}
        res.update(_checks(_env(n_elem).cfg, inp, split))
        res["train"] = _train(n_elem, mesh, f"{tmp}/{case}_ckpt")
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
    checks over a group of one rank, `trained[n_elem]` the PPO
    iteration; and the JAX package's RHS and RL interval of the 4^3
    inputs, `jax`."""

    def __init__(self, tmp: str):
        self.tmp, self.out = tmp, None
        self.procs = {w: _start(w, tmp) for w in WORLDS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as the ranks run, and beside them
        try:
            self.alone = {case: _checks(_env(n).cfg, _inputs(n),
                                        collectives.ElemSplit())
                          for case, (_, n) in CASES.items()}
            self.trained = {n: _train(n, None, f"{tmp}/alone_k{n}")
                            for n in sorted({n for _, n in CASES.values()})}
        finally:
            torch.set_num_threads(threads)
        self.jax = _jax_references()

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


# --- in this process ----------------------------------------------------------
def test_a_group_of_one_rank_is_torch_roll_and_the_unsplit_assembly():
    """`ElemSplit()` rolls by `torch.roll` and its staged assembly is the
    unsplit staged one bit for bit (`use_kernels=False`)."""
    inp = _inputs(2)
    one = collectives.ElemSplit()
    for s in (-1, 1, 2):
        assert torch.equal(one.roll(inp["x"], s, 1),
                           torch.roll(inp["x"], s, 1))
    assert torch.equal(collectives.roll(inp["x"], 1, 1, None),
                       torch.roll(inp["x"], 1, 1))
    cfg = _env(2).cfg
    staged = dataclasses.replace(cfg, use_kernels=False)
    cs = tsolver.broadcast_cs(inp["cs"], cfg).contiguous()
    ops = cfg.operators()
    assert torch.equal(
        tsolver.navier_stokes_rhs(inp["u"], cs, staged, ops, one),
        tsolver.navier_stokes_rhs(inp["u"], cs, staged, ops))
    assert one.halo_bytes == one.gather_bytes == 0


def test_split_refuses_what_it_cannot_split():
    """Ranks that do not divide Kx: ValueError; bf16 on a split mesh:
    NotImplementedError naming its ROADMAP item; an env axis that is also
    the element axis: ValueError."""
    three = collectives.ElemSplit(object(), 0, 3)
    with pytest.raises(ValueError, match="do not divide"):
        _env(2).split_x(three)
    inp = _inputs(2)
    bf16 = dataclasses.replace(_env(2).cfg, precision="bf16")
    with pytest.raises(NotImplementedError, match="A11d"):
        tsolver.advance_rl_interval(inp["u"], inp["cs"], bf16,
                                    collectives.ElemSplit())
    with pytest.raises(ValueError, match="also an env axis"):
        Runner(_env(2), FleetConfig(n_envs=2, elem_axis="data"),
               device="cpu")


# --- the ranks against one process --------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_roll_equals_torch_roll(runs, case):
    x = _inputs(CASES[case][1])["x"]
    for r in runs[case]:
        for s, got in r["roll"].items():
            assert torch.equal(got, torch.roll(x, s, 1)), (r["model_rank"], s)


@pytest.mark.parametrize("case", list(CASES))
def test_rhs_equals_one_process(runs, case):
    """One RHS of both assemblies (the component kernels' plain versions;
    the staged plain one) against the same assembly over one rank, and
    against the unsplit default (fused) path."""
    n = CASES[case][1]
    cfg, inp = _env(n).cfg, _inputs(n)
    cs = tsolver.broadcast_cs(inp["cs"], cfg).contiguous()
    unsplit = tsolver.navier_stokes_rhs(inp["u"], cs, cfg, cfg.operators())
    for r in runs[case]:
        for key in ("rhs_True", "rhs_False"):
            assert _rel(r[key], runs.alone[case][key]) <= PIN_SAME, key
            assert _rel(r[key], unsplit) <= PIN_UNSPLIT, key


@pytest.mark.parametrize("case", list(CASES))
def test_rl_interval_equals_one_process(runs, case):
    n = CASES[case][1]
    cfg, inp = _env(n).cfg, _inputs(n)
    unsplit = tsolver.advance_rl_interval(inp["u"], inp["cs"], cfg)
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
    n = CASES[case][1]
    cfg, inp = _env(n).cfg, _inputs(n)
    want_u, want_r, want_obs = runs.alone[case]["guard"]
    whole0 = tenvs.hit_les.hit_kernel.observe(inp["u"], cfg)
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
    want = runs.trained[CASES[case][1]]["rows"]
    for r in runs[case]:
        for field, got, w in zip(("obs", "actions", "rewards"),
                                 r["train"]["rows"], want):
            assert got.shape == w.shape
            assert _rel(got, w) <= PIN_SAME, field


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_adam_state_bitwise_across_ranks(runs, case):
    """After one update every rank holds the same params and Adam state
    bit for bit, within PIN_STATE of one process's; the evaluation
    return is finite and equal on every rank, and the ranks exchanged
    halo faces and gathered the field."""
    ranks = runs[case]
    want = runs.trained[CASES[case][1]]
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


# --- the 4^3 case against the JAX package -------------------------------------
def test_split_rhs_matches_jax(runs):
    """One split RHS (k4_m2: two x-slabs a rank) of both assemblies
    against the JAX package's staged `navier_stokes_rhs`."""
    for r in runs["k4_m2"]:
        assert _rel(r["rhs_True"], runs.jax["rhs"]) <= PIN_UNSPLIT
        assert _rel(r["rhs_False"], runs.jax["rhs"]) <= PIN_UNSPLIT


def test_split_rl_interval_matches_jax(runs):
    """One split RL interval (k4_m2) against the JAX package's
    `advance_rl_interval` with `use_kernels=False`."""
    for r in runs["k4_m2"]:
        assert _rel(r["interval"], runs.jax["interval"]) <= PIN_UNSPLIT


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
