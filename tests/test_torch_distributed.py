"""PyTorch port vs JAX reference: distribution (`launch/mesh.py`,
`core/collectives.py`, `core/elastic.py`, `core/compression.py`, and the
mesh of `Orchestrator`, `Runner`, `FleetRunner`, `rl_train` and
`load_policy`; the reference's `fleet/superbatch.py` layout is the
orchestrator's over a mesh).

Ranks are processes on the CPU with the gloo backend and a file:// store
under tmp_path: this file, run as a script, is the worker (`_worker`).  One
two-rank run and then one single-process run (the one-rank baselines and
the resume of the two-rank checkpoint) write their results to files that
the tests read.  Workers set `torch.set_num_threads(1)`, so their results
do not depend on the CPU's thread count (ROADMAP C3); the tests that
compare with a worker run nothing themselves.  The pure functions and the
collective-free rollout region are held to the reference in this process,
with the reference's draws and weights carried across.
"""
from __future__ import annotations

import logging
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
from repro.core import compression as jcomp
from repro.core import elastic as jelastic
from repro.core import ppo as jppo
from repro.fleet import multitask as jmt
from repro.fleet import pipeline as jpipe
from repro.fleet import scheduler as jsched
from repro.fleet import superbatch as jsb
from repro.launch import mesh as jmesh
from repro_torch import envs as tenvs
from repro_torch.core import checkpoints as tckpt
from repro_torch.core import collectives, compression, elastic
from repro_torch.core import ppo as tppo
from repro_torch.core import rollout as trollout
from repro_torch.core.orchestrator import FleetConfig, Orchestrator
from repro_torch.fleet import multitask, scheduler
from repro_torch.fleet.pipeline import (FleetOrchestrator, FleetRunner,
                                        FleetRunnerConfig)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import rl_train
from repro_torch.serve import load_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# HIT (one RL step an episode) and Burgers (three), 3 envs each: two ranks
# pad each to 4, so rank 1 rolls one real row and one pad row
NAMED = (("hit_les_reduced", {"t_end": 0.1}), ("burgers_reduced", {}))
N_ENVS = 3
PSUM_ROUNDS = 3        # int8 error feedback carried over 3 calls
RL_ARGS = ["--reduced", "--n-envs", "3", "--iterations", "1",
           "--eval-every", "5", "--device", "cpu"]


class FakeMesh:
    """A mesh as the reference's pure functions read it: a `.shape` dict."""

    def __init__(self, **shape):
        self.shape = shape


def _schedule(pkg_envs, pkg_sched):
    named = [(n, pkg_envs.make(n, **kw)) for n, kw in NAMED]
    return pkg_sched.build_schedule(named, 2 * N_ENVS, costs={
        n: 1.0 for n, _ in NAMED}, use_artifacts=False)


def _fleet_runner(ckpt: str, mesh, **kw) -> FleetRunner:
    cfg = FleetRunnerConfig(n_iterations=2, eval_every=100,
                            checkpoint_every=1, checkpoint_dir=ckpt,
                            async_checkpoint=False, bank_size=4, **kw)
    return FleetRunner(_schedule(tenvs, scheduler), run_cfg=cfg, mesh=mesh,
                       device="cpu")


def _state(runner) -> dict:
    """Params, optimizer state and broker as flat host copies."""
    return {k: v.clone() for k, v in tckpt._flatten(runner._state_tree())}


def _psum_inputs(round_: int) -> dict[str, np.ndarray]:
    """Per-rank gradient trees, stacked on a leading rank axis of 2."""
    rng = np.random.default_rng(100 + round_)
    return {"a": (rng.standard_normal((2, 3, 5)) * 10).astype(np.float32),
            "b": rng.standard_normal((2, 7)).astype(np.float32)}


def _obs(mcfg) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(7)
    return {h.name: torch.from_numpy(rng.standard_normal(
        (5, h.n_elements) + h.spatial + (h.channels,)).astype(np.float32))
        for h in mcfg.heads}


# --- the worker (this file run as a script) ----------------------------------
def _collectives(group, rank: int) -> dict:
    out = {}
    tree = {k: torch.from_numpy(v[rank]) for k, v in _psum_inputs(0).items()}
    for method in ("none", "bf16"):
        red, err = compression.compressed_psum(tree, group, method=method)
        assert err is None
        out[method] = red
    err, out["int8"] = None, []
    for r in range(PSUM_ROUNDS):
        tree = {k: torch.from_numpy(v[rank])
                for k, v in _psum_inputs(r).items()}
        red, err = compression.compressed_psum(tree, group, method="int8",
                                               error_state=err)
        out["int8"].append((red, err))
    out["chunked"] = compression.chunked_psum(tree, group, n_chunks=3)
    return out


def _served(ckpt: str, mesh) -> dict:
    policy = load_policy(ckpt, device="cpu", mesh=mesh)
    with torch.no_grad():
        return {n: multitask.actor_mean(policy.params, policy.mcfg, n, o)
                for n, o in _obs(policy.mcfg).items()}


def _rl_train(argv: list) -> tuple[list, list]:
    """`rl_train.main(argv)` and the batch of every rollout it ran."""
    batches = []
    rollout = trollout.rollout

    def counted(policy, env, u0, **kwargs):
        batches.append(u0.shape[0])
        return rollout(policy, env, u0, **kwargs)

    trollout.rollout = counted
    try:
        return rl_train.main(argv), batches
    finally:
        trollout.rollout = rollout


def _local_rollout_equal(local) -> bool:
    """A rank's rollout over its local (1, 1) mesh is the rollout of an
    orchestrator without a mesh, bit for bit."""
    env = tenvs.make("burgers_reduced")
    head = multitask.MultiTaskPolicy(multitask.MultiTaskConfig.from_envs(
        [("b", env)])).head("b")
    trajs = [Orchestrator(env, FleetConfig(n_envs=3, bank_size=4),
                          mesh=mesh, device="cpu").sample_fleet(
                 head, torch.Generator().manual_seed(5))
             for mesh in (local, None)]
    return all(torch.equal(a, b) for a, b in zip(*trajs))


def _worker(case: str, tmp: str, rank: int) -> None:
    torch.set_num_threads(1)
    out = {}
    if case == "ranks":
        os.environ.update(WORLD_SIZE="2", RANK=str(rank),
                          LOCAL_RANK=str(rank))
        store = f"file://{tmp}/store"
        out["init"] = [mesh_lib.init_distributed(init_method=store,
                                                 device="cpu")]
        out["init"].append(mesh_lib.init_distributed(init_method=store,
                                                     device="cpu"))
        mesh = mesh_lib.make_fleet_mesh(device="cpu")
        out["mesh"] = (collectives.mesh_shape(mesh), dist.get_backend())
        out["host_mesh"] = collectives.mesh_shape(
            mesh_lib.make_host_mesh(device="cpu"))
        local = mesh_lib.make_local_mesh(device="cpu")
        out["local"] = (collectives.mesh_shape(local),
                        dist.get_world_size(local.get_group("data")),
                        _local_rollout_equal(local))
        alone = _fleet_runner(f"{tmp}/local{rank}", local)
        alone.train(2, resume=False)
        out["local_run"] = _state(alone)
        out["psum"] = _collectives(mesh.get_group("data"), rank)
        full = _fleet_runner(f"{tmp}/full", mesh)
        full.train(2, resume=False)
        out["full"] = _state(full)
        half = _fleet_runner(f"{tmp}/half", mesh)
        half.train(1, resume=False)
        dist.barrier()
        out["served"] = _served(f"{tmp}/full", mesh)
        out["served_alone"] = _served(f"{tmp}/full", None)
        out["rl"] = _rl_train(RL_ARGS + ["--checkpoint-dir", f"{tmp}/rl2"])
        dist.destroy_process_group()
    else:
        out["init"] = mesh_lib.init_distributed(), dist.is_initialized()
        base = _fleet_runner(f"{tmp}/base", None)
        base.train(2, resume=False)
        out["base"] = _state(base)
        resumed = _fleet_runner(f"{tmp}/half", None)
        out["restored"] = resumed.restore(), resumed.iteration
        resumed.train(2, resume=False)
        out["resumed"] = _state(resumed)
        out["rl"] = _rl_train(RL_ARGS + ["--checkpoint-dir", f"{tmp}/rl1"])
    if case == "single" or rank == 0:
        for d in ("rl1", "rl2"):
            if os.path.isdir(f"{tmp}/{d}"):
                step = tckpt.latest_step(f"{tmp}/{d}")
                out[f"{d}_ckpt"] = tckpt.restore_arrays(f"{tmp}/{d}", step)
    torch.save(out, f"{tmp}/{case}_{rank}.pt")


def _start(case: str, tmp: str, world: int) -> list[subprocess.Popen]:
    """`world` workers of `case`, each logging to <tmp>/<case>_<rank>.log."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    procs = []
    for r in range(world):
        with open(f"{tmp}/{case}_{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, tmp,
                 str(r)], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _finish(case: str, tmp: str, procs: list) -> list[dict]:
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        with open(f"{tmp}/{case}_{r}.log") as log:
            assert p.returncode == 0, log.read()[-4000:]
    return [torch.load(f"{tmp}/{case}_{r}.pt", weights_only=False)
            for r in range(len(procs))]


class _Runs:
    """The two-rank run, started when the module's first test sets up (the
    tests of this process run meanwhile) and awaited at first read; then
    the single-process run that resumes its checkpoint.  runs["ranks"] is
    [rank 0's results, rank 1's], runs["single"] the single process's."""

    def __init__(self, tmp: str):
        self.tmp, self.out = tmp, None
        self.procs = _start("ranks", tmp, 2)

    def __getitem__(self, key: str):
        if self.out is None:
            ranks = _finish("ranks", self.tmp, self.procs)
            self.procs = _start("single", self.tmp, 1)
            (single,) = _finish("single", self.tmp, self.procs)
            self.out = {"ranks": ranks, "single": single}
        return self.out[key]


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("dist")))
    yield r
    for p in r.procs:
        p.kill()


# --- pure functions against the reference ------------------------------------
@pytest.mark.parametrize("n", list(range(1, 17)) + [24, 32, 256, 512])
def test_split_data_model_equals_the_reference(n):
    assert mesh_lib._split_data_model(n) == jmesh._split_data_model(n)


@pytest.mark.parametrize("data", [1, 2, 3, 4])
def test_elastic_fleet_and_divisibility_equal_the_reference(data):
    for model in (1, 2):
        mesh = FakeMesh(data=data, model=model)
        for axes in (("data",), ("data", "model")):
            for n in range(1, 20):
                assert elastic.elastic_fleet(n, mesh, axes) == \
                    jelastic.elastic_fleet(n, mesh, axes), (n, axes)
        for shape in ((8, 6), (3, 4), (12, 1), (5, 10)):
            for spec in ((None, None), ("data", None), (None, "model"),
                         (("data", "model"), None), ("data", "model")):
                assert elastic.validate_divisibility(shape, spec, mesh) == \
                    jelastic.validate_divisibility(
                        shape, jax.sharding.PartitionSpec(*spec), mesh), \
                    (shape, spec)
    assert elastic.elastic_fleet(7, None) == jelastic.elastic_fleet(7, None)


class _Members:
    def __init__(self, counts):
        self.schedule = type("S", (), {"members": [
            type("M", (), {"name": f"s{i}", "n_envs": n})()
            for i, n in enumerate(counts)]})()
        self.mcfg = None


@pytest.mark.parametrize("data", [1, 2, 3, 4])
def test_b_pad_equals_the_reference(data):
    """Each scenario's padded width (`Orchestrator.b_pad`: `padded` of its
    env count over the env axes' size) against the reference's
    `FleetProgram.b_pad`."""
    counts = [1, 2, 3, 4, 5, 7, 8, 9, 16, 17]
    mesh = FakeMesh(data=data, model=1)
    want = jsb.FleetProgram(_Members(counts), {}, jppo.PPOConfig(),
                            mesh=mesh)
    assert want.n_data == collectives.axes_size(mesh, ("data",)) == data
    assert want.b_pad == {f"s{i}": collectives.padded(n, data)
                          for i, n in enumerate(counts)}


def test_slice_traj_equals_the_reference():
    rng = np.random.default_rng(3)
    fields = {"obs": (4, 6, 2, 3), "actions": (4, 6, 2), "log_probs": (4, 6),
              "rewards": (4, 6), "values": (4, 6), "last_value": (6,)}
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in fields.items()}
    arrays["dones"] = rng.random((4, 6)) > 0.5
    for n in (1, 4, 6):
        got = trollout.slice_traj(tppo.Trajectory(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}), n)
        want = jsb.slice_traj(jppo.Trajectory(**arrays), n)
        for field in tppo.Trajectory._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))


@pytest.mark.parametrize("name", ["channel_wm_reduced", "burgers_reduced"])
def test_elem_axis_raises(name):
    """Only the HIT envs split by their element axis: the others refuse
    `elem_axis`, naming the ROADMAP item of their split."""
    with pytest.raises(NotImplementedError, match="elem_axis.*A11d"):
        Orchestrator(tenvs.make(name),
                     FleetConfig(n_envs=2, elem_axis="model"), device="cpu")


# --- the rollout region against the reference --------------------------------
def test_rollout_shard_equals_the_reference():
    """The orchestrator's rollout of each scenario's rows (its head, its
    env, `rollout(noise=)`) against the reference's
    `FleetProgram.rollout_shard`, on the reference's padded (u0, noise) of
    a `data` size of 2 (HIT and Burgers, 3 envs padded to 4, float32), with
    the reference's weights: per-step quantities within 1e-4 of max
    (the pin of the slice's rollout test; measured <= 4e-7), dones exact."""
    sched_j = _schedule(jenvs, jsched)
    forch_j = jpipe.FleetOrchestrator(sched_j, seed=0, bank_size=4)
    weights = {m.name: m.weight for m in sched_j.members}
    prog_j = jsb.FleetProgram(forch_j, weights, jppo.PPOConfig(),
                              mesh=FakeMesh(data=2, model=1))
    assert prog_j.b_pad == {n: 4 for n, _ in NAMED}
    params = jmt.init(jax.random.PRNGKey(1), forch_j.mcfg)
    keys = {n: jax.random.PRNGKey(10 + i) for i, (n, _) in enumerate(NAMED)}
    drawn = {n: prog_j.draw_padded_inputs(n, keys[n]) for n in prog_j.names}
    u0s = {n: d[0] for n, d in drawn.items()}
    noises = {n: d[1] for n, d in drawn.items()}
    want = jax.jit(prog_j.rollout_shard)(params, u0s, noises)

    forch_t = FleetOrchestrator(_schedule(tenvs, scheduler), bank_size=4,
                                device="cpu")
    multitask.load_jax_params(forch_t.policy,
                              jax.tree.map(np.asarray, params))
    got = {n: trollout.rollout(
               forch_t.policy.head(n), forch_t.orchs[n].env,
               torch.from_numpy(np.asarray(u0s[n])),
               noise=torch.from_numpy(np.asarray(noises[n])))
           for n in forch_t.names}
    for n in forch_t.names:
        for field in tppo.Trajectory._fields:
            g = getattr(got[n], field).numpy()
            w = np.asarray(getattr(want[n], field))
            assert g.shape == w.shape, (n, field)
            if field == "dones":
                np.testing.assert_array_equal(g, w)
            else:
                scale = max(float(np.abs(w).max()), 1.0)
                np.testing.assert_allclose(g, w, rtol=1e-4,
                                           atol=1e-4 * scale,
                                           err_msg=f"{n} {field}")


def test_one_rank_mesh_trains_bitwise_as_no_mesh(runs):
    """Each rank's FleetRunner over its own (1, 1) mesh (bank by broadcast,
    rows gathered over one rank) against one process without a mesh: two
    pipelined iterations give the same params, Adam state and broker bit
    for bit."""
    want = runs["single"]["base"]
    for r, out in enumerate(runs["ranks"]):
        got = out["local_run"]
        assert got.keys() == want.keys(), r
        for k, v in want.items():
            assert torch.equal(got[k], v), (r, k)


def test_init_distributed_is_guarded_and_idempotent(runs, monkeypatch):
    """No launcher variables: False, and no process group; under two ranks
    True, and True again without a second init."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.init_distributed() is False
    assert not dist.is_initialized()
    assert runs["single"]["init"] == (False, False)
    for r, out in enumerate(runs["ranks"]):
        assert out["init"] == [True, True], r
        assert out["mesh"] == ({"data": 2, "model": 1}, "gloo")
        assert out["host_mesh"] == {"data": 1, "model": 2}  # model first
        assert out["local"] == ({"data": 1, "model": 1}, 1, True)


# --- collectives against the reference under jax.vmap ------------------------
def _stacked(tree) -> dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(t[k]) for t in tree]) for k in tree[0]}


@pytest.mark.parametrize("method", ["none", "bf16"])
def test_compressed_psum_equals_the_reference(runs, method):
    """Two ranks' sums against the reference's psum over a vmapped axis of
    2: bitwise (one addition per element, rounded once)."""
    want = jax.vmap(lambda t: jcomp.compressed_psum(t, "i", method=method)[0],
                    axis_name="i")(_psum_inputs(0))
    got = _stacked([out["psum"][method] for out in runs["ranks"]])
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


def test_compressed_psum_int8_error_feedback_equals_the_reference(runs):
    """Three rounds of int8 with the residual carried: the sums and every
    rank's residual bitwise the reference's (int32 sums, a MAX of the
    scales, the same float32 quantization)."""
    err = jax.tree.map(jnp.zeros_like, _psum_inputs(0))
    fn = jax.vmap(lambda t, e: jcomp.compressed_psum(
        t, "i", method="int8", error_state=e), axis_name="i")
    for r in range(PSUM_ROUNDS):
        want, err = fn(_psum_inputs(r), err)
        got = _stacked([out["psum"]["int8"][r][0] for out in runs["ranks"]])
        got_err = _stacked([out["psum"]["int8"][r][1]
                            for out in runs["ranks"]])
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
            np.testing.assert_array_equal(got_err[k], np.asarray(err[k]), k)


def test_chunked_psum_equals_the_reference(runs):
    want = jax.vmap(lambda t: jcomp.chunked_psum(t, "i", n_chunks=3),
                    axis_name="i")(_psum_inputs(PSUM_ROUNDS - 1))
    got = _stacked([out["psum"]["chunked"] for out in runs["ranks"]])
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)


# --- the fleet over ranks ----------------------------------------------------
def test_two_ranks_hold_bitwise_equal_params_and_adam_state(runs):
    """Every rank runs the same update on the same gathered rows: params,
    Adam's moments and step, and the broker, bitwise equal on both."""
    a, b = (out["full"] for out in runs["ranks"])
    assert a.keys() == b.keys()
    assert any("['opt']" in k and "exp_avg_sq" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# A batch of another width changes the float32 sums of the multitask
# policy's dense layers (and of the HIT reward) by an ulp on the CPU, as
# it does on the card (chip_smoke's TOL_SERVE_ROWS): two ranks roll 2 + 2
# rows where one process rolls 3.  Pins, of each leaf's max |value|,
# against the readings of the two-rank run on this CPU:
PIN_TRAJ = 1e-5        # broker trajectories: measured <= 1.9e-6
PIN_STATE = 1e-4       # params 4.5e-6, Adam moments 1.6e-5 after 2 updates
PIN_METRICS = 1e-3     # update stats 2.7e-5 (approx_kl, a small difference)


def _assert_state_close(got: dict, want: dict) -> list[str]:
    """Every leaf within its pin (dones and step counts exact); returns
    the leaves that are not bitwise equal."""
    assert got.keys() == want.keys()
    differ = []
    for k, w in want.items():
        g = got[k]
        if torch.equal(g, w):
            continue
        differ.append(k)
        assert "['dones']" not in k and "['step']" not in k \
            and "['head']" not in k, k
        pin = (PIN_TRAJ if "['traj']" in k else
               PIN_METRICS if "['metrics']" in k else PIN_STATE)
        scale = float(w.detach().abs().max())
        err = float((g.detach().double() - w.detach().double()).abs().max())
        assert err <= pin * scale, (k, err, scale)
    return differ


def test_two_ranks_real_rows_equal_the_one_rank_run(runs):
    """3 envs a scenario split over 2 ranks (padded to 4) against one
    process, two pipelined iterations: the gathered, sliced trajectories in
    the broker, the params and Adam state and the update stats, bitwise
    where the batch width does not enter the sums, else within the pins
    above."""
    two, one = runs["ranks"][0]["full"], runs["single"]["base"]
    differ = _assert_state_close(two, one)
    assert differ, "expected the ulp differences of another batch width"
    burgers = [k for k in two if "['burgers_reduced']" in k
               and "['traj']" in k]
    assert burgers and not set(burgers) & set(differ)


def test_checkpoint_of_two_ranks_resumes_at_one(runs):
    """Iteration 0 over 2 ranks, checkpointed by rank 0; one process
    restores it and runs iteration 1 against the uninterrupted two-rank
    run: params, Adam state and stats bitwise (update 1 consumed traj_1,
    rolled over 2 ranks before the checkpoint), the trajectory rolled
    after the restore within PIN_TRAJ."""
    assert runs["single"]["restored"] == (True, 1)
    differ = _assert_state_close(runs["single"]["resumed"],
                                 runs["ranks"][0]["full"])
    assert all("['broker']['traj']" in k for k in differ), differ


def test_load_policy_on_a_mesh_serves_the_same_actions(runs):
    """The two-rank checkpoint served replicated on the mesh and served
    without one: the same actions, bitwise, on both ranks."""
    a, b = runs["ranks"]
    for n, act in a["served"].items():
        assert torch.equal(act, a["served_alone"][n]), n
        assert torch.equal(act, b["served"][n]), n


def test_rl_train_splits_the_env_batch_over_ranks(runs):
    """`rl_train` under two ranks (hit_les_reduced, 3 envs padded to 4, one
    iteration): each rank rolls out 2 rows, and both ranks report the
    one-process run's iteration record, and rank 0's checkpoint its params
    and Adam state, within the pins above (bitwise where the batch width
    does not enter the sums)."""
    (one, batches), one_ckpt = runs["single"]["rl"], runs["single"]["rl1_ckpt"]
    assert batches == [3]
    for out in runs["ranks"]:
        (rec,), batches = out["rl"]
        assert batches == [2]
        for k in ("return_norm", "ppo/loss", "ppo/grad_norm"):
            assert abs(rec[k] - one[0][k]) <= PIN_METRICS * abs(one[0][k]), k
    (arrays_two, man_two), (arrays_one, man_one) = (
        runs["ranks"][0]["rl2_ckpt"], one_ckpt)
    assert man_two["keys"] == man_one["keys"]
    assert man_two["meta"]["iteration"] == 1
    _assert_state_close(
        {k: torch.from_numpy(x) for k, x in zip(man_two["keys"], arrays_two)},
        {k: torch.from_numpy(y) for k, y in zip(man_one["keys"], arrays_one)})


# --- gloo on CUDA tensors ----------------------------------------------------
@pytest.mark.cuda
def test_cuda_gloo_group_stages_cuda_tensors_through_the_host(tmp_path,
                                                               caplog):
    """A gloo group handed CUDA tensors: gather, broadcast and reduce give
    CUDA results equal to the inputs' reductions, and the staging is
    logged once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        x = torch.arange(6.0, device="cuda").reshape(2, 3)
        with caplog.at_level(logging.WARNING,
                             logger=collectives.__name__):
            collectives._staging_logged = False
            got = collectives.all_gather_cat(x, group, dim=1)
            collectives.broadcast_(x, group)
            collectives.all_reduce_(x, group)
        assert got.is_cuda and torch.equal(got, x)
        assert x.is_cuda and torch.equal(x.cpu(), torch.arange(6.0).reshape(
            2, 3))
        assert [r.message for r in caplog.records].count(
            "gloo group on CUDA tensors: collectives are staged through "
            "host memory") == 1
        tree = {"g": torch.ones(5, device="cuda")}
        red, _ = compression.compressed_psum(tree, group, method="int8")
        assert red["g"].is_cuda
        torch.testing.assert_close(red["g"], tree["g"], rtol=1e-2, atol=0)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
