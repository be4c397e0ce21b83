"""PyTorch port: one HIT environment split over ranks by two element axes
at once, the reference's (mx, my) pencil (`core.collectives.PencilSplit`:
x-slabs over "mx", y-slabs over "my"), as the dry run's HIT cell splits it
(`launch/dryrun.py:run_relexi_cell`).

A split env has no counterpart in the reference's numbers (sharding changes
nothing in what the reference computes), so the pencil is held to the
port's own run in one process, and through it to the JAX package.

Ranks are gloo processes on the CPU with a file:// store under tmp_path:
this file, run as a script, is the worker (`_worker`).  One world of four
ranks on a (data 1, mx 2, my 2) mesh starts when the module's first test
sets up and runs the cases `k2` (hit_les_reduced, 2^3 elements: one
element a rank each way) and `k4` (`n_elem=4`: 2 x 2 x 4 elements a
rank).  Workers set `torch.set_num_threads(1)` (ROADMAP C3).  Each rank
reports its gathered results; this process computes meanwhile the same
assembly over a pencil of one rank each way (no exchange), and in a
thread beside it the JAX package's references.

Pins, relative to the largest reference value, each with the largest
reading over the cases beside it:
  * PIN_SAME 2e-6 against the same assembly in one process (RHS 8.8e-9,
    interval 2.9e-7, the guarded step's state 2.9e-7, its observations
    2.8e-7, its rewards 0): only the order of the forcing's box sums
    differs (the blocks' sums added over "mx", then over "my"), and a
    block's matmuls run at another batch width; the state one env off
    reads 5.3e-1;
  * PIN_UNSPLIT 2e-5 against the JAX package's staged `navier_stokes_rhs`
    and `advance_rl_interval` (k4: RHS 4.7e-7, interval 2.4e-7), the pin
    of tests/test_torch_rhs.py and tests/test_torch_elem_split.py;
  * PIN_BF16 for the bf16 interval (k4), max and relative L2, the pin of
    tests/test_torch_elem_split.py's k4_m2 case, against the same
    assembly in one process (1.9e-2 / 6.0e-3), the port's unsplit staged
    bf16 path (1.3e-2 / 6.2e-3) and the JAX package's (1.9e-2 / 6.4e-3);
    the state one env off 5.3e-1 / 2.5e-1;
  * the y roll and the x roll are `torch.roll` bit for bit (they only
    move values).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.cfd import solver as jsolver
from repro.cfd.solver import HITConfig as JaxHITConfig
from repro_torch import envs as tenvs
from repro_torch.cfd import env as tenv
from repro_torch.cfd import solver as tsolver
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_SAME = 2e-6
PIN_UNSPLIT = 2e-5
PIN_BF16 = {"max": 4e-2, "l2": 1e-2}
MESH = (1, 2, 2)  # (data, mx, my)
CASES = {"k2": {"n_elem": 2}, "k4": {"n_elem": 4}}
BANK_ROWS = 2


def _env(case: str, **kw):
    return tenvs.make("hit_les_reduced", **CASES[case], **kw)


def _inputs(case: str) -> dict[str, torch.Tensor]:
    """The same inputs in every process: bank rows from a CPU generator,
    an action of the whole env and a tensor to roll from numpy."""
    env = _env(case)
    spec = env.action_spec
    k = env.cfg.n_elem
    rng = np.random.default_rng(5)
    return {
        "u": env.initial_state_bank(torch.Generator().manual_seed(3),
                                    BANK_ROWS),
        "action": torch.from_numpy(rng.uniform(
            spec.low, spec.high, (BANK_ROWS, spec.n_elements)
        ).astype(np.float32)),
        "x": torch.from_numpy(rng.standard_normal(
            (BANK_ROWS, k, k, 3, 5)).astype(np.float32)),
    }


def _cs(cfg, action: torch.Tensor, split) -> torch.Tensor:
    """This rank's block of the whole env's per-element C_s."""
    cs = action.reshape((-1,) + (cfg.n_elem,) * 3)
    return cs if split is None else split.slab(cs, 1)


def _rhs(env, u: torch.Tensor, action: torch.Tensor, split=None):
    cfg = env.cfg
    return tsolver.navier_stokes_rhs(
        u, tsolver.broadcast_cs(_cs(cfg, action, split), cfg).contiguous(),
        cfg, cfg.operators(), split)


def _advance(env, u: torch.Tensor, action: torch.Tensor, split=None):
    return tsolver.advance_rl_interval(u, _cs(env.cfg, action, split),
                                       env.cfg, split)


def _poisoned(advance):
    """`advance_rl_interval` with row 0 of the last rank's result made
    non-finite: the guard must revert row 0 on every rank."""
    def wrapped(*args):
        split = args[-1]
        out = advance(*args)
        if (split.x.rank, split.y.rank) == (split.x.size - 1,
                                            split.y.size - 1):
            out[0, -1, -1] = float("nan")
        return out
    return wrapped


def _checks(case: str, inp: dict, split) -> dict:
    """Through the pencil `split` (this rank's block), gathered whole:
    both rolls, one RHS of each assembly, one RL interval (with its
    exchanges counted per axis), one in bf16 (k4) and one guarded
    `cfd/env.step` of the inputs."""
    out = {}
    env = _env(case)
    x = split.slab(inp["x"], 1)
    for d in (0, 1):
        for s in (-1, 1):
            out[f"roll{d}_{s}"] = split.gather(
                split.along(d).roll(x, s, 1 + d), 1)
    u = split.slab(inp["u"], 1)
    for kernels in (True, False):
        out[f"rhs_{kernels}"] = split.gather(
            _rhs(_env(case, use_kernels=kernels), u, inp["action"], split),
            1)
    split.reset()
    interval = _advance(env, u, inp["action"], split)
    out["exchanges"] = {
        axis: {k: getattr(s, k) for k in ("rolls", "halo_bytes",
                                          "gather_bytes")}
        for axis, s in (("mx", split.x), ("my", split.y))}
    out["interval"] = split.gather(interval, 1)
    if case == "k4":
        out["interval_bf16"] = split.gather(
            _advance(_env(case, precision="bf16"), u, inp["action"], split),
            1)
    advance = tsolver.advance_rl_interval
    tsolver.advance_rl_interval = _poisoned(advance)
    try:
        res = tenv.step(tenv.EnvState(u=u, t_step=torch.zeros(
            (BANK_ROWS,), dtype=torch.int32)), inp["action"], env.cfg,
            env.e_dns(), split)
    finally:
        tsolver.advance_rl_interval = advance
    out["guard"] = (split.gather(res.state.u, 1), res.reward, res.obs)
    return out


def _jax_hit() -> dict[str, np.ndarray]:
    """The JAX package's staged RHS, RL interval and bf16 RL interval of
    the k4 inputs."""
    cfg, inp = _env("k4").cfg, _inputs("k4")
    jcfg = JaxHITConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JaxHITConfig)
                           if f.name != "use_kernels"}, use_kernels=False)
    u = jnp.asarray(inp["u"].numpy())
    cs_elem = _cs(cfg, inp["action"], None)
    cs, cs_nodes = (jnp.asarray(x.numpy()) for x in (
        cs_elem, tsolver.broadcast_cs(cs_elem, cfg)))
    rhs = jax.jit(lambda u, c: jsolver.navier_stokes_rhs(
        u, c, jcfg, jcfg.operators()))
    return {"rhs": np.array(rhs(u, cs_nodes)),
            "interval": np.array(jsolver.advance_rl_interval(u, cs, jcfg)),
            "interval_bf16": np.array(jsolver.advance_rl_interval(
                u, cs, dataclasses.replace(jcfg, precision="bf16")))}


def _one_rank_pencil() -> collectives.PencilSplit:
    return collectives.PencilSplit(collectives.ElemSplit(),
                                   collectives.ElemSplit())


# --- the worker (this file run as a script) ----------------------------------
def _worker(tmp: str, rank: int) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(np.prod(MESH)), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh_lib.init_distributed(init_method=f"file://{tmp}/store",
                              device="cpu")
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "mx", "my"))
    split = collectives.pencil_split(mesh, "mx", "my")
    out = {case: _checks(case, _inputs(case), split) for case in CASES}
    out["ranks"] = (split.x.rank, split.y.rank, split.size)
    dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


class _Runs:
    """The four ranks, started at setup and awaited at first read:
    runs[case] is the list of that case's ranks' results.  Meanwhile this
    process computes each case's run over a pencil of one rank each way
    (`alone`) and, in a thread beside it, the JAX package's references
    (`jax`)."""

    def __init__(self, tmp: str):
        self.tmp, self.out = tmp, None
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT",
                            "LOCAL_WORLD_SIZE")}
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env.setdefault("JAX_PLATFORMS", "cpu")
        self.procs = []
        for r in range(int(np.prod(MESH))):
            with open(f"{tmp}/rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), tmp, str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref = pool.submit(_jax_hit)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)  # as the ranks run, and beside them
            try:
                self.alone = {case: _checks(case, _inputs(case),
                                            _one_rank_pencil())
                              for case in CASES}
            finally:
                torch.set_num_threads(threads)
            self.jax = ref.result()

    def __getitem__(self, case: str) -> list[dict]:
        if self.out is None:
            try:
                for p in self.procs:
                    p.wait(timeout=240)
            finally:
                self.kill()
            self.out = []
            for r, p in enumerate(self.procs):
                with open(f"{self.tmp}/rank{r}.log") as log:
                    assert p.returncode == 0, log.read()[-4000:]
                self.out.append(torch.load(f"{self.tmp}/rank{r}.pt",
                                           weights_only=False))
        return [r[case] for r in self.out] if case else self.out

    def kill(self) -> None:
        for p in self.procs:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("pencil")))
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
def test_a_pencil_of_one_rank_each_way_is_torch_roll_and_unsplit():
    """A pencil of one rank on both axes rolls each direction by
    `torch.roll`, leaves z to `torch.roll` (`along(2)` is None), slabs and
    gathers nothing away, and its staged assembly is the unsplit staged
    one bit for bit (`use_kernels=False`)."""
    inp = _inputs("k2")
    one = _one_rank_pencil()
    assert one.size == 1 and one.along(2) is None
    for d in (0, 1):
        for s in (-1, 1):
            assert torch.equal(one.along(d).roll(inp["x"], s, 1 + d),
                               torch.roll(inp["x"], s, 1 + d))
    assert torch.equal(one.gather(one.slab(inp["u"], 1), 1), inp["u"])
    staged = _env("k2", use_kernels=False)
    assert torch.equal(_rhs(staged, inp["u"], inp["action"], one),
                       _rhs(staged, inp["u"], inp["action"]))
    assert one.halo_bytes == one.gather_bytes == 0
    assert one.x.rolls == one.y.rolls == 0


def test_a_pencil_splits_x_then_y_and_gathers_back():
    """`along` gives x's split for direction 0, y's for 1 and none for z
    (`ElemSplit.along` only x's); `slab` cuts x at `dim` and y at `dim +
    1`, and `gather` puts the blocks back, here over one rank each way."""
    x, y = collectives.ElemSplit(), collectives.ElemSplit()
    pencil = collectives.PencilSplit(x, y)
    assert (pencil.along(0), pencil.along(1), pencil.along(2)) == (x, y,
                                                                   None)
    assert x.along(0) is x and x.along(1) is None and x.along(2) is None
    t = torch.arange(2 * 4 * 4 * 3).reshape(2, 4, 4, 3)
    assert torch.equal(pencil.gather(pencil.slab(t, 1), 1), t)


# --- the ranks against one process --------------------------------------------
def test_ranks_hold_the_pencils_blocks(runs):
    """Rank r of the (1, 2, 2) mesh is (mx, my) = (r // 2, r % 2), in a
    pencil of 4."""
    got = [r["ranks"] for r in runs[None]]
    assert got == [(r // 2, r % 2, 4) for r in range(4)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("direction", (0, 1), ids=("x", "y"))
def test_roll_equals_torch_roll(runs, case, direction):
    x = _inputs(case)["x"]
    for i, r in enumerate(runs[case]):
        for s in (-1, 1):
            assert torch.equal(r[f"roll{direction}_{s}"],
                               torch.roll(x, s, 1 + direction)), (i, s)


@pytest.mark.parametrize("case", list(CASES))
def test_rhs_equals_one_process(runs, case):
    """One RHS of each assembly (B2 and B3's plain versions, and the staged
    plain one) against the same assembly over one rank."""
    for r in runs[case]:
        for key in ("rhs_True", "rhs_False"):
            assert _rel(r[key], runs.alone[case][key]) <= PIN_SAME, key


@pytest.mark.parametrize("case", list(CASES))
def test_rl_interval_equals_one_process(runs, case):
    want = runs.alone[case]["interval"]
    for r in runs[case]:
        assert _rel(r["interval"], want) <= PIN_SAME
        # control: the state one env off must exceed the pin
        assert _rel(r["interval"].roll(1, 0), want) > PIN_SAME


@pytest.mark.parametrize("case", list(CASES))
def test_rl_interval_exchanges_both_axes(runs, case):
    """Per RHS, five face rolls along x over "mx" and five along y over
    "my" (the gradient's traces and left faces of (v, T), 4 channels
    each; the divergence's traces of u and of the viscous flux and its
    left faces, 5 channels each: 23 channel-slabs of the rank's block's
    face, 16 nodes a face), and the forcing's box sums once over each
    axis (4 values a row, from the axis's other rank); no gather."""
    cfg = _env(case).cfg
    n_rhs = cfg.n_substeps * 5
    k = cfg.n_elem
    face = BANK_ROWS * (k // 2) * k * 16  # one direction's face, 1 slab
    for r in runs[case]:
        for axis in ("mx", "my"):
            ex = r["exchanges"][axis]
            assert ex["rolls"] == 5 * n_rhs and ex["gather_bytes"] == 0
            assert ex["halo_bytes"] == n_rhs * (23 * face + BANK_ROWS * 4) * 4


@pytest.mark.parametrize("case", list(CASES))
def test_guarded_step_reverts_a_row_non_finite_on_one_rank_only(runs, case):
    """`cfd/env.step` on the pencil: row 0 goes non-finite on the last
    rank alone, and every rank reverts it (the whole row equals its
    initial state, reward -1, its observation the initial state's); row
    1 advances as in one process."""
    env, inp = _env(case), _inputs(case)
    want_u, want_r, want_obs = runs.alone[case]["guard"]
    whole0 = tenv.observe(inp["u"], env.cfg)
    for r in runs[case]:
        u, reward, obs = r["guard"]
        assert torch.equal(u[0], inp["u"][0]) and reward[0].item() == -1.0
        assert torch.equal(obs[0], whole0[0])
        assert torch.isfinite(u[1]).all()
        assert _rel(u[1], want_u[1]) <= PIN_SAME
        assert abs(reward[1].item() - want_r[1].item()) <= PIN_SAME
        assert _rel(obs, want_obs) <= PIN_SAME


def test_pencil_bf16_interval(runs):
    """One bf16 RL interval on the pencil (k4: B2 and B3, the staged
    divergence and forcing) against the same assembly over one rank, the
    port's unsplit staged bf16 path and the JAX package's: within
    PIN_BF16, max and relative L2; the state one env off exceeds both."""
    env, inp = _env("k4"), _inputs("k4")
    staged = _advance(_env("k4", precision="bf16", use_kernels=False),
                      inp["u"], inp["action"])
    wants = {"one process": runs.alone["k4"]["interval_bf16"],
             "unsplit staged": staged, "jax staged": runs.jax["interval_bf16"]}
    for r in runs["k4"]:
        got = r["interval_bf16"]
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        for label, want in wants.items():
            assert _rel(got, want) <= PIN_BF16["max"], label
            assert _rel_l2(got, want) <= PIN_BF16["l2"], label
        assert _rel(got.roll(1, 0), staged) > PIN_BF16["max"]
        assert _rel_l2(got.roll(1, 0), staged) > PIN_BF16["l2"]


# --- against the JAX package ---------------------------------------------------
def test_pencil_rhs_matches_jax(runs):
    """One pencil RHS (k4) of both assemblies against the JAX package's
    staged `navier_stokes_rhs`."""
    for r in runs["k4"]:
        for key in ("rhs_True", "rhs_False"):
            assert _rel(r[key], runs.jax["rhs"]) <= PIN_UNSPLIT, key


def test_pencil_rl_interval_matches_jax(runs):
    """One pencil RL interval (k4) against the JAX package's
    `advance_rl_interval` with `use_kernels=False`."""
    for r in runs["k4"]:
        assert _rel(r["interval"], runs.jax["interval"]) <= PIN_UNSPLIT


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
