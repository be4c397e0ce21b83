"""Trace audit: pin the one-time work and the per-step counts of a real
training run (the port's counterpart of `repro.analysis.trace_audit`).

Eager PyTorch has no jit cache to retrace.  What must grow once per
distinct shape, and never per call, is the port's one-time work: kernel
library loads (`_build._loaded`), the fused RHS's launch plans
(`rhs.cluster_plan`, `rhs.max_active_clusters`: functools cache misses),
and the device tables (`cfd.tables.builds`: operator matrices, spectra
tables, reference spectra).  Beside it the audit pins the launches of
each kernel, the RHS
calls of each RL step, and the host syncs, counted by
`dispatch.Recorder` on the CPU and by `torch.cuda.set_sync_debug_mode`
on the card.  A count beyond its pin is TRACE001.

* `watch({...})` is the generic primitive: snapshot a set of counters
  (callables returning an int), run a body, report the growth.  A
  benchmark harness wraps its timed section in `certify`, so that its
  numbers come with certified counts.
* `run()` drives a short reduced-HIT training run (rollout -> PPO update
  -> held-out evaluation, the real `Runner.train`) and pins the exact
  counts (`expected_reduced_hit`).
"""
from __future__ import annotations

import contextlib
import tempfile
from typing import Any, Callable, Mapping

import torch

from . import dispatch
from .report import Finding, Report

N_ITERATIONS = 2
N_ENVS = 2


def expected_reduced_hit(device: str, *, cluster_loaded: bool = True,
                         n_iterations: int = N_ITERATIONS
                         ) -> dict[str, int]:
    """The pinned counts of `run()` on `device`.

    hit_les_reduced with t_end = 0.41: 4 RL steps an episode (0.41 / 0.1
    rounded), each 5 RK substeps (dt_rl / dt) of 5 stages: 25 RHS calls a
    step.  The run rolls its 2 envs as one batch per iteration and
    evaluates every second iteration.

    One-time work, from cleared caches: 6 device tables (the D and w
    operators, the nodal-to-uniform matrix, the shell one-hot and weights,
    the reference spectrum); on the card one cluster plan and one
    occupancy query (the plain version on the CPU plans nothing), and a
    kernel load only if the cluster library was not loaded before.

    Host syncs, all by design: each iteration its 8 stats read as floats
    (the PPO loss stats, the grad norm, the mean return); each evaluation
    its return; the final checkpoint's host copy of the 52 state tensors
    (the policy's 13 parameters, Adam's step, m and v of each); and the 6
    table builds, one host-to-device copy each.  The runner's timing sync
    (`torch.cuda.synchronize`) is not one: `set_sync_debug_mode` does not
    flag it (measured on an H100 with torch 2.11), and the CPU does not
    count it either."""
    evals = n_iterations // 2
    steps = 4 * (n_iterations + evals)
    card = device == "cuda"
    return {
        "rl_steps": steps,
        "rhs_calls": 25 * steps,
        "rhs_launches": 25 * steps if card else 0,
        "table_builds": 6,
        "cluster_plans": int(card),
        "occupancy_queries": int(card),
        "kernel_loads": int(card and not cluster_loaded),
        "syncs": 8 * n_iterations + evals + 52 + 6,
    }


class TraceWatch:
    """Context manager: growth of a set of counters across a body."""

    def __init__(self, counters: Mapping[str, Callable[[], int]]):
        for name, c in counters.items():
            if not callable(c):
                raise TypeError(f"{name!r} is not a counter (a callable "
                                "returning an int)")
        self.counters = dict(counters)
        self.growth: dict[str, int] = {}
        self._before: dict[str, int] = {}

    def __enter__(self) -> "TraceWatch":
        self._before = {n: int(c()) for n, c in self.counters.items()}
        return self

    def __exit__(self, *exc) -> None:
        self.growth = {n: int(c()) - self._before[n]
                       for n, c in self.counters.items()}

    def check(self, expected: Mapping[str, int],
              entrypoint: str = "") -> list[Finding]:
        """TRACE001 findings for every counter whose growth != its pin."""
        findings = []
        for name, want in expected.items():
            got = self.growth.get(name)
            if got != want:
                findings.append(Finding(
                    rule="TRACE001",
                    message=(f"`{name}` grew {got}, pinned {want}: "
                             + ("work repeated per call" if (got or 0) > want
                                else "stale pin / dead path")),
                    entrypoint=entrypoint or name))
        return findings


def watch(counters: Mapping[str, Callable[[], int]]) -> TraceWatch:
    return TraceWatch(counters)


def certify(counters: Mapping[str, Callable[[], int]],
            expected: Mapping[str, int],
            body: Callable[[], Any]) -> tuple[Any, dict[str, int]]:
    """Benchmark-harness helper: run `body`, hold the counters to their
    pins, return (body result, certified growth).  Raises RuntimeError on
    any mismatch: numbers from a run that repeats its one-time work must
    not be published."""
    with watch(counters) as w:
        result = body()
    bad = w.check(expected, entrypoint="benchmark")
    if bad:
        raise RuntimeError(
            "trace certification failed:\n  "
            + "\n  ".join(f.message for f in bad))
    return result, dict(w.growth)


class CallCount:
    """`owner.attr` wrapped to count its calls while active."""

    def __init__(self, owner, attr: str):
        self.owner, self.attr, self.n = owner, attr, 0

    def __enter__(self) -> "CallCount":
        fn = getattr(self.owner, self.attr)
        self._fn = fn

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        setattr(self.owner, self.attr, counted)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.owner, self.attr, self._fn)


def one_time_counters() -> dict[str, Callable[[], int]]:
    """The port's one-time work, as counters."""
    from ..cfd import tables
    from ..kernels import _build, rhs

    return {
        "table_builds": tables.builds,
        "cluster_plans": lambda: rhs.cluster_plan.cache_info().misses,
        "occupancy_queries":
            lambda: rhs.max_active_clusters.cache_info().misses,
        "kernel_loads": lambda: len(_build._loaded),
    }


def _tally(sites: list[str]) -> dict[str, int]:
    out: dict[str, int] = {}
    for site in sites:
        out[site] = out.get(site, 0) + 1
    return out


def run(report: Report | None = None, n_iterations: int = N_ITERATIONS,
        device: str = "cuda") -> Report:
    """The reduced-HIT certification: a real training run of
    `n_iterations` with one held-out evaluation, on `device` ("cuda", the
    default, or "cpu"), against `expected_reduced_hit`."""
    from .. import envs
    from ..cfd import solver, tables
    from ..core.orchestrator import FleetConfig
    from ..core.runner import Runner, RunnerConfig
    from ..kernels import _build, rhs

    report = report or Report()
    dev = dispatch.device_of(device)
    env = envs.make("hit_les_reduced", t_end=0.41)
    with tempfile.TemporaryDirectory(prefix="repro_torch_trace_") as ckpt:
        runner = Runner(
            env, FleetConfig(n_envs=N_ENVS, bank_size=5),
            run_cfg=RunnerConfig(
                n_iterations=n_iterations, eval_every=2,
                checkpoint_every=10 * n_iterations, async_checkpoint=False,
                checkpoint_dir=ckpt), device=dev)
        # one-time work counts from cleared caches, so that the pins do
        # not depend on what ran before in the process
        tables._made.cache_clear()
        rhs.cluster_plan.cache_clear()
        rhs.max_active_clusters.cache_clear()
        expected = expected_reduced_hit(
            device, n_iterations=n_iterations,
            cluster_loaded=rhs.SOURCES["cluster"] in _build._loaded)
        fused = rhs.fused_navier_stokes_rhs
        with contextlib.ExitStack() as stack:
            rhs_calls = stack.enter_context(
                CallCount(solver, "navier_stokes_rhs"))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                card = stack.enter_context(dispatch.CardSyncs())
                syncs = lambda: len(card.sites)  # noqa: E731
            else:
                rec = stack.enter_context(dispatch.Recorder(
                    ((runner.opt, "step", "torch.optim.Adam.step"),)))
                syncs = lambda: len(rec.syncs)  # noqa: E731
                card = None
            counters = {
                **one_time_counters(),
                "rhs_calls": lambda: rhs_calls.n,
                "rhs_launches": lambda: fused.launches,
                "syncs": syncs,
            }
            with watch(counters) as w:
                history = runner.train(n_iterations, resume=False)
        growth = dict(w.growth)
        rollouts = len(history) + sum("eval_return_norm" in r
                                      for r in history)
        growth["rl_steps"] = env.n_actions * rollouts
    report.extend(w.check({k: v for k, v in expected.items()
                           if k in w.growth}, entrypoint="reduced_hit_run"))
    if growth["rl_steps"] != expected["rl_steps"]:
        report.extend([Finding(
            rule="TRACE001", entrypoint="reduced_hit_run",
            message=f"`rl_steps` {growth['rl_steps']}, pinned "
                    f"{expected['rl_steps']}")])
    out = report.meta.setdefault("trace_audit", {})
    out["reduced_hit_counts"] = growth
    out["expected"] = expected
    out["sync_sites"] = _tally(card.sites if card is not None
                               else [x.where for x in rec.syncs])
    return report
