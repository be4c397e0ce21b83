"""Sub-fleet scheduler: partition the fleet's environment budget across
scenarios (PyTorch port of `repro.fleet.scheduler`).

A heterogeneous fleet must decide how many environments each scenario gets.
This module apportions a total environment budget into per-scenario
sub-fleets weighted by the INVERSE of each scenario's per-environment step
cost, so every sub-fleet costs roughly the same device time per iteration
and no scenario serializes the others.

Step costs come from, in priority order:

  1. explicit `costs` overrides,
  2. the AOT dry-run artifacts (`flops_per_env`, the measured cost of one
     fleet MDP step), matched by the EXACT scenario the cell measured and
     used only when every non-overridden member has one (measured FLOPs
     and the static proxy are different units),
  3. a static FLOP proxy: state DOF x solver substeps per RL step.

The scheduler also owns the fleet's determinism bookkeeping: per-scenario
bank seeds (`scenario_seed`) and per-(scenario, iteration) rollout seeds
(`rollout_seed`), pure functions of (base seed, scenario index[,
iteration]) that seed `torch.Generator`s, so a restored run replays
bit-identically.  Each hashes its arguments jointly (numpy's
`SeedSequence` over fixed-width words, with a tag per function), so no
additive lattice makes two (seed, index) pairs collide.  JAX's threefry
keys are not reproduced: the two packages draw other numbers from one seed.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os

import numpy as np
import torch

from ..envs.base import Env
from ..launch import DRYRUN_ARTIFACT_DIR

# Scenarios whose dry-run fleet cell is identified by the record's `arch`
# tag alone (the HIT cell predates the `variant` field); every other cell
# names its exact scenario in `variant`.
_ARCH_EXACT = {
    "hit_les_24dof": "relexi-hit24",
    "hit_les_32dof": "relexi-hit32",
}


@dataclasses.dataclass(frozen=True)
class SubFleet:
    """One scenario's slice of the fleet: its env, environment count, loss
    weight (its share of the env budget, so the joint PPO loss stays an
    unweighted per-environment mean), and the per-env step cost that sized
    it."""

    name: str
    env: Env
    n_envs: int
    weight: float
    cost: float


@dataclasses.dataclass(frozen=True)
class FleetSchedule:
    """The full partition, ordered; scenario index = position (stable, part
    of the determinism contract: reordering scenarios is a new run)."""

    members: tuple[SubFleet, ...]

    def __post_init__(self):
        names = [m.name for m in self.members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate scenario names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(m.name for m in self.members)

    @property
    def total_envs(self) -> int:
        return sum(m.n_envs for m in self.members)

    def member(self, name: str) -> SubFleet:
        for m in self.members:
            if m.name == name:
                return m
        raise KeyError(name)

    def index(self, name: str) -> int:
        return self.names.index(name)


# --- step-cost estimation ----------------------------------------------------
def static_step_cost(env: Env) -> float:
    """FLOP proxy for one env's RL step: state DOF x solver substeps.

    Generic over the Env protocol: the state shape is that of one bank row
    drawn on the CPU, the substeps come from the config when it declares
    them (all DGSEM scenarios do)."""
    row = env.initial_state_bank(torch.Generator().manual_seed(0), 1)
    dof = float(np.prod(row.shape[1:]))
    substeps = float(getattr(getattr(env, "cfg", None), "n_substeps", 1))
    return dof * substeps


def dryrun_step_cost(name: str, artifact_dir: str | None = None
                     ) -> float | None:
    """Per-env step cost measured by the AOT dry-run, if an artifact exists
    for EXACTLY this scenario.

    Reads the newest `*_fleet_*.json` whose record names the scenario
    (`variant == name`, or the legacy relexi `arch` tags) and carries
    `flops_per_env`; returns None otherwise — a cell measured at another
    scale must not price this one (the units are absolute XLA FLOPs).
    """
    directory = artifact_dir or DRYRUN_ARTIFACT_DIR
    paths = sorted(glob.glob(os.path.join(directory, "*_fleet_*.json")),
                   key=os.path.getmtime)
    for path in reversed(paths):  # newest usable artifact wins
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        # the arch-tag fallback must only fire for scenarios that HAVE a
        # legacy tag: for any other scenario `_ARCH_EXACT.get(name)` is
        # None, and a record without an `arch` field would match it
        # (None == None), pricing the scenario off an unrelated cell
        arch = _ARCH_EXACT.get(name)
        matches = (rec.get("variant") == name
                   or (arch is not None and arch == rec.get("arch")))
        if not (matches and rec.get("status") == "ok"):
            continue
        # Explicit None-check, NOT truthiness: a record that carries the
        # field with a measured 0.0 is a broken measurement and must fail
        # loudly instead of being silently discarded (a zero cost would
        # give the scenario an infinite share of the env budget).
        cost = rec.get("flops_per_env")
        if cost is None:
            continue  # record without a measurement: keep scanning
        cost = float(cost)
        if cost <= 0.0:
            raise ValueError(
                f"dry-run artifact {path} reports non-positive "
                f"flops_per_env={cost!r} for scenario {name!r}; "
                "re-run the dry-run cell")
        return cost
    return None


def _partition(weights: list[float], total: int, min_envs: int) -> list[int]:
    """Largest-remainder apportionment of `total` into len(weights) parts,
    each >= min_envs; deterministic (ties broken by position)."""
    if total < min_envs * len(weights):
        raise ValueError(f"total_envs={total} cannot give {len(weights)} "
                         f"scenarios >= {min_envs} envs each")
    s = sum(weights)
    raw = [total * w / s for w in weights]
    n = [max(min_envs, math.floor(r)) for r in raw]
    # hand out the remainder by descending fractional part (stable)
    order = sorted(range(len(raw)),
                   key=lambda i: (-(raw[i] - math.floor(raw[i])), i))
    i = 0
    while sum(n) < total:
        n[order[i % len(order)]] += 1
        i += 1
    # floors/minimums may have overshot: shave the largest members back
    while sum(n) > total:
        j = max(range(len(n)), key=lambda i: (n[i] > min_envs, n[i], -i))
        if n[j] <= min_envs:
            raise ValueError("cannot satisfy min_envs")  # unreachable: guarded
        n[j] -= 1
    return n


def build_schedule(named_envs, total_envs: int, *,
                   costs: dict[str, float] | None = None,
                   min_envs: int = 1,
                   artifact_dir: str | None = None,
                   use_artifacts: bool = True) -> FleetSchedule:
    """Partition `total_envs` across `named_envs` ([(name, env), ...]).

    Environments are apportioned inversely to per-env step cost so each
    sub-fleet's total per-iteration device time is balanced; `weight` is
    each member's env share (used by the joint PPO loss).
    """
    named_envs = list(named_envs)
    # Measured (artifact) costs are absolute XLA FLOPs while the static
    # fallback is a DOF-x-substeps proxy — different units.  Use the
    # measurements only when every member WITHOUT an explicit override has
    # one; a partial set would mix units inside one partition and skew the
    # weights arbitrarily.  Explicit `costs` always win (the caller vouches
    # for their consistency).
    measured: dict[str, float] = {}
    if use_artifacts:
        for name, _ in named_envs:
            if (costs or {}).get(name) is None:
                c = dryrun_step_cost(name, artifact_dir)
                if c is not None:
                    measured[name] = c
    needing = {n for n, _ in named_envs if (costs or {}).get(n) is None}
    use_measured = needing and set(measured) == needing
    resolved: dict[str, float] = {}
    for name, env in named_envs:
        c = (costs or {}).get(name)
        if c is None and use_measured:
            c = measured[name]
        if c is None:
            c = static_step_cost(env)
        if c <= 0:
            raise ValueError(f"non-positive step cost for {name!r}: {c}")
        resolved[name] = float(c)
    counts = _partition([1.0 / resolved[n] for n, _ in named_envs],
                        total_envs, min_envs)
    members = tuple(
        SubFleet(name=name, env=env, n_envs=k, weight=k / total_envs,
                 cost=resolved[name])
        for (name, env), k in zip(named_envs, counts))
    return FleetSchedule(members=members)


# --- determinism bookkeeping -------------------------------------------------
_BANK, _ROLLOUT = 1, 2  # one tag per derived seed, so the two never meet


def _derive(tag: int, *values: int) -> int:
    """A 63-bit generator seed hashed from (tag, *values).  Each value is
    two 32-bit words, so every argument tuple is one fixed-length entropy
    (SeedSequence would read a trailing zero word as absent)."""
    words = [tag]
    for v in values:
        v = int(v)
        if not 0 <= v < 2**64:
            raise ValueError(f"seed words must lie in [0, 2**64): {v}")
        words += [v & 0xFFFFFFFF, v >> 32]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def scenario_seed(base_seed: int, index: int) -> int:
    """Distinct, stable per-scenario seed for the initial-state bank: a
    joint hash of (seed, index), so `(s, i+1)` and `(s+7919, i)` differ
    (the former additive stride `base_seed + 7919*(index+1)` collided)."""
    return _derive(_BANK, base_seed, index)


def rollout_seed(base_seed: int, index: int, iteration: int) -> int:
    """The rollout generator's seed for (scenario `index`, `iteration`), a
    pure function of the run seed, so crash replay and checkpoint resume
    regenerate the exact draws (the counterpart of the reference's
    `rollout_key`)."""
    return _derive(_ROLLOUT, base_seed, index, iteration)
