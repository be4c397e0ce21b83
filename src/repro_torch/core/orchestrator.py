"""Environment orchestrator (PyTorch port of `repro.core.orchestrator`).

It owns the fleet size and the initial-state bank, which lives on the device
(generated once by the env's `initial_state_bank` hook, indexed per episode:
the RAM-disk trick of the paper's Relexi taken to its endpoint).  Episode i
of iteration k is determined by (seed, k, bank index), so a failed iteration
can be re-run from the same inputs.

With a `mesh` (`launch/mesh.py`) the env batch splits over the mesh axes
`FleetConfig.env_axes`: the mesh's first rank builds the bank and every
rank gets its copy by broadcast; bank indices and action noise are drawn at the real
env count from the iteration's generator, identically on every rank, and
padded to a multiple of the shard count (pad rows replay bank row 0 with
zero noise); each rank rolls out its contiguous rows, and the rows are
gathered and sliced back to the real count before GAE sees them.

With `FleetConfig.elem_axis` each env is also split by its first element
axis over that mesh axis (the paper's several ranks per environment; x for
HIT and the channel, the only axis for Burgers): the env becomes
`env.split_x(ElemSplit)` over the axis's group, each rank of a group takes
its slabs of the rows it draws, and the policy, the trajectory and the
update stay whole and replicated over the group.
Without a mesh the axis has one rank: the split assembly with no
exchange.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import resolve_device
from ..envs.base import Env, as_env
from . import collectives, elastic
from . import policy as policy_lib
from . import ppo as ppo_lib
from . import rollout as rollout_lib


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_envs: int = 16          # parallel environments (paper: 16/32/64...1024)
    bank_size: int = 17       # initial states; last one is the held-out test
    # the mesh axes the env batch splits over, and the one each env's
    # first element axis splits over (None: not split)
    env_axes: tuple[str, ...] = ("data",)
    elem_axis: str | None = None


class Orchestrator:
    """Owns the env fleet, the state bank and the fleet programs.

    `sample_fleet` and `evaluate` take the policy per call: any module with
    `distribution` and `value`, a `Policy` built from `pcfg` (the env's
    spec-derived configuration) or a scenario head of the fleet's
    multitask policy.  With a `mesh`, every rank must make the same calls
    (the bank's broadcast and the rollout's gather are collectives)."""

    def __init__(self, env: Env, fleet: FleetConfig, *, mesh=None,
                 seed: int = 0, device: str | torch.device | None = None):
        env = as_env(env)  # a bare HITConfig coerces here
        self.split = None
        if fleet.elem_axis is not None:
            env = self._split_env(env, fleet, mesh)
        self.env = env
        self.fleet = fleet
        self.mesh = mesh
        self.device = resolve_device(device)
        self.pcfg = policy_lib.PolicyConfig.from_specs(env.obs_spec,
                                                       env.action_spec)
        self.n_shards = collectives.axes_size(mesh, fleet.env_axes)
        self.b_pad = collectives.padded(fleet.n_envs, self.n_shards)
        self.group, self.shard = (None, 0) if mesh is None else \
            collectives.axes_group(mesh, fleet.env_axes)
        # host seconds spent in the rollouts' gathers, and the bytes this
        # rank received in them
        self.gather_s = 0.0
        self.gather_bytes = 0

        def make_bank():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return env.initial_state_bank(gen, fleet.bank_size)

        # index -1 is the unseen test state
        self.bank = elastic.replicate(make_bank, mesh, self.device)

    def _split_env(self, env: Env, fleet: FleetConfig, mesh) -> Env:
        """`env` split by its first element axis over the ranks of
        `fleet.elem_axis` (`self.split`)."""
        split_x = getattr(env, "split_x", None)
        if split_x is None:
            raise TypeError(f"FleetConfig.elem_axis: {type(env).__name__} "
                            f"has no split_x")
        if fleet.elem_axis in fleet.env_axes:
            raise ValueError(f"elem_axis {fleet.elem_axis!r} is also an env "
                             f"axis {fleet.env_axes}")
        size = collectives.axes_size(mesh, (fleet.elem_axis,))
        group, rank = (None, 0) if size == 1 else \
            collectives.axes_group(mesh, (fleet.elem_axis,))
        self.split = collectives.ElemSplit(group, rank, size)
        return split_x(self.split)

    def local(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's part of whole states: its slabs on a split env."""
        return u if self.split is None else self.env.slab(u)

    def draw_initial_states(self, gen: torch.Generator,
                            n_envs: int | None = None) -> torch.Tensor:
        """Random bank rows (excluding the held-out test state), (B, ...)."""
        if n_envs is not None and n_envs <= 0:
            raise ValueError(
                f"n_envs must be a positive environment count, got {n_envs} "
                "(pass None for the configured fleet size)")
        n = self.fleet.n_envs if n_envs is None else n_envs
        idx = torch.randint(0, self.fleet.bank_size - 1, (n,), generator=gen,
                            device=self.device)
        return self.bank[idx]

    def draw_padded_inputs(self, gen: torch.Generator
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """(u0, noise) of one rollout, padded to `b_pad` rows.  Drawn at
        the real env count from `gen` in the order of `draw_initial_states`
        + `rollout`, so the real rows are those of an unsharded rollout
        from the same generator; pad rows replay bank row 0 with zero
        noise.  On a split env u0 is this rank's slabs of the rows; the
        noise is the whole env's."""
        n = self.fleet.n_envs
        pad = self.b_pad - n
        idx = torch.randint(0, self.fleet.bank_size - 1, (n,), generator=gen,
                            device=self.device)
        noise = torch.randn((self.env.n_actions, n)
                            + self.env.action_spec.shape, generator=gen,
                            device=self.device)
        if pad:
            idx = torch.cat([idx, idx.new_zeros(pad)])
            noise = torch.cat([noise, noise.new_zeros(
                (noise.shape[0], pad) + noise.shape[2:])], dim=1)
        return self.local(self.bank[idx]), noise

    def sample_fleet(self, policy: policy_lib.Policy,
                     gen: torch.Generator) -> ppo_lib.Trajectory:
        """One synchronous sampling pass over the whole fleet: this rank's
        rows, gathered over the env shards, sliced to the real count."""
        u0, noise = self.draw_padded_inputs(gen)
        rows = self.b_pad // self.n_shards
        mine = slice(self.shard * rows, (self.shard + 1) * rows)
        traj = rollout_lib.rollout(policy, self.env, u0[mine],
                                   noise=noise[:, mine])
        if self.group is None:
            return traj
        t0 = time.perf_counter()
        traj = rollout_lib.gather_traj(traj, self.group)
        self.gather_s += time.perf_counter() - t0
        self.gather_bytes += sum(
            x.numel() * x.element_size() * (self.n_shards - 1)
            // self.n_shards for x in traj)
        return rollout_lib.slice_traj(traj, self.fleet.n_envs)

    def test_state(self) -> torch.Tensor:
        """The single held-out initial state, batched to (1, ...)."""
        return self.bank[-1:]

    def evaluate(self, policy: policy_lib.Policy) -> float:
        """Deterministic (mean-action) episode on the held-out state ->
        normalized return, as the paper's test-state curve in Fig. 5."""
        traj = rollout_lib.rollout(policy, self.env,
                                   self.local(self.test_state()),
                                   deterministic=True)
        return float(rollout_lib.normalized_return(traj)[0])
