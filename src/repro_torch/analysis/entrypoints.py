"""The registry of hot entry points that the op audit runs (the port's
counterpart of `repro.analysis.entrypoints`, entry for entry).

These are the calls whose work on the device IS the product: the solver's
RL-interval advance, the fleet rollout, the PPO and fleet updates, the
fused RHS, the broker's in-place push and the serving step.  `op_audit`
runs each one at a reduced (but structurally faithful) shape under
`dispatch.Recorder` on the CPU and, with `device="cuda"`, again on the
card under `torch.cuda.set_sync_debug_mode`.

Every entry is built lazily (`build(device)`), at shapes small enough that
the whole registry runs in seconds on the CPU: the reference's reduced
meshes, with the advances' RL interval cut to two RK substeps (each
substep repeats the same ops; `_two_substeps`).  The reference's
`jit_fn` / `expect_aliased` / `max_undonated_mb` (donation) become the
in-place declarations `inplace` / `max_fresh_mb`.

Program suppressions live on the entry (`suppress={"RULE": reason}`), and
a sync pin other than 0 carries its reason (`Built.sync_reason`), so
waivers are reviewed code.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Built:
    """One auditable call: `fn(*args)`."""

    fn: Callable
    args: tuple
    # bf16-interval audit (OPS002): inside the call the carried state stays
    # bf16; state-sized f32 -> bf16 demotes fed by elementwise ops are
    # churn (reduction and product accumulators are not)
    bf16_interval: bool = False
    state_size: int = 0            # elements of the carried state
    # OPS003: the host syncs the call may make (its pin), and why
    syncs: int = 0
    sync_reason: str = ""
    # OPS004 / OPS005: `inplace(out)` names the state tensors the call
    # updates in place, as held after it (`out` is the call's result; None
    # before the call); the bytes of outputs in fresh storage may not pass
    # `max_fresh_mb`
    inplace: Callable[[Any], dict] | None = None
    max_fresh_mb: float | None = None
    # calls recorded as one op each, beside the kernels: (owner, attribute,
    # label), see `dispatch.Recorder`
    opaque: tuple = ()


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    build: Callable[[torch.device], Built]
    suppress: dict = dataclasses.field(default_factory=dict)


def _two_substeps(cfg):
    """`cfg` with its RL interval cut to at most two RK substeps."""
    return dataclasses.replace(cfg, dt_rl=2 * cfg.dt)


def _hit_cfg(precision: str = "fp32", use_kernels: bool = False):
    from ..cfd.solver import HITConfig
    return HITConfig(n_poly=3, n_elem=2, t_end=0.5, precision=precision,
                     use_kernels=use_kernels)


def _hit_state(cfg, device: torch.device) -> torch.Tensor:
    from ..cfd import initial
    gen = torch.Generator().manual_seed(0)
    return initial.make_state_bank(gen, cfg, 1)[0].to(device)


def _build_hit_advance(device: torch.device, precision: str,
                       use_kernels: bool = False) -> Built:
    from ..cfd import solver

    cfg = _two_substeps(_hit_cfg(precision, use_kernels))
    u = _hit_state(cfg, device)
    cs = torch.full((cfg.n_elem,) * 3, 0.17, device=device)
    return Built(fn=lambda u, cs: solver.advance_rl_interval(u, cs, cfg),
                 args=(u, cs), bf16_interval=(precision == "bf16"),
                 state_size=u.numel())


def _build_channel_advance(device: torch.device, precision: str,
                           use_kernels: bool = False) -> Built:
    from ..cfd import channel as channel_mod
    from ..cfd.channel import ChannelConfig

    cfg = _two_substeps(ChannelConfig(n_elem=(2, 3, 2), precision=precision,
                                      use_kernels=use_kernels))
    gen = torch.Generator().manual_seed(1)
    u = channel_mod.sample_initial_state(gen, cfg).to(device)
    kx, _, kz = cfg.n_elem
    scale = torch.ones((kx, kz), device=device)
    return Built(
        fn=lambda u, sb, st: channel_mod.advance_rl_interval(u, sb, st, cfg),
        args=(u, scale, scale), bf16_interval=(precision == "bf16"),
        state_size=u.numel())


def _policy(env, device: torch.device):
    from ..core import policy as policy_lib

    pcfg = policy_lib.PolicyConfig.from_specs(env.obs_spec, env.action_spec)
    return policy_lib.Policy(pcfg, torch.Generator().manual_seed(0)).to(
        device)


def _build_rollout(device: torch.device) -> Built:
    from .. import envs
    from ..core import rollout as rollout_lib

    env = envs.make("hit_les_reduced")
    policy = _policy(env, device)
    u0 = env.initial_state_bank(
        torch.Generator(device=device).manual_seed(1), 2)
    gen = torch.Generator(device=device).manual_seed(2)
    return Built(
        fn=lambda u0: rollout_lib.rollout(policy, env, u0, gen=gen),
        args=(u0,))


def _zero_traj(env, n_envs: int, device: torch.device):
    """A zero trajectory with the rollout's structure."""
    from ..fleet.pipeline import traj_template

    return type(traj_template(env, n_envs))(*(
        torch.zeros(t.shape, dtype=t.dtype, device=device)
        for t in traj_template(env, n_envs)))


def _state(policy, opt) -> dict:
    """The parameters and their optimizer state, by name."""
    out = {}
    for name, p in policy.named_parameters():
        out[name] = p
        for k, v in opt.state[p].items():
            out[f"{name}/{k}"] = v
    return out


def _build_ppo_update(device: torch.device) -> Built:
    from .. import envs
    from ..core import ppo as ppo_lib

    env = envs.make("hit_les_reduced")
    policy = _policy(env, device)
    cfg = ppo_lib.PPOConfig()
    opt = ppo_lib.make_optimizer(policy, cfg)
    traj = _zero_traj(env, 2, device)
    return Built(
        fn=lambda traj: ppo_lib.update(policy, opt, cfg, traj),
        args=(traj,),
        # Adam steps the parameters and its moments in place
        inplace=lambda out: _state(policy, opt),
        opaque=((opt, "step", "torch.optim.Adam.step"),))


def _fleet_runner(device: torch.device):
    from ..fleet.pipeline import FleetRunnerConfig, make_fleet_runner

    # the entries never checkpoint: the directory is not made
    return make_fleet_runner(
        ("hit_les_reduced", "burgers_reduced"), total_envs=2,
        run_cfg=FleetRunnerConfig(
            checkpoint_dir=os.path.join(tempfile.gettempdir(),
                                        "repro_torch_audit"),
            async_checkpoint=False), device=device)


def _build_fleet_update(device: torch.device) -> Built:
    runner = _fleet_runner(device)
    trajs = {m.name: _zero_traj(m.env, m.n_envs, device)
             for m in runner.schedule.members}
    return Built(
        fn=lambda trajs: runner._update(trajs, 0),
        args=(trajs,),
        # the parameters and the whole Adam state update in place (the
        # guard keeps them where a stat is not finite, in place too)
        inplace=lambda out: _state(runner.policy, runner.opt),
        max_fresh_mb=8.0,
        opaque=((runner.opt, "step", "torch.optim.Adam.step"),))


def _build_fleet_program(device: torch.device) -> Built:
    runner = _fleet_runner(device)
    seeds = runner._seeds(1)
    return Built(fn=runner.forch.sample_all, args=(seeds,))


def _build_broker_push(device: torch.device) -> Built:
    from ..fleet import broker as broker_lib

    item = {
        "obs": torch.zeros((3, 2, 8, 4, 4, 4, 3), device=device),
        "rewards": torch.zeros((3, 2), device=device),
    }
    ring = broker_lib.ring_init(item, 2)

    def held(out):
        r = ring if out is None else out
        return {"head": r.head, **r.data}

    return Built(fn=broker_lib.push_donated, args=(ring, item),
                 # every ring buffer and the head update in place
                 inplace=held, max_fresh_mb=1.0)


def _build_fused_rhs(device: torch.device) -> Built:
    from ..kernels import rhs as rhs_mod

    cfg = _hit_cfg()
    ops = cfg.operators(device)
    u = _hit_state(cfg, device)
    cs = torch.full(u.shape[:-1], 0.17, device=device)
    return Built(
        fn=lambda u, cs: rhs_mod.fused_navier_stokes_rhs(
            u, cs, ops["D"], ops["w"], inv_w_end=ops["inv_w_end"],
            jac=cfg.dg.jac, delta=cfg.delta_filter, mu=cfg.gas.mu,
            prandtl=cfg.prandtl, prandtl_turb=cfg.prandtl_turb,
            forcing_a0=cfg.forcing_a0, k_tke=cfg.k_tke),
        args=(u, cs))


def _build_serve_step(device: torch.device) -> Built:
    from .. import envs, nn
    from ..fleet import multitask
    from ..serve import service as serve_lib

    name = "hit_les_reduced"
    mcfg = multitask.MultiTaskConfig.from_envs(
        [(n, envs.make(n)) for n in (name, "burgers_reduced")])
    params = nn.ParamTree(
        multitask.init(torch.Generator().manual_seed(0), mcfg)).to(device)
    svc = serve_lib.ControllerService(params, mcfg, capture=False)
    head = mcfg.head(name)
    obs = torch.zeros((2, head.n_elements, *head.spatial, head.channels),
                      device=device)
    n_valid = torch.full((), 2, dtype=torch.int32, device=device)
    stats = svc._stats[name]
    return Built(
        fn=lambda o, n: serve_lib.serve_step(svc.params, mcfg, name, o, n,
                                             stats),
        args=(obs, n_valid),
        # the telemetry counter advances in place; actions and values are
        # real outputs, small at serving shapes
        inplace=lambda out: {"stats": stats}, max_fresh_mb=1.0)


ENTRYPOINTS: tuple[EntryPoint, ...] = (
    EntryPoint("hit_advance", lambda d: _build_hit_advance(d, "fp32")),
    EntryPoint("hit_advance_bf16", lambda d: _build_hit_advance(d, "bf16")),
    EntryPoint("channel_advance",
               lambda d: _build_channel_advance(d, "fp32")),
    EntryPoint("channel_advance_bf16",
               lambda d: _build_channel_advance(d, "bf16")),
    EntryPoint("rollout", _build_rollout),
    EntryPoint("ppo_update", _build_ppo_update),
    EntryPoint("fleet_update", _build_fleet_update),
    # the reference's FleetProgram was folded into the orchestrators'
    # `sample_fleet` (one per sub-fleet, `FleetOrchestrator.sample_all`)
    EntryPoint("fleet_program", _build_fleet_program),
    EntryPoint("broker_push", _build_broker_push),
    EntryPoint("fused_rhs", _build_fused_rhs),
    EntryPoint("serve_step", _build_serve_step),
    # the port's own: the kernel assembly of the two advances (on the card
    # the channel's three component kernels and the fused RHS in bf16)
    EntryPoint("channel_advance_kernels",
               lambda d: _build_channel_advance(d, "fp32", True)),
    EntryPoint("hit_advance_bf16_kernels",
               lambda d: _build_hit_advance(d, "bf16", True)),
)


def get(name: str) -> EntryPoint:
    for e in ENTRYPOINTS:
        if e.name == name:
            return e
    raise KeyError(f"unknown entry point {name!r}; have "
                   f"{tuple(e.name for e in ENTRYPOINTS)}")
