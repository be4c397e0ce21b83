"""Quickstart of the PyTorch port: the paper's RL-CFD loop through the env
registry, on the GPU.

Any registered scenario (the paper's 3-D HIT-LES, the 1-D Burgers control
problem, or the wall-modeled channel flow, velocity-only or with the
wall pressure) trains through the same few lines:

    from repro_torch import envs
    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner

    env = envs.make("hit_les_reduced")   # or "burgers_reduced", "channel_wm"
    runner = Runner(env, FleetConfig(n_envs=4, bank_size=9))
    history = runner.train()

This script does that for every scenario family at smoke scale (or one
scenario of your choice via --env), then looks under the hood: the
spec-built policy and one fleet rollout.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --env channel_wm_reduced
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import envs, resolve_device
from repro_torch.core import policy, rollout
from repro_torch.core.orchestrator import FleetConfig
from repro_torch.core.runner import Runner, RunnerConfig

SMOKE_SCENARIOS = ("hit_les_reduced", "burgers_reduced", "channel_wm_reduced",
                   "channel_wm_p_reduced")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default=None, choices=envs.registered(),
                    help="train one registered scenario instead of the "
                         "reduced smoke set")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("registered environments:", ", ".join(envs.registered()))

    # 1. Train every scenario family through the identical runner code path.
    for name in ((args.env,) if args.env else SMOKE_SCENARIOS):
        env = envs.make(name)
        runner = Runner(
            env, FleetConfig(n_envs=2, bank_size=4),
            run_cfg=RunnerConfig(n_iterations=3, eval_every=2,
                                 checkpoint_every=10,
                                 checkpoint_dir=f"checkpoints/"
                                                f"torch_quickstart_{name}",
                                 async_checkpoint=False),
            device=device)
        history = runner.train(resume=False)
        returns = [f"{r['return_norm']:+.3f}" for r in history]
        print(f"{name}: obs {env.obs_spec.shape} "
              f"[{','.join(env.obs_spec.channel_names)}] "
              f"act {env.action_spec.shape} "
              f"T={env.n_actions} -> returns {' '.join(returns)}")

    # 2. Under the hood: the policy comes from the env's declarative specs
    #    (the paper's Table-2 Conv3D stack for HIT; the same plan in 1-D for
    #    Burgers), and one episode of the whole fleet is one batched loop of
    #    observe -> policy -> env.step over all envs at once.
    env = envs.make("hit_les_reduced")
    pcfg = policy.PolicyConfig.from_specs(env.obs_spec, env.action_spec)
    pol = policy.Policy(pcfg, torch.Generator().manual_seed(0)).to(device)
    print(f"\npolicy parameters: {policy.param_count(pol):,} "
          f"(paper-scale N=5 has 3,294; tests/test_torch_training.py pins "
          f"Table 2)")
    u0 = env.initial_state_bank(torch.Generator(device=device).manual_seed(1),
                                4)
    traj = rollout.rollout(pol, env, u0, gen=torch.Generator(
        device=device).manual_seed(2))
    print(f"sampled fleet: T={traj.rewards.shape[0]} steps x "
          f"B={traj.rewards.shape[1]} envs, mean return="
          f"{float(torch.mean(torch.sum(traj.rewards, 0))):.3f}")
    print("(train longer with: python -m repro_torch.launch.rl_train "
          "--env hit_les_24dof)")


if __name__ == "__main__":
    main()
