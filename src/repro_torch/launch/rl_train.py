"""The paper's training loop: PPO on a registered environment, on the GPU
(PyTorch port of `repro.launch.rl_train`).

    # paper 24-DOF HIT configuration, 16 parallel environments:
    PYTHONPATH=src python -m repro_torch.launch.rl_train --env hit_les_24dof \
        --n-envs 16 --iterations 4000
    # CPU-scale smoke on the plain PyTorch path:
    PYTHONPATH=src python -m repro_torch.launch.rl_train --reduced \
        --n-envs 2 --iterations 3 --device cpu
"""
from __future__ import annotations

import argparse

from .. import envs
from ..core.orchestrator import FleetConfig
from ..core.ppo import PPOConfig
from ..core.runner import Runner, RunnerConfig


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse `argv` (default: sys.argv), train, return the iteration records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default=None, choices=envs.registered(),
                    help="registered environment name")
    ap.add_argument("--dof", type=int, choices=(24, 32), default=24,
                    help="HIT Table-1 scale (when --env is not given)")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale HIT config (when --env is not given)")
    ap.add_argument("--n-envs", type=int, default=16,
                    help="parallel environments (paper: 16/32/64)")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--checkpoint-dir", default="checkpoints/relexi")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)

    if args.env:
        name = args.env
    elif args.reduced:
        name = "hit_les_reduced"
    else:
        name = f"hit_les_{args.dof}dof"
    env = envs.make(name)
    fleet = FleetConfig(n_envs=args.n_envs, bank_size=max(args.n_envs + 1, 9))
    runner = Runner(
        env, fleet,
        ppo_cfg=PPOConfig(),  # paper Sec. 5.3 defaults
        run_cfg=RunnerConfig(
            n_iterations=args.iterations,
            eval_every=args.eval_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            seed=args.seed,
        ),
        device=args.device,
    )
    print(f"training {name}: {args.iterations} iterations x {args.n_envs} "
          f"envs on {runner.device}")
    history = runner.train()
    last = history[-1] if history else {}
    print(f"finished {len(history)} iterations; "
          f"final return={last.get('return_norm', float('nan')):.4f}")
    return history


if __name__ == "__main__":
    main()
