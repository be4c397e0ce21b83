"""The paper's training loop: PPO on a registered environment, on the GPU
(PyTorch port of `repro.launch.rl_train`).

    # paper 24-DOF HIT configuration, 16 parallel environments:
    PYTHONPATH=src python -m repro_torch.launch.rl_train --env hit_les_24dof \
        --n-envs 16 --iterations 4000
    # CPU-scale smoke on the plain PyTorch path:
    PYTHONPATH=src python -m repro_torch.launch.rl_train --reduced \
        --n-envs 2 --iterations 3 --device cpu
    # the env fleet split over 2 ranks (on one card they share it by gloo):
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.rl_train --env hit_les_24dof --n-envs 16

Under torchrun the ranks form a (data, model) mesh over every rank
(`launch.mesh.make_fleet_mesh`): each rank rolls out its rows of the env
batch, the rows are gathered, and every rank runs the same update; rank 0
writes the checkpoints and the log.  One process runs without a mesh.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from .. import envs, resolve_device
from ..core.orchestrator import FleetConfig
from ..core.ppo import PPOConfig
from ..core.runner import Runner, RunnerConfig
from . import mesh as mesh_lib


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
    device = resolve_device(args.device)
    mesh = None
    if mesh_lib.init_distributed(device=device):
        mesh = mesh_lib.make_fleet_mesh(device=device)
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
        mesh=mesh,
        device=device,
    )
    where = "" if mesh is None else \
        f", rank {dist.get_rank()} of {dist.get_world_size()}"
    print(f"training {name}: {args.iterations} iterations x {args.n_envs} "
          f"envs on {runner.device}{where}")
    history = runner.train()
    last = history[-1] if history else {}
    print(f"finished {len(history)} iterations; "
          f"final return={last.get('return_norm', float('nan')):.4f}")
    return history


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
