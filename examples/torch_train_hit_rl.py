"""End-to-end driver of the PyTorch port: train the paper's RL turbulence
model (Fig. 5) on the GPU.

Runs the fault-tolerant training loop of `repro_torch` (fleet rollout, PPO
update, evaluation on the held-out state every 10 iterations, checkpoints),
then sets the trained dynamic-C_s model beside the paper's two static
baselines on the same held-out state.  `--model M` splits every env over
M ranks by its x-slabs (`FleetConfig(elem_axis="model")`): run it under
torchrun with a multiple of M processes.

    PYTHONPATH=src python examples/torch_train_hit_rl.py --env hit_les_24dof
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        examples/torch_train_hit_rl.py --env hit_les_24dof --model 2
    PYTHONPATH=src python examples/torch_train_hit_rl.py --device cpu
"""
import argparse

import torch.distributed as dist

from repro_torch import envs, resolve_device
from repro_torch.core.orchestrator import FleetConfig
from repro_torch.core.ppo import PPOConfig
from repro_torch.core.rollout import constant_action_return
from repro_torch.core.runner import Runner, RunnerConfig
from repro_torch.launch import mesh as mesh_lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="hit_les_reduced",
                    choices=[n for n in envs.registered()
                             if n.startswith("hit_les")])
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--n-envs", type=int, default=4)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks each env is split over by its x-slabs")
    ap.add_argument("--checkpoint-dir", default="checkpoints/example_rl_torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    mesh = None
    if mesh_lib.init_distributed(device=device):
        mesh = mesh_lib.make_fleet_mesh(model=args.model, device=device)
    elif args.model != 1:
        raise SystemExit("--model > 1 needs torchrun with that many ranks")
    runner = Runner(
        envs.make(args.env),
        FleetConfig(n_envs=args.n_envs, bank_size=args.n_envs + 5,
                    elem_axis="model" if args.model > 1 else None),
        ppo_cfg=PPOConfig(),  # paper Sec. 5.3: gamma .995, lr 1e-4, 5 epochs
        run_cfg=RunnerConfig(n_iterations=args.iterations, eval_every=10,
                             checkpoint_every=20,
                             checkpoint_dir=args.checkpoint_dir),
        mesh=mesh, device=device)
    say = print if mesh is None or dist.get_rank() == 0 else (
        lambda *a, **k: None)
    say(f"training {args.env}: {args.iterations} iterations x "
        f"{args.n_envs} envs on {runner.device}")
    history = runner.train()  # resumes from --checkpoint-dir if it can
    if history:
        say(f"\nreturn (normalized): first={history[0]['return_norm']:.4f} "
            f"last={history[-1]['return_norm']:.4f}")

    # every rank runs the episodes: on a split env they exchange faces
    orch = runner.orch
    rl_eval = orch.evaluate(runner.policy)
    u0 = orch.local(orch.test_state())
    smag = constant_action_return(orch.env, u0, 0.17)
    impl = constant_action_return(orch.env, u0, 0.0)
    say("\n=== held-out test state (paper Fig. 5 bottom) ===")
    say(f"  RL dynamic coefficient : {rl_eval:.4f}")
    say(f"  static C=0.17 baseline : {smag:.4f}")
    say(f"  implicit LES C=0       : {impl:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
