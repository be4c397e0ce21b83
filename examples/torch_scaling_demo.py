"""Scaling demo of the PyTorch port (paper Sec. 6.1): weak-scale the
environment fleet on one GPU and show how one batched program amortizes
the per-step launch overhead over the envs.

Each row times one episode of `n_envs` hit_les_reduced envs (all envs of a
step advance in one batched RHS per RK stage): on the GPU with CUDA events,
after one untimed episode of the same shape (the kernels' first launches);
on the CPU with the host clock.  PyTorch compiles nothing ahead, so there
is no compile column.

    PYTHONPATH=src python examples/torch_scaling_demo.py
    PYTHONPATH=src python examples/torch_scaling_demo.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import envs, resolve_device
from repro_torch.core import policy, rollout


def episode_s(pol, env, u0, device: torch.device) -> float:
    """Seconds of one stochastic episode from u0."""
    gen = torch.Generator(device=device).manual_seed(2)
    if device.type != "cuda":
        t0 = time.perf_counter()
        rollout.rollout(pol, env, u0, gen=gen)
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    rollout.rollout(pol, env, u0, gen=gen)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    env = envs.make("hit_les_reduced")
    pcfg = policy.PolicyConfig.from_specs(env.obs_spec, env.action_spec)
    pol = policy.Policy(pcfg, torch.Generator().manual_seed(0)).to(device)
    bank = env.initial_state_bank(
        torch.Generator(device=device).manual_seed(1), 9)

    print(f"{env.n_actions}-step episodes of hit_les_reduced on {device}")
    print(f"{'n_envs':>7} {'episode_s':>10} {'per_env_s':>10} "
          f"{'speedup':>8}")
    t1 = None
    for n in (1, 2, 4, 8):
        u0 = bank[torch.arange(n, device=device) % 8]
        if device.type == "cuda":  # the first launches of the shape
            episode_s(pol, env, u0, device)
        t_run = episode_s(pol, env, u0, device)
        t1 = t1 or t_run
        print(f"{n:7d} {t_run:10.4f} {t_run / n:10.4f} "
              f"{n * t1 / t_run:8.2f}")

    print("\nAcross ranks each env shard is independent (batch axis); split "
          "the fleet over 2 processes with:")
    print("  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 "
          "-m repro_torch.launch.rl_train --env hit_les_24dof")


if __name__ == "__main__":
    main()
