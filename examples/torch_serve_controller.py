"""Serve trained eddy-viscosity controllers of the PyTorch port from the
newest fleet checkpoint, on the GPU.

The serving half of the HPC story: training (`fleet/pipeline.py`) leaves a
checkpoint of the multitask policy; this example restores only the policy
from it (`repro_torch.serve.load_service`), then answers a batch of
observation requests for two scenarios through the bucketed dispatch layer
(one CUDA graph per scenario and bucket on the GPU): the deterministic
greedy actions a solver would consume.

Self-contained: when the checkpoint directory is empty, a short reduced
fleet run is trained first to produce one.

    PYTHONPATH=src python examples/torch_serve_controller.py
    PYTHONPATH=src python examples/torch_serve_controller.py --requests 5 \\
        --checkpoint-dir checkpoints/fleet
    PYTHONPATH=src python examples/torch_serve_controller.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import envs, fleet, resolve_device, serve
from repro_torch.core import checkpoints
from repro_torch.fleet.pipeline import FleetRunnerConfig

SCENARIOS = ("hit_les_reduced", "burgers_reduced")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint-dir", default="checkpoints/torch_serve_demo")
    ap.add_argument("--requests", type=int, default=3,
                    help="observation requests per scenario")
    ap.add_argument("--train-iters", type=int, default=2,
                    help="reduced training iterations when no checkpoint "
                         "exists")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if checkpoints.latest_step(args.checkpoint_dir) is None:
        print(f"no checkpoint under {args.checkpoint_dir!r}: training "
              f"{args.train_iters} reduced fleet iterations first")
        runner = fleet.make_fleet_runner(
            SCENARIOS, total_envs=4,
            run_cfg=FleetRunnerConfig(
                n_iterations=args.train_iters, eval_every=100,
                checkpoint_every=args.train_iters, async_checkpoint=False,
                checkpoint_dir=args.checkpoint_dir, bank_size=4),
            device=device)
        runner.train(resume=False)

    svc = serve.load_service(args.checkpoint_dir, device=device)
    print(f"serving scenarios {svc.scenarios} from step "
          f"{checkpoints.latest_step(args.checkpoint_dir)} on {device}")

    # real observations: reset each scenario's env from a fresh state bank
    # and observe, what a coupled solver would send over the wire
    uids = {}
    for name in svc.scenarios:
        env = envs.make(name)
        bank = env.initial_state_bank(
            torch.Generator(device=device).manual_seed(0), args.requests + 1)
        for i in range(args.requests):
            _, obs = env.reset_from_bank(
                bank, torch.tensor(i, device=device))
            uids[svc.submit(name, obs.cpu().numpy())] = name

    t0 = time.perf_counter()
    results = svc.flush()
    dt = time.perf_counter() - t0

    for uid, name in uids.items():
        res = results[uid]
        a = res.action
        print(f"  req {uid} [{name}] -> action[{a.shape[0]} elems] "
              f"mean={a.mean():.4f} min={a.min():.4f} max={a.max():.4f} "
              f"value={res.value:+.4f}")
    print(f"answered {len(results)} requests in {dt * 1e3:.1f} ms "
          f"({len(results) / dt:,.0f} req/s, each bucket's first dispatch "
          f"included: on the GPU its CUDA graph capture)")
    print(f"telemetry: {svc.stats()}")


if __name__ == "__main__":
    main()
