"""LM training entry point (PyTorch port of `repro.launch.train`), for any
registered architecture (`repro_torch.configs.ARCH_NAMES`) on one device.

    # hymba-1.5b at full width and depth on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 3 --batch 2 --seq 4096
    # rwkv6-1.6b, the reference launcher's default arch, on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 3 --batch 2 --seq 1024
    # smoke scale on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \
        --batch 2 --seq 32 --device cpu

Float32 master parameters, compute in `cfg.dtype`, Adam with a global-norm
clip of 1.0.  Checkpoints (atomic, integrity-checked) carry the params, the
optimizer state and the token stream's cursor; `--resume` restarts from
the newest complete one and replays the same batches.  It trains on one
device: the LM's mesh (tensor and data parallelism, sharded optimizer
state) is not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import configs, optim, resolve_device
from ..core import checkpoints
from ..core.runner import _copy_into
from ..data import TokenStream
from ..models import api


def state_tree(params, opt_state: optim.AdamState) -> dict:
    """What a checkpoint holds: params and Adam's step and moments, keyed
    by parameter name."""
    names = [name for name, _ in params.named_parameters()]
    return {"params": dict(params.named_parameters()),
            "opt": {"step": opt_state.step,
                    "m": dict(zip(names, opt_state.m)),
                    "v": dict(zip(names, opt_state.v))}}


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse `argv` (default: sys.argv), train, return one record a step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="checkpoints/lm")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    device = resolve_device(args.device)
    adam_cfg = optim.AdamConfig(lr=args.lr, grad_clip=1.0)
    params = api.init(cfg, seed=args.seed, device=device)
    opt_state = optim.adam_init(list(params.parameters()))
    stream = TokenStream(cfg, args.batch, args.seq, seed=args.seed)
    start = 0

    ckpt_dir = os.path.join(args.checkpoint_dir, cfg.name)
    if args.resume:
        step = checkpoints.latest_step(ckpt_dir)
        if step is not None:
            live = state_tree(params, opt_state)
            tree, manifest = checkpoints.restore(ckpt_dir, step, live)
            _copy_into(live, tree)
            stream.load_state_dict(manifest["meta"]["stream"])
            start = int(manifest["meta"]["step"])
            print(f"resumed from step {start}")

    history = []
    for k in range(start, args.steps):
        batch = stream.next()
        t0 = time.perf_counter()
        params, opt_state, metrics = api.train_step(params, opt_state, batch,
                                                    cfg, adam_cfg)
        metrics = {key: float(v) for key, v in metrics.items()}  # syncs
        dt = time.perf_counter() - t0
        tput = args.batch * args.seq / dt
        print(f"step {k:5d} loss={metrics['loss']:.4f} "
              f"grad={metrics['grad_norm']:.3f} {dt * 1e3:8.1f} ms  "
              f"{tput:,.0f} tok/s", flush=True)
        history.append({"step": k, "step_s": dt, "tokens_per_s": tput,
                        **metrics})
        if (k + 1) % args.checkpoint_every == 0 or k + 1 == args.steps:
            checkpoints.save(
                ckpt_dir, k + 1, state_tree(params, opt_state),
                meta={"step": k + 1, "stream": stream.state_dict(),
                      "arch": cfg.name})
    print("done")
    return history


if __name__ == "__main__":
    main()
