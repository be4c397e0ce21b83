"""LM training entry point (PyTorch port of `repro.launch.train`), for any
registered architecture (`repro_torch.configs.ARCH_NAMES`), on one device
or, under torchrun, over a (data, model) mesh of every rank.

    # hymba-1.5b at full width and depth on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 3 --batch 2 --seq 4096
    # rwkv6-1.6b, the reference launcher's default arch, on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 3 --batch 2 --seq 1024
    # smoke scale on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \
        --batch 2 --seq 32 --device cpu
    # whisper-tiny over 2 ranks (tensor parallel, model = 2):
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch whisper-tiny --steps 2 \
        --batch 2 --seq 4096

Float32 master parameters, compute in `cfg.dtype`, Adam with a global-norm
clip of 1.0.  Checkpoints (atomic, integrity-checked) carry the params, the
optimizer state and the token stream's cursor; `--resume` restarts from
the newest complete one and replays the same batches.

Under torchrun with more than one rank, `main` trains on
`launch/mesh.make_host_mesh()` (`build_train_fn`, the reference's): the
parameters and Adam's moments are DTensors under `specs.param_shardings`
/ `opt_shardings` (the step replicated), each batch under
`batch_shardings`, and the model runs on them under the reference's
logical-axis rules (`parallel.sharding`), updated in place (the
reference donates both).  A checkpoint holds whole tensors (rank 0 writes
them), so it restores on any mesh shape or on one device.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

import torch.distributed as dist

from .. import configs, optim, resolve_device
from ..core import checkpoints
from ..core.runner import _copy_into
from ..data import TokenStream
from ..models import api
from ..parallel import sharding as shd
from . import mesh as mesh_lib, specs


def state_tree(params, opt_state: optim.AdamState) -> dict:
    """What a checkpoint holds: params and Adam's step and moments, keyed
    by parameter name; whole tensors (a DTensor is gathered: every rank
    of its mesh must call this)."""
    names = [name for name, _ in params.named_parameters()]
    full = specs.full
    return {"params": {n: full(p) for n, p in params.named_parameters()},
            "opt": {"step": full(opt_state.step),
                    "m": dict(zip(names, map(full, opt_state.m))),
                    "v": dict(zip(names, map(full, opt_state.v)))}}


def build_train_fn(cfg, mesh, adam_cfg: optim.AdamConfig,
                   rule_overrides: dict | None = None):
    """(step(params, opt_state, batch), param specs, opt specs) of training
    on `mesh` (the reference's `build_train_fn`): the step runs
    `api.train_step` under the mesh's rules, in place."""
    rules = specs.rules_for(mesh, rule_overrides)
    ap, p_sh = specs.param_shardings(cfg, mesh, rules)
    _, o_sh = specs.opt_shardings(ap, p_sh, mesh)

    def step(params, opt_state, batch):
        with shd.on_mesh(mesh, rule_overrides):
            return api.train_step(params, opt_state, batch, cfg, adam_cfg)
    return step, p_sh, o_sh


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
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL ranks under torchrun (default: "
                         "launch.mesh's split of the world)")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    device = resolve_device(args.device)
    adam_cfg = optim.AdamConfig(lr=args.lr, grad_clip=1.0)
    mesh = None
    if mesh_lib.init_distributed(device=device):
        shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh \
            else None
        mesh = mesh_lib.make_host_mesh(device=device, shape=shape)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
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

    if mesh is None:
        def train(params, opt_state, batch):
            return api.train_step(params, opt_state, batch, cfg, adam_cfg)
    else:
        train, p_sh, o_sh = build_train_fn(cfg, mesh, adam_cfg)
        specs.place_params(params, p_sh, mesh)
        opt_state = specs.place_opt(opt_state, o_sh, mesh)
        _, b_sh = specs.batch_shardings(
            cfg, configs.ShapeConfig("train", args.seq, args.batch, "train"),
            "train", mesh, specs.rules_for(mesh))
    rank0 = mesh is None or dist.get_rank() == 0

    history = []
    for k in range(start, args.steps):
        batch = stream.next()
        if mesh is not None:
            batch = specs.place_batch(batch, b_sh, mesh)
        t0 = time.perf_counter()
        params, opt_state, metrics = train(params, opt_state, batch)
        metrics = {key: float(specs.full(v))  # syncs
                   for key, v in metrics.items()}
        dt = time.perf_counter() - t0
        tput = args.batch * args.seq / dt
        if rank0:
            print(f"step {k:5d} loss={metrics['loss']:.4f} "
                  f"grad={metrics['grad_norm']:.3f} {dt * 1e3:8.1f} ms  "
                  f"{tput:,.0f} tok/s", flush=True)
        history.append({"step": k, "step_s": dt, "tokens_per_s": tput,
                        **metrics})
        if (k + 1) % args.checkpoint_every == 0 or k + 1 == args.steps:
            tree = state_tree(params, opt_state)
            if rank0:
                checkpoints.save(
                    ckpt_dir, k + 1, tree,
                    meta={"step": k + 1, "stream": stream.state_dict(),
                          "arch": cfg.name})
            if mesh is not None:
                dist.barrier()
    if rank0:
        print("done")
    return history


if __name__ == "__main__":
    main()
