"""Specs and layouts of every (arch x shape) cell's inputs (port of
`repro.launch.specs`).

A cell's parameters, Adam state, batch and decode caches each get a spec
per leaf from the models' logical axes (`models.api.param_axes`,
`cache_axes`, `batch_axes` here) under the rules of a mesh
(`parallel.sharding`).  A spec is a tuple, entry for entry the reference's
`PartitionSpec`; the shape-only trees are tensors on the meta device
(`api.abstract_params`, `abstract_batch`, `api.abstract_caches`), so no
cell allocates.  Leaves are keyed by name: a parameter's `named_parameters`
path, a cache leaf's `lm.flat_names` path.  The reference stacks its layer
groups on a leading axis; the port keeps one tree per layer, so its specs
have no stacked entry.  The same specs lay out the real tensors as DTensors
(`place_params`, `place_opt`, `place_batch`), which `launch/train.py`
trains on.

`lower_cell`, the reference's `.lower()` of a cell's program for the dry
run, belongs with `launch/dryrun.py` and `launch/hlo_analysis.py`, the
slice after this module.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from .. import optim
from ..configs.shapes import ShapeConfig
from ..models import api, lm
from ..models.config import ArchConfig
from ..parallel import sharding as shd


def rules_for(mesh, overrides: dict | None = None) -> shd.AxisRules:
    return shd.AxisRules(mesh, overrides)


def _specs(abstract: dict, axes: dict, rules: shd.AxisRules) -> dict:
    """{name: spec} of a flat {name: tensor} tree and its {name: axes}."""
    return shd.param_specs({k: abstract[k] for k in axes}, axes, rules)


def param_shardings(cfg: ArchConfig, mesh, rules: shd.AxisRules,
                    abstract_params: torch.nn.Module | None = None):
    """(abstract params, {parameter name: spec})."""
    ap = abstract_params if abstract_params is not None else \
        api.abstract_params(cfg)
    return ap, _specs(dict(ap.named_parameters()), api.param_axes(cfg),
                      rules)


def opt_shardings(abstract_params: torch.nn.Module, param_sh: dict, mesh,
                  cfg: ArchConfig | None = None,
                  opt_rules: shd.AxisRules | None = None):
    """(abstract Adam state, its specs): AdamState(step, m, v) with the
    step replicated and the moments, one per parameter in the parameters'
    order, under the parameters' specs, or under `opt_rules` of their
    own (ZeRO-1: replicate the parameters, shard the moments)."""
    plist = list(abstract_params.parameters())
    names = [n for n, _ in abstract_params.named_parameters()]
    abstract_opt = optim.adam_init(plist)
    if opt_rules is not None and cfg is not None:
        moment_sh = _specs(dict(abstract_params.named_parameters()),
                           api.param_axes(cfg), opt_rules)
    else:
        moment_sh = param_sh
    moments = [moment_sh[n] for n in names]
    return abstract_opt, optim.AdamState(step=(), m=list(moments),
                                         v=list(moments))


def batch_axes(cfg: ArchConfig, kind: str) -> dict:
    """Logical axes of the input batch dict."""
    if kind in ("train", "prefill"):
        ax = {"tokens": ("batch", None)}
        if kind == "train":
            ax["labels"] = ("batch", None)
        if cfg.is_encdec:
            ax["frames"] = ("batch", None, None)
        if cfg.vision_dim:
            ax["patches"] = ("batch", None, None)
        return ax
    return {"token": ("batch",)}


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig, kind: str) -> dict:
    """The cell's batch as meta tensors."""
    b, s = shape.global_batch, shape.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    def f32(*dims):
        return torch.empty(dims, dtype=torch.float32, device="meta")

    if kind == "decode":
        return {"token": i32(b)}
    t = s - cfg.vision_tokens if cfg.vision_dim else s
    out = {"tokens": i32(b, t)}
    if kind == "train":
        out["labels"] = i32(b, t)
    if cfg.is_encdec:
        out["frames"] = f32(b, cfg.max_source_positions, cfg.d_model)
    if cfg.vision_dim:
        out["patches"] = f32(b, cfg.vision_tokens, cfg.vision_dim)
    return out


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, kind: str, mesh,
                    rules: shd.AxisRules):
    ab = abstract_batch(cfg, shape, kind)
    return ab, _specs(ab, batch_axes(cfg, kind), rules)


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    rules: shd.AxisRules, dtype=torch.bfloat16):
    """(abstract caches, {cache leaf name: spec}); the decode position is
    a Python int, with no spec."""
    ac = api.abstract_caches(cfg, shape.global_batch, shape.seq_len, dtype)
    flat = lm.flat_names(ac)
    axes = {k: a for k, a in api.cache_axes(cfg).items()
            if isinstance(flat[k], torch.Tensor)}
    return ac, _specs(flat, axes, rules)


# --- the cell programs ---------------------------------------------------------
def train_fn(cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    def step(params, opt_state, batch):
        return api.train_step(params, opt_state, batch, cfg, adam_cfg)
    return step


def prefill_fn(cfg: ArchConfig, cache_len: int):
    def run(params, batch):
        return api.prefill(params, cfg, batch, cache_len=cache_len)
    return run


def serve_fn(cfg: ArchConfig):
    def step(params, token, caches):
        return api.serve_step(params, cfg, token, caches)
    return step


# --- laying real tensors out ----------------------------------------------------
def place_params(params: torch.nn.Module, specs: dict, mesh) -> None:
    """Swap every parameter of `params` (alike on every rank, as a seeded
    init or a restored checkpoint gives them) for the DTensor of its spec,
    keeping `requires_grad`."""
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod.register_parameter(leaf, torch.nn.Parameter(
            shd.distribute(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad))


def place_opt(opt_state: optim.AdamState, opt_specs: optim.AdamState,
              mesh) -> optim.AdamState:
    """Adam's state laid out by `opt_shardings`' specs."""
    return optim.AdamState(
        step=shd.distribute(opt_state.step, opt_specs.step, mesh),
        m=[shd.distribute(x, s, mesh) for x, s in zip(opt_state.m,
                                                     opt_specs.m)],
        v=[shd.distribute(x, s, mesh) for x, s in zip(opt_state.v,
                                                     opt_specs.v)])


def place_batch(batch: dict, specs: dict, mesh) -> dict:
    """A batch (alike on every rank, as a seeded stream gives it) laid out
    by `batch_shardings`' specs, on the mesh's device."""
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return {k: shd.distribute(torch.as_tensor(v).to(dev), specs[k], mesh)
            for k, v in batch.items()}


def full(x: Any) -> Any:
    """The whole tensor of a DTensor (gathered on every rank); `x` itself
    otherwise."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_shapes(tree: dict) -> dict:
    """{name: (local shard shape, spec)} of the DTensors of a flat tree."""
    return {k: (tuple(v.to_local().shape), shd.spec_of(v))
            for k, v in tree.items() if isinstance(v, DTensor)}


__all__ = ["abstract_batch", "batch_axes", "batch_shardings",
           "cache_shardings", "full", "local_shapes",
           "opt_shardings", "param_shardings", "place_batch", "place_opt",
           "place_params", "prefill_fn", "rules_for",
           "serve_fn", "train_fn"]
