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

`lower_cell` is the dry run's cell (`launch/dryrun.py`): the same specs
lay meta shards out as DTensors, and the cell's program runs on them under
a `launch.hlo_analysis.Recorder`.
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
from . import hlo_analysis


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


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               rule_overrides: dict | None = None,
               donate: bool = True,
               opt_rule_overrides: dict | None = None,
               adam_cfg: optim.AdamConfig | None = None):
    """The dry run's counterpart of the reference's `.lower()` of a cell:
    lay the cell's arguments out on `mesh` as DTensors of meta shards (the
    parameters, and Adam's state and the batch for "train"; the batch for
    "prefill"; the token and the caches for "decode"), each by its spec.
    Returns (cell, meta): `cell()` runs the program on them once, under
    the mesh's rules and a `hlo_analysis.Recorder`, and returns the
    Recorder, its `memory` the reference's memory-analysis fields
    (`hlo_analysis.memory_analysis`).  `meta` is the reference's dict.

    The programs are `train_fn` (`api.train_step` with `adam_cfg`, as
    `launch/train.build_train_fn` runs it), `prefill_fn` (cache_len =
    seq_len) and `serve_fn`.  Eager PyTorch updates the parameters, Adam's
    state and the caches in place whatever `donate` says; `donate` says
    whether those outputs count as aliasing their arguments
    (`alias_size_in_bytes`), as XLA's donation does.  Nothing is
    allocated: a cell whose program reaches a kernel wrapper raises there
    (meta tensors have no kernel), so the LM cells of the dry run use the
    plain forms (`attn_impl` / `scan_impl` "chunked")."""
    rules = rules_for(mesh, rule_overrides)
    opt_rules = (rules_for(mesh, opt_rule_overrides)
                 if opt_rule_overrides is not None else None)
    rec = hlo_analysis.Recorder(mesh)
    ap, p_sh = param_shardings(cfg, mesh, rules)
    replace_params(ap, lambda name, p: rec.distribute(p, p_sh[name], mesh))
    ab, b_sh = batch_shardings(cfg, shape, shape.kind, mesh, rules)
    batch = {k: rec.distribute(v, b_sh[k], mesh) for k, v in ab.items()}
    donated: tuple = ()
    if shape.kind == "train":
        ao, o_sh = opt_shardings(ap, p_sh, mesh, cfg, opt_rules)
        opt = optim.AdamState(
            step=rec.distribute(ao.step, o_sh.step, mesh),
            m=[rec.distribute(x, s, mesh) for x, s in zip(ao.m, o_sh.m)],
            v=[rec.distribute(x, s, mesh) for x, s in zip(ao.v, o_sh.v)])
        fn, args = train_fn(cfg, adam_cfg), (ap, opt, batch)
        donated = (ap, opt) if donate else ()
    elif shape.kind == "prefill":
        fn, args = prefill_fn(cfg, shape.seq_len), (ap, batch)
    else:
        ac, c_sh = cache_shardings(cfg, shape, mesh, rules)
        caches = _map_leaves(ac, lambda name, x: rec.distribute(
            x, c_sh[name], mesh) if isinstance(x, torch.Tensor) else x)
        fn, args = serve_fn(cfg), (ap, batch["token"], caches)
        donated = (caches,) if donate else ()

    def cell() -> hlo_analysis.Recorder:
        with rec.run(), shd.on_mesh(mesh, rule_overrides):
            out = fn(*args)
        rec.memory = hlo_analysis.memory_analysis(
            rec, _operands(args), _operands(out), _operands(donated))
        return rec

    meta = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
            "mesh": dict(shd.mesh_axis_sizes(mesh))}
    return cell, meta


def _operands(tree):
    """`tree` with each module replaced by its parameters and each
    `AdamState` by its (step, m, v): the tensors a cell takes or gives."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, optim.AdamState):
        return [tree.step, tree.m, tree.v]
    if isinstance(tree, (list, tuple)):
        return [_operands(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _operands(v) for k, v in tree.items()}
    return tree


def _map_leaves(tree, fn, prefix: str = ""):
    """`tree` (nested dicts and lists) with each leaf replaced by
    `fn(name, leaf)`, named as `lm.flat_names` names it."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


# --- laying real tensors out ----------------------------------------------------
def replace_params(module: torch.nn.Module, make) -> None:
    """Swap every parameter `p` of `module`, named `name`, for
    `make(name, p)`, keeping `requires_grad`."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod.register_parameter(leaf, torch.nn.Parameter(
            make(name, p.detach()), requires_grad=p.requires_grad))


def place_params(params: torch.nn.Module, specs: dict, mesh) -> None:
    """Swap every parameter of `params` (alike on every rank, as a seeded
    init or a restored checkpoint gives them) for the DTensor of its spec,
    keeping `requires_grad`."""
    replace_params(params, lambda name, p: shd.distribute(p, specs[name],
                                                          mesh))


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
           "cache_shardings", "full", "local_shapes", "lower_cell",
           "opt_shardings", "param_shardings", "place_batch", "place_opt",
           "place_params", "prefill_fn", "replace_params", "rules_for",
           "serve_fn", "train_fn"]
