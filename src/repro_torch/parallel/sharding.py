"""Logical-axis sharding: rules map logical array axes to mesh axes (port
of `repro.parallel.sharding`).

Model code never names mesh axes; it annotates values with *logical* axes
("batch", "seq", "heads", "mlp", "experts", ...) through `constrain`.  A
rules context binds logical to physical for the current mesh, with the
reference's divisibility fallback: a logical axis whose dimension does not
divide its mesh-axis product is left unsharded (hymba's 25 heads on a
2-way model axis), and a mesh axis serves at most one dim of an array.

A spec is a tuple with one entry per dim: None, an axis name or a tuple of
names, entry for entry the reference's `PartitionSpec`.  On a
`DeviceMesh` it becomes DTensor placements (`placements`): a dim named by
a mesh axis is `Shard(dim)` on that mesh dim, every other mesh dim
`Replicate()`.  The port's counterpart of a NamedSharding is a DTensor
with those placements; `constrain` redistributes a DTensor to them, as
GSPMD lays a value out by its constraint.  The mesh itself is a
`DeviceMesh` with named dims, or `abstract_mesh`'s shape-only stand-in
(specs need only the axis sizes).

Default rule set (the reference's):

    batch    -> ("pod", "data")     activations / env fleet
    embed    -> "data"              FSDP on the weight's d_model axis
    heads    -> "model"             attention-head parallel
    kv_heads -> "model"
    mlp      -> "model"             FFN hidden tensor-parallel
    experts  -> "model"             expert parallel
    vocab    -> "model"             embedding/logit shard
    seq      -> None
    kv_seq   -> "model"             decode KV caches, sequence-sharded
    act_seq  -> "model"             the stored residual stream
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "seq": None,
    "kv_seq": "model",   # decode KV caches: sequence-shard over `model`
    "act_seq": "model",  # stored residual stream (Megatron-style SP)
    "state": None,
}

Spec = tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes only (the reference's
    `AbstractMesh`): specs, shardings and dry runs need no devices.
    `shape` is an {axis name: size} dict, as `core.collectives.mesh_shape`
    reads it."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]
                  ) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


class AxisRules:
    def __init__(self, mesh, rules: dict[str, Any] | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.sizes = mesh_axis_sizes(mesh) if mesh is not None else {}

    def mesh_axes(self, logical: str | None):
        if logical is None:
            return None
        return self.rules.get(logical)


_state = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any] | None = None):
    """Bind logical->mesh rules for the model code run inside the block."""
    prev = current_rules()
    _state.rules = AxisRules(mesh, rules)
    try:
        yield _state.rules
    finally:
        _state.rules = prev


def _axis_size(sizes: dict[str, int], axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(sizes[a] for a in axes)


def logical_to_spec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                    rules: AxisRules) -> Spec:
    """Spec of `shape` under `rules`, dropping non-divisible axes and axes
    an earlier dim of the array already uses."""
    assert len(shape) == len(logical), (shape, logical)
    if rules.mesh is None:
        return ()
    spec = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        axes = rules.mesh_axes(name)
        if axes is None:
            spec.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t
                       if a not in used and a in rules.sizes)
        if not axes_t or dim % _axis_size(rules.sizes, axes_t) != 0:
            spec.append(None)
            continue
        used.update(axes_t)
        spec.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    return tuple(spec)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on a `DeviceMesh` with named dims: a
    tensor dim named by mesh axes is `Shard(dim)` on each of them (a dim
    over several axes takes them in mesh order, major first, as a
    PartitionSpec's tuple does), every other mesh dim `Replicate()`.  A
    mesh dim of size 1 is `Replicate()` whatever the spec: the same layout,
    and DTensor's view rules get the backward of a reshape wrong on a
    `Shard` over one rank (a local tensor strided unlike its global)."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def spec_of(x: DTensor) -> Spec:
    """The spec of a DTensor's placements (inverse of `placements` for
    Shard/Replicate placements)."""
    names = tuple(x.device_mesh.mesh_dim_names)
    spec: list = [None] * x.ndim
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            cur = spec[pl.dim]
            spec[pl.dim] = name if cur is None else (
                (cur,) if isinstance(cur, str) else cur) + (name,)
    return trim(tuple(spec))


def trim(spec: Spec) -> Spec:
    """`spec` without its trailing None entries: ("data", None) and
    ("data",) lay a tensor out alike (a JAX NamedSharding may report
    either)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def constrain(x, *logical: str | None):
    """Lay `x` out by its logical axes; `x` itself without a rules context
    or a mesh.  Under a `DeviceMesh`, a DTensor is redistributed to the
    spec's placements (Partial sums reduce, shards gather or split); a
    plain tensor raises, since a silent pass would hide a model that left
    the mesh.  An `AbstractMesh` places nothing."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    if not hasattr(rules.mesh, "mesh_dim_names"):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{logical}: a plain {type(x).__name__} of shape "
            f"{tuple(x.shape)} under a device mesh; the model left the mesh")
    want = placements(logical_to_spec(tuple(x.shape), logical, rules),
                      rules.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def param_specs(params: Any, logical_axes: Any, rules: AxisRules) -> Any:
    """Specs of a parameter tree: `params` and `logical_axes` are nested
    dicts (lists) of the same structure, the axes a tuple of logical names
    per leaf (see the models' `param_axes`) or None for a replicated leaf.
    A leaf is anything with a `shape`."""
    if isinstance(params, dict) or (hasattr(params, "keys")
                                    and not hasattr(params, "shape")):
        if not isinstance(logical_axes, dict) or \
                set(logical_axes) != set(params.keys()):
            raise ValueError(f"params keys {sorted(params.keys())} and "
                             f"logical axes {logical_axes} differ")
        return {k: param_specs(params[k], logical_axes[k], rules)
                for k in params.keys()}
    if isinstance(params, (list, tuple)) and not hasattr(params, "shape"):
        if len(params) != len(logical_axes):
            raise ValueError(f"{len(params)} params, {len(logical_axes)} axes")
        return [param_specs(p, a, rules) for p, a in zip(params,
                                                          logical_axes)]
    if logical_axes is None:
        return ()
    return logical_to_spec(tuple(params.shape), tuple(logical_axes), rules)


def mesh_of(*xs):
    """The device mesh of the first DTensor among `xs`, else None."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def distribute(x: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """`x` as a DTensor of `spec` on `mesh`.  A plain tensor is one that
    every rank holds alike (a seeded init, a restored checkpoint, a batch
    made from a seed): each rank keeps its own shard, with no
    communication.  A DTensor is redistributed."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements(spec, mesh))


def place(x: torch.Tensor, *logical: str | None):
    """A plain tensor that every rank holds alike (a fresh cache or
    state), laid out by its logical axes under the current rules
    (`distribute`); `x` itself without a rules context or device mesh."""
    rules = current_rules()
    if rules is None or rules.mesh is None or \
            not hasattr(rules.mesh, "mesh_dim_names"):
        return x
    return distribute(x, logical_to_spec(tuple(x.shape), logical, rules),
                      rules.mesh)


@dataclasses.dataclass(frozen=True)
class Roles:
    """Where an operand of a shard-local function keeps its batch and head
    dims (None: it has none); a head dim may stay sharded only where each
    rank's piece holds whole blocks of `block` values (a flat H x hd dim
    holds whole heads)."""

    batch: int | None = 0
    heads: int | None = None
    block: int = 1


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over the mesh dims
    `dims`: `local_map` hands a replicated operand's gradient back as
    replicated, but each rank computed it from its own batch rows or
    heads only."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.mesh, ctx.layout = x.device_mesh, tuple(x.placements)
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pl = tuple(Partial() if j in ctx.dims else p
                   for j, p in enumerate(ctx.layout))
        g = DTensor.from_local(g.to_local(), ctx.mesh, pl, run_check=False,
                               shape=g.shape, stride=g.stride())
        return g.redistribute(ctx.mesh, ctx.layout), None


def local_map_roles(fn, args: tuple, roles: tuple, out_roles: tuple):
    """Run `fn` on each rank's local shards of its DTensor operands, under
    `torch.distributed.tensor.experimental.local_map`.

    Each mesh dim keeps the layout of the first operand where that is a
    shard of its batch dim, or of its head dim in whole blocks, and every
    operand is brought to it: sharded on its own batch (head) dim, or
    replicated where it has none.  Any other layout (a sharded sequence, a
    Partial sum, heads that do not split into whole blocks) is replicated
    first.  So a kernel sees whole sequences and whole heads, each rank
    its batch rows and heads.  `roles` has one `Roles` (or None for a
    non-tensor) per operand, `out_roles` one per output of `fn`.  Without
    a DTensor operand `fn` runs as it is."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    lead, lead_roles = next((a, r) for a, r in zip(args, roles)
                            if isinstance(a, DTensor))

    def fits(a, r, dim, j, kind):
        if dim is None:
            return True
        if kind == "heads":
            piece = a.shape[dim] // mesh.shape[j]
            return a.shape[dim] % mesh.shape[j] == 0 and \
                piece % r.block == 0
        return a.shape[dim] % mesh.shape[j] == 0

    kinds = []
    for j, pl in enumerate(lead.placements):
        kind = None
        if isinstance(pl, Shard) and mesh.shape[j] > 1:
            if pl.dim == lead_roles.batch:
                kind = "batch"
            elif pl.dim == lead_roles.heads:
                kind = "heads"
        if kind and not all(fits(a, r, getattr(r, kind), j, kind)
                            for a, r in zip(args, roles)
                            if isinstance(a, torch.Tensor)):
            kind = None
        kinds.append(kind)

    def target(r):
        return tuple(Shard(getattr(r, k)) if k and getattr(r, k) is not None
                     else Replicate() for k in kinds)

    in_pl, moved = [], []
    for a, r in zip(args, roles):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            moved.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = target(r)
        in_pl.append(want)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        # an operand whole on every rank of a split mesh dim gets each
        # rank's share of the gradient there: a sum still to be made
        summed = tuple(j for j, k in enumerate(kinds)
                       if k and isinstance(want[j], Replicate))
        if summed and a.requires_grad:
            a = _SumGrad.apply(a, summed)
        moved.append(a)
    out_pl = tuple(None if r is None else target(r) for r in out_roles)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     device_mesh=mesh)(*moved)


def unflatten(x: torch.Tensor, dim: int, sizes: tuple[int, ...]):
    """`x.unflatten(dim, sizes)` (a flat H x hd dim into heads).  A DTensor
    sharded on `dim` in pieces that do not hold whole `sizes[0]` rows (25
    heads over 2 ranks) is replicated on that dim first: DTensor's view
    rule refuses an uneven unflatten."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        dim = dim % x.ndim
        want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim
                     and sizes[0] % mesh.shape[j] else pl
                     for j, pl in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
    return x.unflatten(dim, sizes)


class _GradLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    was laid out."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.layout = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.layout:
            g = g.redistribute(ctx.mesh, ctx.layout)
        return g


def grad_layout(x: torch.Tensor) -> torch.Tensor:
    """`x`, and in the backward pass its gradient redistributed to `x`'s
    placements.  A product's gradient comes back laid out by the weight
    (an output projection's rows split over heads); where the heads were
    replicated for an uneven split, the backward of the reshape that
    merged them needs the gradient so too.  `x` itself off a mesh."""
    if not isinstance(x, DTensor):
        return x
    return _GradLayout.apply(x)


@contextlib.contextmanager
def on_mesh(mesh, rules: dict[str, Any] | None = None):
    """`axis_rules(mesh, rules)`, with plain tensors that meet DTensors in
    an op (masks, position tables, scalars) read as replicated
    (`implicit_replication`).  Without a mesh only the rules bind."""
    with axis_rules(mesh, rules) as bound:
        if mesh is None or not hasattr(mesh, "mesh_dim_names"):
            yield bound
            return
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            yield bound
