"""Adam(W) as a function on lists of tensors (port of `repro.optim.adam`).

The reference is a pure pytree transform that returns new params and
state.  Here the params are updated in place (a 1.4B-parameter model has no
room for a second copy of its masters); the moments are float32 whatever
the params' dtype, the step count is a device tensor (no host sync), and
the arithmetic follows the reference op for op:

    g  = clip_by_global_norm(g), then float32
    m  = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g g
    delta = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)  [+ wd p]
    p  = p - lr delta                 (in float32, cast back to p's dtype)

Leaves are processed with `torch._foreach_*` in groups of at most
`_GROUP_ELEMENTS` values, which bounds the temporaries.

On a device mesh the leaves are DTensors.  The update is elementwise, so
each rank runs the same chain on its local shards, with the gradients and
the moments first laid out as their parameters (a gradient's pending sum
reduced); only the clip's norm crosses ranks, as a sum of squares over
each leaf's shards (`global_norm`).  A norm over a DTensor holding a
pending (Partial) sum would not be a norm, so such leaves are reduced
first.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_GROUP_ELEMENTS = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = None  # global-norm clip


@dataclasses.dataclass
class AdamState:
    """The step count (int32 scalar) and the float32 moments, one per
    parameter in the params' order."""

    step: torch.Tensor
    m: list[torch.Tensor]
    v: list[torch.Tensor]


def adam_init(params: list[torch.Tensor]) -> AdamState:
    """Zero moments beside `params` (on their devices), step 0."""
    params = list(params)
    device = params[0].device if params else None
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        v=[torch.zeros_like(p, dtype=torch.float32) for p in params])


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every value, in float32.  Over
    DTensors, a plain scalar equal on every rank."""
    if any(isinstance(t, DTensor) for t in tensors):
        return _mesh_norm(tensors)
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def _mesh_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """`global_norm` of DTensors: each rank sums the squares of its shards,
    leaves grouped by the mesh dims they are split over, and each group's
    sum is reduced over those dims only (a replicated value counts once)."""
    groups: dict = {}
    for t in tensors:
        t = _reduced(t)
        split = tuple(j for j, pl in enumerate(t.placements)
                      if isinstance(pl, Shard))
        sq = torch.sum(torch.square(t.to_local().float()))
        groups.setdefault((t.device_mesh, split), []).append(sq)
    total = None
    for (mesh, split), sq in groups.items():
        part = DTensor.from_local(
            torch.stack(sq).sum(), mesh,
            [Partial() if j in split else Replicate()
             for j in range(mesh.ndim)], run_check=False).full_tensor()
        total = part if total is None else total + part
    return torch.sqrt(total)


def _reduced(t: DTensor) -> DTensor:
    """`t` with any pending (Partial) sum reduced."""
    if any(isinstance(pl, Partial) for pl in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if isinstance(pl, Partial) else pl
            for pl in t.placements])
    return t


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x: torch.Tensor, p: DTensor) -> torch.Tensor:
    """`x` laid out as the DTensor `p` (a plain tensor taken as
    replicated)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, p.device_mesh,
                               [Replicate()] * p.device_mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(p.placements):
        x = x.redistribute(p.device_mesh, p.placements)
    return x


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm): the factor of the global-norm clip."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Grads scaled by min(1, max_norm / norm), and the norm."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return [g * scale.to(g.dtype) for g in grads], norm


def _groups(tensors: list[torch.Tensor]) -> list[list[int]]:
    """Indices of `tensors` in order, grouped by dtype and device, each
    group holding at most `_GROUP_ELEMENTS` values (or one tensor)."""
    groups: list[list[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        k = (t.dtype, t.device)
        if not groups or k != key or size + t.numel() > _GROUP_ELEMENTS:
            groups.append([])
            size, key = 0, k
        groups[-1].append(i)
        size += t.numel()
    return groups


@torch.no_grad()
def adam_update(cfg: AdamConfig, params: list[torch.Tensor],
                grads: list[torch.Tensor], state: AdamState,
                lr: torch.Tensor | float | None = None,
                norm: torch.Tensor | None = None
                ) -> tuple[list[torch.Tensor], AdamState]:
    """One Adam(W) step, params and state updated in place; returns them.
    `norm` is the grads' global norm where the caller has it already (the
    clip then does not compute it again)."""
    params, grads = list(params), list(grads)
    if any(isinstance(p, DTensor) for p in params):
        return _mesh_update(cfg, params, grads, state, lr, norm)
    scale = None
    if cfg.grad_clip is not None:  # clip_by_global_norm, group by group
        norm = global_norm(grads) if norm is None else norm
        scale = _clip_scale(norm, cfg.grad_clip)
    state.step.add_(1)
    t = state.step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    lr_t = cfg.lr if lr is None else lr
    for idx in _groups(params):
        p = [params[i] for i in idx]
        g = [grads[i] if scale is None else grads[i] * scale.to(grads[i].dtype)
             for i in idx]
        g = [x.float() for x in g]
        m = [state.m[i] for i in idx]
        v = [state.v[i] for i in idx]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1.0 - cfg.b2), g))
        del g
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_div_(delta, denom)
        del denom
        p32 = p if p[0].dtype == torch.float32 else [x.float() for x in p]
        if cfg.weight_decay:
            torch._foreach_add_(delta, torch._foreach_mul(p32,
                                                          cfg.weight_decay))
        torch._foreach_mul_(delta, lr_t)
        if p32 is p:
            torch._foreach_sub_(p, delta)
        else:
            torch._foreach_sub_(p32, delta)
            torch._foreach_copy_(p, p32)
    return params, state


def _mesh_update(cfg: AdamConfig, params, grads, state: AdamState, lr, norm):
    """`adam_update` of DTensor leaves: the gradients and moments laid out
    as their parameters, then the plain update on every rank's local
    shards, in place.  Moments laid out otherwise (`opt_shardings` with
    rules of their own) are updated in the parameters' layout and written
    back to theirs."""
    if cfg.grad_clip is not None and norm is None:
        norm = global_norm(grads)
    moved = [(m, _like(m, p), v, _like(v, p))
             for m, v, p in zip(state.m, state.v, params)]
    local = AdamState(step=_local(state.step),
                      m=[_local(mp) for _, mp, _, _ in moved],
                      v=[_local(vp) for _, _, _, vp in moved])
    adam_update(cfg, [_local(p) for p in params],
                [_local(_like(g, p)) for g, p in zip(grads, params)], local,
                lr=_local(lr) if isinstance(lr, torch.Tensor) else lr,
                norm=None if norm is None else _local(norm))
    with torch.no_grad():
        for m, mp, v, vp in moved:
            for own, upd in ((m, mp), (v, vp)):
                if upd is not own:
                    own.to_local().copy_(_like(upd, own).to_local())
    return params, state
