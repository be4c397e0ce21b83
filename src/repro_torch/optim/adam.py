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
"""
from __future__ import annotations

import dataclasses

import torch

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
    """sqrt of the sum of squares of every value, in float32."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


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
