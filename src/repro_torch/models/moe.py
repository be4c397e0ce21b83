"""Mixture-of-experts FFN, deepseek-moe-16b's and moonshot-v1-16b-a3b's
(port of `repro.models.moe`).

Fine-grained MoE: `n_experts` routed SwiGLU experts with top-k gating plus
`n_shared_experts` always-on shared experts (DeepSeekMoE, Dai et al.
2024).  Tokens are blocked into groups of `moe_group_size`; inside a group
each expert has `_capacity` slots, filled k-major (every token's first
choice claims a slot before any second choice), each choice in token
order.  A choice beyond its expert's capacity is dropped: the token keeps
its other choices, the shared experts and the residual.  This is the
reference's dispatch, slot for slot.

The reference dispatches through dense one-hot (G, T, E, C) tensors and
einsums; here the same slots are index gathers: each kept (token, choice)
pair owns slot `expert * C + position`, each slot reads its token's row
(a zero row where no token came), and each token gathers its choices'
expert outputs back, weighted by their gates.  Routing stays on the
device (no host read, no loop over tokens).  The reference's sharding
constraints (expert parallelism) have no counterpart on one device.

`apply` = `route` + `experts`: the router (float32 logits, softmax, top-k,
renormalised gates where `norm_topk`, the Switch load-balance loss and
the router z-loss) and the expert part, which takes any (gates, indices),
so a test can feed the reference's routing into the port's experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import nn
from .config import ArchConfig


def _capacity(group_size: int, cfg: ArchConfig) -> int:
    """Slots per expert in a group: ceil(T k factor / E), rounded up to a
    multiple of 8 and at least 8 (the reference's TPU tiling)."""
    cap = int(math.ceil(group_size * cfg.top_k * cfg.moe_capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    normal = nn.normal_init(1.0 / math.sqrt(d))
    p = {
        "router": {"w": normal(gen, (d, e))},
        "wg": normal(gen, (e, d, f)),
        "wi": normal(gen, (e, d, f)),
        "wo": nn.normal_init(1.0 / math.sqrt(f))(gen, (e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "wg": {"w": normal(gen, (d, fs))},
            "wi": {"w": normal(gen, (d, fs))},
            "wo": {"w": nn.normal_init(1.0 / math.sqrt(fs))(gen, (fs, d))},
        }
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot of idx over n classes, by comparison (`F.one_hot`
    reads the indices' range back to the host on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _groups(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (G, T, D), T = min(moe_group_size, B S) tokens a group."""
    b, s, d = x.shape
    tokens = b * s
    group = min(cfg.moe_group_size, tokens)
    if tokens % group:
        raise ValueError(f"{tokens} tokens do not split into MoE groups of "
                         f"{group}")
    return x.reshape(tokens // group, group, d)


def _route(p, cfg: ArchConfig, x: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: x (G, T, D) -> (gates (G, T, k) float32, experts (G, T, k)
    int64, aux losses (2,): load balance, z)."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch load-balance loss: E * sum_e f_e * P_e (f = token fraction of
    # the first choice, P = mean router prob); the z-loss keeps the logits
    # small
    e = cfg.n_experts
    f_e = _one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    lb_loss = e * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, idx, torch.stack([lb_loss, z_loss])


def _dispatch(cfg: ArchConfig, idx: torch.Tensor, group_size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot of each (token, choice) of a group: idx (G, T, k) ->
    (slot (G, T, k), keep (G, T, k)).  A kept choice of expert e at
    position p (its rank among the group's tokens routed to e, earlier
    choices first) has slot e * C + p; a dropped one (p >= C) slot E * C,
    the zero row past the buffers."""
    e, cap = cfg.n_experts, _capacity(group_size, cfg)
    fill = torch.zeros((idx.shape[0], 1, e), dtype=torch.int64,
                       device=idx.device)       # per-expert fill so far
    slots, keeps = [], []
    for k in range(idx.shape[-1]):
        oh = _one_hot(idx[..., k], e)                           # (G, T, E)
        pos = torch.cumsum(oh, dim=1) - oh + fill
        fill = fill + oh.sum(dim=1, keepdim=True)
        pos_k = torch.gather(pos, -1, idx[..., k:k + 1])[..., 0]
        keep = pos_k < cap
        slots.append(torch.where(keep, idx[..., k] * cap + pos_k, e * cap))
        keeps.append(keep)
    return torch.stack(slots, dim=-1), torch.stack(keeps, dim=-1)


def experts(p, cfg: ArchConfig, x: torch.Tensor, gates: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """The routed and shared experts for given routing: x (B, S, D), gates
    and idx (G, T, k) over `_groups(cfg, x)` -> (B, S, D) in x's dtype."""
    xg = _groups(cfg, x)
    n_g, t, d = xg.shape
    e, cap = cfg.n_experts, _capacity(t, cfg)
    slot, _ = _dispatch(cfg, idx, t)
    rows = torch.arange(n_g, device=x.device)[:, None]
    # the token that fills each slot (t, the zero row, where none does);
    # dropped choices all land in the discarded column e * cap
    src = torch.full((n_g, e * cap + 1), t, dtype=torch.int64,
                     device=x.device)
    tok = torch.arange(t, device=x.device)[None, :, None].expand_as(slot)
    src.scatter_(1, slot.reshape(n_g, -1), tok.reshape(n_g, -1))
    zero = torch.zeros((n_g, 1, d), dtype=x.dtype, device=x.device)
    xe = torch.cat([xg, zero], dim=1)[rows, src[:, :e * cap]]
    xe = xe.reshape(n_g, e, cap, d)
    dt = x.dtype
    h = torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["wo"].to(dt))
    # each token's choices back, weighted by their gates (dropped: zero)
    ye = torch.cat([ye.reshape(n_g, e * cap, d), zero], dim=1)
    picked = ye[rows, slot.reshape(n_g, -1)].reshape(n_g, t, -1, d)
    out = torch.sum(gates.to(dt).float()[..., None] * picked.float(), dim=2)
    out = out.to(dt).reshape(x.shape)
    if cfg.n_shared_experts:
        sh = p["shared"]
        hs = F.silu(nn.dense(sh["wg"], x, dtype=dt)) * nn.dense(
            sh["wi"], x, dtype=dt)
        out = out + nn.dense(sh["wo"], hs, dtype=dt)
    return out


def route(p, cfg: ArchConfig, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_route` over the groups of x (B, S, D)."""
    return _route(p, cfg, _groups(cfg, x))


def apply(p, cfg: ArchConfig, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN.  x (B, S, D) -> (out (B, S, D), aux (2,) losses)."""
    gates, idx, aux = route(p, cfg, x)
    return experts(p, cfg, x, gates, idx), aux
