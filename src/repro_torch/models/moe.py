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
device (no host read, no loop over tokens).

On a device mesh the reference's constraints lay the groups out over
"batch" and the slots over "experts" (expert parallelism).  The index
plumbing has no DTensor rule, so it runs under `local_map` on each rank's
groups (`_fill_slots`, `_read_slots`), and so does the experts' SwiGLU
(`_expert_ffn`, each rank its experts, the weights' d_model shard
gathered: DTensor's einsum gets the backward's views wrong there).

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
from ..parallel import sharding
from ..parallel.sharding import Roles, local_map_roles
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


def param_axes(cfg: ArchConfig) -> dict:
    ax = {
        "router": {"w": ("embed", None)},
        "wg": ("experts", "embed", "mlp"),
        "wi": ("experts", "embed", "mlp"),
        "wo": ("experts", "mlp", "embed"),
    }
    if cfg.n_shared_experts:
        ax["shared"] = {
            "wg": {"w": ("embed", "mlp")},
            "wi": {"w": ("embed", "mlp")},
            "wo": {"w": ("mlp", "embed")},
        }
    return ax


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
    # the sequence gathered first where it is split (as `nn.dense` does):
    # torch 2.11's DTensor refuses to flatten a split inner dim
    x = nn.gathered_rows(x)
    return sharding.constrain(x.reshape(tokens // group, group, d),
                              "batch", None, None)


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


def _fill_slots(cfg: ArchConfig, xg: torch.Tensor, idx: torch.Tensor):
    """Groups xg (G, T, D) and their choices idx (G, T, k) -> (the rows of
    every expert slot (G, E C, D), zero where no token came; each choice's
    slot (G, T, k))."""
    n_g, t, d = xg.shape
    e, cap = cfg.n_experts, _capacity(t, cfg)
    slot, _ = _dispatch(cfg, idx, t)
    rows = torch.arange(n_g, device=xg.device)[:, None]
    # the token that fills each slot (t, the zero row, where none does);
    # dropped choices all land in the discarded column e * cap
    src = torch.full((n_g, e * cap + 1), t, dtype=torch.int64,
                     device=xg.device)
    tok = torch.arange(t, device=xg.device)[None, :, None].expand_as(slot)
    src.scatter_(1, slot.reshape(n_g, -1), tok.reshape(n_g, -1))
    zero = torch.zeros((n_g, 1, d), dtype=xg.dtype, device=xg.device)
    return torch.cat([xg, zero], dim=1)[rows, src[:, :e * cap]], slot


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor):
    """The routed experts' SwiGLU on their slots: xe (G, E, C, D) ->
    (G, E, C, D), in xe's dtype."""
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, wg.to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, wi.to(dt))
    return (torch.einsum("gecf,efd->gecd", F.silu(h) * u, wo.to(dt)),)


def _read_slots(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor):
    """Each token's choices back from the expert outputs ye (G, E, C, D),
    weighted by their gates (a dropped choice reads zero) -> (G, T, D)."""
    n_g, e, cap, d = ye.shape
    t = slot.shape[1]
    dt = ye.dtype
    rows = torch.arange(n_g, device=ye.device)[:, None]
    zero = torch.zeros((n_g, 1, d), dtype=dt, device=ye.device)
    ye = torch.cat([ye.reshape(n_g, e * cap, d), zero], dim=1)
    picked = ye[rows, slot.reshape(n_g, -1)].reshape(n_g, t, -1, d)
    out = torch.sum(gates.to(dt).float()[..., None] * picked.float(), dim=2)
    return (out.to(dt),)


def experts(p, cfg: ArchConfig, x: torch.Tensor, gates: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """The routed and shared experts for given routing: x (B, S, D), gates
    and idx (G, T, k) over `_groups(cfg, x)` -> (B, S, D) in x's dtype."""
    xg = _groups(cfg, x)
    n_g, t, d = xg.shape
    e, cap = cfg.n_experts, _capacity(t, cfg)
    # the slot plumbing is per group: on a mesh each rank fills and reads
    # its own groups' slots (`local_map`), the experts run sharded
    g_rows = Roles(0)
    xe, slot = local_map_roles(lambda *a: _fill_slots(cfg, *a), (xg, idx),
                               (g_rows, g_rows), (g_rows, g_rows))
    xe = sharding.constrain(xe.reshape(n_g, e, cap, d),
                            "batch", "experts", None, None)
    # each rank runs its groups through its experts (expert parallel)
    experts_ax, weights_ax = Roles(0, 1), Roles(None, 0)
    ye, = local_map_roles(_expert_ffn, (xe, p["wg"], p["wi"], p["wo"]),
                          (experts_ax, weights_ax, weights_ax, weights_ax),
                          (experts_ax,))
    ye = sharding.constrain(ye, "batch", "experts", None, None)
    out, = local_map_roles(_read_slots, (ye, slot, gates),
                           (g_rows, g_rows, g_rows), (g_rows,))
    out = out.reshape(x.shape)
    if cfg.n_shared_experts:
        sh, dt = p["shared"], x.dtype
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
