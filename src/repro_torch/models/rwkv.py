"""RWKV-6 "Finch" blocks, rwkv6-1.6b's mixer and FFN (port of
`repro.models.rwkv`): an attention-free linear RNN with data-dependent
decay (Peng et al. 2024, arXiv:2404.05892).

Time mix:    token-shift interpolation with a data-dependent mix (a low-
             rank "lora"), r/k/v/gate projections, a per-channel data-
             dependent decay w_t = exp(-exp(decay_t)), the bonus u of the
             current token, and the WKV recurrence through
             `kernels.ops.gated_linear_scan` with decay_before_read=False
             (the RWKV read of S_{t-1}): the CUDA kernel on a CUDA tensor
             for `scan_impl="kernel"`, its chunked instance at prefill and
             in training, its step instance at decode.
Channel mix: a token-shifted squared-ReLU MLP with a receptance gate.

The bonus is per head, and the scan takes one (dk,) u, so the scan runs
with an explicit zero u and the bonus (r . (u_h * k)) v is added outside,
as the reference does.  The zero must be explicit: the reference's kernel
path passes u = 0, while its plain forms read u=None as no scaling and so
would count the current token's k v a second time (ROADMAP, queue C).

Dtypes follow the reference: the mixes and the decay are float32 (JAX
promotes x against the float32 lora products), r, k, v and the gate keep
x's dtype, w is float32, the WKV state float32 (B, H, hd, hd).  The decode
carry is {wkv state, time-mix shift (B, D), channel-mix shift (B, D)}.

On a device mesh the WKV recurrence and its group norm (`_wkv`) run under
`local_map` on each rank's batch rows and whole heads, as the SSM's scan.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import nn
from ..kernels import ops as kops
from ..parallel import sharding
from ..parallel.sharding import Roles, local_map_roles
from .config import ArchConfig

_MIX_KEYS = ("r", "k", "v", "w", "g")


def _dims(cfg: ArchConfig) -> tuple[int, int]:
    """(heads, head dim) of the WKV state."""
    return cfg.d_model // cfg.hd, cfg.hd


def init_time_mix(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    _, hd = _dims(cfg)
    lora, dlora, n_mix = cfg.rwkv_lora, cfg.rwkv_decay_lora, len(_MIX_KEYS)
    normal = nn.normal_init(1.0 / math.sqrt(d))
    return {
        # token-shift base mixes + the low-rank data-dependent part
        "mix_base": torch.full((n_mix, d), 0.5),
        "mix_lora_a": {"w": normal(gen, (d, n_mix * lora))},
        "mix_lora_b": normal(gen, (n_mix, lora, d)),
        "wr": {"w": normal(gen, (d, d))},
        "wk": {"w": normal(gen, (d, d))},
        "wv": {"w": normal(gen, (d, d))},
        "wg": {"w": normal(gen, (d, d))},
        "decay_base": torch.full((d,), -6.0),   # w ~ exp(-exp(-6))
        "decay_lora_a": {"w": normal(gen, (d, dlora))},
        "decay_lora_b": {"w": normal(gen, (dlora, d))},
        "u_bonus": torch.zeros((d,)),
        "out_norm": nn.layernorm_init(hd),      # per-head group norm
        "wo": {"w": normal(gen, (d, d))},
    }


def init_channel_mix(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5),
        "mix_r": torch.full((d,), 0.5),
        "wk": {"w": nn.normal_init(1.0 / math.sqrt(d))(gen, (d, f))},
        "wv": {"w": nn.normal_init(1.0 / math.sqrt(f))(gen, (f, d))},
        "wr": {"w": nn.normal_init(1.0 / math.sqrt(d))(gen, (d, d))},
    }


def time_mix_axes(cfg: ArchConfig) -> dict:
    return {
        "mix_base": (None, "embed"),
        "mix_lora_a": {"w": ("embed", None)},
        "mix_lora_b": (None, None, "embed"),
        "wr": {"w": ("embed", "heads")},
        "wk": {"w": ("embed", "heads")},
        "wv": {"w": ("embed", "heads")},
        "wg": {"w": ("embed", "heads")},
        "decay_base": ("embed",),
        "decay_lora_a": {"w": ("embed", None)},
        "decay_lora_b": {"w": (None, "embed")},
        "u_bonus": ("embed",),
        "out_norm": {"scale": (None,), "bias": (None,)},
        "wo": {"w": ("heads", "embed")},
    }


def channel_mix_axes(cfg: ArchConfig) -> dict:
    return {
        "mix_k": ("embed",),
        "mix_r": ("embed",),
        "wk": {"w": ("embed", "mlp")},
        "wv": {"w": ("mlp", "embed")},
        "wr": {"w": ("embed", "heads")},
    }


def state_axes() -> dict:
    return {"wkv": ("batch", "heads", None, None),
            "shift_t": ("batch", "embed"),
            "shift_c": ("batch", "embed")}


def init_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    h, hd = _dims(cfg)
    ax = state_axes()
    return {
        "wkv": sharding.place(torch.zeros((batch, h, hd, hd), device=device),
                              *ax["wkv"]),
        "shift_t": sharding.place(torch.zeros((batch, cfg.d_model),
                                              dtype=dtype, device=device),
                                  *ax["shift_t"]),
        "shift_c": sharding.place(torch.zeros((batch, cfg.d_model),
                                              dtype=dtype, device=device),
                                  *ax["shift_c"]),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None
                 ) -> torch.Tensor:
    """x_{t-1} along the sequence; position 0 sees `prev` (or zeros)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, H * hd) -> (B * H, T, hd), contiguous as the kernel takes it."""
    b, t, _ = x.shape
    return x.reshape(b, t, h, -1).transpose(1, 2).reshape(b * h, t, -1) \
        .contiguous()


def time_mix(p, cfg: ArchConfig, x: torch.Tensor,
             wkv_state: torch.Tensor | None, shift: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV6 time mixing.  x (B, T, D) -> (out, wkv_state', shift')."""
    b, t, d = x.shape
    h, hd = _dims(cfg)
    f32 = torch.float32
    xs = _token_shift(x, shift)
    delta = (xs - x).float()

    # data-dependent token-shift mixes (one per r/k/v/w/g), float32; on a
    # mesh DTensor may split the 5 x lora dim where 5 mixes do not split,
    # forward and backward (the gradient comes back laid out as `la`)
    la = torch.tanh(nn.dense(p["mix_lora_a"], x, dtype=f32))
    la = sharding.grad_layout(
        sharding.unflatten(la, 2, (len(_MIX_KEYS), cfg.rwkv_lora)))
    # the einsum flattens (b, t) forward and backward: a split sequence is
    # gathered first (torch 2.11's DTensor refuses to flatten it)
    dyn = nn.rows_gathered_grad(torch.einsum(
        "btml,mld->btmd", nn.gathered_rows(la), p["mix_lora_b"].float()))
    mixes = p["mix_base"].float()[None, None] + dyn               # (B,T,5,D)
    xi = x.float()[:, :, None, :] + mixes * delta[:, :, None, :]
    xr, xk, xv, xw, xg = (xi[:, :, i, :].to(x.dtype)
                          for i in range(len(_MIX_KEYS)))

    r = nn.dense(p["wr"], xr, dtype=x.dtype)
    k = nn.dense(p["wk"], xk, dtype=x.dtype)
    v = nn.dense(p["wv"], xv, dtype=x.dtype)
    g = F.silu(nn.dense(p["wg"], xg, dtype=x.dtype))
    decay = p["decay_base"].float()[None, None] + nn.dense(
        p["decay_lora_b"],
        torch.tanh(nn.dense(p["decay_lora_a"], xw, dtype=f32)), dtype=f32)
    w = torch.exp(-torch.exp(decay))                              # in (0, 1)

    # on a mesh, each rank scans its batch rows and whole heads
    ax = Roles(0, 2, hd)
    o, s_fin = local_map_roles(
        lambda *a: _wkv(cfg, *a), (r, k, v, w, p["u_bonus"], wkv_state,
                                   p["out_norm"]["scale"],
                                   p["out_norm"]["bias"]),
        (ax, ax, ax, ax, Roles(None, 0, hd), Roles(0, 1),
         Roles(None), Roles(None)), (ax, Roles(0, 1)))
    o = (o * g).to(x.dtype)
    out = nn.dense(p["wo"], o, dtype=x.dtype)
    shift_dtype = shift.dtype if shift is not None else x.dtype
    return out, s_fin, x[:, -1].to(shift_dtype)


def _wkv(cfg: ArchConfig, r, k, v, w, u_bonus, wkv_state, norm_scale,
         norm_bias):
    """The WKV recurrence and its per-head group norm on (a rank's) whole
    heads: r, k, v, w (B, T, H hd) flat, u_bonus (H hd,), the state (B, H,
    hd, hd) or None -> (normed o (B, T, H hd), final state)."""
    b, t, d = r.shape
    hd = cfg.hd
    h = d // hd
    q_, k_, v_, w_ = (_heads(a, h) for a in (r, k, v, w))
    s0 = wkv_state.reshape(b * h, hd, hd) if wkv_state is not None else None
    # o_t = r (S_{t-1} + diag(u_h) k v^T) = scan(u = 0) + (r . (u_h k)) v
    zero_u = torch.zeros((hd,), device=r.device)
    o, s_fin = kops.gated_linear_scan(
        q_, k_, v_, w_, zero_u, s0, decay_before_read=False,
        impl=cfg.scan_impl, chunk=cfg.scan_chunk)
    u_bh = u_bonus.reshape(1, h, 1, hd).expand(b, h, 1, hd) \
        .reshape(b * h, 1, hd)
    o = o + torch.sum(q_ * (u_bh * k_), dim=-1, keepdim=True) * v_

    o = o.reshape(b, h, t, hd).transpose(1, 2)                    # (B,T,H,hd)
    o = nn.layernorm({"scale": norm_scale, "bias": norm_bias}, o)  # group norm
    return o.reshape(b, t, d), s_fin.reshape(b, h, hd, hd)


def channel_mix(p, cfg: ArchConfig, x: torch.Tensor,
                shift: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel mixing (squared-ReLU MLP with receptance gate)."""
    xs = _token_shift(x, shift)
    xk = x + p["mix_k"].to(x.dtype) * (xs - x)
    xr = x + p["mix_r"].to(x.dtype) * (xs - x)
    kk = torch.square(F.relu(nn.dense(p["wk"], xk, dtype=x.dtype)))
    vv = nn.dense(p["wv"], kk, dtype=x.dtype)
    r = torch.sigmoid(nn.dense(p["wr"], xr, dtype=x.dtype))
    shift_dtype = shift.dtype if shift is not None else x.dtype
    return r * vv, x[:, -1].to(shift_dtype)
