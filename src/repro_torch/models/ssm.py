"""Mamba-2-style selective SSM head mixer, hymba-1.5b's SSM branch (port of
`repro.models.ssm`).

Per head h with head dim P and state size N:

    S_t = exp(-softplus(a_h) * dt_t) * S_{t-1} + dt_t * B_t x_t^T     (N, P)
    y_t = C_t @ S_t + D_h * x_t

a gated-linear-attention read with q=C, k=B*dt, a per-head decay w_t
broadcast over N, plus a skip D and an output gate z (SiLU).  The recurrence
runs through `kernels.ops.gated_linear_scan` (decay_before_read=True): the
CUDA kernel on a CUDA tensor for `scan_impl="kernel"`, in prefill over the
prompt and in decode with T=1.  The depthwise causal conv (width d_conv)
carries its last d_conv-1 inputs between calls.

Dtypes follow the reference: the dt projection is float32 (x is promoted,
as JAX promotes a bf16 x against an f32 weight), so k = B * dt and w are
float32 while q and v keep x's dtype; the skip and the gate promote to
float32 where the scan output is float32, then cast back to x's dtype.

On a device mesh the per-head part (`_heads_scan`: the heads' reshapes,
the scan, the skip) runs under `local_map` on each rank's batch rows and
whole heads: the scan flattens the heads into its batch, which DTensor
cannot lay out; heads that do not split evenly (hymba's 25 over 2 ranks)
are replicated first.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..kernels import ops as kops
from ..parallel import sharding
from ..parallel.sharding import Roles, local_map_roles
from .config import ArchConfig


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_heads, head_dim, d_inner) of the SSM branch."""
    return cfg.n_heads, cfg.hd, cfg.n_heads * cfg.hd


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, _, d_in = _dims(cfg)
    n = cfg.ssm_state
    normal = nn.normal_init(1.0 / math.sqrt(d))
    return {
        "wx": {"w": normal(gen, (d, d_in))},
        "wz": {"w": normal(gen, (d, d_in))},
        "wb": {"w": normal(gen, (d, h * n))},
        "wc": {"w": normal(gen, (d, h * n))},
        "wdt": {"w": normal(gen, (d, h)),
                "b": torch.as_tensor(np.log(np.expm1(
                    np.geomspace(1e-3, 0.1, h))), dtype=torch.float32)},
        "a_log": torch.zeros((h,)),     # softplus(a) = log1p(e^0) ~ 0.69
        "d_skip": torch.ones((h,)),
        "conv": {"w": nn.normal_init(1.0 / math.sqrt(cfg.d_conv))(
            gen, (cfg.d_conv, d_in))},
        "wo": {"w": nn.normal_init(1.0 / math.sqrt(d_in))(gen, (d_in, d))},
    }


def param_axes(cfg: ArchConfig) -> dict:
    return {
        "wx": {"w": ("embed", "heads")},
        "wz": {"w": ("embed", "heads")},
        "wb": {"w": ("embed", "heads")},
        "wc": {"w": ("embed", "heads")},
        "wdt": {"w": ("embed", "heads"), "b": ("heads",)},
        "a_log": ("heads",),
        "d_skip": ("heads",),
        "conv": {"w": (None, "heads")},
        "wo": {"w": ("heads", "embed")},
    }


def state_axes() -> dict:
    return {"s": ("batch", "heads", None, None),
            "conv": ("batch", None, "heads")}


def init_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Decode-time carry: SSM state + conv tail."""
    h, p, d_in = _dims(cfg)
    ax = state_axes()
    return {
        "s": sharding.place(torch.zeros((batch, h, cfg.ssm_state, p),
                                        device=device), *ax["s"]),
        "conv": sharding.place(torch.zeros((batch, cfg.d_conv - 1, d_in),
                                           dtype=dtype, device=device),
                               *ax["conv"]),
    }


def _causal_conv(p, x: torch.Tensor, tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq in x's dtype.  x: (B, T, D_in).
    Returns (conv(x), new_tail (B, d_conv-1, D_in), a copy)."""
    w = p["w"].to(x.dtype)  # (K, D_in)
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(k))
    return out, xp[:, xp.shape[1] - (k - 1):].clone()


def _branch_inputs(params, cfg: ArchConfig, x: torch.Tensor,
                   conv_tail: torch.Tensor | None):
    """Shared pre-scan computation.  x: (B, T, D) -> the scan's inputs
    with their heads flat: xin (B, T, H P), z, bmat and cmat (B, T, H N),
    dt and w (B, T, H), and the new conv tail."""
    xin = nn.dense(params["wx"], x, dtype=x.dtype)
    xin, new_tail = _causal_conv(params["conv"], xin, conv_tail)
    xin = F.silu(xin)
    z = F.silu(nn.dense(params["wz"], x, dtype=x.dtype))
    bmat = nn.dense(params["wb"], x, dtype=x.dtype)
    cmat = nn.dense(params["wc"], x, dtype=x.dtype)
    dt = F.softplus(nn.dense(params["wdt"], x, dtype=torch.float32).float())
    a = F.softplus(params["a_log"])[None, None, :]             # (1, 1, H)
    w = torch.exp(-a * dt)                                      # (B, T, H)
    return xin, z, bmat, cmat, dt, w, new_tail


def _heads_scan(cfg: ArchConfig, xin, bmat, cmat, dt, w, d_skip, s0):
    """The per-head part of the branch on (a rank's) whole heads: the
    gated linear scan (q=C, k=dt*B, v=x, decay w broadcast over N) plus
    the skip.  Flat inputs as `_branch_inputs` gives them, s0 (B, H, N, P)
    or None -> (y (B, T, H P) before the gate, final state (B, H, N, P))."""
    b, t, _ = xin.shape
    h, pdim, n = dt.shape[-1], cfg.hd, cfg.ssm_state
    xv = xin.reshape(b, t, h, pdim)
    bmat, cmat = bmat.reshape(b, t, h, n), cmat.reshape(b, t, h, n)
    # the kernel takes contiguous operands, and at b == 1 each reshape
    # is a strided view (at t == 1 the decay's is a stride-0 one)
    q = cmat.permute(0, 2, 1, 3).reshape(b * h, t, n).contiguous()
    k = (bmat * dt[..., None]).permute(0, 2, 1, 3).reshape(
        b * h, t, n).contiguous()
    v = xv.permute(0, 2, 1, 3).reshape(b * h, t, pdim).contiguous()
    wfull = w.permute(0, 2, 1)[..., None].expand(b, h, t, n).reshape(
        b * h, t, n).contiguous()
    s0_flat = s0.reshape(b * h, n, pdim) if s0 is not None else None
    o, s_fin = kops.gated_linear_scan(
        q, k, v, wfull, None, s0_flat, decay_before_read=True,
        impl=cfg.scan_impl, chunk=cfg.scan_chunk)
    o = o.reshape(b, h, t, pdim).permute(0, 2, 1, 3)
    o = o + d_skip[None, None, :, None] * xv
    return o.reshape(b, t, h * pdim), s_fin.reshape(b, h, n, pdim)


def apply_seq(params, cfg: ArchConfig, x: torch.Tensor,
              state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence SSM mixing.  x: (B, T, D) -> (out, new_state).

    With `state=None` (prefill) the new conv tail keeps x's dtype, as in
    the reference; with a state it keeps the state's."""
    conv_tail = state["conv"] if state is not None else None
    s0 = state["s"] if state is not None else None
    xin, z, bmat, cmat, dt, w, new_tail = _branch_inputs(params, cfg, x,
                                                         conv_tail)
    # on a mesh, each rank scans its batch rows and whole heads
    pdim, n = cfg.hd, cfg.ssm_state
    o, s_fin = local_map_roles(
        lambda *a: _heads_scan(cfg, *a),
        (xin, bmat, cmat, dt, w, params["d_skip"], s0),
        (Roles(0, 2, pdim), Roles(0, 2, n), Roles(0, 2, n), Roles(0, 2),
         Roles(0, 2), Roles(None, 0), Roles(0, 1)),
        (Roles(0, 2, pdim), Roles(0, 1)))
    o = (o * z).to(x.dtype)
    out = nn.dense(params["wo"], o, dtype=x.dtype)
    tail_dtype = state["conv"].dtype if state is not None else x.dtype
    return out, {"s": s_fin, "conv": new_tail.to(tail_dtype)}


def apply_step(params, cfg: ArchConfig, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """Single-token decode step.  x: (B, 1, D)."""
    return apply_seq(params, cfg, x, state)
