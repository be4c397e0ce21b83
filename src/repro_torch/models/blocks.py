"""Transformer block assembly: norms + mixer + FFN for every decoder-only
architecture (port of `repro.models.blocks`).

A block is `(params, cfg, layer_kind)` plus a mode:

    mode="train"    full sequence, no cache (teacher forcing)
    mode="prefill"  full sequence, builds the cache
    mode="decode"   one token against the cache

`layer_kind` carries the static per-layer choices: the attention window
(gemma-2's local/global alternation, hymba's and danube's SWA) and the FFN
(the dense-prefix layers of deepseek and moonshot).  Mixers: "attn", the
hybrid "attn+mamba" (hymba: attention and SSM heads read the same normed
input, their outputs averaged) and "rwkv" (rwkv6's time mix).  FFNs: the
dense swiglu / geglu / gelu_mlp, the MoE ("moe") and rwkv6's channel mix
("rwkv_cmix").  Cache dicts mirror the mixer: an attention layer carries a
KV dict, an RWKV layer one dict of its WKV state and both token shifts,
the hybrid both.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import nn
from ..parallel import sharding
from . import attention, moe, rwkv, ssm
from .config import ArchConfig


@dataclasses.dataclass(frozen=True)
class LayerKind:
    window: int | None          # None -> full attention
    ffn: str                    # swiglu | geglu | gelu_mlp | moe | rwkv_cmix
    d_ff: int


def layer_kind(cfg: ArchConfig, i: int) -> LayerKind:
    window = None if cfg.layer_is_global(i) else cfg.window
    if cfg.ffn == "moe" and i < cfg.first_dense_layers:
        return LayerKind(window, "swiglu", cfg.d_ff_dense or cfg.d_ff)
    return LayerKind(window, cfg.ffn, cfg.d_ff)


# --- FFNs -------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg: ArchConfig, kind: LayerKind) -> dict:
    if kind.ffn == "moe":
        return moe.init(gen, cfg)
    if kind.ffn == "rwkv_cmix":
        return rwkv.init_channel_mix(gen, cfg)
    d, f = cfg.d_model, kind.d_ff
    w_in = nn.normal_init(1.0 / math.sqrt(d))
    p = {"wi": nn.dense_init(gen, d, f, bias=cfg.mlp_bias, w_init=w_in),
         "wo": nn.dense_init(gen, f, d, bias=cfg.mlp_bias,
                             w_init=nn.normal_init(1.0 / math.sqrt(f)))}
    if kind.ffn in ("swiglu", "geglu"):
        p["wg"] = nn.dense_init(gen, d, f, bias=cfg.mlp_bias, w_init=w_in)
    return p


def ffn_axes(cfg: ArchConfig, kind: LayerKind) -> dict:
    if kind.ffn == "moe":
        return moe.param_axes(cfg)
    if kind.ffn == "rwkv_cmix":
        return rwkv.channel_mix_axes(cfg)

    def wb(ax):
        return {"w": ax, "b": (ax[-1],)} if cfg.mlp_bias else {"w": ax}

    p = {"wi": wb(("embed", "mlp")), "wo": wb(("mlp", "embed"))}
    if kind.ffn in ("swiglu", "geglu"):
        p["wg"] = wb(("embed", "mlp"))
    return p


def apply_ffn(p, cfg: ArchConfig, kind: LayerKind, x: torch.Tensor,
              state: torch.Tensor | None = None):
    """-> (out, aux, new_state_or_None): aux the MoE's (2,) losses (None
    for the other FFNs, the reference's zeros), the state the channel
    mix's token shift."""
    if kind.ffn == "moe":
        out, aux = moe.apply(p, cfg, x)
        return out, aux, None
    if kind.ffn == "rwkv_cmix":
        out, shift = rwkv.channel_mix(p, cfg, x, state)
        return out, None, shift
    h = nn.dense(p["wi"], x, dtype=x.dtype)
    if kind.ffn == "swiglu":
        h = F.silu(nn.dense(p["wg"], x, dtype=x.dtype)) * h
    elif kind.ffn == "geglu":
        h = F.gelu(nn.dense(p["wg"], x, dtype=x.dtype), approximate="tanh") * h
    else:  # gelu_mlp
        h = F.gelu(h, approximate="tanh")
    h = sharding.constrain(h, "batch", None, "mlp")
    return nn.dense(p["wo"], h, dtype=x.dtype), None, None


# --- norms ------------------------------------------------------------------------
def init_norm(cfg: ArchConfig) -> dict:
    if cfg.norm == "layernorm":
        return nn.layernorm_init(cfg.d_model)
    if cfg.norm == "layernorm_nobias":  # command-r
        return nn.layernorm_init(cfg.d_model, bias=False)
    return nn.rmsnorm_init(cfg.d_model)


def norm_axes(cfg: ArchConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def apply_norm(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm.startswith("layernorm"):
        return nn.layernorm(p, x)
    return nn.rmsnorm(p, x, scale_plus_one=cfg.norm_scale_plus_one)


# --- block ---------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ArchConfig, kind: LayerKind) -> dict:
    p: dict = {"norm1": init_norm(cfg), "ffn": init_ffn(gen, cfg, kind)}
    if cfg.mixer == "rwkv":
        p["mixer"] = rwkv.init_time_mix(gen, cfg)
    elif cfg.mixer == "attn+mamba":
        p["mixer"] = {"attn": attention.init(gen, cfg),
                      "ssm": ssm.init(gen, cfg)}
    elif cfg.mixer == "attn":
        p["mixer"] = attention.init(gen, cfg)
    else:
        raise NotImplementedError(f"mixer {cfg.mixer!r} is not ported")
    if not cfg.parallel_block:
        p["norm2"] = init_norm(cfg)
    if cfg.post_norms:
        p["post_norm1"] = init_norm(cfg)
        p["post_norm2"] = init_norm(cfg)
    return p


def block_axes(cfg: ArchConfig, kind: LayerKind) -> dict:
    """Logical axes of `init_block`'s parameters."""
    ax: dict = {"norm1": norm_axes(cfg), "ffn": ffn_axes(cfg, kind)}
    if cfg.mixer == "rwkv":
        ax["mixer"] = rwkv.time_mix_axes(cfg)
    elif cfg.mixer == "attn+mamba":
        ax["mixer"] = {"attn": attention.param_axes(cfg),
                       "ssm": ssm.param_axes(cfg)}
    else:
        ax["mixer"] = attention.param_axes(cfg)
    if not cfg.parallel_block:
        ax["norm2"] = norm_axes(cfg)
    if cfg.post_norms:
        ax["post_norm1"] = norm_axes(cfg)
        ax["post_norm2"] = norm_axes(cfg)
    return ax


def block_cache_axes(cfg: ArchConfig) -> dict:
    if cfg.mixer == "rwkv":
        return {"mixer": rwkv.state_axes()}
    if cfg.mixer == "attn+mamba":
        return {"mixer": {"attn": attention.cache_axes(),
                          "ssm": ssm.state_axes()}}
    return {"mixer": attention.cache_axes()}


def init_block_cache(cfg: ArchConfig, kind: LayerKind, batch: int,
                     max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    """Prefill/decode cache for one block (empty)."""
    if cfg.mixer == "rwkv":
        # one dict: the WKV state and the time- and channel-mix shifts
        return {"mixer": rwkv.init_state(cfg, batch, dtype, device)}
    kv = attention.init_cache(cfg, batch, max_len, window=kind.window,
                              dtype=dtype, device=device)
    if cfg.mixer == "attn+mamba":
        return {"mixer": {"attn": kv, "ssm": ssm.init_state(
            cfg, batch, dtype, device)}}
    return {"mixer": kv}


def _mix(p, cfg: ArchConfig, kind: LayerKind, x: torch.Tensor, mode: str,
         cache: dict | None):
    """Apply the mixer.  Returns (out, new_cache_or_None)."""
    ca = cache["mixer"] if cache else None
    if cfg.mixer == "rwkv":
        out, wkv, shift = rwkv.time_mix(
            p, cfg, x, ca["wkv"] if ca else None, ca["shift_t"] if ca else None)
        if mode == "train":
            return out, None
        shift_c = (ca["shift_c"] if ca else
                   torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                               device=x.device))
        return out, {"wkv": wkv, "shift_t": shift, "shift_c": shift_c}

    if cfg.mixer == "attn+mamba":
        if mode == "train":
            a_out = attention.full_attention(p["attn"], cfg, x,
                                             window=kind.window)
            s_out, _ = ssm.apply_seq(p["ssm"], cfg, x, None)
            return 0.5 * (a_out + s_out), None
        if mode == "prefill":
            a_out, a_cache = attention.prefill_attention(
                p["attn"], cfg, x, ca["attn"], window=kind.window)
            s_out, s_state = ssm.apply_seq(p["ssm"], cfg, x, None)
        else:
            a_out, a_cache = attention.decode_attention(
                p["attn"], cfg, x, ca["attn"], window=kind.window,
                combine=cfg.decode_combine)
            s_out, s_state = ssm.apply_step(p["ssm"], cfg, x, ca["ssm"])
        return 0.5 * (a_out + s_out), {"attn": a_cache, "ssm": s_state}

    if mode == "train":
        return attention.full_attention(p, cfg, x, window=kind.window), None
    if mode == "prefill":
        return attention.prefill_attention(p, cfg, x, ca, window=kind.window)
    return attention.decode_attention(p, cfg, x, ca, window=kind.window,
                                      combine=cfg.decode_combine)


def apply_block(p, cfg: ArchConfig, kind: LayerKind, x: torch.Tensor,
                mode: str = "train", cache: dict | None = None):
    """-> (x, aux, new_cache_or_None); aux the MoE FFN's (2,) losses, None
    for the other FFNs."""
    h = apply_norm(p["norm1"], cfg, x)
    m_out, m_cache = _mix(p["mixer"], cfg, kind, h, mode, cache)
    if cfg.parallel_block:  # command-r: attn & ffn read the same norm
        f_out, aux, _ = apply_ffn(p["ffn"], cfg, kind, h)
        x = x + m_out + f_out
        return x, aux, None if m_cache is None else {"mixer": m_cache}
    if cfg.post_norms:
        m_out = apply_norm(p["post_norm1"], cfg, m_out)
    x = sharding.constrain(x + m_out, "batch", "act_seq", None)
    shift_c = cache["mixer"]["shift_c"] if cache and cfg.mixer == "rwkv" \
        else None
    f_out, aux, f_state = apply_ffn(p["ffn"], cfg, kind,
                                    apply_norm(p["norm2"], cfg, x), shift_c)
    if cfg.post_norms:
        f_out = apply_norm(p["post_norm2"], cfg, f_out)
    x = sharding.constrain(x + f_out, "batch", "act_seq", None)
    if m_cache is None:
        return x, aux, None
    if f_state is not None:  # rwkv: the channel mix's shift
        m_cache = dict(m_cache, shift_c=f_state)
    return x, aux, {"mixer": m_cache}
