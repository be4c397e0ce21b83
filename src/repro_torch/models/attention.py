"""GQA attention for the LM architectures (port of `repro.models.attention`).

Grouped-query attention with RoPE, sliding windows (ring-buffer KV caches),
logit softcap and optional QKV biases.  Three entry points:

  full_attention     causal self-attention, no cache (teacher forcing)
  prefill_attention  causal self-attention + cache build
  decode_attention   one token against the KV cache

Prefill goes through `kernels.ops.attention` (the flash kernel on a CUDA
tensor for `attn_impl="kernel"`).  Decode is the dense ("allgather") path of
the reference, in plain PyTorch as there; the reference's sharded "flash"
combine needs a device mesh and is not ported.  Compute dtype follows the
inputs; softmax statistics are float32.

Unlike the reference, the caches are updated in place (the KV buffers are
the largest decode-time tensors): prefill writes into the buffers
`init_cache` made, each decode step writes its slot and returns the same
buffers, so a cache dict must not be reused after it was passed on.  `pos`
is a Python int, so a decode step needs no host-device sync.
"""
from __future__ import annotations

import torch

from .. import nn
from ..kernels import ops as kops
from .config import ArchConfig


# --- RoPE --------------------------------------------------------------------
def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for `positions` (any shape) -> (..., head_dim/2)."""
    half = head_dim // 2
    exponents = -torch.arange(0, half, dtype=torch.float32,
                              device=positions.device) / half
    # theta as a Python scalar: no host-to-device copy (a blocking one on
    # the card) at every layer and decode step
    freqs = torch.pow(float(theta), exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs (x[..., :h], x[..., h:]), the neox/llama convention, in
    float32.  x (B, H, S, D); cos/sin (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- parameters ---------------------------------------------------------------
def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One attention block's parameters."""
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": nn.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.attn_bias),
        "wk": nn.dense_init(gen, d, cfg.kv_heads * hd, bias=cfg.attn_bias),
        "wv": nn.dense_init(gen, d, cfg.kv_heads * hd, bias=cfg.attn_bias),
        "wo": nn.dense_init(gen, cfg.n_heads * hd, d, bias=cfg.attn_bias),
    }


# --- cache --------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window: int | None, dtype=torch.bfloat16, device=None) -> dict:
    """Empty KV cache for one layer.  Sliding-window layers get a ring
    buffer bounded by the window; global layers a full-length buffer."""
    length = min(window, max_len) if window else max_len
    shape = (batch, cfg.kv_heads, length, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}  # absolute position of the next write


def _qkv(p, cfg: ArchConfig, x: torch.Tensor):
    """x (B, S, D) -> q (B, Hq, S, hd), k/v (B, Hkv, S, hd) (views)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = nn.dense(p["wq"], x, dtype=x.dtype).reshape(b, s, cfg.n_heads, hd)
    k = nn.dense(p["wk"], x, dtype=x.dtype).reshape(b, s, cfg.kv_heads, hd)
    v = nn.dense(p["wv"], x, dtype=x.dtype).reshape(b, s, cfg.kv_heads, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _out(p, cfg: ArchConfig, o: torch.Tensor) -> torch.Tensor:
    """o (B, Hq, S, hd) -> (B, S, D)."""
    b, _, s, _ = o.shape
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return nn.dense(p["wo"], o, dtype=o.dtype)


def _attend(cfg: ArchConfig, q, k, v, window: int | None) -> torch.Tensor:
    return kops.attention(
        q, k, v, causal=True, window=window,
        softcap=cfg.attn_softcap or None, scale=cfg.attn_scale or None,
        impl=cfg.attn_impl, block_k=cfg.attn_block_k)


# --- train / prefill -----------------------------------------------------------
def full_attention(p, cfg: ArchConfig, x: torch.Tensor, *,
                   window: int | None) -> torch.Tensor:
    """Causal self-attention over the whole sequence (no cache)."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope:
        cos, sin = rope_table(torch.arange(s, device=x.device), cfg.hd,
                              cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return _out(p, cfg, _attend(cfg, q, k, v, window))


def prefill_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict, *,
                      window: int | None) -> tuple[torch.Tensor, dict]:
    """Causal self-attention + cache population (prefill path).

    Assumes an empty cache (pos == 0) and s <= cache length for global
    layers; sliding-window layers keep only the trailing `window` keys, the
    key of position i in slot i % length."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope:
        cos, sin = rope_table(torch.arange(s, device=x.device), cfg.hd,
                              cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = _attend(cfg, q, k, v, window)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[2]
    if length >= s:  # global layer (or a window not yet full): [0, s)
        ck[:, :, :s] = k
        cv[:, :, :s] = v
    else:  # ring buffer: the last `length` positions, slot = pos % length
        slots = (torch.arange(length, device=x.device) + (s - length)) \
            % length
        ck.index_copy_(2, slots, k[:, :, s - length:].to(ck.dtype))
        cv.index_copy_(2, slots, v[:, :, s - length:].to(cv.dtype))
    return _out(p, cfg, o), {"k": ck, "v": cv, "pos": s}


# --- decode ---------------------------------------------------------------------
def decode_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict, *,
                     window: int | None) -> tuple[torch.Tensor, dict]:
    """One-token attention against the cache.  x: (B, 1, D)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)  # (B, H*, 1, hd)
    pos = cache["pos"]  # absolute position of this token
    if cfg.rope:
        cos, sin = rope_table(torch.arange(pos, pos + 1, device=x.device),
                              cfg.hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[2]
    slot = pos % length if window else min(pos, length - 1)
    ck[:, :, slot] = k[:, :, 0]
    cv[:, :, slot] = v[:, :, 0]

    # Valid-slot mask.  Ring buffer: slot s holds absolute position
    # pos - ((pos - s) mod L); cold slots (never written) come out < 0.
    # Global buffer: slots [0, pos].
    slots = torch.arange(length, device=x.device)
    if window:
        mask = pos - torch.remainder(pos - slots, length) >= 0
    else:
        mask = slots <= pos

    hkv, group = cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    scale = cfg.attn_scale or cfg.hd ** -0.5
    qg = q.float().reshape(b, hkv, group, cfg.hd)
    logits = torch.matmul(qg, ck.float().transpose(-1, -2)) * scale
    if cfg.attn_softcap:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    logits = torch.where(mask, logits, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    pr = torch.where(mask, torch.exp(logits - m_safe), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    o = torch.matmul(pr, cv.float()) / torch.clamp(l, min=1e-30)
    o = o.reshape(b, cfg.n_heads, 1, cfg.hd).to(x.dtype)
    return _out(p, cfg, o), {"k": ck, "v": cv, "pos": pos + 1}
