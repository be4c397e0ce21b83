"""Whisper-style encoder-decoder backbone, whisper-tiny (port of
`repro.models.encdec`).

The audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (B, S_src, D), the output of whisper's conv1d
stack.  The encoder adds learned positions and runs bidirectional
attention; the decoder is a causal transformer with cross-attention to the
encoder's states.  Serving builds the cross-attention KV once at prefill,
beside the self-attention caches, and every decode step reads it.

Whisper's parts: pre-LN LayerNorm blocks and a final LayerNorm, GELU MLPs,
attention biases, learned positional embeddings, no RoPE, the decoder's
embedding tied to the output head.  The reference's module docstring says
"biases everywhere except wk", but its `attention.init` gives wk a bias
whenever `attn_bias` is set; the port follows the code.

Every attention goes through `kernels.ops.attention` (on a CUDA tensor
with `attn_impl="kernel"`, the flash kernel): the encoder's non-causal
self-attention, the decoder's causal self-attention in training and
prefill, and the non-causal cross-attention (prompt x S_src in prefill,
1 x S_src at every decode step).  The decoder's self-attention in decode
is the dense path of `models.attention`, as for the decoder-only models.
`lm.greedy_generate(..., frames=)` generates through `prefill` and
`decode_step` here.

Parameters are an `nn.ParamTree` named by the reference's leaf paths, the
stacked layers as lists (`encoder.{i}...`, `decoder.{i}.xattn.wq.w`).
Training remats each encoder and decoder layer (`cfg.remat`, as the
reference's `jax.checkpoint(body)`).  Caches are `{"self": [layer i: KV
dict], "cross": [layer i: {"k", "v"}]}`; the self-attention buffers are
updated in place (see `models.attention`), and the decode position is the
cache's Python int, so a decode step makes no host-device sync.

Entry points:
    init(gen, cfg)                               parameters (f32)
    encode(params, cfg, frames)                  encoder states
    lm_loss(params, cfg, batch)                  scalar loss + metrics
    train_step(params, opt, batch, cfg)          one Adam step, in place
    prefill(params, cfg, frames, tokens, ...)    (last-token logits, caches)
    decode_step(params, cfg, token, caches)      (logits, caches)
    load_jax_params(params, jax_params)          carry the reference's
                                                 weights over
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import nn, optim
from ..kernels import ops as kops
from ..parallel import sharding
from . import attention, blocks, lm
from .config import ArchConfig


def _kind(cfg: ArchConfig) -> blocks.LayerKind:
    return blocks.LayerKind(None, "gelu_mlp", cfg.d_ff)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _remat(cfg: ArchConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


# --- init ---------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ArchConfig) -> nn.ParamTree:
    """Float32 parameters drawn from `gen` on the default device;
    `api.init` places them and casts to `cfg.param_dtype`."""
    kind = _kind(cfg)
    decoder = []
    for _ in range(cfg.n_layers):
        blk = blocks.init_block(gen, cfg, kind)
        blk["xattn"] = attention.init(gen, cfg)
        blk["norm_x"] = blocks.init_norm(cfg)
        decoder.append(blk)
    return nn.ParamTree({
        "enc_pos": {"table": nn.normal_init(0.02)(
            gen, (cfg.max_source_positions, cfg.d_model))},
        "encoder": [blocks.init_block(gen, cfg, kind)
                    for _ in range(cfg.encoder_layers)],
        "enc_final_norm": blocks.init_norm(cfg),
        "embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model),
        "dec_pos": {"table": nn.normal_init(0.02)(
            gen, (cfg.max_positions, cfg.d_model))},
        "decoder": decoder,
        "final_norm": blocks.init_norm(cfg),
    })


def param_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every parameter, keyed by its name in `init`'s tree
    (the reference's stacked layer axis dropped)."""
    kind = _kind(cfg)
    dec = dict(blocks.block_axes(cfg, kind), xattn=attention.param_axes(cfg),
               norm_x=blocks.norm_axes(cfg))
    return lm.flat_names({
        "enc_pos": {"table": (None, "embed")},
        "encoder": [blocks.block_axes(cfg, kind)
                    for _ in range(cfg.encoder_layers)],
        "enc_final_norm": blocks.norm_axes(cfg),
        "embed": {"table": ("vocab", "embed")},
        "dec_pos": {"table": (None, "embed")},
        "decoder": [dec for _ in range(cfg.n_layers)],
        "final_norm": blocks.norm_axes(cfg),
    })


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes of the caches `prefill` builds, keyed as
    `lm.flat_names` of them."""
    return lm.flat_names({
        "self": [attention.cache_axes() for _ in range(cfg.n_layers)],
        "cross": [{"k": ("batch", "kv_heads", None, None),
                   "v": ("batch", "kv_heads", None, None)}
                  for _ in range(cfg.n_layers)]})


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device="meta") -> dict:
    """The caches `prefill` builds, as empty tensors on `device` (the meta
    device by default: shapes only)."""
    cross = (batch, cfg.kv_heads, cfg.max_source_positions, cfg.hd)
    return {
        "self": [attention.init_cache(cfg, batch, max_len, window=None,
                                      dtype=dtype, device=device)
                 for _ in range(cfg.n_layers)],
        "cross": [{"k": torch.empty(cross, dtype=dtype, device=device),
                   "v": torch.empty(cross, dtype=dtype, device=device)}
                  for _ in range(cfg.n_layers)]}


def jax_param_leaves(jax_params: dict):
    """(port parameter name, leaf) for every leaf of a tree in the
    reference's `encdec.init` layout (its params or a gradient of them):
    the encoder's and decoder's block leaves stacked over the layers on a
    leading axis."""
    def walk(prefix: str, tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from walk(f"{prefix}{key}.", val)
            else:
                yield prefix + key, val

    for key, val in jax_params.items():
        if key in ("encoder", "decoder"):
            for path, leaf in walk("", val):
                for i in range(leaf.shape[0]):
                    yield f"{key}.{i}.{path}", leaf[i]
        else:
            yield from walk(f"{key}.", val)


def load_jax_params(params: nn.ParamTree, jax_params: dict) -> None:
    """Copy the reference's parameter tree (numpy leaves, `encdec.init`'s
    layout) into `params`, each leaf cast to the port's dtype.  Raises
    unless every leaf of both trees is matched, with equal shapes."""
    lm.load_leaves(params, jax_param_leaves(jax_params))


# --- encoder -------------------------------------------------------------------------
def _encoder_block(p_l, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = blocks.apply_norm(p_l["norm1"], cfg, x)
    q, k, v = attention._qkv(p_l["mixer"], cfg, h)
    o = kops.attention(q, k, v, causal=False, window=None, softcap=None,
                       impl=cfg.attn_impl, block_k=cfg.attn_block_k)
    x = x + attention._out(p_l["mixer"], cfg, o)
    h2 = blocks.apply_norm(p_l["norm2"], cfg, x)
    f, _, _ = blocks.apply_ffn(p_l["ffn"], cfg, _kind(cfg), h2)
    return sharding.constrain(x + f, "batch", "act_seq", None)


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_src, D), the stub frontend's embeddings -> encoder
    states (B, S_src, D) in `cfg.dtype`."""
    dt = _dtype(cfg)
    s = frames.shape[1]
    x = frames.to(_device(params), dt) + params["enc_pos"]["table"][:s].to(dt)
    x = sharding.constrain(x, "batch", "act_seq", None)
    for p_l in params["encoder"]:
        x = (checkpoint(_encoder_block, p_l, cfg, x, use_reentrant=False)
             if _remat(cfg) else _encoder_block(p_l, cfg, x))
    return blocks.apply_norm(params["enc_final_norm"], cfg, x)


# --- decoder -------------------------------------------------------------------------
def _cross_kv(p, cfg: ArchConfig, enc: torch.Tensor) -> dict:
    """The cross-attention K and V of one decoder layer: (B, Hkv, S_src,
    hd) views, in the encoder states' dtype."""
    heads = (cfg.kv_heads, cfg.hd)
    k = sharding.unflatten(nn.dense(p["wk"], enc, dtype=enc.dtype), 2, heads)
    v = sharding.unflatten(nn.dense(p["wv"], enc, dtype=enc.dtype), 2, heads)
    ax = ("batch", "kv_heads", None, None)
    return {"k": sharding.constrain(k.transpose(1, 2), *ax),
            "v": sharding.constrain(v.transpose(1, 2), *ax)}


def cross_kv(params, cfg: ArchConfig, enc: torch.Tensor) -> list[dict]:
    """Every decoder layer's cross-attention KV of the encoder states."""
    return [_cross_kv(p_l["xattn"], cfg, enc) for p_l in params["decoder"]]


def _cross_attend(p, cfg: ArchConfig, x: torch.Tensor, kv: dict
                  ) -> torch.Tensor:
    q = sharding.unflatten(nn.dense(p["wq"], x, dtype=x.dtype), 2,
                           (cfg.n_heads, cfg.hd))
    o = kops.attention(q.transpose(1, 2), kv["k"].to(x.dtype),
                       kv["v"].to(x.dtype), causal=False, window=None,
                       softcap=None, impl=cfg.attn_impl,
                       block_k=cfg.attn_block_k)
    return attention._out(p, cfg, o)


def _decoder_block(p_l, cfg: ArchConfig, x: torch.Tensor, mode: str,
                   self_cache: dict | None, cross: dict):
    """Self-attention, cross-attention, FFN -> (x, new self cache or
    None in train mode)."""
    h = blocks.apply_norm(p_l["norm1"], cfg, x)
    if mode == "train":
        a, new_self = attention.full_attention(p_l["mixer"], cfg, h,
                                               window=None), None
    elif mode == "prefill":
        a, new_self = attention.prefill_attention(p_l["mixer"], cfg, h,
                                                  self_cache, window=None)
    else:
        a, new_self = attention.decode_attention(
            p_l["mixer"], cfg, h, self_cache, window=None,
            combine=cfg.decode_combine)
    x = x + a
    hx = blocks.apply_norm(p_l["norm_x"], cfg, x)
    x = x + _cross_attend(p_l["xattn"], cfg, hx, cross)
    h2 = blocks.apply_norm(p_l["norm2"], cfg, x)
    f, _, _ = blocks.apply_ffn(p_l["ffn"], cfg, _kind(cfg), h2)
    return sharding.constrain(x + f, "batch", "act_seq", None), new_self


def _train_layer(p_l, cfg: ArchConfig, x: torch.Tensor, cross: dict
                 ) -> torch.Tensor:
    return _decoder_block(p_l, cfg, x, "train", None, cross)[0]


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor, start: int
           ) -> torch.Tensor:
    """Token embeddings plus the learned positions start .. start + T - 1
    (a slice of the table: no index tensor, no host-device copy)."""
    dt = _dtype(cfg)
    t = tokens.shape[1]
    return (nn.embedding(params["embed"], tokens).to(dt)
            + params["dec_pos"]["table"][start:start + t].to(dt))


def decode_hidden(params, cfg: ArchConfig, tokens: torch.Tensor, start: int,
                  caches: dict, mode: str) -> tuple[torch.Tensor, dict | None]:
    """tokens (B, T) at positions start .. start + T - 1 through the
    decoder -> (hidden (B, T, D), new caches; None in train mode)."""
    x = sharding.constrain(_embed(params, cfg, tokens, start),
                           "batch", "act_seq", None)
    new_self = []
    for i, p_l in enumerate(params["decoder"]):
        cross = caches["cross"][i]
        if mode == "train" and _remat(cfg):
            x = checkpoint(_train_layer, p_l, cfg, x, cross,
                           use_reentrant=False)
            continue
        x, c = _decoder_block(p_l, cfg, x, mode,
                              caches["self"][i] if caches.get("self")
                              else None, cross)
        new_self.append(c)
    if mode == "train":
        return x, None
    return x, {"self": new_self, "cross": caches["cross"]}


def _device(params) -> torch.device:
    return params["embed"]["table"].device


# --- losses / steps ------------------------------------------------------------------
def lm_loss(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch: {"frames" (B, S_src, D), "tokens" (B, T), "labels" (B, T),
    optional "mask"} -> (loss, metrics): the mean cross-entropy through
    the tied head, `lm.chunked_ce` as in the reference."""
    dev = _device(params)
    tokens, labels = batch["tokens"].to(dev), batch["labels"].to(dev)
    enc = encode(params, cfg, batch["frames"])
    x, _ = decode_hidden(params, cfg, tokens, 0,
                         {"cross": cross_kv(params, cfg, enc)}, "train")
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, device=dev) if mask is None
            else mask.to(dev, torch.float32))
    nll_sum, count = lm.chunked_ce(params, cfg, x, labels, mask)
    ce = nll_sum / torch.clamp(count, min=1.0)
    return ce, {"loss": ce, "ce": ce, "tokens": count}


def train_step(params, opt_state: optim.AdamState, batch: dict,
               cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    """One Adam step on `batch`, in place -> (params, opt_state, metrics),
    as `lm.train_step`."""
    return lm.adam_step(lm_loss, params, opt_state, batch, cfg, adam_cfg)


# --- serving -------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor, cache_len: int | None = None,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Encode the frames, build every layer's cross KV (in `cfg.dtype`),
    run the prompt (B, T) through the decoder and fill its self-attention
    caches (`cache_dtype`, `cache_len` positions, default T).  Returns
    (last-token logits (B, V), caches)."""
    tokens = tokens.to(_device(params))
    b, t = tokens.shape
    enc = encode(params, cfg, frames)
    caches = {
        "self": [attention.init_cache(cfg, b, cache_len or t, window=None,
                                      dtype=cache_dtype, device=enc.device)
                 for _ in range(cfg.n_layers)],
        "cross": cross_kv(params, cfg, enc)}
    x, caches = decode_hidden(params, cfg, tokens, 0, caches, "prefill")
    return lm.logits_for(params, cfg, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) -> (logits (B, V), caches)."""
    pos = caches["self"][0]["pos"]  # shared across layers
    x, caches = decode_hidden(params, cfg,
                              token.to(_device(params))[:, None], pos,
                              caches, "decode")
    return lm.logits_for(params, cfg, x)[:, 0], caches
