"""Decoder-only LM assembly: training and serving (port of
`repro.models.lm` for the decoder-only architectures the port registers).

Layers come in groups: group size = the architecture's layer-kind period
(hymba: global attention every 8th layer, so groups of 8 blocks b0..b7).
The reference stacks each block's parameters over the groups and
`lax.scan`s; here `params["layers"]` is a list of groups and the forward
pass a Python loop, so parameter names keep the JAX leaf paths with the
group index in front (`layers.{m}.b{j}.mixer.attn.wq.w`).

Training remats each layer group (`cfg.remat`: the group runs under
`torch.utils.checkpoint`, as the reference's `jax.checkpoint(group_fn)`),
and the cross-entropy runs in sequence chunks of `cfg.loss_chunk`, one
checkpoint each, without ever holding the (B, S, V) logits.

Entry points:
    init(gen, cfg)                        parameters (a `ParamTree`, f32)
    lm_loss(params, cfg, batch)           scalar loss + metrics
    train_step(params, opt, batch, cfg)   one Adam step, in place
    prefill(params, cfg, tokens, ...)     (last-token logits, caches)
    decode_step(params, cfg, token, c)    (logits, caches)
    greedy_generate(params, cfg, p, n)    (B, n) greedy tokens
    load_jax_params(params, jax_params)   carry the reference's weights over

The MoE dense prefix and llava projector are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import nn, optim
from . import blocks
from .config import ArchConfig


# --- structure helpers -----------------------------------------------------------
def group_size(cfg: ArchConfig) -> int:
    return cfg.window_pattern if cfg.window_pattern else 1


def n_prefix(cfg: ArchConfig) -> int:
    return cfg.first_dense_layers if cfg.ffn == "moe" else 0


def n_groups(cfg: ArchConfig) -> int:
    g = group_size(cfg)
    scanned = cfg.n_layers - n_prefix(cfg)
    if scanned % g:
        raise ValueError(f"{cfg.name}: {scanned} layers do not split into "
                         f"groups of {g}")
    return scanned // g


def group_kinds(cfg: ArchConfig) -> list[blocks.LayerKind]:
    """Layer kinds of the blocks inside every group (a kind depends on the
    layer index only through i % group size)."""
    p = n_prefix(cfg)
    return [blocks.layer_kind(cfg, p + j) for j in range(group_size(cfg))]


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.is_encdec or cfg.vision_dim or n_prefix(cfg):
        raise NotImplementedError(f"{cfg.name}: enc-dec, vision projector "
                                  f"and dense-prefix layers are not ported")


# --- init -------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ArchConfig) -> nn.ParamTree:
    """Float32 parameters drawn from `gen`, on the default device (see
    `nn.layers`); `api.init` places them and casts to `cfg.param_dtype`."""
    _check_ported(cfg)
    params: dict = {"embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model),
                    "final_norm": blocks.init_norm(cfg)}
    if not cfg.tie_embeddings:
        params["head"] = {"w": nn.normal_init(1.0 / math.sqrt(cfg.d_model))(
            gen, (cfg.d_model, cfg.vocab))}
    kinds = group_kinds(cfg)
    params["layers"] = [
        {f"b{j}": blocks.init_block(gen, cfg, kind)
         for j, kind in enumerate(kinds)}
        for _ in range(n_groups(cfg))]
    return nn.ParamTree(params)


def load_jax_params(params: nn.ParamTree, jax_params: dict) -> None:
    """Copy the reference's parameter tree (numpy leaves, `lm.init`'s
    layout: each block leaf stacked over the groups on a leading axis) into
    `params`, leaf by leaf, each cast to the port's dtype.  Raises unless
    every leaf of both trees is matched, with equal shapes."""
    ours = dict(params.named_parameters())
    seen = set()

    def put(path: str, leaf) -> None:
        if path not in ours:
            raise KeyError(f"reference leaf {path} has no counterpart")
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.shape != tuple(ours[path].shape):
            raise ValueError(f"{path}: reference {arr.shape}, port "
                             f"{tuple(ours[path].shape)}")
        with torch.no_grad():
            ours[path].copy_(torch.tensor(arr))
        seen.add(path)

    def walk(prefix: str, tree, group: int | None) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val, group)
            else:
                put(prefix + key, val if group is None else val[group])

    for key, val in jax_params.items():
        if key == "layers":
            for m in range(len(params["layers"])):
                walk(f"layers.{m}.", val, m)
        else:
            walk(f"{key}.", val, None)
    missing = sorted(set(ours) - seen)
    if missing:
        raise KeyError(f"port parameters not in the reference tree: "
                       f"{missing[:5]}{'...' if len(missing) > 5 else ''}")


# --- caches -------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Empty caches: `{"layers": [group m: {"b{j}": block cache}]}`."""
    kinds = group_kinds(cfg)
    return {"layers": [
        {f"b{j}": blocks.init_block_cache(cfg, kind, batch, max_len, dtype,
                                          device)
         for j, kind in enumerate(kinds)}
        for _ in range(n_groups(cfg))]}


# --- forward -------------------------------------------------------------------------
def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = nn.embedding(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _train_group(p_m, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """One layer group's blocks in train mode (no caches)."""
    for j, kind in enumerate(group_kinds(cfg)):
        x, _ = blocks.apply_block(p_m[f"b{j}"], cfg, kind, x, "train")
    return x


def forward_hidden(params, cfg: ArchConfig, x: torch.Tensor,
                   mode: str = "train", caches: dict | None = None
                   ) -> tuple[torch.Tensor, dict | None]:
    """Embedded input (B, S, D) -> (hidden, new caches; None in train).
    With `cfg.remat`, each group in train mode keeps only its input for
    the backward pass and runs again there."""
    if mode == "train" and cfg.remat and torch.is_grad_enabled():
        for p_m in params["layers"]:
            x = checkpoint(_train_group, p_m, cfg, x, use_reentrant=False)
        return x, None
    kinds = group_kinds(cfg)
    new_layers = []
    for m, p_m in enumerate(params["layers"]):
        c_m = caches["layers"][m] if caches is not None else None
        new_c = {}
        for j, kind in enumerate(kinds):
            x, new_c[f"b{j}"] = blocks.apply_block(
                p_m[f"b{j}"], cfg, kind, x, mode,
                c_m[f"b{j}"] if c_m is not None else None)
        new_layers.append(new_c)
    if mode == "train" or caches is None:
        return x, None
    return x, {"layers": new_layers}


def logits_for(params, cfg: ArchConfig, hidden: torch.Tensor
               ) -> torch.Tensor:
    """hidden (B, S, D) -> logits (B, S, V) (float32, softcapped)."""
    h = blocks.apply_norm(params["final_norm"], cfg, hidden)
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["head"]["w"])
    logits = (h @ w.to(h.dtype)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _device(params) -> torch.device:
    return params["embed"]["table"].device


# --- loss ------------------------------------------------------------------------------
def _chunk_nll(params, cfg: ArchConfig, hidden: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked -log p(label), sum of mask) over one sequence chunk."""
    logits = logits_for(params, cfg, hidden)            # (B, C, V) float32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_ce(params, cfg: ArchConfig, hidden: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over sequence chunks of `cfg.loss_chunk`, each under a
    checkpoint with `cfg.remat`, so at most one chunk's (B, C, V) logits
    exist at a time.  hidden (B, S, D); labels, mask (B, S).  Returns
    (nll_sum, count)."""
    s = hidden.shape[1]
    chunk = min(cfg.loss_chunk, s)
    remat = cfg.remat and torch.is_grad_enabled()
    nll_sum = torch.zeros((), device=hidden.device)
    count = torch.zeros((), device=hidden.device)
    for start in range(0, s, chunk):
        piece = (hidden[:, start:start + chunk],
                 labels[:, start:start + chunk], mask[:, start:start + chunk])
        if remat:
            nll, n = checkpoint(_chunk_nll, params, cfg, *piece,
                                use_reentrant=False)
        else:
            nll, n = _chunk_nll(params, cfg, *piece)
        nll_sum, count = nll_sum + nll, count + n
    return nll_sum, count


def lm_loss(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens" (B, S), "labels" (B, S), optional "mask"} -> (loss,
    metrics).  The MoE auxiliary terms are zeros: no registered
    architecture has an MoE layer."""
    _check_ported(cfg)
    dev = _device(params)
    tokens, labels = batch["tokens"].to(dev), batch["labels"].to(dev)
    x = embed_tokens(params, cfg, tokens)
    x, _ = forward_hidden(params, cfg, x, mode="train")
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, device=dev) if mask is None
            else mask.to(dev, torch.float32))
    nll_sum, count = chunked_ce(params, cfg, x, labels, mask)
    ce = nll_sum / torch.clamp(count, min=1.0)
    lb = z = torch.zeros((), device=dev)
    loss = ce + 0.01 * lb + 1e-3 * z
    return loss, {"loss": loss, "ce": ce, "moe_lb": lb, "router_z": z,
                  "tokens": count}


def train_step(params, opt_state: optim.AdamState, batch: dict,
               cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    """One synchronous training step: the loss and its gradient with
    respect to every parameter (which are made to require grad), the
    gradient's global norm, then one Adam step in place.  Returns (params,
    opt_state, metrics), the metrics detached on the device."""
    adam_cfg = adam_cfg or optim.AdamConfig(lr=3e-4, grad_clip=1.0)
    plist = list(params.parameters())
    with torch.enable_grad():
        params.requires_grad_(True)
        loss, metrics = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, plist)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = optim.global_norm(grads)
    optim.adam_update(adam_cfg, plist, grads, opt_state,
                      norm=metrics["grad_norm"])
    return params, opt_state, metrics


# --- serving -------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int | None = None, cache_dtype=torch.bfloat16
            ) -> tuple[torch.Tensor, dict]:
    """Process the prompt (B, S), build the caches.  Returns (last-token
    logits (B, V), caches)."""
    tokens = tokens.to(_device(params))
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    caches = init_caches(cfg, b, cache_len or s, cache_dtype, x.device)
    x, caches = forward_hidden(params, cfg, x, mode="prefill", caches=caches)
    return logits_for(params, cfg, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) -> (logits (B, V), caches).  The
    caches are updated in place (see `models.attention`)."""
    x = embed_tokens(params, cfg, token.to(_device(params))[:, None])
    x, caches = forward_hidden(params, cfg, x, mode="decode", caches=caches)
    return logits_for(params, cfg, x)[:, 0], caches


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt: torch.Tensor,
                    n_new: int) -> torch.Tensor:
    """Greedy decoding: prefill the prompt (B, S), then n_new - 1 decode
    steps.  Returns the (B, n_new) generated tokens (int64), on the
    parameters' device.  The caches are bf16, as in the reference."""
    logits, caches = prefill(params, cfg, prompt,
                             cache_len=prompt.shape[1] + n_new)
    toks = [torch.argmax(logits, dim=-1)]
    for _ in range(n_new - 1):
        logits, caches = decode_step(params, cfg, toks[-1], caches)
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1)
