"""Decoder-only LM assembly: training and serving (port of
`repro.models.lm`, every architecture but the enc-dec whisper, which is
`models.encdec`).

Layers come in groups: group size = the architecture's layer-kind period
(gemma-2's local/global pair = 2, hymba's global-every-8 = 8, otherwise
1).  The reference stacks each block's parameters over the groups and
`lax.scan`s; here `params["layers"]` is a list of groups and the forward
pass a Python loop, so parameter names keep the JAX leaf paths with the
group index in front (`layers.{m}.b{j}.mixer.attn.wq.w`).  The MoE
architectures' dense-prefix layers come first, a list as in the reference
(`prefix.{i}...`), and llava's projector maps precomputed patch
embeddings to image tokens that precede the text (`project_patches`).
The MoE layers' auxiliary losses add up over the layers into `lm_loss`.

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
    greedy_generate(params, cfg, p, n)    (B, n) greedy tokens (whisper's
                                          through `encdec`, given frames=)
    load_jax_params(params, jax_params)   carry the reference's weights over
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import nn, optim
from ..parallel import sharding
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


def _check_decoder_only(cfg: ArchConfig) -> None:
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an enc-dec model: use "
                         f"models.encdec (models.api dispatches to it)")


# --- init -------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ArchConfig) -> nn.ParamTree:
    """Float32 parameters drawn from `gen`, on the default device (see
    `nn.layers`); `api.init` places them and casts to `cfg.param_dtype`."""
    _check_decoder_only(cfg)
    params: dict = {"embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model),
                    "final_norm": blocks.init_norm(cfg)}
    if not cfg.tie_embeddings:
        params["head"] = {"w": nn.normal_init(1.0 / math.sqrt(cfg.d_model))(
            gen, (cfg.d_model, cfg.vocab))}
    if n_prefix(cfg):
        params["prefix"] = [
            blocks.init_block(gen, cfg, blocks.layer_kind(cfg, i))
            for i in range(n_prefix(cfg))]
    kinds = group_kinds(cfg)
    params["layers"] = [
        {f"b{j}": blocks.init_block(gen, cfg, kind)
         for j, kind in enumerate(kinds)}
        for _ in range(n_groups(cfg))]
    if cfg.vision_dim:  # llava's projector (2-layer GELU MLP)
        params["projector"] = {
            "w1": nn.dense_init(gen, cfg.vision_dim, cfg.d_model),
            "w2": nn.dense_init(gen, cfg.d_model, cfg.d_model)}
    return nn.ParamTree(params)


def param_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every parameter, keyed by its name in `init`'s tree
    (`named_parameters()`); the reference's stacked group axis has no
    counterpart, each group being a tree of its own."""
    kinds = group_kinds(cfg)
    ax: dict = {"embed": {"table": ("vocab", "embed")},
                "final_norm": blocks.norm_axes(cfg)}
    if not cfg.tie_embeddings:
        ax["head"] = {"w": ("embed", "vocab")}
    if n_prefix(cfg):
        ax["prefix"] = [blocks.block_axes(cfg, blocks.layer_kind(cfg, i))
                        for i in range(n_prefix(cfg))]
    ax["layers"] = [{f"b{j}": blocks.block_axes(cfg, kind)
                     for j, kind in enumerate(kinds)}
                    for _ in range(n_groups(cfg))]
    if cfg.vision_dim:
        ax["projector"] = {"w1": {"w": (None, "embed"), "b": ("embed",)},
                           "w2": {"w": ("embed", "embed"), "b": ("embed",)}}
    return flat_names(ax)


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes of every cache leaf, keyed as `flat_names` of
    `init_caches`' tree."""
    kinds = group_kinds(cfg)
    ax: dict = {"layers": [{f"b{j}": blocks.block_cache_axes(cfg)
                            for j in range(len(kinds))}
                           for _ in range(n_groups(cfg))]}
    if n_prefix(cfg):
        ax["prefix"] = [blocks.block_cache_axes(cfg)
                        for _ in range(n_prefix(cfg))]
    return flat_names(ax)


def flat_names(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict/list tree (the names
    `nn.ParamTree.named_parameters()` gives); a leaf is a tensor, a
    logical-axes tuple, None or a Python number."""
    out: dict = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            out.update(flat_names(val, f"{prefix}{key}."))
        return out
    if isinstance(tree, list):
        for i, val in enumerate(tree):
            out.update(flat_names(val, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def jax_param_leaves(jax_params: dict, n_groups: int):
    """(port parameter name, leaf) for every leaf of a tree in the
    reference's `lm.init` layout (its params, or a gradient of them): each
    block leaf stacked over the `n_groups` groups on a leading axis, the
    dense prefix a list of blocks."""
    def walk(prefix: str, tree, group: int | None):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from walk(f"{prefix}{key}.", val, group)
            elif isinstance(val, (list, tuple)):
                for i, sub in enumerate(val):
                    yield from walk(f"{prefix}{key}.{i}.", sub, group)
            else:
                yield prefix + key, val if group is None else val[group]

    for key, val in jax_params.items():
        if key == "layers":
            for m in range(n_groups):
                yield from walk(f"layers.{m}.", val, m)
        else:
            yield from walk("", {key: val}, None)


def load_jax_params(params: nn.ParamTree, jax_params: dict) -> None:
    """Copy the reference's parameter tree (numpy leaves, `lm.init`'s
    layout, see `jax_param_leaves`) into `params`, leaf by leaf, each cast
    to the port's dtype.  Raises unless every leaf of both trees is
    matched, with equal shapes."""
    load_leaves(params, jax_param_leaves(jax_params, len(params["layers"])))


def load_leaves(params: nn.ParamTree, leaves) -> None:
    """Copy (port parameter name, numpy leaf) pairs into `params`, each
    leaf cast to the port's dtype; raises unless every leaf and every
    parameter is matched, with equal shapes."""
    ours = dict(params.named_parameters())
    seen = set()
    for path, leaf in leaves:
        if path not in ours:
            raise KeyError(f"reference leaf {path} has no counterpart")
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.shape != tuple(ours[path].shape):
            raise ValueError(f"{path}: reference {arr.shape}, port "
                             f"{tuple(ours[path].shape)}")
        with torch.no_grad():
            ours[path].copy_(torch.tensor(arr))
        seen.add(path)
    missing = sorted(set(ours) - seen)
    if missing:
        raise KeyError(f"port parameters not in the reference tree: "
                       f"{missing[:5]}{'...' if len(missing) > 5 else ''}")


# --- caches -------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Empty caches: `{"layers": [group m: {"b{j}": block cache}]}`, and
    `"prefix": [block cache]` for the dense-prefix layers."""
    kinds = group_kinds(cfg)
    caches: dict = {"layers": [
        {f"b{j}": blocks.init_block_cache(cfg, kind, batch, max_len, dtype,
                                          device)
         for j, kind in enumerate(kinds)}
        for _ in range(n_groups(cfg))]}
    if n_prefix(cfg):
        caches["prefix"] = [
            blocks.init_block_cache(cfg, blocks.layer_kind(cfg, i), batch,
                                    max_len, dtype, device)
            for i in range(n_prefix(cfg))]
    return caches


# --- forward -------------------------------------------------------------------------
def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = nn.embedding(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def project_patches(params, cfg: ArchConfig, patches: torch.Tensor
                    ) -> torch.Tensor:
    """llava: precomputed patch embeddings (B, N, vision_dim) -> image
    tokens (B, N, D), through the 2-layer GELU projector.  As in the
    reference the product promotes to the weights' dtype (float32 masters
    give float32 image tokens)."""
    p = params["projector"]
    h = nn.dense(p["w1"], patches.to(getattr(torch, cfg.dtype)))
    return nn.dense(p["w2"], F.gelu(h, approximate="tanh"))


def _embed_input(params, cfg: ArchConfig, tokens: torch.Tensor,
                 patches: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings, preceded by llava's image tokens where patches are
    given; the two join in their promoted dtype, as `jnp.concatenate`."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.vision_dim and patches is not None:
        img = project_patches(params, cfg, patches.to(x.device))
        dt = torch.promote_types(img.dtype, x.dtype)
        x = torch.cat([img.to(dt), x.to(dt)], dim=1)
    return x


def _add(total: torch.Tensor | None, aux: torch.Tensor | None):
    """Sum of the MoE layers' aux losses; None while no layer gave one."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _train_group(p_m, cfg: ArchConfig, x: torch.Tensor):
    """One layer group's blocks in train mode (no caches) -> (x, aux)."""
    aux = None
    for j, kind in enumerate(group_kinds(cfg)):
        x, a, _ = blocks.apply_block(p_m[f"b{j}"], cfg, kind, x, "train")
        aux = _add(aux, a)
    return x, aux


def forward_hidden(params, cfg: ArchConfig, x: torch.Tensor,
                   mode: str = "train", caches: dict | None = None):
    """Embedded input (B, S, D) -> (hidden, aux, new caches): aux the summed
    MoE losses (2,) (None without an MoE layer), the caches None in train.
    With `cfg.remat`, each group in train mode keeps only its input for
    the backward pass and runs again there."""
    x = sharding.constrain(x, "batch", "act_seq", None)
    aux = None
    new_prefix = []
    for i in range(n_prefix(cfg)):
        x, a, c = blocks.apply_block(
            params["prefix"][i], cfg, blocks.layer_kind(cfg, i), x, mode,
            caches["prefix"][i] if caches is not None else None)
        aux = _add(aux, a)
        new_prefix.append(c)
    if mode == "train" and cfg.remat and torch.is_grad_enabled():
        for p_m in params["layers"]:
            x, a = checkpoint(_train_group, p_m, cfg, x, use_reentrant=False)
            aux = _add(aux, a)
        return x, aux, None
    kinds = group_kinds(cfg)
    new_layers = []
    for m, p_m in enumerate(params["layers"]):
        c_m = caches["layers"][m] if caches is not None else None
        new_c = {}
        for j, kind in enumerate(kinds):
            x, a, new_c[f"b{j}"] = blocks.apply_block(
                p_m[f"b{j}"], cfg, kind, x, mode,
                c_m[f"b{j}"] if c_m is not None else None)
            aux = _add(aux, a)
        new_layers.append(new_c)
    if mode == "train" or caches is None:
        return x, aux, None
    new_caches = {"layers": new_layers}
    if new_prefix:
        new_caches["prefix"] = new_prefix
    return x, aux, new_caches


def logits_for(params, cfg: ArchConfig, hidden: torch.Tensor
               ) -> torch.Tensor:
    """hidden (B, S, D) -> logits (B, S, V) (float32, softcapped)."""
    h = blocks.apply_norm(params["final_norm"], cfg, hidden)
    # a tied table's gradient comes back laid out as the table, to add to
    # the embedding's (`nn.embedding`)
    w = (sharding.grad_layout(params["embed"]["table"]).T
         if cfg.tie_embeddings else params["head"]["w"])
    logits = sharding.constrain((h @ w.to(h.dtype)).float(),
                                "batch", None, "vocab")
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _device(params) -> torch.device:
    return params["embed"]["table"].device


# --- loss ------------------------------------------------------------------------------
def _chunk_nll(params, cfg: ArchConfig, hidden: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked -log p(label), sum of mask) over one sequence chunk.
    On a mesh that splits the vocab, the label's logit is a pending sum
    over the vocab's ranks, reduced before anything else touches it:
    DTensor's rule for it fails on a select or an elementwise op."""
    logits = logits_for(params, cfg, hidden)            # (B, C, V) float32
    lse = torch.logsumexp(logits, dim=-1)
    ll = sharding.constrain(torch.gather(logits, -1, labels[..., None]),
                            "batch", None, None)[..., 0]
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
    """batch: {"tokens" (B, S), "labels" (B, S), optional "mask" and, for
    llava, "patches" (B, N, vision_dim)} -> (loss, metrics).  The loss adds
    the MoE layers' load-balance (x 0.01) and router z (x 1e-3) losses,
    summed over the layers."""
    _check_decoder_only(cfg)
    dev = _device(params)
    tokens, labels = batch["tokens"].to(dev), batch["labels"].to(dev)
    x = _embed_input(params, cfg, tokens, batch.get("patches"))
    n_img = x.shape[1] - tokens.shape[1]
    x, aux, _ = forward_hidden(params, cfg, x, mode="train")
    if n_img:  # positions [n_img-1, n_img+T-1) predict tok_0..tok_{T-1}
        x = x[:, n_img - 1:n_img - 1 + tokens.shape[1]]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, device=dev) if mask is None
            else mask.to(dev, torch.float32))
    nll_sum, count = chunked_ce(params, cfg, x, labels, mask)
    ce = nll_sum / torch.clamp(count, min=1.0)
    if aux is None:
        aux = torch.zeros((2,), device=dev)
    lb, z = aux[0], aux[1]
    loss = ce + 0.01 * lb + 1e-3 * z
    return loss, {"loss": loss, "ce": ce, "moe_lb": lb, "router_z": z,
                  "tokens": count}


def train_step(params, opt_state: optim.AdamState, batch: dict,
               cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    """One synchronous training step: the loss and its gradient with
    respect to every parameter (which are made to require grad), the
    gradient's global norm, then one Adam step in place.  Returns (params,
    opt_state, metrics), the metrics detached on the device."""
    return adam_step(lm_loss, params, opt_state, batch, cfg, adam_cfg)


def adam_step(loss_fn, params, opt_state: optim.AdamState, batch: dict,
              cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    """`train_step` for any `loss_fn(params, cfg, batch) -> (loss,
    metrics)` (the decoder-only and the enc-dec losses)."""
    adam_cfg = adam_cfg or optim.AdamConfig(lr=3e-4, grad_clip=1.0)
    plist = list(params.parameters())
    with torch.enable_grad():
        params.requires_grad_(True)
        loss, metrics = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, plist)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = optim.global_norm(grads)
    optim.adam_update(adam_cfg, plist, grads, opt_state,
                      norm=metrics["grad_norm"])
    return params, opt_state, metrics


# --- serving -------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: torch.Tensor | None = None, cache_len: int | None = None,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Process the prompt (B, S), after llava's image tokens where patches
    are given, and build the caches.  Returns (last-token logits (B, V),
    caches)."""
    tokens = tokens.to(_device(params))
    x = _embed_input(params, cfg, tokens, patches)
    caches = init_caches(cfg, tokens.shape[0], cache_len or x.shape[1],
                         cache_dtype, x.device)
    x, _, caches = forward_hidden(params, cfg, x, mode="prefill",
                                  caches=caches)
    return logits_for(params, cfg, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) -> (logits (B, V), caches).  The KV
    caches are updated in place (see `models.attention`)."""
    x = embed_tokens(params, cfg, token.to(_device(params))[:, None])
    x, _, caches = forward_hidden(params, cfg, x, mode="decode",
                                  caches=caches)
    return logits_for(params, cfg, x)[:, 0], caches


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt: torch.Tensor,
                    n_new: int, patches: torch.Tensor | None = None,
                    frames: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy decoding: prefill the prompt (B, S) (after llava's image
    tokens where patches are given; for whisper against the encoded
    frames, through `encdec`), then n_new - 1 decode steps.  Returns the
    (B, n_new) generated tokens (int64), on the parameters' device.  The
    caches are bf16, as in the reference."""
    if cfg.is_encdec:
        from . import encdec
        logits, caches = encdec.prefill(params, cfg, frames, prompt,
                                        cache_len=prompt.shape[1] + n_new)
        step = encdec.decode_step
    else:
        n_img = patches.shape[1] if cfg.vision_dim and patches is not None \
            else 0
        logits, caches = prefill(params, cfg, prompt, patches,
                                 cache_len=n_img + prompt.shape[1] + n_new)
        step = decode_step
    toks = [torch.argmax(logits, dim=-1)]
    for _ in range(n_new - 1):
        logits, caches = step(params, cfg, toks[-1], caches)
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1)
