"""The training and serving entry points (port of `repro.models.api`):
one interface over the decoder-only models (`lm`) and the enc-dec whisper
(`encdec`), dispatched on `cfg.is_encdec`.

`init` and `init_caches` take `device=None`, which means the GPU, and raise
without one unless the caller asks for the CPU (`device="cpu"`).  `loss`,
`train_step`, `prefill` and `decode_step` run where the parameters are.
Batches come from `data.synthetic` with the reference's keys: "tokens",
"labels", and llava's "patches" or whisper's "frames".
"""
from __future__ import annotations

import torch

from .. import optim, resolve_device
from . import encdec, lm
from .config import ArchConfig


def init(cfg: ArchConfig, seed: int = 0, device=None) -> torch.nn.Module:
    """Parameters drawn from a `torch.Generator` seeded with `seed` on the
    device, then cast once to `cfg.param_dtype` (float32 training masters;
    "bfloat16" is the serving artifact, as the reference's
    `api.abstract_params` treats it)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        params = (encdec if cfg.is_encdec else lm).init(gen, cfg)
    return params.to(getattr(torch, cfg.param_dtype))


def param_axes(cfg: ArchConfig) -> dict:
    """{parameter name: logical axes} (see `parallel.sharding`)."""
    return (encdec if cfg.is_encdec else lm).param_axes(cfg)


def abstract_params(cfg: ArchConfig) -> torch.nn.Module:
    """The parameters on the meta device: shapes and `cfg.param_dtype`, no
    storage (the reference's `jax.eval_shape` of `init`)."""
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        params = (encdec if cfg.is_encdec else lm).init(gen, cfg)
    return params.to(getattr(torch, cfg.param_dtype))


def cache_axes(cfg: ArchConfig) -> dict:
    """{cache leaf name: logical axes}, named as `lm.flat_names` of the
    caches (`init_caches`, or an enc-dec model's `prefill`)."""
    return (encdec if cfg.is_encdec else lm).cache_axes(cfg)


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16) -> dict:
    """The decode caches on the meta device (no storage)."""
    if cfg.is_encdec:
        return encdec.abstract_caches(cfg, batch, max_len, dtype)
    return lm.init_caches(cfg, batch, max_len, dtype, torch.device("meta"))


def loss(params, cfg: ArchConfig, batch: dict):
    """batch: {"tokens", "labels", optional "mask", "patches" (llava) or
    "frames" (whisper)} -> (scalar loss, metrics)."""
    return (encdec if cfg.is_encdec else lm).lm_loss(params, cfg, batch)


def train_step(params, opt_state: optim.AdamState, batch: dict,
               cfg: ArchConfig, adam_cfg: optim.AdamConfig | None = None):
    """One Adam step on `batch`, in place -> (params, opt_state, metrics)."""
    fn = encdec.train_step if cfg.is_encdec else lm.train_step
    return fn(params, opt_state, batch, cfg, adam_cfg)


def prefill(params, cfg: ArchConfig, batch: dict,
            cache_len: int | None = None, cache_dtype=torch.bfloat16):
    """batch: {"tokens": (B, S), optional "patches" (llava), "frames"
    (whisper)} -> (last-token logits (B, V), caches)."""
    if cfg.is_encdec:
        return encdec.prefill(params, cfg, batch["frames"], batch["tokens"],
                              cache_len=cache_len, cache_dtype=cache_dtype)
    return lm.prefill(params, cfg, batch["tokens"],
                      patches=batch.get("patches"), cache_len=cache_len,
                      cache_dtype=cache_dtype)


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: dict):
    """One new token (B,) against the caches -> (logits (B, V), caches)."""
    fn = encdec.decode_step if cfg.is_encdec else lm.decode_step
    return fn(params, cfg, token, caches)


def serve_step(params, cfg: ArchConfig, token: torch.Tensor, caches: dict):
    """Alias of `decode_step`, the reference's name for one served token."""
    return decode_step(params, cfg, token, caches)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Empty caches of every layer: KV buffers, SSM and RWKV states, the
    dense prefix's.  An enc-dec model's caches come from `prefill` (the
    cross KV depends on the encoder's output)."""
    if cfg.is_encdec:
        raise ValueError("enc-dec caches are built by prefill (cross-KV "
                         "depends on the encoder output)")
    return lm.init_caches(cfg, batch, max_len, dtype, resolve_device(device))
