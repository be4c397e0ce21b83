"""Assigned input-shape set (identical for all LM-family architectures).

The port's copy of `repro.configs.shapes` (pure Python), line for line.

``decode_*`` / ``long_*`` lower `serve_step` (one new token against a KV
cache of seq_len), NOT `train_step`.  `long_500k` requires sub-quadratic
attention and only runs for SSM / hybrid / SWA-bounded architectures — the
skip logic lives in `cells()` and every skip carries its reason into the
dry-run and roofline tables.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def long_context_ok(cfg: ArchConfig) -> tuple[bool, str]:
    """Can this architecture serve a 500k-token context?"""
    if cfg.mixer == "rwkv":
        return True, "attention-free (O(1) state)"
    if cfg.mixer == "attn+mamba":
        return True, "hybrid: SWA + SSM state bound the context"
    if cfg.window and not cfg.window_pattern and not cfg.is_encdec:
        return True, f"sliding window {cfg.window} bounds the KV cache"
    if cfg.is_encdec:
        return False, "enc-dec: 500k decoder positions out of family (30s receptive field)"
    if cfg.window_pattern:
        return False, "global full-attention layers -> O(S^2)/O(S) KV at 500k"
    return False, "pure full attention -> unbounded KV at 500k"


def cells(cfg: ArchConfig) -> list[tuple[ShapeConfig, bool, str]]:
    """All four (shape, runnable, reason) cells for an architecture."""
    out = []
    for shape in SHAPES.values():
        if shape.name == "long_500k":
            ok, reason = long_context_ok(cfg)
            out.append((shape, ok, reason))
        else:
            out.append((shape, True, ""))
    return out
