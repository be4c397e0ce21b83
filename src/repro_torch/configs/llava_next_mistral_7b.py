"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres vision prefix.

The port's copy of `repro.configs.llava_next_mistral_7b`, value for value.

hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified tier).  Backbone: 32L,
d_model 4096, 32 heads GQA kv=8 (head_dim 128), d_ff 14336 (SwiGLU),
vocab 32000, rope_theta 1e6, full attention (mistral-v0.2 base, no SWA).

The anyres tiling frontend is a STUB per the brief: `input_specs()` feeds
precomputed CLIP patch embeddings (B, 576, 1024); the in-model part — the
2-layer GELU mm-projector — IS implemented (models/lm.py `projector`), and
the projected image tokens are prepended to the text sequence.  Cell
`seq_len` counts the TOTAL sequence (image prefix + text).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    mixer="attn",
    ffn="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1_000_000.0,
    vision_dim=1024,
    vision_tokens=576,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=160, vocab=491, vision_dim=32, vision_tokens=16,
        loss_chunk=32, attn_block_k=32)
