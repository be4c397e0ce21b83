"""command-r-35b [dense] — parallel-block decoder, no biases.

The port's copy of `repro.configs.command_r_35b`, value for value.

hf:CohereForAI/c4ai-command-r-v01 (unverified tier).  40L, d_model 8192,
64 heads GQA kv=8 (head_dim 128), d_ff 22528 (SwiGLU), vocab 256000.
Cohere specifics: attention and FFN branch from the SAME pre-norm
(parallel block), bias-free LayerNorm, tied embeddings, rope_theta 8e6.
(The released model's 0.0625 logit_scale multiplier is folded into the
embedding init here — noted, not modeled separately.)
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22528,
    vocab=256_000,
    head_dim=128,
    mixer="attn",
    ffn="swiglu",
    norm="layernorm_nobias",
    parallel_block=True,
    tie_embeddings=True,
    rope=True,
    rope_theta=8_000_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=8, kv_heads=2, head_dim=16,
        d_ff=160, vocab=499, loss_chunk=32, attn_block_k=32)
