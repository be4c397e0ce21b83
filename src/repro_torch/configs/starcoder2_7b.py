"""starcoder2-7b [dense] — GQA + RoPE code model (arXiv:2402.19173).

The port's copy of `repro.configs.starcoder2_7b`, value for value.

32L, d_model 4608, 36 heads GQA kv=4 (head_dim 128), d_ff 18432 (plain GELU
MLP), vocab 49152.  StarCoder2 uses LayerNorm and biases on attention/MLP
projections; per the assignment's feature list the attention is full causal
(no sliding window), which is also what rules this arch out of long_500k.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    mixer="attn",
    ffn="gelu_mlp",
    norm="layernorm",
    attn_bias=True,
    mlp_bias=True,
    rope=True,
    rope_theta=100_000.0,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=192, vocab=501, loss_chunk=32, attn_block_k=32)
