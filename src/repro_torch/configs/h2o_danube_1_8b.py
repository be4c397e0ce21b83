"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

The port's copy of `repro.configs.h2o_danube_1_8b`, value for value.

arXiv:2401.16818.  24L, d_model 2560, 32 heads GQA kv=8 (head_dim 80),
d_ff 6912 (SwiGLU), vocab 32000, 4096-token sliding window on every layer —
the window bounds the KV cache, which qualifies the long_500k cell.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    kv_heads=8,
    d_ff=6912,
    vocab=32000,
    head_dim=80,
    mixer="attn",
    ffn="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=10000.0,
    window=4096,
    window_pattern=0,  # SWA on every layer
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=160, vocab=493, window=16, loss_chunk=32, attn_block_k=32)
