"""gemma2-27b [dense] — local/global alternating attention, logit softcaps.

The port's copy of `repro.configs.gemma2_27b`, value for value.

arXiv:2408.00118.  46L, d_model 4608, 32 heads GQA kv=16 (head_dim 128),
d_ff 36864 (GeGLU), vocab 256000.  Gemma-2 specifics honored: sandwich
(post) norms, (1+scale) RMSNorm, sqrt(d_model) embedding scale, tied
embeddings, attn softcap 50, final-logit softcap 30, query scale
(d_model/n_heads)^-1/2 = 144^-1/2, 4096-token sliding window on every other
layer (odd layers global).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    kv_heads=16,
    d_ff=36864,
    vocab=256_000,
    head_dim=128,
    mixer="attn",
    ffn="geglu",
    norm="rmsnorm",
    norm_scale_plus_one=True,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    attn_scale=(4608 / 32) ** -0.5,
    rope=True,
    rope_theta=10000.0,
    window=4096,
    window_pattern=2,  # layer i global iff i % 2 == 1
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=256, vocab=509, window=16, attn_scale=16.0 ** -0.5,
        loss_chunk=32, attn_block_k=32)
