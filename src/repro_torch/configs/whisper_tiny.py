"""whisper-tiny [audio] — encoder-decoder speech backbone.

The port's copy of `repro.configs.whisper_tiny`, value for value.
arXiv:2212.04356.  4 encoder + 4 decoder layers, d_model 384, 6 heads
(kv 6, head_dim 64), d_ff 1536 (GELU MLP), vocab 51865, LayerNorm and
biases, learned positions, tied decoder head.

The conv1d audio frontend is a stub, as in the JAX package: a batch
carries precomputed frame embeddings (B, 1500, 384) (`data.synthetic`).
The learned decoder position table is sized to the largest decoder length
of the shape set (32,768); the released model decodes at most 448
positions.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    mixer="attn",
    ffn="gelu_mlp",
    norm="layernorm",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    rope=False,
    max_source_positions=1500,
    max_positions=32768,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        kv_heads=4, head_dim=16, d_ff=128, vocab=479,
        max_source_positions=24, max_positions=128,
        loss_chunk=32, attn_block_k=32)
