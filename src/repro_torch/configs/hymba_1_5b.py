"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

The port's copy of `repro.configs.hymba_1_5b`, value for value.
arXiv:2411.13676 (NVIDIA Hymba).  32L, d_model 1600, 25 query heads with
GQA kv=5 (head_dim 64), d_ff 5504, vocab 32001, ssm_state 16.

Simplifications (as in the JAX package): Hymba's meta-tokens are omitted,
and its {first, middle, last}-layer global attention becomes a
global-every-8th-layer pattern so the layer stack is uniform; all other
layers use the paper's sliding window.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    mixer="attn+mamba",
    ffn="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=10000.0,
    window=1024,
    window_pattern=8,   # layer i global iff i % 8 == 7 (see module docstring)
    ssm_state=16,
    d_conv=4,
)


def reduced() -> ArchConfig:
    """Smoke-test scale: same family, tiny dimensions."""
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=5, kv_heads=1, head_dim=16,
        d_ff=128, vocab=257, window=16, window_pattern=8, ssm_state=4,
        moe_group_size=64, loss_chunk=32, scan_chunk=8, attn_block_k=32)
