"""rwkv6-1.6b [ssm] — Finch: attention-free linear RNN with data-dependent

The port's copy of `repro.configs.rwkv6_1_6b`, value for value.
decay (arXiv:2404.05892, unverified tier).

24L, d_model 2048, d_ff 7168 (channel-mix), vocab 65536, head_dim 64 ->
32 WKV heads.  O(1)-state decode is what qualifies the long_500k cell.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / head_dim WKV heads
    kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    mixer="rwkv",
    ffn="rwkv_cmix",
    norm="layernorm",
    rope=False,
    rwkv_lora=32,
    rwkv_decay_lora=64,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=487, rwkv_lora=8, rwkv_decay_lora=8,
        loss_chunk=32, scan_chunk=8)
