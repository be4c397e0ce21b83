"""deepseek-moe-16b [moe] — fine-grained MoE with shared experts.

The port's copy of `repro.configs.deepseek_moe_16b`, value for value.

arXiv:2401.06066 (DeepSeekMoE).  28L, d_model 2048, 16 heads (MHA: kv=16,
head_dim 128), 64 routed experts top-6 + 2 shared (expert d_ff 1408),
first layer dense (d_ff 10944), vocab 102400.  DeepSeek-v1 routing: top-k
gates are NOT renormalized.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    head_dim=128,
    mixer="attn",
    ffn="moe",
    norm="rmsnorm",
    rope=True,
    rope_theta=10_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_dense=10944,
    first_dense_layers=1,
    norm_topk=False,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=48, d_ff_dense=128, n_experts=8, top_k=2, vocab=497,
        moe_group_size=64, loss_chunk=32, attn_block_k=32)
