"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B-style fine-grained MoE.

The port's copy of `repro.configs.moonshot_v1_16b_a3b`, value for value.

hf:moonshotai/Moonlight-16B-A3B.  48L, d_model 2048, 16 heads (kv=16,
head_dim 128), 64 routed experts top-6 + 2 shared (expert d_ff 1408),
first layer dense (d_ff 11264), vocab 163840, renormalized top-k gates.
Per the assignment the attention is GQA (the released model's MLA variant
is out of the assigned scope — noted in DESIGN.md).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    head_dim=128,
    mixer="attn",
    ffn="moe",
    norm="rmsnorm",
    rope=True,
    rope_theta=50_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_dense=11264,
    first_dense_layers=1,
    norm_topk=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=48, d_ff_dense=128, n_experts=8, top_k=2, vocab=503,
        moe_group_size=64, loss_chunk=32, attn_block_k=32)
