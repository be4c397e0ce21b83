"""ArchConfig: one dataclass covering all ten assigned architectures.

A copy of `repro.models.config.ArchConfig` (the port imports nothing of the
JAX package), field for field, so a config means the same in both packages.
Two defaults differ: `attn_impl` and `scan_impl` are "kernel", which runs
the CUDA kernel on a CUDA tensor and its plain PyTorch version on a CPU
tensor; "chunked"/"naive" and "chunked"/"scan" select the plain forms on
any device.  Training reads `remat` (one checkpoint per layer group) and
`loss_chunk`, decode `decode_combine` (on a device mesh); the JAX-only
fields (remat_policy, scan_layers, unroll_scans, ...) are kept so that
configs stay comparable, and the port does not read them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int               # query heads (attention mixers)
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads

    # block structure
    mixer: str = "attn"        # attn | mamba | rwkv | attn+mamba
    ffn: str = "swiglu"        # swiglu | geglu | gelu_mlp | moe | rwkv_cmix
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    norm_scale_plus_one: bool = False  # gemma (1 + scale) RMSNorm
    post_norms: bool = False   # gemma-2 sandwich norms
    parallel_block: bool = False  # command-r: attn & ffn from the same norm
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    logit_softcap: float = 0.0  # 0 -> off
    attn_softcap: float = 0.0

    # attention geometry
    rope: bool = True
    rope_theta: float = 10000.0
    attn_scale: float = 0.0    # 0 -> head_dim**-0.5 (gemma-2: query_pre_attn)
    max_positions: int = 32768  # learned-pos archs (whisper) table size
    window: int = 0            # sliding-window size; 0 -> full attention
    window_pattern: int = 0    # gemma-2: layer i is GLOBAL iff i % pattern
    #                            == pattern-1; 0 -> window on all layers

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_dense: int = 0        # dense FFN width of the first layers
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25
    norm_topk: bool = True     # renormalize top-k gates (moonshot yes, deepseek no)
    moe_group_size: int = 4096  # GShard dispatch group (tokens)

    # ssm / rwkv
    ssm_state: int = 0
    d_conv: int = 4
    rwkv_lora: int = 32        # token-shift mix lora rank
    rwkv_decay_lora: int = 64  # data-dependent decay lora rank

    # enc-dec / modality frontends (STUBS per the brief)
    encoder_layers: int = 0    # >0 -> whisper-style enc-dec
    max_source_positions: int = 1500
    vision_dim: int = 0        # llava: precomputed patch-embedding width
    vision_tokens: int = 576   # anyres base grid (24x24) — stub frontend

    # numerics / implementation
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # f32 training masters; serve in bf16
    attn_impl: str = "kernel"    # kernel | chunked | naive
    scan_impl: str = "kernel"    # kernel | chunked | scan
    attn_block_k: int = 1024
    scan_chunk: int = 64
    remat: bool = True           # checkpoint each layer group in training
    remat_policy: str = "nothing"  # nothing | dots | proj_dots
    #                              (proj_dots = dots_with_no_batch_dims:
    #                               save x@W outputs, recompute attention)
    scan_layers: bool = True     # lax.scan over layer stacks
    decode_combine: str = "allgather"  # seq-sharded KV combine: allgather|flash
    loss_chunk: int = 512        # chunked cross-entropy sequence chunk
    unroll_scans: bool = False   # the reference's dry-run calibration
    #                              (XLA counts a while body once); kept for
    #                              parity: the port runs every layer and
    #                              chunk eagerly, and its dry run counts
    #                              them all (launch/dryrun.py)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def group_size(self) -> int:
        """Layers per scan group (window_pattern or dense-prefix handling)."""
        return self.window_pattern if self.window_pattern else 1

    def layer_is_global(self, i: int) -> bool:
        """Full-attention layer? (gemma-2 local/global alternation)."""
        if self.window == 0:
            return True
        if self.window_pattern == 0:
            return False
        return i % self.window_pattern == self.window_pattern - 1

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.mixer in ("rwkv",)

    # rough parameter count (the exact count comes from the built model)
    def approx_params(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        per_layer = 0
        if "attn" in self.mixer:
            per_layer += d * self.hd * (self.n_heads + 2 * self.kv_heads) \
                + self.n_heads * self.hd * d
        if "mamba" in self.mixer:
            per_layer += 2 * d * d + d * (2 * self.ssm_state * self.n_heads)
        if self.mixer == "rwkv":
            per_layer += 4 * d * d + 2 * d * 64
        if self.ffn == "moe":
            expert = 3 * d * ff
            per_layer += self.n_experts * expert \
                + self.n_shared_experts * expert + d * self.n_experts
        elif self.ffn == "swiglu" or self.ffn == "geglu":
            per_layer += 3 * d * ff
        else:
            per_layer += 2 * d * ff
        total = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            total += self.encoder_layers * (4 * d * d + 2 * d * ff)
        return total
