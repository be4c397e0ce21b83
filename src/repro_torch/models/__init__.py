"""LM substrate of the port (counterpart of `repro.models`).

  config     ArchConfig, a copy of the reference's dataclass
  attention  GQA + RoPE + SWA + softcap; train/prefill/decode paths
  ssm        Mamba-2-style selective SSM (hymba's branch)
  rwkv       RWKV-6 time mix (the WKV scan) and channel mix (rwkv6)
  moe        routed + shared experts with capacity dispatch (deepseek,
             moonshot)
  blocks     norm + mixer + FFN block assembly, per-layer kinds, caches
  lm         decoder-only assembly (dense prefix, llava's projector), loss
             and training step, serving entry points, weight loading
  encdec     whisper's encoder-decoder: encoder, cross-attention, its own
             loss, training step and serving entry points
  api        the entry points a trainer or a server calls

Every architecture of the reference (`repro_torch.configs.ARCH_NAMES`)
runs.  Submodules are imported where they are used.
"""
from .config import ArchConfig

__all__ = ["ArchConfig"]
