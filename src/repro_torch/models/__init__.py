"""LM substrate of the port (counterpart of `repro.models`).

  config     ArchConfig, a copy of the reference's dataclass
  attention  GQA + RoPE + SWA + softcap; train/prefill/decode paths
  ssm        Mamba-2-style selective SSM (hymba's branch)
  blocks     norm + mixer + FFN block assembly, per-layer kinds, caches
  lm         decoder-only assembly, loss and training step, serving entry
             points, weight loading
  api        the entry points a trainer or a server calls

Only what the registered architectures (`repro_torch.configs.ARCH_NAMES`)
run is ported: the MoE FFN, the RWKV mixer, enc-dec and the vision
projector are not.  Submodules are imported where they are used.
"""
from .config import ArchConfig

__all__ = ["ArchConfig"]
