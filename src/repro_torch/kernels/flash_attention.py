"""Flash attention forward (online-softmax GQA attention), as two CUDA
kernels and their plain PyTorch versions.

`flash_attention` replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py:flash_attention`, with its whole contract:
GQA (query head h reads kv head h // (Hq / Hkv)), causal masking in the
decode convention (q holds the last Sq of the Skv positions), a sliding
window (key k is seen by query q iff k > q - window), logit softcap
(cap * tanh(x / cap)), an explicit scale, ragged Sq and Skv, rows with no
valid key giving 0, float32 statistics and the output in q's dtype.  Where
grad mode is on and an input requires grad, the call goes through
`FlashAttention` (a `torch.autograd.Function`): the forward is the kernel,
the backward the vjp of `mha_chunked` at its default `block_k`, recomputed
from the saved q, k, v, as the reference's `ops._fa_bwd` does (the JAX
package has no backward kernel).

The instance follows the dtype (`instance`):
  bfloat16 on CUDA  "tensor_core": `csrc/flash_attention_tc.cu`, wgmma in
                    bf16 with float32 accumulators, tiles loaded by TMA.
                    P is rounded to bf16 before P V.  TMA takes 16-byte-
                    aligned bases and strides that are multiples of 16 bytes
                    (`tma_strides`); the wrapper raises on any other view.
  float32 on CUDA   "cuda_core": `csrc/flash_attention.cu`, exact float32 on
                    the CUDA cores (no TF32).
  any CPU tensor    `mha_chunked`.

`mha_chunked` ports `repro/kernels/ref.py:mha_chunked` (online softmax over
kv blocks) and is the kernels' plain version.  `mha` ports `ref.mha` (the
whole logits matrix).  `flash_attention.launches` counts the calls that
launched a kernel, `flash_attention.instance_launches` those of each
instance.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCES = {"cuda_core": "flash_attention.cu",
           "tensor_core": "flash_attention_tc.cu"}
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
             + (ctypes.c_longlong,) * 9
             + (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float))
_ARGTYPES_CUDA_CORE = _ARGTYPES + (ctypes.c_void_p,)
_ARGTYPES_TENSOR_CORE = _ARGTYPES + (ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p)
MAX_HEAD_DIM = 256
# the tensor-core instances: head dim padded to -> (query rows, keys) per
# tile, as `Tile` in csrc/flash_attention_tc.cu
TC_TILES = {64: (128, 128), 128: (128, 64), 256: (64, 64)}
TMA_ALIGN = 16      # bytes: TMA's base address and stride granularity
TMA_MAX_STRIDE = 1 << 40


def instance(dtype: torch.dtype) -> str:
    """The kernel that takes a CUDA tensor of `dtype`."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                    f"got {dtype}")


def padded_head_dim(d: int) -> int:
    """The tensor-core instance a head dim runs in: 64, 128 or 256."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside the kernel's 1..."
                         f"{MAX_HEAD_DIM}")
    return next(dp for dp in sorted(TC_TILES) if d <= dp)


def tma_strides(t: torch.Tensor, name: str = "tensor"
                ) -> tuple[int, int, int]:
    """Byte strides of the (B, H, S) axes of a (B, H, S, D) bf16 tensor as
    the TMA descriptor takes them; raises ValueError on a view TMA cannot
    read (a base not 16-byte aligned, a stride not a multiple of 16 bytes
    or past 2^40).  An axis of size 1 is never stepped along, so its stride
    is replaced by the tensor's span rounded up to 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                         f"{TMA_ALIGN}-byte aligned, as TMA needs")
    span = -(-(t.numel() * size) // TMA_ALIGN) * TMA_ALIGN
    out = []
    for axis in range(3):
        if t.shape[axis] == 1:
            out.append(max(span, TMA_ALIGN))
            continue
        stride = t.stride(axis) * size
        if stride % TMA_ALIGN or not 0 < stride < TMA_MAX_STRIDE:
            raise ValueError(
                f"{name}: stride {t.stride(axis)} of axis {axis} is {stride} "
                f"bytes; TMA needs a positive multiple of {TMA_ALIGN} bytes "
                f"below 2^40 (shape {tuple(t.shape)}, strides {t.stride()})")
        out.append(stride)
    return out[0], out[1], out[2]


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, Sq, D) -> (B, Hkv, group * Sq, D): the query rows of each kv
    head side by side, so GQA is one batched product per kv head."""
    b, hq, sq, d = q.shape
    return q.reshape(b, hkv, (hq // hkv) * sq, d)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int | None) -> torch.Tensor:
    """(rows, keys) bool: key k_pos visible from absolute position q_pos."""
    mask = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        softcap: float | None = None, scale: float | None = None
        ) -> torch.Tensor:
    """Attention through the whole (Sq, Skv) logits matrix, as `ref.mha`.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D).  A row with no valid key is
    NaN here (softmax of all -inf), as in the reference."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = _grouped(q.float(), hkv)
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = (torch.arange(sq, device=q.device) + (skv - sq)).repeat(hq // hkv)
    mask = _mask(q_pos, torch.arange(skv, device=q.device), causal, window)
    logits = torch.where(mask, logits, float("-inf"))
    out = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int | None = None,
                softcap: float | None = None, scale: float | None = None,
                block_k: int = 512) -> torch.Tensor:
    """Online softmax over kv blocks of `block_k`, as `ref.mha_chunked`:
    float32 statistics, rows with no valid key keep m = -inf and give 0,
    the output in q's dtype.  Same shapes as `mha`."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = _grouped(q.float(), hkv)                  # (B, Hkv, G*Sq, D)
    q_pos = (torch.arange(sq, device=q.device) + (skv - sq)).repeat(group)
    m = torch.full(qg.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(qg.shape[:-1], device=q.device)
    acc = torch.zeros(qg.shape, device=q.device)
    for start in range(0, skv, block_k):
        k_blk = k[:, :, start:start + block_k].float()
        v_blk = v[:, :, start:start + block_k].float()
        logits = torch.matmul(qg, k_blk.transpose(-1, -2)) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        k_pos = torch.arange(start, start + k_blk.shape[2], device=q.device)
        mask = _mask(q_pos, k_pos, causal, window)
        logits = torch.where(mask, logits, float("-inf"))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # rows with no valid key yet keep m = -inf: guard the rescale
        alpha = torch.exp(torch.where(torch.isinf(m), 0.0, m - m_new))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.matmul(p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int | None, softcap: float | None) -> None:
    """Raise on anything the kernel of q's dtype does not take."""
    instance(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         f"batch and head_dim must agree, Hq % Hkv == 0")
    padded_head_dim(d)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must have a unit stride along head_dim")
    if instance(q.dtype) == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            tma_strides(t, name)
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")


class FlashAttention(torch.autograd.Function):
    """The forward of `_forward` (the kernel on a CUDA tensor), the backward
    of `mha_chunked` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return _forward(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mha_chunked(*inputs, **ctx.kw)
        return (*torch.autograd.grad(out, inputs, grad), None, None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  On the CPU the plain `mha_chunked`; on a CUDA tensor the kernel
    of its dtype (`instance`), which takes strided views whose last axis is
    contiguous (the model's head-transposed q, k, v) and writes a
    contiguous output.  Differentiable through `FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int | None, softcap: float | None,
             scale: float | None) -> torch.Tensor:
    """The plain version on the CPU, the kernel on a CUDA tensor."""
    if q.device.type == "cpu":
        return mha_chunked(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check_inputs(q, k, v, window, softcap)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kind = instance(q.dtype)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d)
    tail = (int(causal), int(window or 0), float(softcap or 0.0),
            float(scale))
    if kind == "tensor_core":
        strides = (*tma_strides(q, "q"), *tma_strides(k, "k"),
                   *tma_strides(v, "v"))
        _build.launcher(SOURCES[kind], "flash_attention_tc",
                        _ARGTYPES_TENSOR_CORE)(
            *head, *strides, *tail, *TC_TILES[padded_head_dim(d)], stream)
    else:
        _build.launcher(SOURCES[kind], "flash_attention",
                        _ARGTYPES_CUDA_CORE)(
            *head, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *tail,
            stream)
    flash_attention.launches += 1
    flash_attention.instance_launches[kind] += 1
    return out


flash_attention.launches = 0
flash_attention.instance_launches = dict.fromkeys(SOURCES, 0)
