"""GQA attention for the LM architectures (port of `repro.models.attention`).

Grouped-query attention with RoPE, sliding windows (ring-buffer KV caches),
logit softcap and optional QKV biases.  Three entry points:

  full_attention     causal self-attention, no cache (teacher forcing)
  prefill_attention  causal self-attention + cache build
  decode_attention   one token against the KV cache

Prefill goes through `kernels.ops.attention` (the flash kernel on a CUDA
tensor for `attn_impl="kernel"`).  Decode is plain PyTorch, as in the
reference, with its two combines for a cache split over the "kv_seq"
mesh axis: "allgather" (the dense path) and "flash" (`_flash_decode`:
partial softmaxes merged across the axis); without a device mesh both are
the dense path.  Compute dtype follows the inputs; softmax statistics are
float32.

On a device mesh (`parallel.sharding`) the weights, activations and
caches are DTensors, laid out at the reference's `constrain` sites.  What
DTensor has no rule for runs at one place each, on local shards:
  * a flat H x hd projection into heads (`sharding.unflatten`): an uneven
    split (25 heads over 2 ranks) is replicated first; the output
    projection's gradient comes back laid out as its input
    (`sharding.grad_layout`);
  * the cache writes (`_store`): each rank writes the slots of its own
    sequence shard into its local buffer, in place;
  * the decode read: the dense one under `local_map` on each rank's heads
    of the gathered cache, the flash one under `local_map` on each rank's
    slots with explicit all-reduces.

Unlike the reference, the caches are updated in place (the KV buffers are
the largest decode-time tensors): prefill writes into the buffers
`init_cache` made, each decode step writes its slot and returns the same
buffers, so a cache dict must not be reused after it was passed on.  `pos`
is a Python int, so a decode step needs no host-device sync.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import nn
from ..kernels import ops as kops
from ..parallel import sharding
from ..parallel.sharding import Roles, local_map_roles
from .config import ArchConfig


# --- RoPE --------------------------------------------------------------------
def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for `positions` (any shape) -> (..., head_dim/2)."""
    half = head_dim // 2
    exponents = -torch.arange(0, half, dtype=torch.float32,
                              device=positions.device) / half
    # theta as a Python scalar: no host-to-device copy (a blocking one on
    # the card) at every layer and decode step
    freqs = torch.pow(float(theta), exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs (x[..., :h], x[..., h:]), the neox/llama convention, in
    float32.  x (B, H, S, D); cos/sin (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- parameters ---------------------------------------------------------------
def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One attention block's parameters."""
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": nn.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.attn_bias),
        "wk": nn.dense_init(gen, d, cfg.kv_heads * hd, bias=cfg.attn_bias),
        "wv": nn.dense_init(gen, d, cfg.kv_heads * hd, bias=cfg.attn_bias),
        "wo": nn.dense_init(gen, cfg.n_heads * hd, d, bias=cfg.attn_bias),
    }


def param_axes(cfg: ArchConfig) -> dict:
    """Logical axes mirroring `init` (see `parallel.sharding.param_specs`)."""
    def with_bias(ax):
        return {"w": ax, "b": (ax[-1],)} if cfg.attn_bias else {"w": ax}

    return {
        "wq": with_bias(("embed", "heads")),
        "wk": with_bias(("embed", "kv_heads")),
        "wv": with_bias(("embed", "kv_heads")),
        "wo": with_bias(("heads", "embed")),
    }


# --- cache --------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window: int | None, dtype=torch.bfloat16, device=None) -> dict:
    """Empty KV cache for one layer.  Sliding-window layers get a ring
    buffer bounded by the window; global layers a full-length buffer."""
    length = min(window, max_len) if window else max_len
    shape = (batch, cfg.kv_heads, length, cfg.hd)
    ax = cache_axes()["k"]
    return {"k": sharding.place(torch.zeros(shape, dtype=dtype,
                                            device=device), *ax),
            "v": sharding.place(torch.zeros(shape, dtype=dtype,
                                            device=device), *ax),
            "pos": 0}  # absolute position of the next write


def cache_axes() -> dict:
    """Logical axes of `init_cache`'s buffers (`pos` is a Python int)."""
    return {"k": ("batch", "kv_heads", "kv_seq", None),
            "v": ("batch", "kv_heads", "kv_seq", None),
            "pos": None}


def _qkv(p, cfg: ArchConfig, x: torch.Tensor):
    """x (B, S, D) -> q (B, Hq, S, hd), k/v (B, Hkv, S, hd) (views)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = sharding.unflatten(nn.dense(p["wq"], x, dtype=x.dtype), 2,
                           (cfg.n_heads, hd))
    k = sharding.unflatten(nn.dense(p["wk"], x, dtype=x.dtype), 2,
                           (cfg.kv_heads, hd))
    v = sharding.unflatten(nn.dense(p["wv"], x, dtype=x.dtype), 2,
                           (cfg.kv_heads, hd))
    q = sharding.constrain(q.transpose(1, 2), "batch", "heads", None, None)
    k = sharding.constrain(k.transpose(1, 2), "batch", "kv_heads", None, None)
    v = sharding.constrain(v.transpose(1, 2), "batch", "kv_heads", None, None)
    return q, k, v


def _out(p, cfg: ArchConfig, o: torch.Tensor) -> torch.Tensor:
    """o (B, Hq, S, hd) -> (B, S, D)."""
    b, _, s, _ = o.shape
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return nn.dense(p["wo"], sharding.grad_layout(o), dtype=o.dtype)


def _attend(cfg: ArchConfig, q, k, v, window: int | None) -> torch.Tensor:
    return kops.attention(
        q, k, v, causal=True, window=window,
        softcap=cfg.attn_softcap or None, scale=cfg.attn_scale or None,
        impl=cfg.attn_impl, block_k=cfg.attn_block_k)


# --- train / prefill -----------------------------------------------------------
def full_attention(p, cfg: ArchConfig, x: torch.Tensor, *,
                   window: int | None) -> torch.Tensor:
    """Causal self-attention over the whole sequence (no cache)."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope:
        cos, sin = rope_table(torch.arange(s, device=x.device), cfg.hd,
                              cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return _out(p, cfg, _attend(cfg, q, k, v, window))


def prefill_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict, *,
                      window: int | None) -> tuple[torch.Tensor, dict]:
    """Causal self-attention + cache population (prefill path).

    Assumes an empty cache (pos == 0) and s <= cache length for global
    layers; sliding-window layers keep only the trailing `window` keys, the
    key of position i in slot i % length."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope:
        cos, sin = rope_table(torch.arange(s, device=x.device), cfg.hd,
                              cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = _attend(cfg, q, k, v, window)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[2]
    if isinstance(ck, DTensor):  # each rank writes its own shard's slots
        first = max(s - length, 0)
        slots = [i % length for i in range(first, s)]
        _store(ck, k[:, :, first:], slots)
        _store(cv, v[:, :, first:], slots)
    elif length >= s:  # global layer (or a window not yet full): [0, s)
        ck[:, :, :s] = k
        cv[:, :, :s] = v
    else:  # ring buffer: the last `length` positions, slot = pos % length
        slots = (torch.arange(length, device=x.device) + (s - length)) \
            % length
        ck.index_copy_(2, slots, k[:, :, s - length:].to(ck.dtype))
        cv.index_copy_(2, slots, v[:, :, s - length:].to(cv.dtype))
    return _out(p, cfg, o), {"k": ck, "v": cv, "pos": s}


def _seq_range(buf: DTensor) -> tuple[int, int]:
    """(first slot, slot count) of this rank's shard of a DTensor cache
    (B, H, L, D) along L; the whole buffer where L is not split."""
    length = buf.shape[2]
    mesh = buf.device_mesh
    split = [j for j, pl in enumerate(buf.placements)
             if isinstance(pl, Shard) and pl.dim == 2]
    if not split:
        return 0, length
    if len(split) > 1:
        raise NotImplementedError("a cache split over two mesh dims")
    n = length // mesh.shape[split[0]]
    return mesh.get_local_rank(split[0]) * n, n


def _store(buf: DTensor, new, slots: list[int]) -> None:
    """Write `new` (B, H, n, D) into the slots `slots` (n global slot
    indices) of a DTensor cache, in place and shard-locally: `new` is laid
    out as `buf` over batch and heads, and each rank writes the slots of
    its own sequence shard (a rank outside a slot's shard leaves its cache
    as it was)."""
    mesh = buf.device_mesh
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == 2
                 else pl for pl in buf.placements)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    lo, n = _seq_range(buf)
    pairs = [(i, s - lo) for i, s in enumerate(slots) if lo <= s < lo + n]
    if not pairs:
        return
    local, upd = buf.to_local(), new.to_local().to(buf.dtype)
    src, dst = zip(*pairs)
    if list(dst) == list(range(dst[0], dst[0] + len(dst))) and \
            list(src) == list(range(src[0], src[0] + len(src))):
        local[:, :, dst[0]:dst[0] + len(dst)] = \
            upd[:, :, src[0]:src[0] + len(src)]
    else:
        dev = local.device
        local.index_copy_(2, torch.tensor(dst, device=dev),
                          upd.index_select(2, torch.tensor(src, device=dev)))


# --- decode ---------------------------------------------------------------------
def _partial_softmax_attn(q, k, v, mask, softcap: float, scale: float):
    """Attention over a KV slice with its partial-softmax statistics.

    q (B, Hq, 1, D); k, v (B, Hkv, L, D); mask (L,) of valid slots.
    Returns (acc, m, l), each grouped (B, Hkv, group, .): acc the sum of
    exp(logits - m_safe) v, m the row max (-inf where every slot is
    masked), l the exp-sum.  out = acc / l here; a combine across shards
    rescales each shard's by exp(m - m_max) first (flash decoding)."""
    b, hkv, _, d = k.shape
    qg = q.float().reshape(b, hkv, q.shape[1] // hkv, d)
    logits = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    pr = torch.where(mask, torch.exp(logits - m_safe), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    return torch.matmul(pr, v.float()), m, l


def _valid_slots(pos: int, slots: torch.Tensor, length: int,
                 window: int | None) -> torch.Tensor:
    """Valid-slot mask.  Ring buffer: slot s holds absolute position
    pos - ((pos - s) mod L); cold slots (never written) come out < 0.
    Global buffer: slots [0, pos]."""
    if window:
        return pos - torch.remainder(pos - slots, length) >= 0
    return slots <= pos


def _dense_decode(cfg: ArchConfig, pos: int, window: int | None, q, ck, cv):
    """One query row (B, Hq, 1, D) against whole caches -> (B, Hq, 1, D)
    float32 (each rank's heads on a mesh)."""
    length = ck.shape[2]
    mask = _valid_slots(pos, torch.arange(length, device=q.device), length,
                        window)
    acc, _, l = _partial_softmax_attn(q, ck, cv, mask,
                                      cfg.attn_softcap or 0.0,
                                      cfg.attn_scale or cfg.hd ** -0.5)
    o = acc / torch.clamp(l, min=1e-30)
    return (o.reshape(q.shape),)


def decode_attention(p, cfg: ArchConfig, x: torch.Tensor, cache: dict, *,
                     window: int | None, combine: str = "allgather"
                     ) -> tuple[torch.Tensor, dict]:
    """One-token attention against the cache.  x: (B, 1, D).

    `combine` is how a cache split along its sequence over the mesh axis
    of "kv_seq" is read: "allgather" gathers the slices (the dense path),
    "flash" attends to each slice where it lies and merges the partial
    softmaxes (`_flash_decode`).  Without a device mesh, or where that
    axis does not divide the cache length, both are the dense path."""
    q, k, v = _qkv(p, cfg, x)  # (B, H*, 1, hd)
    pos = cache["pos"]  # absolute position of this token
    if cfg.rope:
        cos, sin = rope_table(torch.arange(pos, pos + 1, device=x.device),
                              cfg.hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[2]
    slot = pos % length if window else min(pos, length - 1)
    new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    if combine == "flash":
        axis = _flash_axis(length)
        if axis is not None:
            o = _flash_decode(cfg, q, ck, cv, k, v, pos, slot, window, axis)
            return _out(p, cfg, o.to(x.dtype)), new_cache
    elif combine != "allgather":
        raise ValueError(f"unknown decode combine: {combine}")
    if isinstance(ck, DTensor):
        _store(ck, k, [slot])
        _store(cv, v, [slot])
    else:
        ck[:, :, slot] = k[:, :, 0]
        cv[:, :, slot] = v[:, :, 0]
    # on a mesh, each rank reads its heads of the whole (gathered) cache
    heads = Roles(0, 1)
    o, = local_map_roles(
        lambda *a: _dense_decode(cfg, pos, window, *a), (q, ck, cv),
        (heads, heads, heads), (heads,))
    return _out(p, cfg, o.to(x.dtype)), new_cache


def _flash_axis(length: int) -> str | None:
    """The mesh axis of "kv_seq" under the current rules where a device
    mesh is bound and the axis divides `length`, else None."""
    rules = sharding.current_rules()
    if rules is None or rules.mesh is None or \
            not hasattr(rules.mesh, "mesh_dim_names"):
        return None
    axis = rules.mesh_axes("kv_seq")
    if not isinstance(axis, str) or axis not in rules.sizes or \
            length % rules.sizes[axis]:
        return None
    return axis


def _flash_decode(cfg: ArchConfig, q, ck: DTensor, cv: DTensor, k_new,
                  v_new, pos: int, slot: int, window: int | None, axis: str):
    """Flash decoding with a shard-local cache update (the reference's
    `_flash_decode`, under `local_map`).

    Each rank of `axis` holds a contiguous slice of the cache's slots and
    every head: it writes the new key where the slot falls in its slice
    (the other ranks leave theirs as they were), attends to its slice,
    and the partial softmaxes merge across the axis with an all-reduce
    MAX of m, then SUMs of acc exp(m - m_max) and l exp(m - m_max).  A
    cache laid out otherwise (split over heads, as the default rules lay
    a cache whose KV heads divide the axis) is written in place where it
    lies and read through a copy in that layout.  -> (B, Hq, 1, D)
    float32."""
    from ..core import collectives

    mesh = ck.device_mesh
    j = list(mesh.mesh_dim_names).index(axis)
    layout = tuple(Shard(2) if i == j else
                   (pl if isinstance(pl, Shard) and pl.dim == 0
                    else Replicate())
                   for i, pl in enumerate(ck.placements))
    tok = tuple(Replicate() if i == j else pl for i, pl in enumerate(layout))
    if tuple(ck.placements) == layout:
        kf, vf = ck, cv
    else:  # the slot where the cache lies, then a copy laid out by slot
        _store(ck, k_new, [slot])
        _store(cv, v_new, [slot])
        kf, vf = ck.redistribute(mesh, layout), cv.redistribute(mesh, layout)
    q, k_new, v_new = (t.redistribute(mesh, tok)
                       if tuple(t.placements) != tok else t
                       for t in (q, k_new, v_new))
    n = ck.shape[2] // mesh.shape[j]
    lo = mesh.get_local_rank(j) * n
    group = mesh.get_group(j)

    def shard_fn(q_s, kc, vc, kn, vn):
        if lo <= slot < lo + n:
            kc[:, :, slot - lo] = kn[:, :, 0].to(kc.dtype)
            vc[:, :, slot - lo] = vn[:, :, 0].to(vc.dtype)
        mask = _valid_slots(pos, lo + torch.arange(n, device=kc.device),
                            ck.shape[2], window)
        acc, m, l = _partial_softmax_attn(q_s, kc, vc, mask,
                                          cfg.attn_softcap or 0.0,
                                          cfg.attn_scale or cfg.hd ** -0.5)
        m_max = collectives.all_reduce_(m.clone(), group, dist.ReduceOp.MAX)
        w = torch.exp(m - m_max)        # 0 on fully masked slices
        num = collectives.all_reduce_(acc * w, group)
        den = collectives.all_reduce_(l * w, group)
        return ((num / torch.clamp(den, min=1e-30)).reshape(q_s.shape),)

    from torch.distributed.tensor.experimental import local_map
    o, = local_map(shard_fn, out_placements=(tok,),
                   in_placements=(tok, layout, layout, tok, tok),
                   device_mesh=mesh)(q, kf, vf, k_new, v_new)
    return o
