"""Gated linear recurrence (o, S_final), as the CUDA kernel
(`csrc/linear_scan.cu`) and its plain PyTorch versions.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T                 state (dk, dv)
    o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)           RWKV6 read
    o_t = q_t @ S_t                                     GLA/Mamba read
                                                        (decay_before_read)

`linear_scan` replaces the Pallas TPU kernel
`repro/kernels/linear_scan.py:linear_scan`, with its contract: q, k, w
(B, T, dk), v (B, T, dv), each float32 or bfloat16 on its own (the SSM
branch hands q and v in bf16, k and w in f32), all math in float32; u (dk,)
or None (None: no bonus scaling, u = 1), s0 (B, dk, dv) or None (zeros);
any T >= 1; o comes back in q's dtype and S_final in float32.  It is
forward only: on a CUDA tensor it raises if grad mode is on and an input
requires grad.

`linear_scan_chunked` ports `repro/kernels/ref.py:linear_scan_chunked` (the
Pallas kernel's chunk-parallel algorithm, o in float32) and, with o cast to
q's dtype, is the kernel's plain version: a CPU tensor takes it.
`linear_scan_sequential` ports the exact step-by-step oracle
`ref.linear_scan`.  `linear_scan.launches` counts the calls that launched
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "linear_scan.cu"
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
             + (ctypes.c_int,) * 4 + (ctypes.c_int, ctypes.c_void_p))
_DTYPES = (torch.float32, torch.bfloat16)


def linear_scan_sequential(q, k, v, w, u=None, s0=None, *,
                           decay_before_read: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one step at a time, as `ref.linear_scan`: float32,
    o (B, T, dv) and S_final (B, dk, dv)."""
    b, t, dk = q.shape
    dv = v.shape[-1]
    q, k, v, w = (x.float() for x in (q, k, v, w))
    s = (torch.zeros((b, dk, dv), device=q.device) if s0 is None
         else s0.float())
    outs = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        if decay_before_read:
            s = w[:, i, :, None] * s + kv
            outs.append(torch.einsum("bk,bkv->bv", q[:, i], s))
        else:
            read = s + (u.float()[None, :, None] * kv if u is not None
                        else kv)
            outs.append(torch.einsum("bk,bkv->bv", q[:, i], read))
            s = w[:, i, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def linear_scan_chunked(q, k, v, w, u=None, s0=None, *,
                        decay_before_read: bool = False, chunk: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel form, as `ref.linear_scan_chunked`: within a chunk
    dense products with the pair decays exp(cw_t - cw_s) <= 1, between
    chunks the (dk, dv) state.  Ragged T pads with w = 1, k = 0.  float32
    o (B, T, dv) and S_final (B, dk, dv)."""
    b, t, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    q, k, v, w = (x.float() for x in (q, k, v, w))
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (q, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    nc = (t + pad) // chunk
    s = (torch.zeros((b, dk, dv), device=q.device) if s0 is None
         else s0.float())
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device),
                      diagonal=0 if decay_before_read else -1)
    eye = torch.eye(chunk, device=q.device)
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb, wb = q[:, sl], k[:, sl], v[:, sl], w[:, sl]
        cw = torch.cumsum(torch.log(torch.clamp(wb, min=1e-30)), dim=1)
        if decay_before_read:
            q_decay = torch.exp(cw)
            pair = cw[:, :, None, :] - cw[:, None, :, :]
        else:
            cw_prev = torch.cat([torch.zeros_like(cw[:, :1]), cw[:, :-1]],
                                dim=1)
            q_decay = torch.exp(cw_prev)
            pair = cw_prev[:, :, None, :] - cw[:, None, :, :]
        pair = torch.where(mask[None, :, :, None], pair, float("-inf"))
        a = torch.einsum("btd,bsd,btsd->bts", qb, kb, torch.exp(pair))
        if not decay_before_read:
            bonus = u.float()[None, None, :] * kb if u is not None else kb
            a = a + (qb * bonus).sum(dim=-1)[:, :, None] * eye[None]
        outs.append(torch.einsum("bts,bsv->btv", a, vb)
                    + torch.einsum("btk,bkv->btv", qb * q_decay, s))
        k_decay = torch.exp(cw[:, -1:, :] - cw)
        s = torch.exp(cw[:, -1])[..., None] * s + torch.einsum(
            "btk,btv->bkv", kb * k_decay, vb)
    return torch.cat(outs, dim=1)[:, :t], s


def _check_inputs(q, k, v, w, u, s0) -> None:
    """Raise on anything the kernel does not take."""
    for name, x in (("q", q), ("k", k), ("v", v), ("w", w)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"linear scan kernel takes float32 or bfloat16 "
                            f"operands, got {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != 3 or k.shape != q.shape or w.shape != q.shape \
            or v.ndim != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k, w must be (B, T, dk) and v (B, T, dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}, {tuple(v.shape)}")
    b, _, dk = q.shape
    dv = v.shape[-1]
    if not (1 <= dk <= 512 and 1 <= dv <= 65535):
        raise ValueError(f"(dk, dv) = ({dk}, {dv}) outside the kernel's "
                         f"range: dk <= 512, dv <= 65535")
    for name, x, shape in (("u", u, (dk,)), ("s0", s0, (b, dk, dv))):
        if x is not None and (tuple(x.shape) != shape
                              or x.device != q.device):
            raise ValueError(f"{name} must be {shape} on {q.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, w, u, s0)):
        raise RuntimeError("the linear scan kernel is forward only: run it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor | None = None,
                s0: torch.Tensor | None = None, *,
                decay_before_read: bool = False, chunk: int = 64
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, S_final in float32).  On the CPU the plain
    `linear_scan_chunked` with `chunk`; on a CUDA tensor the kernel, which
    walks the steps in order and takes no chunk size."""
    if q.device.type == "cpu":
        o, s = linear_scan_chunked(q, k, v, w, u, s0,
                                   decay_before_read=decay_before_read,
                                   chunk=chunk)
        return o.to(q.dtype), s
    if q.device.type != "cuda":
        raise ValueError(f"no linear scan kernel for device {q.device}")
    _check_inputs(q, k, v, w, u, s0)
    b, t, dk = q.shape
    dv = v.shape[-1]
    o = torch.empty((b, t, dv), dtype=q.dtype, device=q.device)
    s_fin = torch.empty((b, dk, dv), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        s_fin.copy_(s0 if s0 is not None else torch.zeros_like(s_fin))
        return o, s_fin
    # the two small operands in float32, as the kernel reads them
    u32 = u.float().contiguous() if u is not None else None
    s032 = s0.float().contiguous() if s0 is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launcher(_SOURCE, "linear_scan", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr() if u32 is not None else None,
        s032.data_ptr() if s032 is not None else None,
        o.data_ptr(), s_fin.data_ptr(), b, t, dk, dv,
        *(int(x.dtype == torch.bfloat16) for x in (q, k, v, w)),
        int(decay_before_read), stream)
    linear_scan.launches += 1
    return o, s_fin


linear_scan.launches = 0
