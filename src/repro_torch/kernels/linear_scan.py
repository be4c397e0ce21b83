"""Gated linear recurrence (o, S_final), as two CUDA kernels
(`csrc/linear_scan.cu`, `csrc/linear_scan_chunked.cu`) and their plain
PyTorch versions.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T                 state (dk, dv)
    o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)           RWKV6 read
    o_t = q_t @ S_t                                     GLA/Mamba read
                                                        (decay_before_read)

`linear_scan` replaces the Pallas TPU kernel
`repro/kernels/linear_scan.py:linear_scan`, with its contract: q, k, w
(B, T, dk), v (B, T, dv), each float32 or bfloat16 on its own (the SSM
branch hands q and v in bf16, k and w in f32), all math in float32; u (dk,)
or None (None: no bonus scaling, u = 1), s0 (B, dk, dv) or None (zeros);
any T >= 1; o comes back in q's dtype and S_final in float32.  Where grad
mode is on and an input requires grad, the call goes through `LinearScan`
(a `torch.autograd.Function`): the forward is the kernel, the backward the
vjp of `linear_scan_chunked` at its default chunk, recomputed from the
saved inputs with the forward's reading of u and s0 (None: no bonus
scaling, a zero state), as the reference's `ops._ls_bwd` does (the JAX
package has no backward kernel).

Two instances, picked by shape (`pick_instance`): "chunked"
(`linear_scan_chunked.cu`, chunk-parallel over T in three launches: each
chunk's end state from zero, the carry over the chunks, each chunk's outputs
from its incoming state) for T of at least one chunk and dk <= 64, "step"
(`linear_scan.cu`, the steps in order, one launch) otherwise, e.g. a decode
step.  `linear_scan.launches` counts the calls that launched a kernel,
`linear_scan.instance_launches` the same by instance.

`linear_scan_chunked` ports `repro/kernels/ref.py:linear_scan_chunked` (the
Pallas kernel's chunk-parallel algorithm, o in float32) and, with o cast to
q's dtype, is the kernels' plain version: a CPU tensor takes it.
`linear_scan_sequential` ports the exact step-by-step oracle
`ref.linear_scan`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

SOURCES = {"step": "linear_scan.cu", "chunked": "linear_scan_chunked.cu"}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
             + (ctypes.c_int,) * 4 + (ctypes.c_int, ctypes.c_void_p))
_ARGTYPES_CHUNKED = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4
                     + (ctypes.c_int,) * 4 + (ctypes.c_int,) * 3
                     + (ctypes.c_void_p,))
_DTYPES = (torch.float32, torch.bfloat16)
# the chunked instance's layout, as csrc/linear_scan_chunked.cu has it:
# state rows per thread, the largest dk, threads of a block, steps of a
# chunk, and the shared memory that a chunk's tiles may take
CHUNKED_ROWS = 16
CHUNKED_MAX_DK = 64
CHUNKED_MAX_THREADS = 256
CHUNKED_MAX_CHUNK = 64
CHUNKED_SMEM_BUDGET = 48 * 1024


class ChunkPlan(NamedTuple):
    """Lanes per column (G), columns per block, steps per chunk."""

    groups: int
    cols: int
    chunk: int


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def chunked_plan(dk: int, dv: int) -> ChunkPlan:
    """The chunked instance's layout for (dk, dv), as its `make_plan`: G =
    dk/16 lanes per column (a power of two), G x cols threads (a warp to
    256), and the largest chunk <= 64 whose tiles fit 48 KB whatever the
    dtypes: q, k, w as float32 and as raw bf16 (chunk x 16 G each, 6 bytes
    a value) and v as float32 (chunk x cols)."""
    if not 1 <= dk <= CHUNKED_MAX_DK:
        raise ValueError(f"the chunked scan takes dk <= {CHUNKED_MAX_DK}, "
                         f"got {dk}")
    groups = _ceil_pow2(-(-dk // CHUNKED_ROWS))
    dkp = groups * CHUNKED_ROWS
    cols = min(max(_ceil_pow2(dv), 32 // groups),
               CHUNKED_MAX_THREADS // groups)
    chunk = CHUNKED_MAX_CHUNK
    while chunk > 1 and chunk * (18 * dkp + 4 * cols) > CHUNKED_SMEM_BUDGET:
        chunk //= 2
    return ChunkPlan(groups, cols, chunk)


def pick_instance(t: int, dk: int) -> str:
    """"chunked" for at least one full chunk of steps and dk <= 64 (hymba's
    prefill, RWKV6's 64 x 64 state), "step" otherwise (a decode step, short
    or ragged prompts below one chunk, dk above 64)."""
    return ("chunked" if t >= CHUNKED_MAX_CHUNK and dk <= CHUNKED_MAX_DK
            else "step")


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


class LinearScan(torch.autograd.Function):
    """The forward of `_forward` (a kernel on a CUDA tensor), the backward of
    `linear_scan_chunked` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, w, u, s0, decay_before_read, chunk, instance):
        ctx.save_for_backward(q, k, v, w, u, s0)
        ctx.decay_before_read = decay_before_read
        return _forward(q, k, v, w, u, s0,
                        decay_before_read=decay_before_read, chunk=chunk,
                        instance=instance)

    @staticmethod
    def backward(ctx, grad_o, grad_s):
        saved = ctx.saved_tensors
        inputs = [x.detach().requires_grad_(need) if x is not None else None
                  for x, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            o, s = linear_scan_chunked(
                *inputs, decay_before_read=ctx.decay_before_read)
            wrt = [x for x in inputs if x is not None and x.requires_grad]
            # S_final depends on neither q nor u: only the outputs that the
            # inputs asked for reach
            outs = [(y, g) for y, g in ((o.to(saved[0].dtype), grad_o),
                                        (s, grad_s)) if y.requires_grad]
            grads = iter(torch.autograd.grad(
                [y for y, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True))
        return (*(next(grads) if x is not None and x.requires_grad else None
                  for x in inputs), None, None, None)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor | None = None,
                s0: torch.Tensor | None = None, *,
                decay_before_read: bool = False, chunk: int = 64,
                instance: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, S_final in float32).  On the CPU the plain
    `linear_scan_chunked` with `chunk`; on a CUDA tensor a kernel, which
    takes its own chunk size: the instance `pick_instance` gives for the
    shape, or the one named by `instance` ("step" or "chunked", for
    comparing the two).  Differentiable through `LinearScan`."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, w, u, s0)):
        return LinearScan.apply(q, k, v, w, u, s0, decay_before_read, chunk,
                                instance)
    return _forward(q, k, v, w, u, s0, decay_before_read=decay_before_read,
                    chunk=chunk, instance=instance)


def _forward(q, k, v, w, u, s0, *, decay_before_read: bool, chunk: int,
             instance: str | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the CPU, a kernel on a CUDA tensor."""
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
    kind = pick_instance(t, dk) if instance is None else instance
    if kind not in SOURCES:
        raise ValueError(f"unknown linear scan instance {kind!r}")
    o = torch.empty((b, t, dv), dtype=q.dtype, device=q.device)
    s_fin = torch.empty((b, dk, dv), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        s_fin.copy_(s0 if s0 is not None else torch.zeros_like(s_fin))
        return o, s_fin
    # the two small operands in float32, as the kernels read them
    u32 = u.float().contiguous() if u is not None else None
    s032 = s0.float().contiguous() if s0 is not None else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr() if u32 is not None else None,
            s032.data_ptr() if s032 is not None else None,
            o.data_ptr(), s_fin.data_ptr())
    dtypes = tuple(int(x.dtype == torch.bfloat16) for x in (q, k, v, w))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "chunked":
        plan = chunked_plan(dk, dv)
        n_chunks = -(-t // plan.chunk)
        s_loc = torch.empty((b, n_chunks, dk, dv), dtype=torch.float32,
                            device=q.device)
        prod_w = torch.empty((b, n_chunks, dk), dtype=torch.float32,
                             device=q.device)
        _build.launcher(SOURCES[kind], "linear_scan_chunked",
                        _ARGTYPES_CHUNKED)(
            *ptrs, s_loc.data_ptr(), prod_w.data_ptr(), b, t, dk, dv,
            *dtypes, int(decay_before_read), plan.chunk, plan.cols, stream)
    else:
        _build.launcher(SOURCES[kind], "linear_scan", _ARGTYPES)(
            *ptrs, b, t, dk, dv, *dtypes, int(decay_before_read), stream)
    linear_scan.launches += 1
    linear_scan.instance_launches[kind] += 1
    return o, s_fin


linear_scan.launches = 0
linear_scan.instance_launches = dict.fromkeys(SOURCES, 0)
