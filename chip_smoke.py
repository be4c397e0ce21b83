#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, and any failure exits non-zero:
  1. prints the card's name and power limit, the torch and CUDA versions, and
     the TF32 flags: matmuls full float32 (torch's default, set for the
     run); cuDNN's flag left at torch's default, since the package runs the
     policy's convolutions in its own setting (`repro_torch.CONV_ALLOW_TF32`,
     False: float32), which is printed, so that the run measures what the
     entry point runs;
  2. builds every CUDA kernel of the three paths from the sources in the
     checkout (one nvcc per source, all ten started together: the fused
     RHS has a cluster and a two-pass source, dg_derivative3 a tiled and a
     generic one, flash attention a bf16 tensor-core and a float32
     CUDA-core one, the linear scan a chunked and a step one) and prints
     each build's time and nvcc's register report (read by the kernel
     audit's parser, `repro_torch.analysis.kernel_audit`), then the
     static-analysis gate on the card (`analysis_phase`: every layer of
     `repro_torch.analysis` with `device="cuda"`; any unsuppressed
     finding fails, a spill not measured and kept among them), then the RHS
     cluster plans of
     24-DOF and 32-DOF and how many of their clusters the card holds at
     once, and the chunked scan's plan, blocks per SM and waves at hymba's
     prefills;
  3. holds each kernel to its plain PyTorch version on the card, in float32
     and bfloat16: the fused RHS, both instances, on synthetic and real HIT
     states (24-DOF at 16 envs and at the fleet's 8, 32-DOF, n=3 K=3, a
     non-cubic mesh), the cluster
     instance also bit for bit against itself; the three
     channel kernels at the channel path's shapes (16 envs), the fleet's
     channel sub-fleet's (8 envs), the split paths' (a channel_wm x-slab
     of 3 ranks; dg_derivative3 and smagorinsky_nut also on a 24-DOF
     x-slab of 2) and beyond
     (dg_derivative3 on both instances, the tiled one at every n from 2 to
     8 and C from 1 to 5; smagorinsky_nut on the strided views it reads in
     place, aligned or not, and a stride-0 C_s); flash
     attention (each instance, with the model's transposed views, D up to
     256, ragged S) and the linear scan (each instance) at hymba-1.5b's
     shapes and at the other corners of their contracts; then one RL
     interval of each CFD
     scenario on the kernel path against the staged plain path, and
     hymba-1.5b at full width in float32 (prefill of 2 x 1,100 tokens and 4
     teacher-forced decode steps) and in bf16 (the prefill) on the kernel
     path against the plain path; then the two LM wrappers with inputs
     that require grad (their autograd Functions: the kernel forward, the
     plain chunked backward) against the plain forms at hymba's training
     shape (batch 2 x 4,096 tokens; flash windowed, where whole kv blocks
     of a row are masked, and global, bf16 and float32; the scan on its
     chunked instance): the kernel's forward output, and the gradients
     (the Function's wiring);
  4. times each kernel at its path's shape (16 envs; hymba's prefill of
     4 x 2,048 tokens): its device time (torch.profiler over back-to-back
     calls, in turns plain, kernel, kernel, plain), which the kernels'
     record reports as `ms`; one call alone with the wrapper's host work
     (CUDA events), `call_ms`; the same two for the plain version and,
     where one PyTorch call computes the same function, for that call; and
     the bound, from the bytes and operations the call needs; for the fused
     RHS both instances at 24-DOF and 32-DOF in float32 and bf16, and the
     device kernels in the trace of 50 calls (the cluster kernel alone);
     for flash
     attention at both hymba shapes also the float32 CUDA-core instance,
     and the device kernels in the trace of five bf16 calls (the
     tensor-core kernel alone); the linear scan's two instances side by
     side at hymba's prefill and the step instance at decode; the wall
     model at both walls' P = 4,608 beside one wall's 2,304;
     dg_derivative3's two instances and torch.matmul(K, u) at the channel's
     shape and at 1,024 elements of n = 6; smagorinsky_nut at P = 36,864
     and 6 x that on the gradient's velocity rows (the path's call), on a
     contiguous copy and as a copy plus the kernel (PR 16's call); the
     card's floor per launch (a one-element PyTorch elementwise kernel);
     and the device kernels of a bf16 dg_derivative3 call with a bf16 D
     and of smagorinsky_nut as the channel calls it (each its kernel
     alone: no cast, no copy); at hymba's training shape, flash attention's
     and the scan's kernel forward, the plain backward their Functions run
     and both together, beside SDPA forward + backward;
  5. drives the six paths through their entry points, each with every
     launch count set to 0 just before it and read just after:
     `hit_les_24dof` through `repro_torch.launch.rl_train` (2 PPO iterations
     + 1 evaluation, 16 envs) must launch the fused RHS exactly 3 episodes x
     50 steps x 13 substeps x 5 stages times, all on its cluster instance;
     the paper's static baselines (`rollout.constant_action_return`,
     Smagorinsky C_s = 0.17 and implicit LES C_s = 0) on its held-out
     test state, printed beside the evaluation return, each finite in
     [-1, 1] and launching the fused RHS 3,250 times on its cluster
     instance;
     `channel_wm` (1 iteration, no
     evaluation, 16 envs) must launch dg_derivative3, smagorinsky_nut and
     wall_model_tau exactly 20 x 26 x 5 times each (the wall model once
     per RHS for both walls; dg_derivative3 all on its tiled instance);
     the fleet `hit_les_24dof` + `channel_wm` + `burgers_96dof` through
     `fleet.make_fleet_runner` (32 envs, at least 8 each: 8 / 8 / 16, one
     shared multitask policy) trains one pipelined iteration (2 fleet
     rollouts), one more pipelined iteration (1 rollout), then a second
     runner one synchronous iteration (1 rollout, with t_sample_s and
     t_update_s) followed by the evaluation episode of every scenario:
     each fleet rollout or evaluation must launch the fused RHS
     50 x 13 x 5 = 3,250 times (one launch per RK stage for all HIT envs,
     all on the cluster instance) and each channel kernel
     20 x 26 x 5 = 2,600 times (dg_derivative3 all tiled), with update_ok
     1 and every scenario's return_norm and eval_return_norm in [-1, 1];
     the env-steps the non-finite guard reverted are counted per
     sub-fleet: none in the channel and Burgers rollouts, none in any
     evaluation (the mean action), and the synchronous return no higher
     than the reverted share allows (HIT's exploratory steps are reverted:
     see PERF.md); then one RL step of each sub-fleet is timed, and
     Burgers' step and one RK substep of the channel's (5 RHS calls)
     profiled for their launches per RHS;
     the fleet's trained controllers served from the pipelined runner's
     newest checkpoint (`serve.load_service`, one CUDA graph per (scenario,
     bucket)) on observations its envs produced: two passes of 1, 2, 3, 5,
     16 and 37 requests per scenario, every served action and value equal
     to `multitask.actor_mean` / `value` on the same padded batch bit for
     bit, one capture per (scenario, bucket), the counters equal to what
     was sent, no RL kernel launched; batch-1 rows against a batch of 16;
     p50 / p99 latency of submit -> flush per (scenario, bucket), graph
     replay and eager dispatch;
     the fleet across ranks on the one card (`distributed_phase`): the
     collectives (`core.collectives.all_gather_cat`, `core.compression`'s
     `compressed_psum` in its three codecs and `chunked_psum`) on a
     one-rank NCCL group, bit for bit their single-process values; then,
     under `python -m torch.distributed.run --standalone` of this script's
     `--rank-worker` mode (ranks sharing the card use gloo), `rl_train`
     on hit_les_24dof with 16 envs over 2 ranks (one iteration) and the
     fleet at 8 / 8 / 16 envs over 3 ranks (each scenario padded to 9 /
     9 / 18, one synchronous iteration): every rank's launches exact
     (3,250 RHS, 2,600 of each channel kernel per rank and rollout) and
     summed over the ranks by an all-reduce, params, Adam state and
     broker bitwise equal on every rank, update_ok 1, every return_norm
     in [-1, 1], no revert in the channel and Burgers rollouts, the
     fleet's gathered step-0 observations, actions and rewards within
     TOL_FLEET_ROWS of the one-process synchronous iteration above (and
     the rows one env off outside it), and env-steps/s beside that
     iteration's; then hit_les_24dof with its 16 envs each split over 2
     ranks by its x-slabs (`FleetConfig(elem_axis="model")` on a (data 1,
     model 2) mesh, `split_rank`, episodes cut to 10 RL steps): one RL
     interval of 16 bank rows under a fixed C_s field within TOL_SPLIT of
     the same staged assembly in one process and within TOL of the fused
     kernel path (the state one env off outside TOL_SPLIT), one in bf16
     within the bf16 TOL of the same assembly in bf16 in one process, then
     one PPO iteration (no evaluation) that launches dg_derivative3
     (tiled) and smagorinsky_nut exactly 650 times a rank and the fused
     RHS never, params and Adam state bitwise on both ranks, return_norm
     in [-1, 1], the step-0 rows within TOL_FLEET_ROWS of one process's
     first RL step of the same assembly; the ranks' times, the halo
     exchanges' and the gathers' seconds and bytes, and env-steps/s beside
     the HIT path's; then channel_wm and burgers_96dof, 16 envs each, every
     env split over 3 ranks by its element axis (a (data 1, model 3) mesh,
     `split3_rank`, episodes cut to 5 RL steps): for each one RL interval
     within TOL_SPLIT of the same assembly in one process and within TOL of
     the unsplit path (the state one env off outside TOL_SPLIT), one PPO
     iteration (no evaluation) with exact launches a rank (the channel 650
     each of dg_derivative3 (tiled), smagorinsky_nut and wall_model_tau,
     Burgers none), params and Adam state bitwise on the 3 ranks,
     return_norm in [-1, 1], and each rank's exchanges and env-steps/s
     beside one process's rollout of the same cut episode;
     hymba-1.5b serving (bf16 weights from a seed,
     `lm.greedy_generate` of 32 new tokens for 4 prompts of 2,048 Zipf
     tokens, then for 4 of 700) must launch flash_attention 32 times, all on
     its tensor-core instance, and linear_scan 1,024 times per batch (32
     layers x (1 prefill + 31 decode steps)), the 32 prefill calls on its
     chunked instance and the 992 decode calls on its step instance;
     hymba-1.5b at full width and depth: one step's loss and gradient
     norm at 2 x 4,096 tokens on the kernel path against the plain path,
     and two controls (the kernel path with the attention's window dropped,
     and with the scan's decay read in bf16) that the same gate must
     reject; then training through `repro_torch.launch.train` (float32
     masters, bf16 compute, 2 x 4,096 tokens, Adam): 3 steps and a
     checkpoint, then `--resume` of one more, finite loss and gradient
     norm, flash attention and the chunked scan launched 2 x 32 times a
     step (forward and remat recompute), peak device memory, and disk
     enough for two checkpoints checked first; then
     profiles one RL step of each CFD path (the channel's launches per
     RHS), one HIT PPO epoch, one hymba prefill and one decode step
     (torch.profiler) to show where the time goes;
  6. prints one JSON line per the kernels' record (`launches` summed over
     the paths, `launches_by_path` beside it), then the last line
     `{"ok": true, "device": {...}}`.
Each phase's start is printed with the run's time so far.

It needs a CUDA device and the repository's `src/` beside it.  The
kernels are built by phase 2, before any rank starts: the ranks load them
from the shared build directory.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, float32 rate
# outside the tensor cores, dense bf16 rate of the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_TC_PER_S = 989e12

# max |kernel - plain| / max |plain| allowed, by I/O dtype.
#   float32: both compute the same formulas in float32, in another summation
#     order (line contractions, quadrature partial sums); 1e-4 leaves two
#     orders of magnitude above the ~1e-6 that reordering gives.
#   bfloat16: both compute in float32 from the same bf16 inputs, but a
#     float32 difference of one ulp can flip the final rounding to bf16
#     (relative step 2^-8 = 3.9e-3 of the value); 4e-2 is the JAX package's
#     own bf16 gate (tests/test_kernel_parity.py).
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# The two elementwise channel kernels compute one short formula per point in
# float32 from the same inputs as their plain versions: float32 1e-5.
TOL_ELEMENTWISE = {"float32": 1e-5, "bfloat16": 4e-2}
# flash attention against mha_chunked: the float32 CUDA-core instance as
# TOL; the bf16 tensor-core instance also rounds P to bf16 before P V,
# which the plain version does not: measured 2.4e-3 to 4.8e-3 of max
# |plain| over the 10 shapes below (a bf16 ulp of the output is 2^-8 to
# 2^-7 of its magnitude), so 1.5e-2, tighter than the general bf16 gate.
TOL_FLASH = {"float32": 1e-4, "bfloat16": 1.5e-2}
# hymba-1.5b at full width in float32, kernel path against plain path: 32
# layers of float32 math that differ only in the order of the attention and
# scan sums (each within ~1e-6 of its plain version); 1e-4 of max |logit|.
TOL_MODEL = 1e-4
# the same in bf16 as served: 1e-1 of max |logit|, the pin of
# tests/test_torch_lm.py::test_bf16_serving_matches_reference (32 layers of
# bf16 activations, each op rounded to bf16 on both paths, where the two
# paths' attention and scan round differently).
TOL_MODEL_BF16 = 1e-1
# a served row alone (bucket 1) against the same row in a batch of 16: the
# same float32 dense layers as GEMMs of other M, which cuBLAS may sum in
# another order; 1e-5 of max |action| (a reorder over <= 648 inputs gives
# ~1e-7)
TOL_SERVE_ROWS = 1e-5
# hymba-1.5b training, one step's loss and gradient norm at 2 x 4,096
# tokens on the kernel path against the plain path (`lm_path_parity`),
# relative.  Measured on an H100 80GB HBM3 at 700 W: the kernel path
# 1.29e-4 (loss) and 1.23e-3 (grad norm); the controls that the gate must
# reject, the attention's window dropped 1.14e-3 / 1.79e-2 and the scan's
# decay read in bf16 1.33e-4 / 2.25e-2.  Each limit sits between the two,
# about 3x from each side (the loss alone cannot tell the bf16 decay from
# the sound path; the grad norm tells both).
TOL_TRAIN_LOSS = 4e-4
TOL_TRAIN_GRAD_NORM = 5e-3
# The fleet's first step over 3 ranks against one process of the same seed:
# a rank rolls 3 of 8 (or 6 of 16) rows, so the policy's dense layers are
# GEMMs of another M (TOL_SERVE_ROWS' reason), whose ulps then pass through
# one RL interval (65 RHS calls for HIT, 130 for the channel) and the
# reward.  Readings (of max |value|, the same in every run on the H100):
# observations 0, actions 0 (HIT, Burgers) and 1.47e-7 (channel), rewards
# 0 (HIT), 1.22e-7 (channel) and 2.60e-6 (Burgers).  The limit sits ~8x
# above the largest; the control (the rows shifted by one env, what a
# wrong shard layout gives) reads O(1).
TOL_FLEET_ROWS = 2e-5
# One env split over ranks by its element axis against the same assembly
# in one process (a group of one rank): only the order of HIT's and
# Burgers' forcing sums differs (the slabs' sums are added over the ranks),
# and a slab's matmuls see fewer elements (cuBLAS may sum another way).
# Readings of one RL interval of 16 envs on an H100 80GB HBM3 at 700 W:
# hit_les_24dof over 2 ranks 3.85e-7 of max |u|, channel_wm over 3
# 5.81e-7, burgers_96dof over 3 5.62e-7, the same in every run; the CPU
# test pins 2e-6 too (tests/test_torch_elem_split.py).  Against the unsplit
# path the float32 TOL holds.  The control (the state one env off) reads
# 0.17 (the channel's bank rows differ little) to O(1).
TOL_SPLIT = 2e-6
SPLIT_ROWS = 16  # envs of each split run, the HIT path's
# RL steps of the split runs' episodes, cut from 50 (hit_les_24dof), 20
# (channel_wm) and 50 (burgers_96dof) to keep the run inside its limit:
# every split RHS exchanges its faces through the host
SPLIT_STEPS = {"hit_les_24dof": 10, "channel_wm": 5, "burgers_96dof": 5}
SPLIT3_NAMES = ("channel_wm", "burgers_96dof")  # split over 3 ranks
FLEET_NAMES = ("hit_les_24dof", "channel_wm", "burgers_96dof")


def ns_rhs_operations(batch: int, kx: int, ky: int, kz: int, n: int) -> int:
    """Float32 operations (+, -, *, /, sqrt, min, max, abs each 1) that one
    fused RHS call needs at these shapes, whatever a kernel recomputes: every
    node's primitives, strain, viscous flux and Euler flux once; each face's
    central values and LLF flux once for the two elements that share it; the
    symmetric Kennedy-Gruber two-point flux once per pair of nodes on a line.
    The work does not depend on the data."""
    n3, elems = n**3, kx * ky * kz
    nodes, faces = batch * elems * n3, batch * elems * 3 * n * n
    per_node = (
        15                      # rho, v (3 div), |v|^2 (5), kinetic (2),
                                # p (2), T (2), E/rho
        + 6 + 4                 # 1/2 m.v; 4 values times the node weight
        + 3 * 4 * (2 * n - 1) + 12  # gradient of (v, T): 3 x 4 lines, jac
        + 6 + 12 + 6            # strain (3 off-diagonal), S:S, nu_t
        + 10 + 3 * 11           # viscous flux: shared terms, per direction
        + 3 * (10 * (n - 1) + 6 + 10 * n)  # split form: half of the n - 1
                                # partners' fluxes (20 each), the Euler flux
                                # (6), D contraction of 5 channels, factor 2
        + 3 * 4 * 2 * n         # viscous volume: D contraction, subtract
        + 15                    # sum of the 3 directions, jac
        + 15)                   # forcing: fluctuation, scale, energy, add
    per_face = 8 + 37 + 12      # central (v, T); LLF; central viscous flux
    per_face_side = 12 + 19     # gradient lift; flux lift
    return (nodes * per_node + faces * (per_face + 2 * per_face_side)
            + 4 * (nodes - batch)  # the weighted sums, per env
            + batch * (4 + 5)      # means; TKE controller
            + 5 * n3)              # node weights w_i w_j w_k / 8


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(label: str, n_bytes: int, ops: int,
             peak: tuple[str, float] = ("fp32", PEAK_FP32_PER_S)
             ) -> tuple[float, str]:
    """Least time for one call: `n_bytes` (each input read once, each output
    written once) at the memory rate against `ops` at `peak` (the float32
    rate unless named); the larger term bounds."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak[1]
    print(f"bound {label}: {n_bytes} bytes -> {t_bytes * 1e3:.7f} ms; {ops} "
          f"{peak[0]} ops -> {t_ops * 1e3:.7f} ms")
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rhs_bound_ms(u, cs, d_matrix, w) -> tuple[float, str]:
    kx, ky, kz, n = u.shape[-7], u.shape[-6], u.shape[-5], u.shape[-2]
    ops = ns_rhs_operations(u.numel() // (kx * ky * kz * n**3 * 5),
                            kx, ky, kz, n)
    return bound_ms("fused RHS", 2 * nbytes(u) + nbytes(cs, d_matrix, w),
                    ops)


def dg_derivative3_operations(u) -> int:
    """n multiply-adds for each value of each of the three derivatives."""
    return 3 * 2 * u.shape[1] * u.numel()


def smagorinsky_operations(p: int) -> int:
    """Per point: the 3 off-diagonal entries of S (2 each), S:S from 6 squares
    with the 3 off-diagonal ones doubled and 5 adds (14), x2 + 1e-30 (2),
    sqrt, (C_s Delta)^2 (2), times |S|."""
    return p * (6 + 14 + 2 + 1 + 2 + 1)


def wall_model_operations(p: int, iters: int) -> int:
    """Per point: the laminar guess (4), per round y+ (2), Reichardt's u+
    (13, each transcendental counted as 1), the floor, the update (4); then
    rho u_tau^2 (2).  The rounds do not end early."""
    return p * (4 + iters * (2 + 13 + 1 + 4) + 2)


def band_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs one attention head must compute: query i at
    absolute position i + skv - sq sees keys <= it (causal) and > it -
    window."""
    total = 0
    for i in range(sq):
        pos = i + skv - sq
        hi = min(skv - 1, pos) if causal else skv - 1
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_operations(heads: int, sq: int, skv: int, d: int, causal: bool,
                     window: int | None) -> int:
    """Per visible pair: q.k and p v, a multiply and an add per element each
    (4 d), the scale, max, exp and sum (4); per query row the d divides.
    Pairs outside the causal/window band need no work."""
    return heads * (band_pairs(sq, skv, causal, window) * (4 * d + 4)
                    + sq * d)


def scan_operations(rows: int, t: int, dk: int, dv: int, gla: bool) -> int:
    """Per step and state entry: k v, w S and their sum (3), then the read:
    q S summed (2, GLA) or u k v, S + it, times q, summed (4, RWKV6)."""
    return rows * t * dk * dv * (5 if gla else 7)


def synthetic_state(gen, shape_prefix, cfg, device, elems=None):
    """Physically plausible conservative state (as the JAX parity tests make
    them): rho ~ 1, subsonic velocity, pressure well clear of vacuum; on
    cfg's cubic mesh unless `elems` gives (Kx, Ky, Kz)."""
    import torch

    n, k = cfg.n_poly + 1, cfg.n_elem
    mesh = tuple(shape_prefix) + (elems or (k, k, k)) + (n, n, n)
    rho = 1.0 + 0.1 * torch.rand(mesh + (1,), generator=gen)
    vel = 0.3 * torch.randn(mesh + (3,), generator=gen)
    p = 7.0 + 0.5 * torch.rand(mesh + (1,), generator=gen)
    e = p / 0.4 + 0.5 * rho * torch.sum(vel**2, dim=-1, keepdim=True)
    return torch.cat([rho, rho * vel, e], dim=-1).to(device)


def rhs_kwargs(cfg, device):
    ops = cfg.operators(device)
    return ops, dict(inv_w_end=ops["inv_w_end"], jac=cfg.dg.jac,
                     delta=cfg.delta_filter, mu=cfg.gas.mu,
                     prandtl=cfg.prandtl, prandtl_turb=cfg.prandtl_turb,
                     forcing_a0=cfg.forcing_a0, k_tke=cfg.k_tke)


def traced(fn) -> tuple[float, list[tuple[float, int, str]]]:
    """Wall ms of one call of `fn` under torch.profiler, and the trace's
    device kernels as (device us, launches, name), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((evt.self_device_time_total, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if str(evt.device_type).endswith("CUDA")
                   and evt.self_device_time_total > 0), reverse=True)
    return wall_ms, rows


def trace_kernels(fn, calls: int = 50) -> list[tuple[float, int, str]]:
    """The device kernels in a trace of `calls` back-to-back calls of `fn`,
    as `traced` gives them: 50 calls, as `device_ms` traces them (windows
    of 5 once showed no kernel); a window the profiler dropped is traced
    again, up to three times in all."""
    for _ in range(3):
        _, rows = traced(lambda: [fn() for _ in range(calls)])
        if rows:
            break
    return rows


# the device functions of the port's own kernels, as the trace names them
OWN_KERNELS = ("ns_rhs_cluster_kernel", "grad_pass", "div_pass",
               "dg_derivative3_kernel", "dg_derivative3_tiled_kernel",
               "smagorinsky_kernel", "wall_model_kernel",
               "flash_attention_kernel", "flash_attention_tc_kernel",
               "linear_scan_kernel", "chunk_state_kernel",
               "chunk_carry_kernel", "chunk_output_kernel")


def profile_window(label: str, fn, card: str) -> int | None:
    """Device busy time, the top kernels and the port's own kernels of one
    call of `fn`; "not measured" where the trace shows no device time.
    Returns the trace's kernel launches (None if it shows none)."""
    wall_ms, rows = traced(fn)
    if not rows:
        print(f"profile {label}: wall {wall_ms:.3f} ms; device time not "
              f"measured (the trace shows none)")
        return None
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile {label} ({card}): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(r[1] for r in rows)} kernel launches")
    for dev_us, count, key in rows[:6]:
        print(f"  {dev_us / 1e3:9.3f} ms {count:6d} x {key[:90]}")
    for own in OWN_KERNELS:
        mine = [r for r in rows if own in r[2]]
        if mine:
            dev_ms = sum(r[0] for r in mine) / 1e3
            count = sum(r[1] for r in mine)
            print(f"  port kernel {own}: {count} launches, {dev_ms:.3f} ms "
                  f"({dev_ms / count:.7f} ms each, "
                  f"{100 * dev_ms / busy_ms:.2f}% of device busy)")
    return sum(r[1] for r in rows)


def device_ms(fn, calls: int) -> float:
    """Device time of one call of `fn`, from a profiler trace of `calls`
    back-to-back calls: for each kernel name, the mean device time of its
    launches in the trace times its launches per call (its count over
    `calls`, rounded, at least 1), summed over the names.  The profiler
    drops some of a window's events (3 to 10 of 50 launches on the H100,
    once about half), which a plain sum over `calls` would count as time
    saved.  A trace that shows no device time is taken again, up to
    three times in all; then CUDA events around the same loop (which also
    count any gaps the host leaves)."""
    import torch

    for _ in range(3):
        _, rows = traced(lambda: [fn() for _ in range(calls)])
        if rows:
            return sum(us / n * max(1, round(n / calls))
                       for us, n, _ in rows) / 1e3
        print("device time: the trace shows none")
    print("device time: CUDA events around the loop")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def event_ms(calls: dict, reps: int = 5) -> dict:
    """Per named zero-argument call: the median of `reps` CUDA-event
    timings of one call (after two warm-up calls), in turns.  For calls of
    tens of milliseconds and thousands of launches, which a profiler
    window of 50 would take minutes to trace."""
    import torch

    for _ in range(2):
        for f in calls.values():
            f()
    times: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(reps):
        for name, f in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, t in times.items():
        print(f"  {name}: {statistics.median(t):.7f} ms (median of "
              f"{reps}: {', '.join(f'{x:.4f}' for x in t)})")
    return {k: statistics.median(v) for k, v in times.items()}


def time_calls(calls: dict, windows: int = 50, alone: int = 25,
               plain_windows: int | None = None) -> tuple[dict, dict]:
    """Per named zero-argument call: its device time per call (profiler over
    `windows` back-to-back calls, one window each in the order of `calls`
    and again in reverse, e.g. plain, kernel, kernel, plain; the mean of
    the two), and one call alone with its host work (median of `alone`
    CUDA-event windows, the calls in turns).  `plain_windows`, where given,
    is the window of the call named "plain": a plain version launches
    hundreds to thousands of kernels a call, so a short window holds
    thousands of events, and the profiler takes seconds per thousand."""
    import torch

    for _ in range(3):  # warm-up
        for f in calls.values():
            f()
    torch.cuda.synchronize()
    alone_times: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(alone):
        for name, f in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            end.synchronize()
            alone_times[name].append(start.elapsed_time(end))
    dev_times: dict[str, list[float]] = {k: [] for k in calls}
    for name in list(calls) + list(reversed(calls)):
        dev_times[name].append(device_ms(
            calls[name], plain_windows if name == "plain" and plain_windows
            else windows))
    for name in calls:
        print(f"  {name}: device time {statistics.mean(dev_times[name]):.7f} "
              f"ms ({', '.join(f'{t:.7f}' for t in dev_times[name])}); one "
              f"call alone {statistics.median(alone_times[name]):.7f} ms")
    return ({k: statistics.mean(v) for k, v in dev_times.items()},
            {k: statistics.median(v) for k, v in alone_times.items()})


def parity(label: str, got, want, tol: float) -> float:
    """max |got - want|, checked against tol * max |want|; raises on a miss."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: kernel output {got.dtype} "
                             f"{tuple(got.shape)}, plain {want.dtype} "
                             f"{tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = math.isfinite(err) and err <= tol * scale
    print(f"parity {label}: max|d|={err:.3e} max|plain|={scale:.3e} "
          f"rel={err / scale:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{label}")
    return err


def zero_counts(counters: list) -> None:
    """Set every launch count of `counters` (and its counts by instance)
    to 0."""
    for fn in counters:
        fn.launches = 0
        for key in getattr(fn, "instance_launches", {}):
            fn.instance_launches[key] = 0


def cut_env(name: str):
    """The registered env `name` with its episodes cut to
    `SPLIT_STEPS[name]` RL steps."""
    from repro_torch import envs

    return envs.make(name, t_end=SPLIT_STEPS[name]
                     * envs.make(name).cfg.dt_rl)


def train(env_name: str, n_iter: int, counters: list,
          evaluate: bool = True) -> tuple:
    """`rl_train` on `env_name` with 16 envs, `n_iter` PPO iterations and,
    if `evaluate`, an evaluation after the last; every counter in
    `counters` (and its counts by instance) is set to 0 just before and read
    just after.  Returns (history, launches, wall s, checkpoint step), after
    checking returns and the checkpoint."""
    import torch

    from repro_torch.core import checkpoints
    from repro_torch.launch import rl_train

    with tempfile.TemporaryDirectory() as ckpt:
        zero_counts(counters)
        t0 = time.perf_counter()
        history = rl_train.main([
            "--env", env_name, "--n-envs", "16", "--iterations", str(n_iter),
            "--eval-every", str(n_iter if evaluate else n_iter + 1),
            "--checkpoint-dir", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        step = checkpoints.latest_step(ckpt)
    for rec in history:
        print(f"{env_name} iteration {rec['iteration']}: t_sample_s="
              f"{rec['t_sample_s']:.3f} t_update_s={rec['t_update_s']:.3f} "
              f"return_norm={rec['return_norm']:.6f}"
              + (f" eval_return_norm={rec['eval_return_norm']:.6f}"
                 if "eval_return_norm" in rec else ""))
    if len(history) != n_iter:
        raise AssertionError(f"{len(history)} iterations, wanted {n_iter}")
    for rec in history:
        for key in ("return_norm",) + (("eval_return_norm",)
                                       if "eval_return_norm" in rec else ()):
            if not (math.isfinite(rec[key]) and -1.0 <= rec[key] <= 1.0):
                raise AssertionError(f"{key}={rec[key]} not in [-1, 1]")
    if evaluate != ("eval_return_norm" in history[-1]):
        raise AssertionError(f"evaluation episode asked {evaluate}, run "
                             f"{not evaluate}")
    if step != n_iter:
        raise AssertionError(f"no checkpoint of step {n_iter} (got {step})")
    return history, launches, wall, step


class GuardReverts:
    """An env seen through its `step`: counts on the device, by batch size,
    the env-steps whose state comes back bit for bit unchanged, which are
    the non-finite guard's reverts (a step that advances changes the
    state).  Every other attribute is the env's."""

    def __init__(self, env):
        self.env = env
        self.counts: dict = {}   # batch size -> [reverted (device), steps]

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, state, action):
        import torch

        res = self.env.step(state, action)
        same = (res.state.u == state.u).flatten(1).all(1)
        count = self.counts.setdefault(state.u.shape[0], [
            torch.zeros((), dtype=torch.int64, device=state.u.device), 0])
        count[0] += same.sum()
        count[1] += same.numel()
        return res

    def read(self) -> dict:
        """{batch size: (reverted, env-steps)}, then every count to 0."""
        out = {b: (int(c[0]), c[1]) for b, c in self.counts.items()}
        self.counts.clear()
        return out


def fleet_phase(counters: list, per_rollout: dict, card: str,
                ckpt: str) -> tuple:
    """The heterogeneous fleet through `fleet.make_fleet_runner` (device
    None: the GPU): 32 envs apportioned by static step cost with at least 8
    each, one shared multitask policy; one pipelined iteration (the
    prologue rollout, then update 0 and rollout 1), then one synchronous
    iteration of a second runner for the timings, followed by every
    scenario's evaluation episode.  Each call's launches must be
    `per_rollout` times its fleet rollouts and evaluations; each
    sub-fleet's guard reverts are counted (`GuardReverts`) and held.  Then
    one RL step of each sub-fleet, timed alone, and Burgers' step and one
    RK substep of the channel profiled.  The runners checkpoint under
    `ckpt`.  Returns the launches summed over the calls, in the order of
    `counters`, the
    pipelined runner (its checkpoints stay for the serving phase), and the
    synchronous iteration's record, env-steps and first-step rows (obs,
    actions, rewards of step 0 by scenario, on the host), which the
    distributed phase compares with."""
    import torch

    from repro_torch import envs, fleet
    from repro_torch.fleet.pipeline import FleetRunnerConfig
    from repro_torch.kernels import dg_derivative, rhs

    names = [fn.__name__ for fn in counters]
    dev = torch.device("cuda", 0)
    fleet_names = FLEET_NAMES
    fleet_launches = [0] * len(counters)
    for label, pipelined, rollouts in (
            ("pipelined, prologue + iteration 0", True, 2),
            ("synchronous, iteration 0 + evaluation", False, 2)):
        frunner = fleet.make_fleet_runner(
            fleet_names, total_envs=32, min_envs=8,
            run_cfg=FleetRunnerConfig(
                pipelined=pipelined,
                eval_every=10**6 if pipelined else 1,
                checkpoint_every=10**6,
                checkpoint_dir=os.path.join(ckpt, label[:4])))
        split = [m.n_envs for m in frunner.schedule.members]
        costs = [m.cost for m in frunner.schedule.members]
        print(f"fleet schedule: {dict(zip(fleet_names, split))}, "
              f"static costs {costs}, on {frunner.device}")
        if split != [8, 8, 16] or frunner.device.type != "cuda":
            raise AssertionError(f"fleet schedule {split} on "
                                 f"{frunner.device}, expected "
                                 f"[8, 8, 16] on the GPU")
        for orch in frunner.forch.orchs.values():
            orch.env = GuardReverts(orch.env)
        if pipelined:
            prunner = frunner
        history, counts, wall = drive_fleet(frunner, 1, counters)
        reverts = {n: frunner.forch.orchs[n].env.read()
                   for n in fleet_names}
        want = [rollouts * per_rollout["hit"]] + \
            [rollouts * per_rollout["chan"]] * 3 + [0, 0]
        want_split = ({"cluster": want[0], "two_pass": 0},
                      {"tiled": want[1], "generic": 0})
        split = (dict(rhs.fused_navier_stokes_rhs.instance_launches),
                 dict(dg_derivative.dg_derivative3.instance_launches))
        print(f"main path fleet {label}: {wall:.3f} s wall ({card}), "
              f"{rollouts} fleet rollout(s) or evaluation(s), launches "
              f"{dict(zip(names, counts))}; fused RHS by instance "
              f"{split[0]}, dg_derivative3 by instance {split[1]}")
        if counts != want or split != want_split:
            raise AssertionError(f"fleet {label}: launches {counts} "
                                 f"{split}, expected {want} {want_split}")
        (rec,) = history
        for key in ("t_sample_s", "t_update_s"):
            if key in rec:
                print(f"  {key}={rec[key]:.3f}")
        print("  " + ", ".join(
            f"{n}: return_norm={rec[f'{n}/return_norm']:.6f}"
            for n in fleet_names) + f", update_ok={rec['update_ok']}")
        print("  guard reverts {batch: (reverted, env-steps)}: "
              + ", ".join(f"{n} {reverts[n]}" for n in fleet_names))
        if rec["update_ok"] != 1.0 or not all(
                math.isfinite(rec[f"{n}/return_norm"])
                and -1.0 <= rec[f"{n}/return_norm"] <= 1.0
                for n in fleet_names):
            raise AssertionError(f"fleet {label}: {rec}")
        if pipelined != ("t_sample_s" not in rec):
            raise AssertionError(f"fleet {label}: timings {rec}")
        check_reverts(label, frunner, rec, reverts, pipelined)
        fleet_launches = [a + c for a, c in zip(fleet_launches, counts)]
        if not pipelined:
            one_rank = {"record": rec, "rows": first_rows(frunner),
                        "env_steps": env_steps(frunner)}
    for runner in (prunner, frunner):
        for orch in runner.forch.orchs.values():
            if isinstance(orch.env, GuardReverts):
                orch.env = orch.env.env
    # one RL step of each sub-fleet at its batch, timed alone; Burgers'
    # step and one substep of the channel's profiled for launches per RHS
    for name, orch in frunner.forch.orchs.items():
        n_envs = orch.fleet.n_envs
        fstate = envs.init_state(orch.draw_initial_states(
            torch.Generator(device=dev).manual_seed(9)), (n_envs,))
        with torch.no_grad():
            faction = frunner.policy.head(name).actor_mean(
                orch.env.observe(fstate))
        orch.env.step(fstate, faction)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orch.env.step(fstate, faction)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        n_rhs = orch.env.cfg.n_substeps * 5
        print(f"fleet sub-fleet {name}: {n_envs} envs, one RL step "
              f"({n_rhs} RHS calls) {step_ms:.3f} ms wall ({card}), "
              f"{orch.env.n_actions} steps an episode")
        if name != "hit_les_24dof":
            # the channel profiled over one RK substep (5 RHS calls): a trace
            # of its whole RL step (~88,000 launches) took tens of seconds
            # to read
            penv = envs.make(name, dt_rl=orch.env.cfg.dt) \
                if name == "channel_wm" else orch.env
            n_prof = penv.cfg.n_substeps * 5
            got = profile_window(f"one {name} RL step of {n_envs} envs "
                                 f"({n_prof} RHS calls; fleet sub-fleet)",
                                 lambda: penv.step(fstate, faction), card)
            if got is not None:
                print(f"  {name}: {got} launches in the trace over {n_prof} "
                      f"RHS calls, {got / n_prof:.1f} per RHS (the profiler "
                      f"may drop a few)")
    return fleet_launches, prunner, one_rank


def first_rows(frunner) -> dict:
    """{scenario: (obs, actions, rewards) of step 0} of the trajectory the
    runner's broker holds last, on the host."""
    from repro_torch.fleet import broker as broker_lib

    return {n: tuple(x[0].cpu() for x in (t.obs, t.actions, t.rewards))
            for n in frunner.forch.names
            for t in [broker_lib.latest_traj(frunner.broker, n)]}


def env_steps(frunner) -> int:
    """Env-steps of one rollout of the whole fleet (real envs)."""
    return sum(o.fleet.n_envs * o.env.n_actions
               for o in frunner.forch.orchs.values())


def state_digests(runner) -> dict:
    """sha256 of the runner's params, optimizer state and (if it has one)
    broker, each over its leaves' names and bytes in a fixed order."""
    import hashlib

    import torch

    from repro_torch.core import checkpoints

    out = {}
    for part, tree in runner._state_tree().items():
        h = hashlib.sha256()
        for key, x in checkpoints._flatten(tree):
            h.update(key.encode())
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        out[part] = h.hexdigest()
    return out


def rank_worker(kind: str, out: str, ckpt: str) -> int:
    """One rank under torchrun (started by `distributed_phase`): `rl_train`
    (hit_les_24dof, 16 envs, one iteration), the fleet (`FLEET_NAMES` at
    32 envs, at least 8 each, one synchronous iteration), one
    hit_les_24dof env split over the ranks by its x-slabs (`split_rank`)
    or channel_wm and burgers_96dof envs split over them by their element
    axis (`split3_rank`), each through its entry point over the ranks'
    mesh, every launch count 0 before it and read after.  The ranks' records, launch counts, launch counts by
    instance, the batch of every rollout they ran and state digests are
    gathered; rank 0 writes them as JSON to `out` (and the fleet's
    first-step rows to `out`.pt)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import fleet
    from repro_torch.core import collectives
    from repro_torch.core import rollout as rollout_lib
    from repro_torch.core import runner as runner_lib
    from repro_torch.fleet.pipeline import FleetRunnerConfig
    from repro_torch.kernels import (dg_derivative, flash_attention,
                                     linear_scan, rhs, smagorinsky,
                                     wall_model)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import rl_train

    counters = [rhs.fused_navier_stokes_rhs, dg_derivative.dg_derivative3,
                smagorinsky.smagorinsky_nut, wall_model.wall_model_tau,
                flash_attention.flash_attention, linear_scan.linear_scan]
    result = {"batches": []}

    def batch(rollout):
        def wrapped(policy, env, u0, **kwargs):
            result["batches"].append(u0.shape[0])
            return rollout(policy, env, u0, **kwargs)
        return wrapped

    runner = None
    if kind == "split":
        with patched(rollout_lib, "rollout", batch):
            runner = split_rank(ckpt, out, counters, result)
        wall, history = result.pop("wall_s"), result.pop("records")
    elif kind == "split3":
        with patched(rollout_lib, "rollout", batch):
            split3_rank(ckpt, out, counters, result)
    elif kind == "rl_train":
        captured = []

        def keep(train):
            def wrapped(self, *args, **kwargs):
                captured.append(self)
                return train(self, *args, **kwargs)
            return wrapped

        with patched(runner_lib.Runner, "train", keep), \
                patched(rollout_lib, "rollout", batch):
            zero_counts(counters)
            t0 = time.perf_counter()
            history = rl_train.main([
                "--env", "hit_les_24dof", "--n-envs", "16", "--iterations",
                "1", "--eval-every", "2", "--checkpoint-dir", ckpt])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (runner,) = captured
        result["b_pad"] = runner.orch.b_pad
    elif kind == "fleet":
        mesh_lib.init_distributed()
        runner = fleet.make_fleet_runner(
            FLEET_NAMES, total_envs=32, min_envs=8,
            mesh=mesh_lib.make_fleet_mesh(),
            run_cfg=FleetRunnerConfig(pipelined=False, eval_every=10**6,
                                      checkpoint_every=10**6,
                                      checkpoint_dir=ckpt))
        for orch in runner.forch.orchs.values():
            orch.env = GuardReverts(orch.env)
        with patched(rollout_lib, "rollout", batch):
            zero_counts(counters)
            t0 = time.perf_counter()
            history = runner.train(1, resume=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        result["b_pad"] = {n: o.b_pad
                           for n, o in runner.forch.orchs.items()}
        result["n_envs"] = {n: o.fleet.n_envs
                            for n, o in runner.forch.orchs.items()}
        result["env_steps"] = env_steps(runner)
        result["reverts"] = {n: o.env.read()
                             for n, o in runner.forch.orchs.items()}
        if dist.get_rank() == 0:
            torch.save(first_rows(runner), out + ".pt")
    if runner is not None:
        result.update(
            wall_s=wall, records=history,
            launches=[fn.launches for fn in counters],
            instances=[dict(rhs.fused_navier_stokes_rhs.instance_launches),
                       dict(dg_derivative.dg_derivative3.instance_launches)],
            digests=state_digests(runner))
    result.update(rank=dist.get_rank(), backend=dist.get_backend(),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    total = torch.tensor(result["launches"], dtype=torch.int64)
    collectives.all_reduce_(total, dist.group.WORLD)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, result)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump({"ranks": ranks, "launches_sum": total.tolist()}, f)
    dist.destroy_process_group()
    return 0


def split_rank(ckpt: str, out: str, counters: list, result: dict):
    """One rank of hit_les_24dof (episodes cut to `SPLIT_STEPS`) split
    over a (data 1, model 2) mesh by its x-slabs
    (`FleetConfig(elem_axis="model")`, 16 envs): first one RL interval of
    the first 16 bank rows under a fixed C_s field in float32 and one in
    bf16 (rank 0 writes the inputs and the gathered states to
    `out`.interval.pt), then one PPO iteration through `Runner.train` (no
    evaluation), every launch count 0 before each; rank 0 writes the
    gathered trajectory's step-0 rows to `out`.pt.  Records into `result`
    the intervals' launches, the exchanges' seconds and bytes of the
    iteration, and its wall time.  Returns the runner."""
    import torch
    import torch.distributed as dist

    from repro_torch.cfd import solver
    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner, RunnerConfig
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_distributed()
    runner = Runner(cut_env("hit_les_24dof"),
                    FleetConfig(n_envs=SPLIT_ROWS, elem_axis="model"),
                    run_cfg=RunnerConfig(eval_every=10**6,
                                         checkpoint_every=10**6,
                                         checkpoint_dir=ckpt),
                    mesh=mesh_lib.make_fleet_mesh(model=2))
    orch, split = runner.orch, runner.orch.split
    cfg = orch.env.cfg
    rows = orch.bank[:SPLIT_ROWS]
    gen = torch.Generator(device=orch.device).manual_seed(7)
    cs = 0.12 + 0.1 * torch.rand((SPLIT_ROWS,) + (cfg.n_elem,) * 3,
                                 generator=gen, device=orch.device)
    intervals = {}
    for precision in ("fp32", "bf16"):
        zero_counts(counters)
        intervals[precision] = split.gather(solver.advance_rl_interval(
            orch.env.slab(rows), split.slab(cs, 1),
            dataclasses.replace(cfg, precision=precision), split), 1)
        torch.cuda.synchronize()
        result[f"interval_launches_{precision}"] = [fn.launches
                                                    for fn in counters]
    if dist.get_rank() == 0:
        torch.save({"rows": rows.cpu(), "cs": cs.cpu(),
                    **{f"u_{k}": v.cpu() for k, v in intervals.items()}},
                   out + ".interval.pt")
    trajs = []
    sample = orch.sample_fleet

    def kept(policy, gen):
        trajs.append(sample(policy, gen))
        return trajs[-1]

    orch.sample_fleet = kept
    split.halo_s = split.gather_s = 0.0
    split.halo_bytes = split.gather_bytes = 0
    zero_counts(counters)
    t0 = time.perf_counter()
    result["records"] = runner.train(1, resume=False)
    torch.cuda.synchronize()
    result["wall_s"] = time.perf_counter() - t0
    result["exchanges"] = {k: getattr(split, k) for k in (
        "halo_s", "halo_bytes", "gather_s", "gather_bytes")}
    result["b_pad"] = orch.b_pad
    if dist.get_rank() == 0:
        torch.save(tuple(x[0].cpu() for x in (
            trajs[0].obs, trajs[0].actions, trajs[0].rewards)), out + ".pt")
    return runner


def split3_rank(ckpt: str, out: str, counters: list, result: dict) -> None:
    """One rank of channel_wm and of burgers_96dof (`SPLIT3_NAMES`,
    episodes cut to `SPLIT_STEPS`), each with 16 envs split over a (data 1,
    model 3) mesh by its first element axis (`FleetConfig(elem_axis=
    "model")`): first one RL interval of its first 16 bank rows under a
    fixed action (rank 0 writes the inputs and the gathered state to
    `out`.<name>.pt), then one PPO iteration through `Runner.train` (no
    evaluation), every launch count 0 before each.  Records into
    `result["envs"][name]` the interval's and the iteration's launches,
    the fused RHS's and dg_derivative3's by instance, the rollouts'
    batches, the records,
    the exchanges' seconds and bytes, the wall time and the state digests;
    into `result["launches"]` the iterations' launches summed."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner, RunnerConfig
    from repro_torch.kernels import dg_derivative, rhs
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_distributed()
    mesh = mesh_lib.make_fleet_mesh(model=3)
    result["envs"], total = {}, [0] * len(counters)
    for name in SPLIT3_NAMES:
        runner = Runner(cut_env(name),
                        FleetConfig(n_envs=SPLIT_ROWS, elem_axis="model"),
                        run_cfg=RunnerConfig(
                            eval_every=10**6, checkpoint_every=10**6,
                            checkpoint_dir=os.path.join(ckpt, name)),
                        mesh=mesh)
        orch, split = runner.orch, runner.orch.split
        spec = orch.env.action_spec
        rows = orch.bank[:SPLIT_ROWS]
        gen = torch.Generator(device=orch.device).manual_seed(7)
        action = spec.low + (spec.high - spec.low) * (0.25 + 0.5 * torch.rand(
            (SPLIT_ROWS,) + spec.shape, generator=gen, device=orch.device))
        rec = {}
        zero_counts(counters)
        u = split.gather(orch.env.env.advance(orch.env.slab(rows), action,
                                              split), 1)
        torch.cuda.synchronize()
        rec["interval_launches"] = [fn.launches for fn in counters]
        if dist.get_rank() == 0:
            torch.save({"rows": rows.cpu(), "action": action.cpu(),
                        "u": u.cpu()}, f"{out}.{name}.pt")
        split.halo_s = split.gather_s = 0.0
        split.halo_bytes = split.gather_bytes = 0
        result["batches"] = []
        zero_counts(counters)
        t0 = time.perf_counter()
        rec["records"] = runner.train(1, resume=False)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = [fn.launches for fn in counters]
        rec["instances"] = [
            dict(rhs.fused_navier_stokes_rhs.instance_launches),
            dict(dg_derivative.dg_derivative3.instance_launches)]
        rec["batches"] = result["batches"]
        rec["exchanges"] = {k: getattr(split, k) for k in (
            "halo_s", "halo_bytes", "gather_s", "gather_bytes")}
        rec["b_pad"] = orch.b_pad
        rec["digests"] = state_digests(runner)
        result["envs"][name] = rec
        total = [a + b for a, b in zip(total, rec["launches"])]
    result["launches"] = total
    result["batches"] = [b for r in result["envs"].values()
                         for b in r["batches"]]


def split_phase(names: list, card: str, tmp: str, hit_one: list) -> dict:
    """(d) of `distributed_phase`: hit_les_24dof with 16 envs, each split
    over 2 ranks by its x-slabs (`split_rank`; episodes cut to
    `SPLIT_STEPS`).  Gates: the ranks' PPO iteration launches
    dg_derivative3 (tiled) and smagorinsky_nut exactly 650 times each a
    rank and the fused RHS never; params and Adam state bitwise on both
    ranks; return_norm in [-1, 1]; the split RL interval within TOL_SPLIT
    of the same staged assembly in one process and within TOL of the fused
    kernel path, the state one env off outside TOL_SPLIT; the split bf16
    interval within the bf16 TOL of the same staged assembly in bf16 in
    one process, the state one env off outside it; the step-0
    observations, actions and rewards within TOL_FLEET_ROWS of one
    process's rollout of the same assembly (one RL step of the same draws
    and initial policy), and the rows one env off outside it.  Prints the
    ranks' times and exchanges and env-steps/s beside one process's
    (`hit_one`: the records of the HIT path's unsplit iterations)."""
    import torch

    from repro_torch.cfd import solver
    from repro_torch.core import collectives, policy as policy_lib
    from repro_torch.core import rollout as rollout_lib
    from repro_torch.core.orchestrator import FleetConfig, Orchestrator
    from repro_torch.core.runner import iteration_seed
    from repro_torch.envs.hit_les import HITLESEnv

    env = cut_env("hit_les_24dof")
    cfg = env.cfg
    per_rollout = cfg.n_actions * cfg.n_substeps * 5
    out = os.path.join(tmp, "split.json")
    wall = torchrun(2, ["split", out, os.path.join(tmp, "split")], 400)
    got = read_ranks(out, 2, "split")
    print(f"hit_les_24dof, {SPLIT_ROWS} envs each split over 2 ranks by "
          f"its x-slabs, episodes cut to {cfg.n_actions} RL steps ({card}): "
          f"{wall:.3f} s wall, torchrun included")
    check_ranks("hit_les_24dof split", got,
                [0, per_rollout, per_rollout, 0, 0, 0],
                ({"cluster": 0, "two_pass": 0},
                 {"tiled": per_rollout, "generic": 0}), names, [SPLIT_ROWS])
    interval = cfg.n_substeps * 5
    for r in got["ranks"]:
        (rec,) = r["records"]
        ex = r["exchanges"]
        print(f"  rank {r['rank']}: t_sample_s={rec['t_sample_s']:.3f} "
              f"t_update_s={rec['t_update_s']:.3f} return_norm="
              f"{rec['return_norm']:.6f}; halo exchanges and box sums "
              f"{ex['halo_s']:.3f} s, {ex['halo_bytes']} B received; the "
              f"velocity's gathers {ex['gather_s']:.3f} s, "
              f"{ex['gather_bytes']} B received; the intervals' launches "
              + ", ".join(f"{p} {dict(zip(names, r[f'interval_launches_{p}']))}"
                          for p in ("fp32", "bf16")))
        if not -1.0 <= rec["return_norm"] <= 1.0:
            raise AssertionError(f"split: return_norm {rec}")
        for p in ("fp32", "bf16"):
            if r[f"interval_launches_{p}"] != [0, interval, interval, 0, 0,
                                               0]:
                raise AssertionError(f"split {p} interval launches "
                                     f"{r[f'interval_launches_{p}']}")

    dev = torch.device("cuda", 0)
    data = torch.load(out + ".interval.pt")
    rows, cs = (data[k].to(dev) for k in ("rows", "cs"))
    one = collectives.ElemSplit()
    u_split = data["u_fp32"].to(dev)
    u_same = solver.advance_rl_interval(rows, cs, cfg, one)
    u_fused = solver.advance_rl_interval(rows, cs, cfg)
    bf16 = dataclasses.replace(cfg, precision="bf16")
    u_split16 = data["u_bf16"].to(dev)
    u_same16 = solver.advance_rl_interval(rows, cs, bf16, one)
    for label, u in (("split", u_split), ("one process", u_same),
                     ("fused", u_fused), ("split bf16", u_split16),
                     ("one process bf16", u_same16)):
        if not torch.isfinite(u).all():
            raise AssertionError(f"split interval: {label} state not "
                                 f"finite")
    label = (f"one 24-DOF RL interval of {SPLIT_ROWS} envs ({interval} RHS "
             f"calls) split over 2 ranks")
    err = parity(f"{label} vs the same assembly in one process", u_split,
                 u_same, TOL_SPLIT)
    parity(f"{label} vs the fused kernel path", u_split, u_fused,
           TOL["float32"])
    err16 = parity(f"{label} in bf16 vs the same staged assembly in bf16 in "
                   f"one process", u_split16, u_same16, TOL["bfloat16"])
    for lbl, got_u, want_u, tol in (("", u_split, u_same, TOL_SPLIT),
                                   (" bf16", u_split16, u_same16,
                                    TOL["bfloat16"])):
        rel = ((got_u.roll(1, 0) - want_u).abs().max()
               / want_u.abs().max()).item()
        print(f"    control, the split{lbl} state one env off: "
              f"rel={rel:.3e}")
        if not rel > tol:
            raise AssertionError(f"split{lbl}: the gate cannot tell the "
                                 f"state one env off")

    # one process, the same assembly: the rollout's first step from the
    # same draws and initial policy
    orch = Orchestrator(env, FleetConfig(n_envs=SPLIT_ROWS,
                                         elem_axis="model"))
    u0, noise = orch.draw_padded_inputs(torch.Generator(
        device=dev).manual_seed(iteration_seed(0, 0)))
    policy = policy_lib.Policy(orch.pcfg, torch.Generator().manual_seed(
        0)).to(dev)
    one_step = HITLESEnv(dataclasses.replace(cfg, t_end=cfg.dt_rl)).split_x(
        collectives.ElemSplit())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = rollout_lib.rollout(policy, one_step, u0, noise=noise[:1])
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    want = tuple(x[0].cpu() for x in (traj.obs, traj.actions, traj.rewards))
    rows0 = torch.load(out + ".pt")
    for field, g, w in zip(("obs", "actions", "rewards"), rows0, want):
        parity(f"hit_les_24dof split over 2 ranks vs one process, step-0 "
               f"{field}", g, w, TOL_FLEET_ROWS)
        print(f"    bitwise: {torch.equal(g, w)}")
    rel = ((rows0[0].roll(1, 0) - want[0]).abs().max()
           / want[0].abs().max()).item()
    print(f"    control, step-0 obs one env off: rel={rel:.3e}")
    if not rel > TOL_FLEET_ROWS:
        raise AssertionError("split: the gate cannot tell the rows one env "
                             "off")
    steps = SPLIT_ROWS * cfg.n_actions
    t_sample = max(r["records"][0]["t_sample_s"] for r in got["ranks"])
    rate = steps / t_sample
    full = SPLIT_ROWS * 50  # the HIT path's episodes: 50 RL steps
    one = [full / rec["t_sample_s"] for rec in hit_one]
    print(f"hit_les_24dof env-steps/s ({card}): split over 2 ranks on the "
          f"card {rate:.3f} ({steps} env-steps in the slowest rank's "
          f"t_sample_s={t_sample:.3f}); one process, the fused kernel path "
          f"(phase 5's iterations of 50 steps) "
          + ", ".join(f"{x:.3f}" for x in one)
          + f"; one process, the same staged assembly: one RL step of "
          f"{SPLIT_ROWS} envs in {t_step:.3f} s (the first of its shape)")
    return {"wall_s": wall, "ranks": got["ranks"], "interval_err": err,
            "interval_err_bf16": err16, "env_steps_per_s": rate,
            "one_rank_env_steps_per_s": one, "one_step_s": t_step}


def split3_phase(names: list, card: str, tmp: str) -> dict:
    """(e) of `distributed_phase`: channel_wm and burgers_96dof, 16 envs
    each, every env split over 3 ranks by its first element axis
    (`split3_rank`; episodes cut to `SPLIT_STEPS`).  Gates, for each: the
    split RL interval within TOL_SPLIT of the same assembly in one process
    and within TOL of the unsplit path, the state one env off outside
    TOL_SPLIT; every rank's launches exact (the channel's interval 130 and
    iteration 650 of dg_derivative3 (tiled), smagorinsky_nut and
    wall_model_tau a rank; Burgers none of any kernel) and their sum over
    the ranks (all-reduced); params and Adam state bitwise on the 3 ranks;
    return_norm in [-1, 1].  Prints the ranks' times, exchanges and
    env-steps/s beside one process's rollout of the same cut episode on
    the unsplit path."""
    import torch

    from repro_torch.core import collectives, policy as policy_lib
    from repro_torch.core import rollout as rollout_lib

    out = os.path.join(tmp, "split3.json")
    wall = torchrun(3, ["split3", out, os.path.join(tmp, "split3")], 400)
    got = read_ranks(out, 3, "split3")
    print(f"{' and '.join(SPLIT3_NAMES)}, {SPLIT_ROWS} envs each, every env "
          f"split over 3 ranks by its element axis ({card}): {wall:.3f} s "
          f"wall, torchrun included")
    dev = torch.device("cuda", 0)
    readings, want_sum = {}, [0] * len(names)
    for name in SPLIT3_NAMES:
        env = cut_env(name)
        cfg = env.cfg
        interval = cfg.n_substeps * 5
        chan = name.startswith("channel")
        want = [0, 1, 1, 1, 0, 0] if chan else [0] * len(names)
        rollout_n = cfg.n_actions * interval
        print(f"  {name}: episodes cut to {cfg.n_actions} RL steps of "
              f"{interval} RHS calls")
        ranks = [dict(r, **r["envs"][name]) for r in got["ranks"]]
        check_ranks(f"{name} split over 3 ranks", {
            "ranks": ranks, "launches_sum": [
                sum(r["launches"][i] for r in ranks)
                for i in range(len(names))]},
            [rollout_n * w for w in want],
            ({"cluster": 0, "two_pass": 0},
             {"tiled": rollout_n * want[1], "generic": 0}), names,
            [SPLIT_ROWS])
        want_sum = [a + 3 * rollout_n * w for a, w in zip(want_sum, want)]
        for r in ranks:
            (rec,) = r["records"]
            ex = r["exchanges"]
            print(f"  {name} rank {r['rank']}: t_sample_s="
                  f"{rec['t_sample_s']:.3f} t_update_s="
                  f"{rec['t_update_s']:.3f} return_norm="
                  f"{rec['return_norm']:.6f}; halo_s={ex['halo_s']:.3f} "
                  f"halo_bytes={ex['halo_bytes']} gather_s="
                  f"{ex['gather_s']:.3f} gather_bytes={ex['gather_bytes']}; "
                  f"the interval's launches "
                  f"{dict(zip(names, r['interval_launches']))}")
            if not -1.0 <= rec["return_norm"] <= 1.0:
                raise AssertionError(f"{name} split: return_norm {rec}")
            if r["interval_launches"] != [interval * w for w in want]:
                raise AssertionError(f"{name} split interval launches "
                                     f"{r['interval_launches']}")

        data = torch.load(f"{out}.{name}.pt")
        rows, action, u_split = (data[k].to(dev) for k in ("rows", "action",
                                                            "u"))
        u_same = env.advance(rows, action, collectives.ElemSplit())
        u_whole = env.advance(rows, action)
        for label, u in (("split", u_split), ("one process", u_same),
                         ("unsplit", u_whole)):
            if not torch.isfinite(u).all():
                raise AssertionError(f"{name} split interval: {label} state "
                                     f"not finite")
        label = (f"one {name} RL interval of {SPLIT_ROWS} envs ({interval} "
                 f"RHS calls) split over 3 ranks")
        err = parity(f"{label} vs the same assembly in one process", u_split,
                     u_same, TOL_SPLIT)
        print(f"    bitwise: {torch.equal(u_split, u_same)}")
        parity(f"{label} vs the unsplit path", u_split, u_whole,
               TOL["float32"])
        rel = ((u_split.roll(1, 0) - u_same).abs().max()
               / u_same.abs().max()).item()
        print(f"    control, the split state one env off: rel={rel:.3e}")
        if not rel > TOL_SPLIT:
            raise AssertionError(f"{name} split: the gate cannot tell the "
                                 f"state one env off")

        # one process, the unsplit path: one rollout of the same cut
        # episode, the same envs, timed as the ranks' t_sample
        policy = policy_lib.Policy(
            policy_lib.PolicyConfig.from_specs(env.obs_spec,
                                               env.action_spec),
            torch.Generator().manual_seed(0)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout_lib.rollout(policy, env, rows, gen=torch.Generator(
            device=dev).manual_seed(3))
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        steps = SPLIT_ROWS * cfg.n_actions
        t_sample = max(r["records"][0]["t_sample_s"] for r in ranks)
        rate, one_rate = steps / t_sample, steps / t_one
        print(f"{name} env-steps/s ({card}): split over 3 ranks on the card "
              f"{rate:.3f} ({steps} env-steps in the slowest rank's "
              f"t_sample_s={t_sample:.3f}); one process, the unsplit path, "
              f"{one_rate:.3f} ({t_one:.3f} s): {rate / one_rate:.3f}x")
        readings[name] = {"ranks": ranks, "interval_err": err,
                          "env_steps_per_s": rate,
                          "one_rank_env_steps_per_s": one_rate}
    print(f"  launches summed over the 3 ranks and both envs (all-reduce): "
          f"{dict(zip(names, got['launches_sum']))}")
    if got["launches_sum"] != want_sum:
        raise AssertionError(f"split3: summed launches {got['launches_sum']}"
                             f", expected {want_sum}")
    return {"wall_s": wall, "ranks": got["ranks"], "envs": readings}


def baselines(counters: list, eval_return: float, card: str) -> int:
    """The paper's static baselines (Fig. 5 bottom) on hit_les_24dof's
    held-out test state (the bank of `rl_train`'s seed 0):
    `rollout.constant_action_return` at Smagorinsky C_s = 0.17 and
    implicit LES C_s = 0, printed beside the trained policy's evaluation
    return.  Each episode must launch the fused RHS 3,250 times, all on
    the cluster instance, and return a finite value in [-1, 1].  Returns
    the launches of both."""
    import torch

    from repro_torch import envs
    from repro_torch.core.orchestrator import FleetConfig, Orchestrator
    from repro_torch.core.rollout import constant_action_return
    from repro_torch.kernels import rhs

    orch = Orchestrator(envs.make("hit_les_24dof"), FleetConfig(n_envs=16))
    cfg = orch.env.cfg
    want = [cfg.n_actions * cfg.n_substeps * 5, 0, 0, 0, 0, 0]
    total = 0
    for label, value in (("Smagorinsky C_s = 0.17", 0.17),
                         ("implicit LES C_s = 0", 0.0)):
        zero_counts(counters)
        t0 = time.perf_counter()
        ret = constant_action_return(orch.env, orch.test_state(), value)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        cluster = rhs.fused_navier_stokes_rhs.instance_launches["cluster"]
        print(f"baseline {label} on the held-out test state ({card}): "
              f"return_norm={ret:.6f} beside the trained policy's "
              f"eval_return_norm={eval_return:.6f}; {wall:.3f} s, launches "
              f"{launches} ({cluster} on the cluster instance)")
        if launches != want or cluster != want[0]:
            raise AssertionError(f"baseline {label}: launches {launches}, "
                                 f"expected {want} all on the cluster "
                                 f"instance")
        if not (math.isfinite(ret) and -1.0 <= ret <= 1.0):
            raise AssertionError(f"baseline {label}: return {ret}")
        total += launches[0]
    return total


def torchrun(nproc: int, args: list, timeout: float) -> float:
    """`python -m torch.distributed.run --standalone` of this script's
    `rank_worker` on `nproc` ranks; its output printed indented.  Raises on
    a failure, and kills the whole process group at the time limit.
    Returns the wall time."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.abspath(__file__),
           "--rank-worker", *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        log = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    for line in log.splitlines():
        print(f"  | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {args[0]} on {nproc} ranks exited "
                             f"{proc.returncode}")
    return wall


def collectives_on_one_rank(card: str) -> dict:
    """A one-rank NCCL group on the card: `all_gather_cat`, the three codecs
    of `compressed_psum` (int8 over two rounds of error feedback) and
    `chunked_psum`, each bit for bit its single-process value (a sum over
    one rank; the codecs' rounding computed in plain PyTorch)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives, compression

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        times["init_s"] = time.perf_counter() - t0
        try:
            group = dist.group.WORLD
            if dist.get_backend(group) != "nccl":
                raise AssertionError(f"backend {dist.get_backend(group)}")
            tree = {"w": torch.randn((257, 33), generator=gen, device=dev),
                    "b": torch.randn((1000,), generator=gen,
                                     device=dev) * 1e-3}
            t0 = time.perf_counter()
            checks = {"all_gather": (collectives.all_gather_cat(
                tree["w"], group, dim=1), tree["w"])}
            red, _ = compression.compressed_psum(tree, group, method="none")
            checks.update({f"none {k}": (red[k], tree[k]) for k in tree})
            red, _ = compression.compressed_psum(tree, group, method="bf16")
            checks.update({f"bf16 {k}": (red[k], tree[k].to(
                torch.bfloat16).float()) for k in tree})
            err = None
            want_err = {k: torch.zeros_like(v) for k, v in tree.items()}
            for r in range(2):
                red, err = compression.compressed_psum(
                    tree, group, method="int8", error_state=err)
                for k, g in tree.items():
                    g = g + want_err[k]
                    scale = g.abs().max() / 127.0 + 1e-30
                    q = torch.clamp(torch.round(g / scale), -127, 127)
                    want = q.to(torch.int8).float() * scale
                    want_err[k] = g - want
                    checks[f"int8 round {r} {k}"] = (red[k], want)
                    checks[f"int8 round {r} {k} residual"] = (
                        err[k], want_err[k])
            red = compression.chunked_psum(tree, group, n_chunks=4)
            checks.update({f"chunked {k}": (red[k], tree[k]) for k in tree})
            torch.cuda.synchronize()
            times["checks_s"] = time.perf_counter() - t0
            for label, (got, want) in checks.items():
                if not (got.is_cuda and got.dtype == want.dtype
                        and torch.equal(got, want)):
                    raise AssertionError(f"one-rank NCCL {label}: not its "
                                         f"single-process value")
        finally:
            dist.destroy_process_group()
    print(f"one-rank NCCL group ({card}): all_gather_cat, compressed_psum "
          f"none/bf16/int8 (2 rounds of error feedback) and chunked_psum "
          f"bit for bit their single-process values ({len(checks)} checks); "
          f"init {times['init_s']:.3f} s, checks {times['checks_s']:.3f} s")
    return times


def read_ranks(path: str, nproc: int, label: str) -> dict:
    with open(path) as f:
        got = json.load(f)
    if len(got["ranks"]) != nproc:
        raise AssertionError(f"{label}: {len(got['ranks'])} ranks reported")
    return got


def check_ranks(label: str, got: dict, want: list, want_split: tuple,
                names: list, batches: list) -> None:
    """Exact launches and launches by instance on every rank, their sum
    over ranks, every rank's rollouts at its share of the rows (`batches`),
    every rank's backend gloo, and params, optimizer state and broker
    bitwise equal on every rank."""
    for r in got["ranks"]:
        split = tuple(r["instances"])
        print(f"  rank {r['rank']} ({r['backend']}): rollouts of "
              f"{r['batches']} rows, launches "
              f"{dict(zip(names, r['launches']))}, fused RHS by instance "
              f"{split[0]}, dg_derivative3 by instance {split[1]}, "
              f"{r['wall_s']:.3f} s wall, peak {r['peak_gib']:.3f} GiB, "
              f"state digests {r['digests']}")
        if r["launches"] != want or split != want_split:
            raise AssertionError(f"{label} rank {r['rank']}: launches "
                                 f"{r['launches']} {split}, expected {want} "
                                 f"{want_split}")
        if r["batches"] != batches:
            raise AssertionError(f"{label} rank {r['rank']}: rollouts of "
                                 f"{r['batches']} rows, expected {batches}")
        if r["backend"] != "gloo":
            raise AssertionError(f"{label}: backend {r['backend']}, ranks "
                                 f"sharing one card need gloo")
    n = len(got["ranks"])
    print(f"  launches summed over the {n} ranks (all-reduce): "
          f"{dict(zip(names, got['launches_sum']))}")
    if got["launches_sum"] != [n * c for c in want]:
        raise AssertionError(f"{label}: summed launches "
                             f"{got['launches_sum']}")
    digests = [r["digests"] for r in got["ranks"]]
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"{label}: params / optimizer state / broker "
                             f"differ between ranks: {digests}")


def distributed_phase(counters: list, per_rollout: dict, card: str,
                      one_rank: dict, hit_one: list) -> dict:
    """The fleet across ranks on the one card: (a) the collectives on a
    one-rank NCCL group; (b) `rl_train` on hit_les_24dof, 16 envs split
    over 2 ranks (8 each), one iteration; (c) the fleet `FLEET_NAMES` at
    8 / 8 / 16 envs over 3 ranks (each padded: 9 / 9 / 18, 3 / 3 / 6 rows
    a rank), one synchronous iteration.  Ranks sharing a card use gloo.
    Gates: the launches of every rank exact (a rollout's per rank), all on
    the cluster / tiled instances; params, Adam state and broker bitwise
    equal on every rank; update_ok 1 and every return_norm in [-1, 1];
    the fleet's first-step rows within TOL_FLEET_ROWS of the one-process
    synchronous iteration (`one_rank`, from `fleet_phase`); the channel
    and Burgers sub-fleets revert nothing.  Prints env-steps/s beside the
    one-process iteration's.  (d) hit_les_24dof with each env split over 2
    ranks by its x-slabs (`split_phase`, against `hit_one`, the HIT path's
    records).  (e) channel_wm and burgers_96dof with each env split over 3
    ranks (`split3_phase`).  Returns the readings."""
    import torch

    names = [fn.__name__ for fn in counters]
    readings = {"collectives": collectives_on_one_rank(card)}
    hit, chan = per_rollout["hit"], per_rollout["chan"]
    with tempfile.TemporaryDirectory() as tmp:
        # (b) rl_train over 2 ranks
        out = os.path.join(tmp, "rl_train.json")
        wall = torchrun(2, ["rl_train", out, os.path.join(tmp, "rl")], 400)
        got = read_ranks(out, 2, "rl_train")
        print(f"rl_train hit_les_24dof over 2 ranks ({card}): "
              f"{wall:.3f} s wall, torchrun included")
        check_ranks("rl_train", got, [hit, 0, 0, 0, 0, 0],
                    ({"cluster": hit, "two_pass": 0},
                     {"tiled": 0, "generic": 0}), names, [8])
        for r in got["ranks"]:
            (rec,) = r["records"]
            print(f"  rank {r['rank']}: b_pad {r['b_pad']}, t_sample_s="
                  f"{rec['t_sample_s']:.3f} t_update_s="
                  f"{rec['t_update_s']:.3f} return_norm="
                  f"{rec['return_norm']:.6f}")
            if not -1.0 <= rec["return_norm"] <= 1.0:
                raise AssertionError(f"rl_train: return_norm {rec}")
        readings["rl_train"] = {"wall_s": wall, "ranks": got["ranks"]}

        # (c) the fleet over 3 ranks
        out = os.path.join(tmp, "fleet.json")
        wall = torchrun(3, ["fleet", out, os.path.join(tmp, "fleet")], 600)
        got = read_ranks(out, 3, "fleet")
        print(f"fleet {'/'.join(FLEET_NAMES)} over 3 ranks ({card}): "
              f"{wall:.3f} s wall, torchrun included")
        check_ranks("fleet", got, [hit, chan, chan, chan, 0, 0],
                    ({"cluster": hit, "two_pass": 0},
                     {"tiled": chan, "generic": 0}), names, [3, 3, 6])
        rank0 = got["ranks"][0]
        if rank0["n_envs"] != dict(zip(FLEET_NAMES, (8, 8, 16))) or \
                rank0["b_pad"] != dict(zip(FLEET_NAMES, (9, 9, 18))):
            raise AssertionError(f"fleet over 3 ranks: {rank0['n_envs']} "
                                 f"padded to {rank0['b_pad']}")
        for r in got["ranks"]:
            (rec,) = r["records"]
            print(f"  rank {r['rank']}: t_sample_s={rec['t_sample_s']:.3f} "
                  f"t_update_s={rec['t_update_s']:.3f} t_gather_s="
                  f"{rec['t_gather_s']:.3f} gather_bytes="
                  f"{int(rec['gather_bytes'])} update_ok={rec['update_ok']} "
                  + ", ".join(f"{n}: return_norm="
                              f"{rec[f'{n}/return_norm']:.6f}"
                              for n in FLEET_NAMES)
                  + f"; guard reverts {r['reverts']}")
            if rec["update_ok"] != 1.0 or not all(
                    -1.0 <= rec[f"{n}/return_norm"] <= 1.0
                    for n in FLEET_NAMES):
                raise AssertionError(f"fleet over 3 ranks: {rec}")
            for n in FLEET_NAMES[1:]:
                if any(v[0] for v in r["reverts"][n].values()):
                    raise AssertionError(f"fleet over 3 ranks: {n} "
                                         f"reverted {r['reverts'][n]}")
        rows = torch.load(out + ".pt")
        for n in FLEET_NAMES:
            for field, g, w in zip(("obs", "actions", "rewards"), rows[n],
                                   one_rank["rows"][n]):
                parity(f"fleet over 3 ranks vs one process, {n} step-0 "
                       f"{field}", g, w, TOL_FLEET_ROWS)
                print(f"    bitwise: {torch.equal(g, w)}")
            # control: the rows one env off, as a wrong shard layout gives
            g, w = rows[n][0].float(), one_rank["rows"][n][0].float()
            rel = ((g.roll(1, dims=0) - w).abs().max()
                   / w.abs().max()).item()
            print(f"    control, {n} step-0 obs one env off: rel={rel:.3e}")
            if not rel > TOL_FLEET_ROWS:
                raise AssertionError(f"fleet over 3 ranks: the gate cannot "
                                     f"tell {n}'s rows one env off")
        steps = one_rank["env_steps"]
        one_rate = steps / one_rank["record"]["t_sample_s"]
        t_sample = max(r["records"][0]["t_sample_s"] for r in got["ranks"])
        rate = rank0["env_steps"] / t_sample
        print(f"fleet env-steps/s ({card}): one process {one_rate:.3f} "
              f"({steps} env-steps in t_sample_s="
              f"{one_rank['record']['t_sample_s']:.3f}), 3 ranks on the "
              f"card {rate:.3f} ({rank0['env_steps']} in the slowest "
              f"rank's t_sample_s={t_sample:.3f}): {rate / one_rate:.3f}x")
        readings["fleet"] = {"wall_s": wall, "ranks": got["ranks"],
                             "env_steps_per_s": rate,
                             "one_rank_env_steps_per_s": one_rate}

        # (d) one env split over 2 ranks by its x-slabs
        readings["split"] = split_phase(names, card, tmp, hit_one)

        # (e) the channel and Burgers, every env split over 3 ranks
        readings["split3"] = split3_phase(names, card, tmp)
    return readings


def lm_grad_parity(lm_cfg, gen, dev, errs: dict) -> None:
    """The LM kernel wrappers with inputs that require grad, at hymba-1.5b's
    training shape (batch 2 x 4,096 tokens), against the plain forms: the
    kernel's forward output (the kernel itself at this shape) and the
    gradients (the Function's backward is autograd through the same plain
    form, so these check the Function's wiring: which inputs, which
    cotangents, the forward's u/s0 reading).  Each error goes into
    `errs`."""
    import torch

    from repro_torch.kernels import flash_attention, linear_scan

    # the two wrappers through their autograd Functions (the kernel
    # forward, the backward of the plain chunked form) against autograd
    # through the plain forms: flash attention windowed (rows past window
    # + block_k have whole kv blocks masked, m = -inf there) and global,
    # bf16 on the tensor-core instance and float32 on the CUDA-core one;
    # the scan at 50 rows of T = 4,096 on the chunked instance, with a
    # cotangent on S_final too
    b_tr, s_tr = 2, 4096
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        kind = flash_attention.instance(dtype)
        for label, window in ((f"window {lm_cfg.window}", lm_cfg.window),
                              ("global", None)):
            q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                       for shape in ((b_tr, lm_cfg.n_heads, s_tr, lm_cfg.hd),
                                     (b_tr, lm_cfg.kv_heads, s_tr, lm_cfg.hd),
                                     (b_tr, lm_cfg.kv_heads, s_tr, lm_cfg.hd)))
            grad = torch.randn(q.shape, generator=gen).to(dev, dtype)
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            before = flash_attention.flash_attention.instance_launches[kind]
            out = flash_attention.flash_attention(*ins, window=window)
            got = torch.autograd.grad(out, ins, grad)
            torch.cuda.synchronize()
            if flash_attention.flash_attention.instance_launches[kind] \
                    != before + 1:
                raise AssertionError(f"flash_attention with grad did not "
                                     f"launch its {kind} instance once")
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = flash_attention.mha_chunked(*plain, window=window)
            want = torch.autograd.grad(ref, plain, grad)
            shapes = f"{label} q {tuple(q.shape)} kv {tuple(k.shape)} {tname}"
            errs[f"flash_attention forward {tname} {label}"] = parity(
                f"flash_attention [{kind}] with grad, output {shapes}: "
                f"kernel vs mha_chunked", out.detach(), ref.detach(),
                TOL_FLASH[tname])
            err = max(parity(f"flash_attention [{kind}] gradient d{name} "
                             f"{shapes}: Function vs autograd through "
                             f"mha_chunked (wiring)", a, w, TOL_FLASH[tname])
                      for name, a, w in zip("qkv", got, want))
            errs[f"flash_attention grad {tname} {label}"] = err
            del q, k, v, grad, ins, plain, out, ref, got, want
        rows = b_tr * lm_cfg.n_heads
        n_s, d_s = lm_cfg.ssm_state, lm_cfg.hd
        qs = torch.randn((rows, s_tr, n_s), generator=gen).to(dev, dtype)
        ks = (0.25 * torch.randn((rows, s_tr, n_s), generator=gen)).to(dev)
        vs = torch.randn((rows, s_tr, d_s), generator=gen).to(dev, dtype)
        ws = torch.exp(-0.1 * torch.rand((rows, s_tr, n_s),
                                         generator=gen)).to(dev)
        go = torch.randn((rows, s_tr, d_s), generator=gen).to(dev, dtype)
        gs = torch.randn((rows, n_s, d_s), generator=gen).to(dev)
        ins = [x.clone().requires_grad_() for x in (qs, ks, vs, ws)]
        before = dict(linear_scan.linear_scan.instance_launches)
        o, s_fin = linear_scan.linear_scan(*ins, decay_before_read=True)
        got = torch.autograd.grad((o, s_fin), ins, (go, gs))
        torch.cuda.synchronize()
        if linear_scan.linear_scan.instance_launches != dict(
                before, chunked=before["chunked"] + 1):
            raise AssertionError("linear_scan with grad did not launch its "
                                 "chunked instance once")
        plain = [x.clone().requires_grad_() for x in (qs, ks, vs, ws)]
        o_p, s_p = linear_scan.linear_scan_chunked(*plain,
                                                   decay_before_read=True)
        want = torch.autograd.grad((o_p.to(dtype), s_p), plain, (go, gs))
        shapes = f"({rows}, {s_tr}, {n_s}, {d_s}) {tname}"
        errs[f"linear_scan forward {tname}"] = max(
            parity(f"linear_scan [chunked] with grad, {name} {shapes}: "
                   f"kernel vs linear_scan_chunked", a.detach(),
                   w.detach().to(a.dtype), TOL[str(a.dtype).split(".")[-1]])
            for name, a, w in (("o", o, o_p), ("S_final", s_fin, s_p)))
        err = max(parity(f"linear_scan [chunked] gradient d{name} {shapes}: "
                         f"Function vs autograd through linear_scan_chunked "
                         f"(wiring)", a, w,
                         TOL[tname if a.dtype == dtype else "float32"])
                  for name, a, w in zip("qkvw", got, want))
        errs[f"linear_scan grad {tname}"] = err
        del qs, ks, vs, ws, go, gs, ins, plain, o, s_fin, o_p, s_p, got, want



def training_errs(errs: dict, kernel: str) -> dict:
    """A kernel's errors from `lm_grad_parity` for the kernels line: the
    forward output at the training shape (the kernel's own error), and the
    gradients (the Function's wiring; 0 where it is right), by dtype and
    case."""
    return {key: {k.split(f"{kind} ", 1)[1]: v for k, v in errs.items()
                  if k.startswith(f"{kernel} {kind} ")}
            for key, kind in (("max_abs_err", "forward"),
                              ("max_abs_err_grad_wiring", "grad"))}


def lm_training_times(lm_cfg, gen, dev, card: str) -> tuple[dict, dict]:
    """Times of the training path's LM kernel calls at batch 2 x 4,096
    tokens, one call alone each (CUDA events, `event_ms`): flash attention
    (bf16, window) and the scan, each its kernel forward, the plain
    backward its Function runs, and both through the Function; SDPA
    forward + backward beside attention."""
    import torch

    from repro_torch.kernels import flash_attention, linear_scan

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, win = torch.bfloat16, lm_cfg.window
    hq, hkv, d, n = (lm_cfg.n_heads, lm_cfg.kv_heads, lm_cfg.hd,
                     lm_cfg.ssm_state)
    seq = 4096
    # the training path's calls at batch 2 x 4,096 tokens: the kernel's
    # forward, the plain backward its autograd Function runs (the plain
    # chunked forward again and its vjp), the two through the Function,
    # and for attention one PyTorch call that does both, SDPA forward +
    # backward (band mask, enable_gqa); bf16 attention as trained
    qt, kt, vt = (torch.randn(shape, generator=gen).to(dev, bf16)
                  for shape in ((2, hq, seq, d), (2, hkv, seq, d),
                                (2, hkv, seq, d)))
    gt = torch.randn(qt.shape, generator=gen).to(dev, bf16)
    band = torch.ones((seq, seq), dtype=torch.bool, device=dev)
    band = band.tril() & ~band.tril(-win)

    def vjp(fn, *xs, grad):
        """The gradients of fn's output at xs, along `grad`."""
        xs = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*xs), xs, grad)

    def training_times(ms: dict) -> dict:
        return {"forward_ms": ms["kernel forward"],
                "plain_backward_ms": ms["plain backward"],
                "function_forward_backward_ms":
                    ms["kernel forward + plain backward (Function)"]}

    print(f"time per call ({card}), flash_attention window {win} q "
          f"{tuple(qt.shape)} kv {tuple(kt.shape)} bf16, training:")
    ms = event_ms({
        "kernel forward": lambda: flash_attention.flash_attention(
            qt, kt, vt, window=win),
        "plain backward": lambda: vjp(
            lambda *x: flash_attention.mha_chunked(*x, window=win),
            qt, kt, vt, grad=gt),
        "kernel forward + plain backward (Function)": lambda: vjp(
            lambda *x: flash_attention.flash_attention(*x, window=win),
            qt, kt, vt, grad=gt),
        "library forward + backward": lambda: vjp(
            lambda *x: sdpa(*x, attn_mask=band, enable_gqa=True),
            qt, kt, vt, grad=gt)})
    train_fa = training_times(ms)
    train_fa["library_forward_backward_ms"] = \
        ms["library forward + backward"]
    print(f"  flash_attention training ({card}): kernel forward "
          f"{ms['kernel forward']:.7f} ms, plain backward "
          f"{ms['plain backward']:.7f} ms, both through the Function "
          f"{ms['kernel forward + plain backward (Function)']:.7f} ms; SDPA "
          f"forward + backward {ms['library forward + backward']:.7f} ms")
    del qt, kt, vt, gt, band
    qs_t = torch.randn((2 * hq, seq, n), generator=gen).to(dev, bf16)
    ks_t = (0.25 * torch.randn((2 * hq, seq, n), generator=gen)).to(dev)
    vs_t = torch.randn((2 * hq, seq, d), generator=gen).to(dev, bf16)
    ws_t = torch.exp(-0.1 * torch.rand((2 * hq, seq, n),
                                       generator=gen)).to(dev)
    go_t = torch.randn((2 * hq, seq, d), generator=gen).to(dev, bf16)
    print(f"time per call ({card}), linear_scan q/k/w {tuple(qs_t.shape)} v "
          f"{tuple(vs_t.shape)} (q, v bf16; k, w f32), training:")
    ms = event_ms({
        "kernel forward": lambda: linear_scan.linear_scan(
            qs_t, ks_t, vs_t, ws_t, decay_before_read=True),
        "plain backward": lambda: vjp(
            lambda *x: linear_scan.linear_scan_chunked(
                *x, decay_before_read=True)[0].to(bf16),
            qs_t, ks_t, vs_t, ws_t, grad=go_t),
        "kernel forward + plain backward (Function)": lambda: vjp(
            lambda *x: linear_scan.linear_scan(
                *x, decay_before_read=True)[0],
            qs_t, ks_t, vs_t, ws_t, grad=go_t)})
    train_ls = training_times(ms)
    print(f"  linear_scan training ({card}): kernel forward "
          f"{ms['kernel forward']:.7f} ms, plain backward "
          f"{ms['plain backward']:.7f} ms, both through the Function "
          f"{ms['kernel forward + plain backward (Function)']:.7f} ms; "
          f"library call: none")
    del qs_t, ks_t, vs_t, ws_t, go_t
    return train_fa, train_ls


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """module.name replaced by wrap(module.name) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def lm_path_parity(cfg, card: str) -> dict:
    """One training step's loss and gradient norm at the training path's
    batch (2 x 4,096 tokens, the TokenStream's first batch, the seed's
    params): the kernel path against the plain path, and against the
    kernel path with a fault put into one kernel's output (the controls,
    which the gate must reject).  The plain path runs one sequence at a
    time (with remat it keeps a whole group's float32 attention blocks,
    ~5 GB a layer per sequence, so 2 x 4,096 does not fit the card) and
    its losses and gradients are combined with the token counts as
    weights, which is the batch's mean.  Returns the readings, relative to
    the plain path, and the parameter count."""
    import gc

    import torch

    from repro_torch import optim
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import api, lm

    batch, seq = 2, 4096
    params = api.init(cfg, seed=0)
    plist = list(params.parameters())
    n_params = sum(p.numel() for p in plist)
    tokens = TokenStream(cfg, batch, seq, seed=0).next()
    kernel_cfg = dataclasses.replace(cfg, attn_impl="kernel",
                                     scan_impl="kernel")
    plain_cfg = dataclasses.replace(cfg, attn_impl="chunked",
                                    scan_impl="chunked")

    def loss_and_grads(cfg_i, rows):
        params.requires_grad_(True)
        loss, metrics = lm.lm_loss(params, cfg_i, rows)
        grads = torch.autograd.grad(loss, plist)
        return float(loss.detach()), float(metrics["tokens"]), grads

    def step(label: str, cfg_i) -> tuple[float, float]:
        """The kernel-path step at the full batch: (loss, grad_norm)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(cfg_i, tokens)
        norm = float(optim.global_norm(grads))
        print(f"hymba-1.5b one step's loss and gradient at {batch} x {seq} "
              f"tokens, {label}: loss {loss:.6f}, grad_norm {norm:.6f}, "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"({card})")
        return loss, norm

    got = {"kernel path": step("kernel path", kernel_cfg)}
    # the plain path, one sequence at a time; the first sequence's
    # gradients wait on the host while the second runs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    parts = []
    for i in range(batch):
        loss, count, grads = loss_and_grads(
            plain_cfg, {k: v[i:i + 1] for k, v in tokens.items()})
        parts.append((loss, count, [g.cpu() for g in grads] if i == 0
                      else grads))
        del grads
    total = sum(c for _, c, _ in parts)
    loss = sum(l_i * c for l_i, c, _ in parts) / total
    (_, c0, g0), (_, c1, g1) = parts
    sq = torch.zeros((), device=g1[0].device)
    for a, b in zip(g0, g1):
        sq += torch.sum(torch.square((a.to(b.device) * c0 + b * c1) / total))
    got["plain path"] = (loss, float(torch.sqrt(sq)))
    print(f"hymba-1.5b one step's loss and gradient at {batch} x {seq} "
          f"tokens, plain path (one sequence at a time): loss {loss:.6f}, "
          f"grad_norm {got['plain path'][1]:.6f}, "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    del parts, g0, g1, sq
    # the controls: the kernel path with one fault of the kind the gate is
    # there to catch, put into a kernel's inputs or output at the model's
    # dispatch (`kernels.ops`); the last is below what the gate resolves
    # (measured: 3.0e-5 / 8.1e-4, inside the kernel path's own spread) and
    # is printed to show that resolution, not gated
    bf16 = torch.bfloat16
    controls = {
        "control: attention window dropped": ("attention",
            lambda f: lambda q, k, v, **kw: f(q, k, v, **dict(kw,
                                                              window=None))),
        "control: scan decay read in bf16": ("gated_linear_scan",
            lambda f: lambda q, k, v, w, *a, **kw: f(
                q, k, v, w.to(bf16).to(w.dtype), *a, **kw)),
        "below resolution: attention output 2^-7 high": ("attention",
            lambda f: lambda *a, **kw: f(*a, **kw) * (1.0 + 2.0**-7)),
    }
    for label, (name, wrap) in controls.items():
        with patched(ops, name, wrap):
            got[label] = step(label, kernel_cfg)
    del params, plist, tokens
    gc.collect()
    torch.cuda.empty_cache()
    lp, gp = got["plain path"]
    rel = {label: (abs(lo - lp) / abs(lp), abs(gn - gp) / gp)
           for label, (lo, gn) in got.items() if label != "plain path"}
    for label, (dl, dg) in rel.items():
        print(f"hymba-1.5b training step, {label} vs plain path: loss rel "
              f"{dl:.3e} (tol {TOL_TRAIN_LOSS:g}), grad_norm rel {dg:.3e} "
              f"(tol {TOL_TRAIN_GRAD_NORM:g})")
    dl, dg = rel["kernel path"]
    if not (dl <= TOL_TRAIN_LOSS and dg <= TOL_TRAIN_GRAD_NORM):
        raise AssertionError("hymba-1.5b training: kernel path and plain "
                             "path disagree beyond the bf16 pins")
    for label in controls:
        if not label.startswith("control"):
            continue
        dl, dg = rel[label]
        if dl <= TOL_TRAIN_LOSS and dg <= TOL_TRAIN_GRAD_NORM:
            raise AssertionError(f"hymba-1.5b training: the gate passes "
                                 f"the {label}")
    return {"readings": got, "relative": rel, "n_params": n_params}


def lm_train_phase(counters: list, card: str) -> dict:
    """hymba-1.5b at full width and depth: first one step's loss and
    gradient norm on the kernel path against the plain path
    (`lm_path_parity`), then training through `repro_torch.launch.train`
    (device None: the GPU): float32 masters, bf16 compute, batch 2 x 4,096
    tokens, Adam (lr 3e-4, clip 1.0); 3 steps and a checkpoint, then
    `--resume` of one more step.  Each run with every count set to 0 just
    before and read just after: per step each layer's flash attention and
    scan run twice (the forward and the remat recompute; the backward is
    the plain chunked forms'), all on the tensor-core flash instance and
    the chunked scan instance.  Returns the launches by counter name, the
    comparison's readings, and each run's wall time, peak memory and step
    records."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention, linear_scan
    from repro_torch.launch import train as train_cli

    names = [fn.__name__ for fn in counters]
    cfg = configs.get("hymba-1.5b")
    batch, seq = 2, 4096
    per_step = 2 * cfg.n_layers
    out = {"launches": [0] * len(counters),
           "parity": lm_path_parity(cfg, card)}
    fa_split = flash_attention.flash_attention.instance_launches
    ls_split = linear_scan.linear_scan.instance_launches
    with tempfile.TemporaryDirectory() as ckpt:
        # the two runs leave two checkpoints (params, m, v in float32)
        need = 2 * 12 * out["parity"]["n_params"]
        free = shutil.disk_usage(ckpt).free
        print(f"checkpoint disk: {need / 1e9:.1f} GB needed for two "
              f"checkpoints, {free / 1e9:.1f} GB free in {ckpt}")
        if free < need + 2**30:
            raise AssertionError(f"hymba training needs {need / 1e9:.1f} GB "
                                 f"of disk for its checkpoints, "
                                 f"{free / 1e9:.1f} GB free")
        for label, steps, extra, n_steps in (
                ("3 steps", 3, [], 3),
                ("--resume, 1 more step", 4, ["--resume"], 1)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(counters)
            t0 = time.perf_counter()
            history = train_cli.main([
                "--arch", "hymba-1.5b", "--steps", str(steps), "--batch",
                str(batch), "--seq", str(seq), "--checkpoint-dir", ckpt,
                "--checkpoint-every", "1000"] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = [fn.launches for fn in counters]
            split = (dict(fa_split), dict(ls_split))
            peak = torch.cuda.max_memory_allocated()
            want = [0, 0, 0, 0, n_steps * per_step, n_steps * per_step]
            want_split = ({"cuda_core": 0, "tensor_core": want[4]},
                          {"step": 0, "chunked": want[5]})
            steps_s = [r["step_s"] for r in history]
            print(f"main path hymba-1.5b training, {label} ({card}): "
                  f"{wall:.3f} s wall ({sum(steps_s):.3f} s in the steps, the "
                  f"rest init and checkpoint I/O), peak device memory "
                  f"{peak / 2**30:.3f} GiB; launches {dict(zip(names, counts))}"
                  f" (expected {dict(zip(names, want))}); flash by instance "
                  f"{split[0]}, scan by instance {split[1]}")
            for rec in history:
                print(f"  step {rec['step']}: loss {rec['loss']:.6f}, ce "
                      f"{rec['ce']:.6f}, grad_norm {rec['grad_norm']:.6f}, "
                      f"{rec['step_s'] * 1e3:.3f} ms, "
                      f"{rec['tokens_per_s']:.1f} tokens/s")
            if [r["step"] for r in history] != list(range(steps - n_steps,
                                                          steps)):
                raise AssertionError(f"hymba training {label}: steps "
                                     f"{[r['step'] for r in history]}")
            if not all(math.isfinite(r[k]) for r in history
                       for k in ("loss", "grad_norm")):
                raise AssertionError(f"hymba training {label}: non-finite "
                                     f"loss or gradient norm")
            if counts != want or split != want_split:
                raise AssertionError(f"hymba training {label}: launches "
                                     f"{counts} {split}, expected {want} "
                                     f"{want_split}")
            out["launches"] = [a + c for a, c in zip(out["launches"],
                                                     counts)]
            out[label] = {"wall_s": wall, "peak_bytes": peak,
                          "history": history}
    return out


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) of `values`, nearest rank."""
    ranked = sorted(values)
    return ranked[min(len(ranked) - 1, max(0, math.ceil(q / 100 * len(ranked))
                                           - 1))]


def serve_phase(runner, counters: list, card: str) -> dict:
    """The fleet's trained controllers served from the pipelined runner's
    newest checkpoint through `serve.load_service` (device None: the GPU),
    on observations its envs produced (the broker's last trajectories).
    Two passes over every scenario at 1, 2, 3, 5, 16 and 37 requests (every
    bucket of the ladder, padding, chunking above 16): each served action
    and value must equal `multitask.actor_mean` / `value` of the runner's
    policy on the same padded batch, eager on the card, bit for bit; each
    (scenario, bucket) captured once over the two passes; the counters
    equal the requests and batches sent; no RL kernel launched.  Then
    batch-1 rows against a batch of 16, and the latency of submit -> flush
    per (scenario, bucket), graph replay against eager dispatch.  Returns
    the latencies."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.core import checkpoints
    from repro_torch.fleet import broker as broker_lib
    from repro_torch.fleet import multitask

    names = runner.forch.names
    ckpt = runner.run_cfg.checkpoint_dir
    obs = {n: broker_lib.latest_traj(runner.broker, n).obs.flatten(0, 1)
           .cpu().numpy() for n in names}
    zero_counts(counters)
    t0 = time.perf_counter()
    svc = serve.load_service(ckpt)
    print(f"serving: checkpoint step {checkpoints.latest_step(ckpt)} of the "
          f"pipelined fleet runner (iteration {runner.iteration}) loaded on "
          f"{svc.device} in {time.perf_counter() - t0:.3f} s; observation "
          f"rows from its broker {({n: o.shape for n, o in obs.items()})}")
    if svc.device.type != "cuda" or svc.scenarios != names:
        raise AssertionError(f"service on {svc.device} for {svc.scenarios}")
    counts_sent = {n: {"requests": 0, "batches": 0} for n in names}
    mismatched = 0
    for _ in range(2):
        for name in names:
            start = 0
            for n_req in (1, 2, 3, 5, 16, 37):
                rows = obs[name][np.arange(start, start + n_req)
                                 % len(obs[name])]
                start += n_req
                uids = [svc.submit(name, row) for row in rows]
                results = svc.flush()
                cap = serve.DEFAULT_BUCKETS[-1]
                for c in range(0, n_req, cap):
                    chunk = rows[c:c + cap]
                    bucket = serve.bucket_for(len(chunk))
                    padded = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bucket - len(chunk),
                                          0)])
                    x = torch.from_numpy(padded).cuda()
                    with torch.no_grad():
                        want_a = multitask.actor_mean(
                            runner.policy.params, svc.mcfg, name, x).cpu()
                        want_v = multitask.value(
                            runner.policy.params, svc.mcfg, name, x).cpu()
                    for i, uid in enumerate(uids[c:c + cap]):
                        res = results[uid]
                        mismatched += int(not (
                            np.array_equal(res.action, want_a[i].numpy())
                            and res.value == float(want_v[i])))
                    counts_sent[name]["requests"] += len(chunk)
                    counts_sent[name]["batches"] += 1
    launched = [fn.launches for fn in counters]
    stats = svc.stats()
    want_captures = {(n, b): 1 for n in names for b in serve.DEFAULT_BUCKETS}
    print(f"serving, two passes of {names} x (1, 2, 3, 5, 16, 37) requests: "
          f"{mismatched} results differ from actor_mean/value on the padded "
          f"batch; captures {svc.captures}; counters {stats} (sent "
          f"{counts_sent}); RL kernel launches {launched}")
    if mismatched or svc.captures != want_captures or stats != counts_sent \
            or any(launched):
        raise AssertionError("serving the fleet's controllers: results, "
                             "captures, counters or launches are off")
    # batch-1 rows against the same rows in one batch of 16 (other GEMM
    # shapes on the card)
    worst = 0.0
    for name in names:
        rows = obs[name][:16]
        singles = np.stack([svc.serve_batch(name, r[None])[0] for r in rows])
        batch = svc.serve_batch(name, rows)
        diff = float(np.abs(singles - batch).max())
        scale = float(np.abs(batch).max())
        print(f"serving {name}: 16 rows one at a time vs in one batch of "
              f"16: max |d| {diff:.3e} of max |action| {scale:.3e}"
              f"{' (bitwise equal)' if diff == 0 else ''}")
        worst = max(worst, diff / scale)
    if worst > TOL_SERVE_ROWS:
        raise AssertionError(f"batch-1 vs batch-16 rows differ by {worst:.3e}"
                             f" of max, above {TOL_SERVE_ROWS}")
    # latency of submit -> flush (results on the host) per (scenario,
    # bucket): the graph path and eager dispatch on the same card
    eager = serve.ControllerService.from_policy(
        serve.load_policy(ckpt), capture=False)
    latency = {}
    for name in names:
        for bucket in serve.DEFAULT_BUCKETS:
            rows = obs[name][:bucket]
            for mode, service in (("graph", svc), ("eager", eager)):
                times = []
                for rep in range(203):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for row in rows:
                        service.submit(name, row)
                    service.flush()
                    if rep >= 3:  # warm-up
                        times.append((time.perf_counter() - t0) * 1e3)
                p50, p99 = percentile(times, 50), percentile(times, 99)
                latency[f"{name} {bucket} {mode}"] = {
                    "p50_ms": p50, "p99_ms": p99,
                    "requests_per_s": bucket / p50 * 1e3}
            g, e = (latency[f"{name} {bucket} {m}"] for m in ("graph",
                                                               "eager"))
            print(f"serving latency {name} bucket {bucket} ({card}): graph "
                  f"p50 {g['p50_ms']:.4f} ms p99 {g['p99_ms']:.4f} ms "
                  f"({g['requests_per_s']:.0f} requests/s); eager p50 "
                  f"{e['p50_ms']:.4f} ms p99 {e['p99_ms']:.4f} ms "
                  f"({e['requests_per_s']:.0f} requests/s)")
    return latency


def check_reverts(label: str, frunner, rec: dict, reverts: dict,
                  pipelined: bool) -> None:
    """Hold one fleet call's guard reverts: every rollout of the channel
    and Burgers sub-fleets and every evaluation episode (batch 1, the mean
    action) advance on every step.  HIT's exploratory steps may be
    reverted (the reward floor -1 each).  In the synchronous call, whose
    record reports the rollout it counted, each sub-fleet's return_norm
    can be at most 1 - 2 x its reverted share (reverted steps give -1,
    the others at most 1)."""
    for name, by_batch in reverts.items():
        n_envs = frunner.forch.orchs[name].fleet.n_envs
        reverted, steps = by_batch[n_envs]
        if name != "hit_les_24dof" and reverted:
            raise AssertionError(f"fleet {label}: {name} reverted "
                                 f"{reverted} of {steps} env-steps")
        if not pipelined:
            cap = 1.0 - 2.0 * reverted / steps
            if rec[f"{name}/return_norm"] > cap + 1e-6:
                raise AssertionError(
                    f"fleet {label}: {name} return_norm "
                    f"{rec[f'{name}/return_norm']} above {cap}, the most "
                    f"that {reverted} reverts of {steps} allow")
            ev_reverted, ev_steps = by_batch[1]
            n_actions = frunner.forch.orchs[name].env.n_actions
            if ev_reverted or ev_steps != n_actions:
                raise AssertionError(f"fleet {label}: {name} evaluation "
                                     f"reverted {ev_reverted} of {ev_steps} "
                                     f"steps")
        elif set(by_batch) != {n_envs}:
            raise AssertionError(f"fleet {label}: {name} batches "
                                 f"{set(by_batch)}, no evaluation asked")
    if not pipelined:
        evals = read_evaluations(frunner)
        print("  evaluation: " + ", ".join(
            f"{n}: eval_return_norm={v:.6f}" for n, v in evals.items()))
        if set(evals) != set(reverts) or not all(
                math.isfinite(v) and -1.0 <= v <= 1.0
                for v in evals.values()):
            raise AssertionError(f"fleet {label}: evaluation {evals}")


def read_evaluations(frunner) -> dict:
    """{scenario: eval_return_norm} from the runner's metric log: the one
    evaluation record of this call."""
    with open(frunner.metrics_path) as f:
        records = [json.loads(line) for line in f]
    (rec,) = [r for r in records
              if any(k.endswith("/eval_return_norm") for k in r)]
    return {k.split("/")[0]: v for k, v in rec.items()
            if k.endswith("/eval_return_norm")}


def drive_fleet(runner, n_iter: int, counters: list) -> tuple:
    """`runner.train(n_iter)` with every counter set to 0 just before and
    read just after; returns (this call's records, launches, wall s)."""
    import torch

    zero_counts(counters)
    t0 = time.perf_counter()
    history = runner.train(n_iter, resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return history, [fn.launches for fn in counters], wall


def analysis_phase(card: str) -> dict:
    """Every layer of the port's static-analysis gate on the card
    (`repro_torch.analysis.cli.run_layers`, `device="cuda"`): the source
    lint; each registered entry point on the CPU under the recorder and
    again on the card under `torch.cuda.set_sync_debug_mode`, the two sync
    counts held equal; each library's registers, spills and static shared
    memory from cuobjdump, each planned launch's shared memory read from
    its library and held to its wrapper's plan and to the card's limit;
    the reduced-HIT training run's pinned counters on the card.
    Any unsuppressed finding fails.  Returns the phase's `analysis`
    record."""
    from repro_torch.analysis import cli

    t0 = time.perf_counter()
    report = cli.run_layers(cli.LAYERS, root=ROOT, device="cuda")
    secs = time.perf_counter() - t0
    by_layer: dict = {layer: {} for layer in cli.LAYERS}
    layer_of = {"AST": "ast", "OPS": "ops", "KER": "kernel", "TRA": "trace"}
    for f in report.unsuppressed():
        counts = by_layer[layer_of[f.rule[:3]]]
        counts[f.rule] = counts.get(f.rule, 0) + 1
    meta = report.meta
    record = {
        "seconds": round(secs, 3),
        "layer_seconds": meta["seconds"],
        "card": card,
        "findings": by_layer,
        "suppressed": [f"{f.rule} {f.location}: {f.suppress_reason}"
                       for f in report.findings if f.suppressed],
        "libraries": {
            source: {k: r[k] for k in ("functions", "registers", "spills",
                                       "shared", "stack")}
            for source, r in meta["kernel_audit"]["libraries"].items()},
        "smem_optin_bytes": meta["kernel_audit"]["smem_limit"],
        "max_smem_by_case": {
            name: s["max_smem"]
            for name, s in meta["kernel_audit"]["kernels"].items()},
        "syncs": {name: {"cpu": v["cpu"], "card": v["card"]}
                  for name, v in meta["op_audit"]["syncs"].items()},
        "launches_by_entry": meta["op_audit"].get("launches", {}),
        "trace": meta["trace_audit"]["reduced_hit_counts"],
        "trace_sync_sites": meta["trace_audit"]["sync_sites"],
    }
    print(report.summary())
    print(f"static analysis on the card in {secs:.1f} s ({card}): "
          f"{len(report.unsuppressed())} unsuppressed finding(s); syncs "
          f"per entry (cpu/card) "
          + ", ".join(f"{n} {v['cpu']}/{v['card']}"
                      for n, v in record["syncs"].items()))
    if not report.clean:
        raise AssertionError(f"static analysis: "
                             f"{len(report.unsuppressed())} unsuppressed "
                             f"finding(s)")
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch import configs as lm_configs
    from repro_torch import envs, fleet
    from repro_torch.cfd import channel, equations, gll, initial
    from repro_torch.cfd.solver import HITConfig
    from repro_torch.configs import relexi_hit
    from repro_torch.core import ppo
    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner
    from repro_torch.fleet.pipeline import FleetRunnerConfig
    from repro_torch.data import lm_batch
    from repro_torch.kernels import (_build, dg_derivative, flash_attention,
                                     linear_scan, rhs, smagorinsky,
                                     wall_model)
    from repro_torch.analysis import kernel_audit
    from repro_torch.models import api, lm

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def elapsed(label: str) -> None:
        """The run's time so far, at the start of `label`."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {label}")

    # --- 1. the card and the numerics flags ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"for the whole run; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (torch's default, not set "
          f"here); the policy's convolutions run with the package's "
          f"repro_torch.CONV_ALLOW_TF32={repro_torch.CONV_ALLOW_TF32} "
          f"(conv_precision, around the rollout and each PPO epoch)")

    # --- 2. build: one nvcc per source, all started together -----------------
    elapsed("phase 2: build")
    sources = kernel_audit.all_sources()

    def build(source: str) -> float:
        t0 = time.perf_counter()
        _build.build(source)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        build_s = dict(zip(sources, pool.map(build, sources)))
    print(f"built {len(sources)} sources in {time.perf_counter() - t0:.2f} s "
          f"wall, in parallel")
    for source, secs in build_s.items():   # resources: the analysis line
        _build.load(source)
        print(f"built {source} in {secs:.2f} s")

    # --- 2b. the static-analysis gate on the card ------------------------------
    elapsed("phase 2b: static analysis")
    analysis = analysis_phase(card)
    for label, cfg in (("24-DOF", relexi_hit.HIT24),
                       ("32-DOF", relexi_hit.HIT32)):
        k, n = cfg.n_elem, cfg.n_poly + 1
        plan = rhs.cluster_plan(k, k, k, n, torch.float32)
        elems = k**3 // plan.ctas
        active = {str(dt).split(".")[-1]: rhs.max_active_clusters(
            k, k, k, n, dt) for dt in (torch.float32, torch.bfloat16)}
        print(f"fused RHS cluster_plan {label} ({k}^3 elements, n={n}): "
              f"{plan}, {elems} elements per CTA; B=16 is 16 clusters = "
              f"{16 * plan.ctas} CTAs; cudaOccupancyMaxActiveClusters "
              f"{active} ({card})")
    per_sm = _build.load(linear_scan.SOURCES["chunked"]) \
        .linear_scan_chunked_blocks_per_sm
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (rows, t_len, dk, dv) in (
            ("hymba prefill 4 x 2048", (100, 2048, 16, 64)),
            ("hymba prefill 4 x 700", (100, 700, 16, 64)),
            ("RWKV6 64 x 64 state, 64 x 512, float32", (64, 512, 64, 64))):
        plan = linear_scan.chunked_plan(dk, dv)
        blocks = rows * -(-t_len // plan.chunk) * -(-dv // plan.cols)
        dts = (1, 0, 1, 0) if dk == 16 else (0, 0, 0, 0)  # q, k, v, w bf16
        occ = {phase: per_sm(dk, dv, *dts, i) for i, phase in
               enumerate(("A (chunk states)", "C (outputs)"))}
        if min(occ.values()) < 1:
            raise AssertionError(f"chunked scan {label}: the card holds no "
                                 f"block ({occ})")
        waves = {ph: round(blocks / (n * n_sm), 3) for ph, n in occ.items()}
        print(f"linear_scan chunked plan {label} (dk {dk}, dv {dv}): {plan},"
              f" {plan.groups * plan.cols} threads, {blocks} blocks per "
              f"phase; blocks per SM {occ}; waves on {n_sm} SMs {waves} "
              f"({card})")

    # --- 3. kernel vs plain on the card --------------------------------------
    elapsed("phase 3: kernel vs plain")
    gen = torch.Generator().manual_seed(0)
    cases = [("24-DOF", (16,), relexi_hit.HIT24, None),
             ("32-DOF", (4,), relexi_hit.HIT32, None),
             ("n_poly=2 K=3", (3,), HITConfig(n_poly=2, n_elem=3), None),
             ("32-DOF", (16,), relexi_hit.HIT32, None),
             ("non-cubic 2x3x4", (2,), relexi_hit.HIT24, (2, 3, 4)),
             ("24-DOF", (8,), relexi_hit.HIT24, None)]  # the fleet's HIT
    states = [(name, synthetic_state(gen, prefix, cfg, dev, elems), cfg)
              for name, prefix, cfg, elems in cases]
    bank_gen = torch.Generator(device=dev).manual_seed(1)
    states.append(("24-DOF bank", initial.make_state_bank(
        bank_gen, relexi_hit.HIT24, 4), relexi_hit.HIT24))
    errs = {}
    rhs_instances = rhs.fused_navier_stokes_rhs.instance_launches
    for name, u, cfg in states:
        ops, kw = rhs_kwargs(cfg, dev)
        cs_elem = 0.5 * torch.rand(u.shape[:-4], generator=gen)
        cs = cs_elem[..., None, None, None].expand(u.shape[:-1]).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            ud, csd = u.to(dtype).contiguous(), cs.to(dtype).contiguous()
            d_mat, w = ops["D"].to(dtype), ops["w"].to(dtype)
            want = rhs.navier_stokes_rhs_plain(ud, csd, d_mat, w, **kw)
            tname = str(dtype).split(".")[-1]
            if rhs.pick_instance(ud.shape, dtype) != "cluster":
                raise AssertionError(f"fused RHS {name}: no cluster plan")
            for kind in ("cluster", "two_pass"):
                before = rhs_instances[kind]
                got = rhs.fused_navier_stokes_rhs(ud, csd, d_mat, w,
                                                  instance=kind, **kw)
                torch.cuda.synchronize()
                if rhs_instances[kind] != before + 1:
                    raise AssertionError(f"fused RHS {name} did not launch "
                                         f"its {kind} instance")
                err = parity(f"fused RHS [{kind}] {name} n={cfg.n_poly + 1} "
                             f"mesh {tuple(ud.shape[1:4])} B={u.shape[0]} "
                             f"{tname}", got, want, TOL[tname])
                if kind == "cluster":  # the picked instance, bit for bit
                    again = rhs.fused_navier_stokes_rhs(ud, csd, d_mat, w,
                                                        **kw)
                    if not torch.equal(again, got):
                        raise AssertionError(f"fused RHS {name} {tname}: "
                                             f"two calls differ")
                if name == "24-DOF" and u.shape[0] == 16 \
                        and dtype == torch.float32:
                    errs[f"fused_navier_stokes_rhs {kind}"] = err

    # the three channel kernels: the channel path's shapes first (16 envs),
    # then the fleet's channel sub-fleet (8 envs), then the split paths'
    # (a channel_wm x-slab of 3 ranks, a hit_les_24dof x-slab of 2)
    elapsed("phase 3: channel kernels")
    chan = envs.make("channel_wm").cfg
    kx, ky, kz = chan.n_elem
    n = chan.n
    p_nodes = 16 * kx * ky * kz * n**3           # 36,864 nodes
    p_wall = 16 * kx * kz * n * n                # 2,304 wall-face columns
    # of one wall; the path batches both walls, 4,608
    dg_instances = dg_derivative.dg_derivative3.instance_launches
    if dg_derivative.pick_instance(9, 4, torch.float32) != "generic":
        raise AssertionError("dg_derivative3 picks the tiled instance at n=9")
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        # dg_derivative3: the paths' shapes (the channel, HIT's n = 6) on
        # both instances; the tiled instance at every n it is built for,
        # C = 1..5 and ragged batches; the generic instance at n = 9.  D in
        # u's dtype, as the rollouts hand it over
        dg_cases = [("channel", 16 * kx * ky * kz, n, 4, ("tiled", "generic")),
                    ("fleet channel", 8 * kx * ky * kz, n, 4,
                     ("tiled", "generic")),
                    ("HIT n=6", 16 * 64, 6, 4, ("tiled", "generic")),
                    ("channel x-slab of 3", 16 * ky * kz, n, 4,
                     ("tiled", "generic")),
                    ("HIT n=6 x-slab of 2", 16 * 32, 6, 4,
                     ("tiled", "generic")),
                    ("n=9", 577, 9, 4, ("generic",))]
        dg_cases += [(f"n={nn} C={c}", b, nn, c, ("tiled",))
                     for nn in range(2, 9) for c in range(1, 6)
                     for b in (1, 577)]
        for label, b, nn, c, kinds in dg_cases:
            u = torch.randn((b, nn, nn, nn, c), generator=gen).to(dev, dtype)
            d = torch.as_tensor(gll.lagrange_derivative_matrix(nn - 1),
                                dtype=dtype, device=dev)
            want = torch.stack(dg_derivative.dg_derivative3_plain(u, d))
            for kind in kinds:
                before = dict(dg_instances)
                got = dg_derivative.dg_derivative3(u, d, instance=kind)
                torch.cuda.synchronize()
                if dg_instances != dict(before, **{kind: before[kind] + 1}):
                    raise AssertionError(f"dg_derivative3 {label} did not "
                                         f"launch its {kind} instance once")
                err = parity(f"dg_derivative3 [{kind}] {label} "
                             f"{tuple(u.shape)} {tname} (du0, du1, du2)",
                             torch.stack(got), want, TOL[tname])
                if label == "channel" and dtype == torch.float32:
                    errs[f"dg_derivative3 {kind}"] = err
        # smagorinsky_nut: the contiguous (P, 3, 3) of PR 16 and the views
        # the kernel reads in place: the velocity rows of a (P, 4, 3)
        # gradient as the channel hands them over (s_p = 12), the same one
        # point (48 bytes) and 9 values (not 16-byte aligned) into a larger
        # buffer, with a stride-0 C_s, and a point stride of 60 (more than
        # the kernel stages); P of the channel path (16 envs), of the
        # fleet's channel sub-fleet (8 envs), of a channel x-slab of 3
        # ranks, of a 24-DOF x-slab of 2 and a ragged one
        for p_pts in (p_nodes, p_nodes // 2, p_nodes // kx, 16 * 32 * 6**3,
                      1007):
            for label, offset, s_p, cs_stride0 in (
                    ("contiguous", 0, 9, False),
                    ("rows of (P, 4, 3)", 0, 12, False),
                    ("rows one point in", 12, 12, False),
                    ("rows 9 values in", 9, 12, False),
                    ("rows, stride-0 cs", 0, 12, True),
                    ("point stride 60", 0, 60, False)):
                buf = torch.randn((offset + p_pts * s_p,), generator=gen).to(
                    dev, dtype)
                g = buf[offset:].view(p_pts, s_p // 3, 3)[:, :3]
                cs = (torch.full((), chan.cs_sgs, device=dev,
                                 dtype=dtype).expand(p_pts) if cs_stride0
                      else (0.5 * torch.rand((p_pts,), generator=gen)).to(
                          dev, dtype))
                before = smagorinsky.smagorinsky_nut.launches
                got = smagorinsky.smagorinsky_nut(g, cs, chan.delta_filter)
                torch.cuda.synchronize()
                if smagorinsky.smagorinsky_nut.launches != before + 1:
                    raise AssertionError(f"smagorinsky_nut {label} did not "
                                         f"launch its kernel once")
                err = parity(f"smagorinsky_nut {label} P={p_pts} strides "
                             f"{g.stride()}/{cs.stride()} {tname}", got,
                             smagorinsky.smagorinsky_nut_plain(
                                 g, cs, chan.delta_filter),
                             TOL_ELEMENTWISE[tname])
                if p_pts == p_nodes and label == "rows of (P, 4, 3)" \
                        and dtype == torch.float32:
                    errs["smagorinsky_nut"] = err
        # matching-point speeds across the viscous sublayer and the log
        # layer: one wall, both walls in one batch as the path calls it,
        # and both walls of a channel x-slab of 3 ranks
        for p_pts in (p_wall, 2 * p_wall, 2 * p_wall // kx):
            up = torch.logspace(-3, math.log10(1.6), p_pts).to(dev, dtype)
            rho = (0.9 + 0.2 * torch.rand((p_pts,), generator=gen)).to(
                dev, dtype)
            for cfg_name in ("channel_wm", "channel_wm_hre"):
                c = envs.make(cfg_name).cfg
                kw = dict(y_m=0.5 * c.dxs[1], nu=c.nu, kappa=c.kappa,
                          iters=c.wm_iters)
                got = wall_model.wall_model_tau(up, rho, **kw)
                torch.cuda.synchronize()
                err = parity(f"wall_model_tau P={p_pts} iters={c.wm_iters} "
                             f"nu={c.nu} {tname}", got,
                             wall_model.wall_model_tau_plain(up, rho, **kw),
                             TOL_ELEMENTWISE[tname])
                if cfg_name == "channel_wm" and p_pts == 2 * p_wall \
                        and dtype == torch.float32:
                    errs["wall_model_tau"] = err

    # flash attention: hymba's prefill (window 1024 on 28 layers, full on 4)
    elapsed("phase 3: LM kernels")
    # and the contract's other corners; bf16 runs the tensor-core instance,
    # float32 the CUDA-core one.  "views": q, k, v as the model hands them
    # over, (B, S, H, D) transposed to (B, H, S, D)
    flash_cases = (
        ("hymba SWA", (2, 25, 5, 2048, 2048, 64), dict(window=1024), False),
        ("hymba global", (2, 25, 5, 2048, 2048, 64), {}, False),
        ("D=128 GQA 2 softcap 50", (2, 8, 4, 512, 512, 128),
         dict(softcap=50.0), False),
        ("D=80", (2, 8, 8, 512, 512, 80), {}, False),
        ("non-causal", (2, 8, 2, 512, 512, 64), dict(causal=False), False),
        ("Sq=17 < Skv=300", (2, 8, 2, 17, 300, 64), {}, False),
        ("ragged S=1000", (2, 8, 2, 1000, 1000, 64), dict(window=300),
         False),
        ("D=256", (2, 4, 2, 700, 700, 256), dict(window=100), False),
        ("ragged S=2047", (2, 25, 5, 2047, 2047, 64), dict(window=1024),
         False),
        ("hymba SWA model views", (2, 25, 5, 2048, 2048, 64),
         dict(window=1024), True))
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        kind = flash_attention.instance(dtype)
        for label, (b, hq, hkv, sq, skv, d), kw, views in flash_cases:
            if views:
                q, k, v = (torch.randn((b, s_, h_, d), generator=gen).to(
                    dev, dtype).transpose(1, 2) for s_, h_ in
                    ((sq, hq), (skv, hkv), (skv, hkv)))
            else:
                q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                           for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                         (b, hkv, skv, d)))
            before = flash_attention.flash_attention.instance_launches[kind]
            got = flash_attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if flash_attention.flash_attention.instance_launches[kind] \
                    != before + 1:
                raise AssertionError(f"flash_attention {tname} did not "
                                     f"launch its {kind} instance")
            err = parity(f"flash_attention [{kind}] {label} "
                         f"{tuple(q.shape)} kv {tuple(k.shape)} {kw} "
                         f"{tname}", got,
                         flash_attention.mha_chunked(q, k, v, **kw),
                         TOL_FLASH[tname])
            if label == "hymba SWA":
                errs[f"flash_attention {tname}"] = err
        # linear scan, each instance: hymba's GLA read at prefill (2,048
        # and 700 tokens) and decode, RWKV6's read, ragged T, one chunk and
        # a chunk plus one step
        scan_instances = linear_scan.linear_scan.instance_launches
        for label, (b, t, dk, dv), gla, with_u, with_s0 in (
                ("hymba GLA", (50, 2048, 16, 64), True, False, False),
                ("hymba GLA T=700 with s0", (50, 700, 16, 64), True, False,
                 True),
                ("hymba decode T=1 with s0", (50, 1, 16, 64), True, False,
                 True),
                ("RWKV6 read with u", (64, 512, 64, 64), False, True, True),
                ("ragged T=1000", (50, 1000, 16, 64), True, False, True),
                ("one chunk T=64", (50, 64, 16, 64), True, False, True),
                ("a chunk plus one step T=65", (50, 65, 16, 64), True, False,
                 True)):
            q = torch.randn((b, t, dk), generator=gen).to(dev, dtype)
            k = (0.25 * torch.randn((b, t, dk), generator=gen)).to(dev)
            v = torch.randn((b, t, dv), generator=gen).to(dev, dtype)
            w = torch.exp(-0.5 * torch.rand((b, t, dk), generator=gen)).to(dev)
            u = torch.randn((dk,), generator=gen).to(dev) if with_u else None
            s0 = (torch.randn((b, dk, dv), generator=gen).to(dev)
                  if with_s0 else None)
            o_p, s_p = linear_scan.linear_scan_chunked(
                q, k, v, w, u, s0, decay_before_read=gla)
            for kind in ("chunked", "step"):
                before = dict(scan_instances)
                o, s_fin = linear_scan.linear_scan(q, k, v, w, u, s0,
                                                   decay_before_read=gla,
                                                   instance=kind)
                torch.cuda.synchronize()
                if scan_instances != dict(before, **{kind: before[kind] + 1}):
                    raise AssertionError(f"linear_scan {label} did not "
                                         f"launch its {kind} instance once")
                name = (f"linear_scan [{kind}] {label} ({b}, {t}, {dk}, "
                        f"{dv}) {tname}")
                err = max(parity(f"{name} o", o, o_p.to(dtype), TOL[tname]),
                          parity(f"{name} S_final", s_fin, s_p,
                                 TOL["float32"]))
                if label == "hymba GLA" and dtype == torch.float32:
                    errs[f"linear_scan {kind}"] = err

    elapsed("phase 3: RL intervals")
    # one RL interval of each scenario: the kernel path vs the staged plain
    # assembly, both on the card
    env = envs.make("hit_les_24dof")
    state, _ = env.reset_from_bank(states[-1][1], torch.tensor([0], device=dev))
    action = torch.full((1, env.action_spec.n_elements), 0.17, device=dev)
    u_ker = env.step(state, action).state.u
    u_ref = envs.make("hit_les_24dof", use_kernels=False).step(
        state, action).state.u
    parity(f"one 24-DOF RL interval ({env.cfg.n_substeps * 5} RHS calls), "
           f"kernel path vs staged plain path", u_ker, u_ref, TOL["float32"])
    chan_env = envs.make("channel_wm")
    chan_bank = chan_env.initial_state_bank(
        torch.Generator(device=dev).manual_seed(2), 16)
    chan_state, _ = chan_env.reset_from_bank(chan_bank,
                                             torch.arange(16, device=dev))
    chan_action = 0.5 + torch.rand((16, chan_env.action_spec.n_elements),
                                   generator=gen).to(dev)
    u_ker = chan_env.step(chan_state, chan_action).state.u
    u_ref = envs.make("channel_wm", use_kernels=False).step(
        chan_state, chan_action).state.u
    parity(f"one channel_wm RL interval of 16 envs ({chan.n_substeps * 5} "
           f"RHS calls), kernel path vs staged plain path", u_ker, u_ref,
           TOL["float32"])

    elapsed("phase 3: hymba-1.5b float32 and bf16")
    # hymba-1.5b at full width in float32: prefill of 2 x 1,100 tokens (the
    # window of 1,024 wraps) and 4 teacher-forced decode steps, the kernel
    # path against the plain path
    lm_cfg = lm_configs.get("hymba-1.5b")
    cfg32 = dataclasses.replace(lm_cfg, dtype="float32",
                                param_dtype="float32")
    params32 = api.init(cfg32, seed=1)
    toks = lm_batch(1, 2, 1104, lm_cfg.vocab)["tokens"].to(dev)

    def teacher_forced(cfg):
        logits, caches = api.prefill(params32, cfg, {"tokens": toks[:, :1100]},
                                     cache_len=1104, cache_dtype=torch.float32)
        out = [logits]
        for t in range(1100, 1104):
            logits, caches = api.decode_step(params32, cfg, toks[:, t], caches)
            out.append(logits)
        return torch.stack(out, 1)

    parity("hymba-1.5b full width float32, prefill 2 x 1100 + 4 decode "
           "steps, logits: kernel path vs plain path", teacher_forced(cfg32),
           teacher_forced(dataclasses.replace(cfg32, attn_impl="chunked",
                                              scan_impl="chunked")),
           TOL_MODEL)
    del params32

    # the same prefill in bf16 as served (bf16 weights and activations):
    # the tensor-core flash instance against the plain path
    cfg16 = dataclasses.replace(lm_cfg, param_dtype="bfloat16")
    params16 = api.init(cfg16, seed=1)

    def prefill16(cfg):
        return api.prefill(params16, cfg, {"tokens": toks[:, :1100]},
                           cache_len=1104)[0]

    before = flash_attention.flash_attention.instance_launches["tensor_core"]
    got16 = prefill16(cfg16)
    torch.cuda.synchronize()
    if flash_attention.flash_attention.instance_launches["tensor_core"] \
            != before + lm_cfg.n_layers:
        raise AssertionError("bf16 prefill did not run the tensor-core "
                             "flash instance once per layer")
    plain16 = prefill16(dataclasses.replace(cfg16, attn_impl="chunked",
                                            scan_impl="chunked"))
    parity("hymba-1.5b full width bf16, prefill 2 x 1100, logits: kernel "
           "path vs plain path", got16, plain16, TOL_MODEL_BF16)
    # the share of that difference that the attention kernel alone makes
    parity("hymba-1.5b full width bf16, prefill 2 x 1100, logits: flash "
           "kernel + plain scan vs plain path",
           prefill16(dataclasses.replace(cfg16, scan_impl="chunked")),
           plain16, TOL_MODEL_BF16)
    del params16, got16, plain16

    elapsed("phase 3: LM kernel gradients at hymba's training shape")
    lm_grad_parity(lm_cfg, gen, dev, errs)

    # --- 4. time each kernel at its path's shape (16 envs, float32) ----------
    elapsed("phase 4: timing")
    record = {}
    # the fused RHS: the cluster instance (the path's), the two-pass one
    # and the plain version at 24-DOF and 32-DOF, 16 envs, float32 and bf16
    rhs_shapes = {"24-DOF": states[0], "32-DOF": states[3]}
    for label, (_, u16, cfg) in rhs_shapes.items():
        ops, kw = rhs_kwargs(cfg, dev)
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            ud = u16.to(dtype).contiguous()
            args = (ud, torch.full(ud.shape[:-1], 0.17, device=dev,
                                   dtype=dtype), ops["D"], ops["w"])
            print(f"time per call ({card}), fused RHS {label} B=16 "
                  f"{tname}:")
            ms, call_ms = time_calls({
                "plain": lambda: rhs.navier_stokes_rhs_plain(*args, **kw),
                "kernel": lambda: rhs.fused_navier_stokes_rhs(
                    *args, instance="cluster", **kw),
                "kernel two_pass": lambda: rhs.fused_navier_stokes_rhs(
                    *args, instance="two_pass", **kw)}, windows=20, alone=10,
                plain_windows=10)
            bound = rhs_bound_ms(*args)
            clu, two = ms["kernel"], ms["kernel two_pass"]
            print(f"  fused RHS {label} {tname} ({card}): cluster instance "
                  f"{clu:.7f} ms, {'below' if clu < two else 'NOT below'} "
                  f"the two-pass instance's {two:.7f} ms ({two / clu:.3f}x);"
                  f" {100 * bound[0] / clu:.3f}% of the bound's speed "
                  f"({bound[0]:.7f} ms by {bound[1]}); two-pass "
                  f"{100 * bound[0] / two:.3f}%")
            if label == "24-DOF" and dtype == torch.float32:
                record["fused_navier_stokes_rhs"] = dict(
                    ms=ms, call_ms=call_ms, library_ms=None, bound=bound)
                rhs_args, rhs_kw = args, kw
    print("  library call: none, no single PyTorch call computes this RHS")
    # what one RHS call launches on the card: the cluster kernel alone, once
    # per call (the profiler may drop a few launches)
    rows = trace_kernels(lambda: rhs.fused_navier_stokes_rhs(*rhs_args,
                                                             **rhs_kw))
    print(f"fused RHS 24-DOF call x 50, device kernels in its trace: "
          f"{[(r[2], r[1]) for r in rows]}")
    if len(rows) != 1 or "ns_rhs_cluster_kernel" not in rows[0][2] \
            or not 1 <= rows[0][1] <= 50:
        raise AssertionError("a fused RHS call did not launch the cluster "
                             "kernel alone, once")

    elapsed("phase 4: channel kernels")
    # the card's floor per launch: the device time of a one-element PyTorch
    # elementwise kernel, timed beside the two kernels
    chan_ops = chan.operators(dev)
    one = torch.zeros((1,), device=dev)
    floor = {"launch floor": lambda: one.add_(1.0)}
    # dg_derivative3 on both instances, beside torch.matmul(K, u) (its
    # library call): at the channel's shape (a bank state's primitives, 576
    # elements of 4^3 x 4) and at HIT's n = 6 (1,024 elements)
    rho_c, vel_c, _, temp_c = equations.conservative_to_primitive(
        chan_bank)
    q_chan = torch.cat([vel_c, temp_c[..., None]], dim=-1).reshape(
        (-1, n, n, n, 4)).contiguous()
    q_six = torch.randn((1024, 6, 6, 6, 4), generator=gen).to(dev)
    dg_extra = {}
    for label, q in (("channel", q_chan), ("n=6", q_six)):
        nq = q.shape[1]
        d = torch.as_tensor(gll.lagrange_derivative_matrix(nq - 1),
                            dtype=torch.float32, device=dev)
        eye = torch.eye(nq, device=dev)
        kron = torch.kron
        k_mat = torch.cat([kron(kron(d, eye), eye), kron(kron(eye, d), eye),
                           kron(kron(eye, eye), d)])  # (3 n^3, n^3)
        q_lines = q.view(q.shape[0], nq**3, 4)
        print(f"time per call ({card}), dg_derivative3 {tuple(q.shape)} "
              f"float32 (the rule picks "
              f"{dg_derivative.pick_instance(nq, 4, q.dtype)}):")
        ms, call_ms = time_calls({
            "plain": functools.partial(dg_derivative.dg_derivative3_plain,
                                       q, d),
            "kernel": functools.partial(dg_derivative.dg_derivative3, q, d,
                                        instance="tiled"),
            "kernel generic": functools.partial(dg_derivative.dg_derivative3,
                                                q, d, instance="generic"),
            "library": functools.partial(torch.matmul, k_mat, q_lines),
            **(floor if label == "channel" else {})})
        lib_out = torch.matmul(k_mat, q_lines).view(q.shape[0], 3, nq, nq,
                                                    nq, 4)
        parity("library call torch.matmul(K, u) vs plain",
               lib_out.transpose(0, 1).contiguous(),
               torch.stack(dg_derivative.dg_derivative3_plain(q, d)),
               TOL["float32"])
        bound = bound_ms(f"dg_derivative3 {label}",
                         4 * nbytes(q) + nbytes(d),
                         dg_derivative3_operations(q))
        tiled, generic = ms["kernel"], ms["kernel generic"]
        print(f"  dg_derivative3 {label} ({card}): tiled instance "
              f"{tiled:.7f} ms, generic {generic:.7f} ms ({generic / tiled:.3f}"
              f"x); {100 * bound[0] / tiled:.3f}% of the bound's speed "
              f"({bound[0]:.7f} ms by {bound[1]}), generic "
              f"{100 * bound[0] / generic:.3f}%; torch.matmul(K, u) "
              f"{ms['library']:.7f} ms ({ms['library'] / tiled:.3f}x)"
              + (f"; the launch floor {ms['launch floor']:.7f} ms, tiled "
                 f"{tiled - ms['launch floor']:.7f} ms above it"
                 if "launch floor" in ms else ""))
        if label == "channel":
            record["dg_derivative3"] = dict(
                ms=ms, call_ms=call_ms, library_ms=ms["library"],
                bound=bound)
        else:
            dg_extra["n6_b1024"] = {
                "ms": tiled, "call_ms": call_ms["kernel"],
                "generic_ms": generic,
                "generic_call_ms": call_ms["kernel generic"],
                "plain_ms": ms["plain"], "library_ms": ms["library"],
                "bound_ms": bound[0], "bound_by": bound[1]}
    record["dg_derivative3"]["extra"] = dg_extra
    # a bf16 call with the bf16 D of a bf16 rollout launches the tiled
    # kernel alone: no cast of D
    q16, d16 = q_chan.to(torch.bfloat16), chan_ops["D"].to(torch.bfloat16)
    names = [r[2] for r in trace_kernels(
        lambda: dg_derivative.dg_derivative3(q16, d16))]
    print(f"dg_derivative3 bf16 call with a bf16 D, device kernels in its "
          f"trace: {names}")
    if not names or any("dg_derivative3_tiled_kernel" not in n_
                        for n_ in names):
        raise AssertionError(f"the bf16 dg_derivative3 call launched "
                             f"{names}, not the tiled kernel alone")

    # smagorinsky_nut as kernel_grad_nut calls it, on the velocity rows of a
    # (..., 4, 3) gradient, at the path's P = 36,864 and at 6 x that; beside
    # the kernel on a contiguous (P, 3, 3) and PR 16's call (a copy of the
    # rows, then the kernel)
    delta = chan.delta_filter
    smag = smagorinsky.smagorinsky_nut
    for reps in (1, 6):
        grad_prim = torch.randn((16 * reps,) + chan_bank.shape[1:-1] + (4, 3),
                                generator=gen).to(dev)
        cs_nodes = torch.full(grad_prim.shape[:-2], chan.cs_sgs, device=dev)
        view = grad_prim[..., 0:3, :].reshape((-1, 3, 3))
        cs = cs_nodes.reshape(-1)
        grad = view.contiguous()
        p_pts = view.shape[0]
        print(f"time per call ({card}), smagorinsky_nut P={p_pts} float32, "
              f"grad_v strides {view.stride()}:")
        ms, call_ms = time_calls({
            "plain": functools.partial(smagorinsky.smagorinsky_nut_plain,
                                       view, cs, delta),
            "kernel": functools.partial(smag, view, cs, delta),
            "kernel contiguous": functools.partial(smag, grad, cs, delta),
            "copy + kernel": lambda: smag(view.contiguous(), cs, delta),
            **(floor if reps == 1 else {})})
        print("  library call: none, no single PyTorch call computes nu_t")
        nu_t = smag(view, cs, delta)
        bound = bound_ms(f"smagorinsky_nut P={p_pts}", nbytes(grad, cs, nu_t),
                         smagorinsky_operations(p_pts))
        kern = ms["kernel"]
        print(f"  smagorinsky_nut P={p_pts} ({card}): on the view "
              f"{kern:.7f} ms, on a contiguous copy "
              f"{ms['kernel contiguous']:.7f} ms "
              f"({ms['kernel contiguous'] / kern:.3f}x), copy + kernel "
              f"{ms['copy + kernel']:.7f} ms; {100 * bound[0] / kern:.3f}% "
              f"of the bound's speed ({bound[0]:.7f} ms by {bound[1]})"
              + (f"; the launch floor {ms['launch floor']:.7f} ms, the kernel "
                 f"{kern - ms['launch floor']:.7f} ms above it"
                 if "launch floor" in ms else ""))
        if reps == 1:
            record["smagorinsky_nut"] = dict(
                ms=ms, call_ms=call_ms, library_ms=None, bound=bound,
                extra={})
            # the caller's call launches the kernel alone: no copy
            names = [r[2] for r in trace_kernels(
                lambda: smag(grad_prim[..., 0:3, :].reshape((-1, 3, 3)),
                             cs_nodes.reshape(-1), delta))]
            print(f"smagorinsky_nut as kernel_grad_nut calls it, device "
                  f"kernels in its trace: {names}")
            if not names or any("smagorinsky_kernel" not in n_
                                for n_ in names):
                raise AssertionError(f"the smagorinsky_nut call launched "
                                     f"{names}, not its kernel alone")
        else:
            record["smagorinsky_nut"]["extra"][f"p{p_pts}"] = {
                "ms": kern, "call_ms": call_ms["kernel"],
                "contiguous_ms": ms["kernel contiguous"],
                "copy_and_kernel_ms": ms["copy + kernel"],
                "plain_ms": ms["plain"], "bound_ms": bound[0],
                "bound_by": bound[1]}
    smag_ms = record["smagorinsky_nut"]["ms"]
    record["smagorinsky_nut"]["extra"].update(
        contiguous_ms=smag_ms["kernel contiguous"],
        copy_and_kernel_ms=smag_ms["copy + kernel"])
    for name in ("dg_derivative3", "smagorinsky_nut"):
        record[name]["extra"]["launch_floor_ms"] = \
            record[name]["ms"]["launch floor"]

    # both walls' matching points in one batch, as `wall_fluxes` hands them
    # (P = 2 x 2,304), and the bottom wall's alone (the former call per wall)
    rho_m, ux_m, uz_m = channel._matching_state(chan_bank, chan, chan_ops)
    u_par = torch.sqrt(ux_m**2 + uz_m**2 + 1e-12)
    u_one, rho_one = u_par[0].contiguous(), rho_m[0].contiguous()
    wkw = dict(y_m=0.5 * chan.dxs[1], nu=chan.nu, kappa=chan.kappa,
               iters=chan.wm_iters)
    print(f"time per call ({card}), wall_model_tau P={u_par.numel()} "
          f"iters={chan.wm_iters} float32 (one wall: P={u_one.numel()}):")
    ms, call_ms = time_calls({
        "plain": lambda: wall_model.wall_model_tau_plain(u_par, rho_m, **wkw),
        "kernel": lambda: wall_model.wall_model_tau(u_par, rho_m, **wkw),
        "kernel one wall": lambda: wall_model.wall_model_tau(u_one, rho_one,
                                                             **wkw)})
    print("  library call: none, no single PyTorch call inverts the wall law")
    bound_one = bound_ms("wall_model_tau one wall", 3 * nbytes(u_one),
                         wall_model_operations(u_one.numel(), chan.wm_iters))
    record["wall_model_tau"] = dict(
        ms=ms, call_ms=call_ms, library_ms=None,
        bound=bound_ms("wall_model_tau", 3 * nbytes(u_par),
                       wall_model_operations(u_par.numel(), chan.wm_iters)),
        extra={"one_wall_call": {"p": u_one.numel(),
                                 "ms": ms["kernel one wall"],
                                 "call_ms": call_ms["kernel one wall"],
                                 "bound_ms": bound_one[0]}})
    elapsed("phase 4: LM kernels")
    # the LM kernels at hymba's prefill of 4 x 2,048 tokens, bf16 as served
    b, hq, hkv, sq = 4, lm_cfg.n_heads, lm_cfg.kv_heads, 2048
    d, win, bf16 = lm_cfg.hd, lm_cfg.window, torch.bfloat16
    q = torch.randn((b, hq, sq, d), generator=gen).to(dev, bf16)
    k = torch.randn((b, hkv, sq, d), generator=gen).to(dev, bf16)
    v = torch.randn((b, hkv, sq, d), generator=gen).to(dev, bf16)
    q32, k32, v32 = q.float(), k.float(), v.float()
    ones = torch.ones((sq, sq), dtype=torch.bool, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # what the bf16 call launches on the card: the tensor-core kernel alone
    names = [r[2] for r in trace_kernels(
        lambda: flash_attention.flash_attention(q, k, v, window=win))]
    print(f"flash_attention bf16 call, device kernels in its trace: {names}")
    if not names or any("flash_attention_tc_kernel" not in n_ for n_ in names):
        raise AssertionError(f"the bf16 flash_attention call launched "
                             f"{names}, not its tensor-core kernel alone")
    for label, window, mask in (("window 1024 (28 layers)", win,
                                 ones.tril() & ~ones.tril(-win)),
                                ("global (4 layers)", None, ones.tril())):
        print(f"time per call ({card}), flash_attention {label} q "
              f"{tuple(q.shape)} kv {tuple(k.shape)} bf16 (float32 for the "
              f"CUDA-core instance):")
        ms, call_ms = time_calls({
            "plain": lambda: flash_attention.mha_chunked(q, k, v,
                                                         window=window),
            "kernel": lambda: flash_attention.flash_attention(q, k, v,
                                                              window=window),
            "kernel float32 (CUDA cores)": lambda:
                flash_attention.flash_attention(q32, k32, v32, window=window),
            "library": lambda: sdpa(q, k, v, attn_mask=mask,
                                    enable_gqa=True)}, plain_windows=10)
        parity("library call scaled_dot_product_attention(band mask, "
               "enable_gqa) vs plain", sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=True),
               flash_attention.mha_chunked(q, k, v, window=window),
               TOL["bfloat16"])
        bound = bound_ms(f"flash_attention {label}", 2 * nbytes(q, k),
                         flash_operations(b * hq, sq, sq, d, True, window),
                         ("bf16 tensor-core", PEAK_BF16_TC_PER_S))
        tc, lib = ms["kernel"], ms["library"]
        print(f"  flash_attention {label} ({card}): tensor-core instance "
              f"{tc:.7f} ms, {'below' if tc < lib else 'NOT below'} "
              f"scaled_dot_product_attention's {lib:.7f} ms ({lib / tc:.3f}"
              f"x); {100 * bound[0] / tc:.3f}% of the bound's speed "
              f"({bound[0]:.7f} ms by {bound[1]}); CUDA-core float32 "
              f"instance {ms['kernel float32 (CUDA cores)']:.7f} ms")
        if window:
            record["flash_attention"] = dict(
                ms=ms, call_ms=call_ms, library_ms=lib, bound=bound)
    del q32, k32, v32

    n, rows = lm_cfg.ssm_state, b * hq
    qs = torch.randn((rows, sq, n), generator=gen).to(dev, bf16)
    ks = (0.25 * torch.randn((rows, sq, n), generator=gen)).to(dev)
    vs = torch.randn((rows, sq, d), generator=gen).to(dev, bf16)
    ws = torch.exp(-0.1 * torch.rand((rows, sq, n), generator=gen)).to(dev)
    s0 = torch.zeros((rows, n, d), device=dev)
    # the prefill on both instances side by side (the path's: chunked),
    # a decode step on the step instance (the path's)
    for label, t_len, kinds in (("prefill", sq, ("chunked", "step")),
                                ("one decode step", 1, ("step",))):
        qt, kt, vt, wt = (x[:, :t_len].contiguous() for x in (qs, ks, vs, ws))
        st = s0 if t_len == 1 else None
        print(f"time per call ({card}), linear_scan {label} q/k/w "
              f"{tuple(qt.shape)} v {tuple(vt.shape)} (q, v bf16; k, w "
              f"f32{'; s0 f32' if st is not None else ''}), instances "
              f"{kinds} (the rule picks "
              f"{linear_scan.pick_instance(t_len, n)}):")
        calls = {"plain": lambda: linear_scan.linear_scan_chunked(
            qt, kt, vt, wt, None, st, decay_before_read=True,
            chunk=lm_cfg.scan_chunk)}
        for kind in kinds:
            calls[f"kernel {kind}"] = functools.partial(
                linear_scan.linear_scan, qt, kt, vt, wt, None, st,
                decay_before_read=True, instance=kind)
        ms, call_ms = time_calls(calls, plain_windows=10)
        out_bytes = vt.numel() * 2 + s0.numel() * 4  # o bf16, S_final f32
        bound = bound_ms(f"linear_scan {label}",
                         nbytes(qt, kt, vt, wt) + out_bytes
                         + (nbytes(st) if st is not None else 0),
                         scan_operations(rows, t_len, n, d, True))
        kind = kinds[0]
        ms["kernel"], call_ms["kernel"] = (ms[f"kernel {kind}"],
                                           call_ms[f"kernel {kind}"])
        print(f"  linear_scan {label} ({card}): {kind} instance "
              f"{ms['kernel']:.7f} ms, {100 * bound[0] / ms['kernel']:.3f}% "
              f"of the bound's speed ({bound[0]:.7f} ms by {bound[1]})"
              + (f"; step instance {ms['kernel step']:.7f} ms "
                 f"({ms['kernel step'] / ms['kernel']:.3f}x)"
                 if kind != "step" else ""))
        print("  library call: none, no single PyTorch call computes the "
              "gated linear recurrence")
        record[f"linear_scan {kind}"] = dict(ms=ms, call_ms=call_ms,
                                             library_ms=None, bound=bound)

    elapsed("phase 4: LM kernels at hymba's training shape, with gradients")
    train_fa, train_ls = lm_training_times(lm_cfg, gen, dev, card)
    for name, rec in record.items():
        b, by = rec["bound"]
        print(f"{name} ({card}): device time {rec['ms']['kernel']:.7f} ms "
              f"against a bound of {b:.7f} ms by {by}: "
              f"{100 * b / rec['ms']['kernel']:.3f}% of the bound's speed")

    # --- 5. the three paths, each with every count set to 0 just before it --
    elapsed("phase 5: hit_les_24dof")
    counters = [rhs.fused_navier_stokes_rhs, dg_derivative.dg_derivative3,
                smagorinsky.smagorinsky_nut, wall_model.wall_model_tau,
                flash_attention.flash_attention, linear_scan.linear_scan]
    names = [fn.__name__ for fn in counters]
    launches = {}
    n_iter = 2
    cfg = env.cfg
    expected = (n_iter + 1) * cfg.n_actions * cfg.n_substeps * 5
    if expected != 9750:  # 3 episodes x 50 steps x 13 substeps x 5 stages
        raise AssertionError(f"HIT episode arithmetic gives {expected}")
    hit_history, counts, wall, step = train("hit_les_24dof", n_iter,
                                            counters)
    print(f"main path hit_les_24dof: {wall:.2f} s wall, launches "
          f"{dict(zip(names, counts))} (fused RHS expected {expected}), "
          f"checkpoint step {step}")
    if counts != [expected, 0, 0, 0, 0, 0]:
        raise AssertionError(f"HIT path launches {counts}, expected "
                             f"[{expected}, 0, 0, 0, 0, 0]")
    hit_instances = dict(rhs.fused_navier_stokes_rhs.instance_launches)
    print(f"main path hit_les_24dof: fused RHS launches by instance "
          f"{hit_instances}")
    if hit_instances != {"cluster": expected, "two_pass": 0}:
        raise AssertionError(f"HIT path RHS instances {hit_instances}, "
                             f"expected all {expected} on the cluster "
                             f"kernel")
    # each kernel's launches by path: the record's `launches` is their sum
    by_path = {"fused_navier_stokes_rhs": {"hit_les_24dof": counts[0]}}

    elapsed("phase 5: the paper's constant-C_s baselines")
    by_path["fused_navier_stokes_rhs"]["baselines"] = baselines(
        counters, hit_history[-1]["eval_return_norm"], card)

    elapsed("phase 5: channel_wm")
    # one iteration, no evaluation episode (the fleet phase below runs the
    # channel again, and the run must stay well inside its time limit)
    chan_iter = 1
    rhs_calls = chan_iter * chan.n_actions * chan.n_substeps * 5
    if rhs_calls != 20 * 26 * 5:
        raise AssertionError(f"channel episode arithmetic gives {rhs_calls}")
    chan_expected = [0, rhs_calls, rhs_calls, rhs_calls, 0, 0]
    _, counts, wall, step = train("channel_wm", chan_iter, counters,
                                  evaluate=False)
    print(f"main path channel_wm: {wall:.2f} s wall, launches "
          f"{dict(zip(names, counts))} (expected "
          f"{dict(zip(names, chan_expected))}), checkpoint step {step}")
    if counts != chan_expected:
        raise AssertionError(f"channel path launches {counts}, expected "
                             f"{chan_expected}")
    for name, n_ in zip(names[1:4], counts[1:4]):
        by_path[name] = {"channel_wm": n_}
    dg_split = dict(dg_derivative.dg_derivative3.instance_launches)
    print(f"main path channel_wm: dg_derivative3 launches by instance "
          f"{dg_split}")
    if dg_split != {"tiled": rhs_calls, "generic": 0}:
        raise AssertionError(f"channel path dg_derivative3 instances "
                             f"{dg_split}, expected all {rhs_calls} on the "
                             f"tiled kernel")

    elapsed("phase 5: fleet hit_les_24dof + channel_wm + burgers_96dof")
    # the heterogeneous fleet through `fleet.make_fleet_runner` (device
    # None: the GPU): 32 envs apportioned by static step cost with at
    # least 8 each, one shared multitask policy; one pipelined iteration
    # (the prologue rollout, then update 0 and rollout 1), then one
    # synchronous iteration of a second runner for the timings and every
    # scenario's evaluation episode
    per_rollout = {"hit": cfg.n_actions * cfg.n_substeps * 5,
                   "chan": chan.n_actions * chan.n_substeps * 5}
    if per_rollout != {"hit": 3250, "chan": 2600}:
        raise AssertionError(f"fleet episode arithmetic gives {per_rollout}")
    fleet_ckpt = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        fleet_launches, prunner, one_rank = fleet_phase(
            counters, per_rollout, card, fleet_ckpt)
        for name, n_ in zip(names[:4], fleet_launches[:4]):
            by_path[name]["fleet"] = n_
        elapsed("phase 5: serving the fleet's controllers")
        serve_phase(prunner, counters, card)
        del prunner
    finally:
        shutil.rmtree(fleet_ckpt, ignore_errors=True)

    elapsed("phase 5: the fleet across ranks")
    ranked = distributed_phase(counters, per_rollout, card, one_rank,
                               hit_history)
    for label, key in (("rl_train over 2 ranks", "rl_train"),
                       ("fleet over 3 ranks", "fleet"),
                       ("hit_les_24dof split over 2 ranks", "split"),
                       ("channel_wm and burgers_96dof split over 3 ranks",
                        "split3")):
        summed = [sum(r["launches"][i] for r in ranked[key]["ranks"])
                  for i in range(4)]
        for name, n_ in zip(names[:4], summed):
            if n_:
                by_path[name][label] = n_

    elapsed("phase 5: hymba-1.5b serving")
    # hymba-1.5b serving: bf16 weights from a seed (cast once, as served),
    # two request batches through lm.greedy_generate, 32 new tokens each
    serve_cfg = dataclasses.replace(lm_cfg, param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = api.init(serve_cfg, seed=0)
    torch.cuda.synchronize()
    print(f"hymba-1.5b: {sum(p.numel() for p in params.parameters())} "
          f"parameters, bf16, built on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    n_new = 32
    per_batch = [0, 0, 0, 0, lm_cfg.n_layers, lm_cfg.n_layers * n_new]
    if per_batch[4:] != [32, 1024]:  # 32 layers x (1 prefill + 31 decodes)
        raise AssertionError(f"hymba serving arithmetic gives {per_batch}")
    lm_launches = [0] * len(counters)
    by_instance = flash_attention.flash_attention.instance_launches
    flash_instances = dict.fromkeys(by_instance, 0)
    scan_by_instance = linear_scan.linear_scan.instance_launches
    scan_instances = dict.fromkeys(scan_by_instance, 0)
    scan_per_batch = {"step": lm_cfg.n_layers * (n_new - 1),
                      "chunked": lm_cfg.n_layers}
    for seed, n_prompts, s_len in ((3, 4, 2048), (4, 4, 700)):
        prompt = lm_batch(seed, n_prompts, s_len, lm_cfg.vocab)["tokens"].to(
            dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        for key in by_instance:
            by_instance[key] = 0
        for key in scan_by_instance:
            scan_by_instance[key] = 0
        t0 = time.perf_counter()
        out = lm.greedy_generate(params, serve_cfg, prompt, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in counters]
        instances = dict(by_instance)
        scan_split = dict(scan_by_instance)
        peak = torch.cuda.max_memory_allocated()
        label = f"hymba-1.5b greedy_generate {n_prompts} x {s_len} tokens"
        print(f"main path {label} + {n_new} new: {wall:.3f} s wall, "
              f"{n_prompts * n_new / wall:.2f} generated tokens/s, peak "
              f"memory {peak / 2**30:.3f} GiB, launches "
              f"{dict(zip(names, counts))} (expected "
              f"{dict(zip(names, per_batch))})")
        if counts != per_batch:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{per_batch}")
        print(f"  flash_attention launches by instance: {instances}")
        if instances != {"cuda_core": 0, "tensor_core": lm_cfg.n_layers}:
            raise AssertionError(f"{label}: flash instances {instances}, "
                                 f"expected all {lm_cfg.n_layers} on the "
                                 f"tensor cores")
        for key, n_ in instances.items():
            flash_instances[key] += n_
        print(f"  linear_scan launches by instance: {scan_split}")
        if scan_split != scan_per_batch:
            raise AssertionError(f"{label}: scan instances {scan_split}, "
                                 f"expected {scan_per_batch} (prefill on "
                                 f"the chunked instance, decode on the "
                                 f"step one)")
        for key, n_ in scan_split.items():
            scan_instances[key] += n_
        if out.shape != (n_prompts, n_new) or out.dtype != torch.int64 \
                or not bool(((out >= 0) & (out < lm_cfg.vocab)).all()):
            raise AssertionError(f"{label}: tokens {out.dtype} "
                                 f"{tuple(out.shape)} out of range")
        lm_launches = [a + c for a, c in zip(lm_launches, counts)]
        # the same requests through api.prefill / api.decode_step, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = api.prefill(params, serve_cfg, {"tokens": prompt},
                                     cache_len=s_len + n_new)
        toks = [torch.argmax(logits, dim=-1)]
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        finite = [torch.isfinite(logits).all()]
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            logits, caches = api.decode_step(params, serve_cfg, toks[-1],
                                             caches)
            toks.append(torch.argmax(logits, dim=-1))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{label}: non-finite logits")
        same = int((torch.stack(toks, 1) == out).sum())
        print(f"  {label} by phase ({card}): prefill {t_prefill * 1e3:.3f} "
              f"ms, decode {t_decode * 1e3 / (n_new - 1):.3f} ms per token "
              f"step of {n_prompts} sequences; tokens equal to "
              f"greedy_generate's: {same} of {out.numel()}")
    print(f"main path hymba-1.5b serving, both batches: launches "
          f"{dict(zip(names, lm_launches))}")
    if lm_launches != [2 * c for c in per_batch]:
        raise AssertionError(f"serving launches {lm_launches}, expected "
                             f"{[2 * c for c in per_batch]}")
    print(f"main path hymba-1.5b serving, both batches: flash_attention "
          f"launches by instance {flash_instances}, linear_scan launches "
          f"by instance {scan_instances}")
    by_path["flash_attention"] = {"hymba-1.5b": lm_launches[4]}
    for kind, n_ in scan_instances.items():
        by_path[f"linear_scan {kind}"] = {"hymba-1.5b": n_}

    elapsed("phase 5: hymba-1.5b training")
    del params, caches, logits  # the served model's: training needs the room
    trained = lm_train_phase(counters, card)
    by_path["flash_attention"]["hymba-1.5b training"] = \
        trained["launches"][4]
    by_path["linear_scan chunked"]["hymba-1.5b training"] = \
        trained["launches"][5]
    by_path["linear_scan step"]["hymba-1.5b training"] = 0
    launches = {name: sum(p.values()) for name, p in by_path.items()}

    # --- 5b. where the paths' time goes (after the counts were read) ---------
    elapsed("phase 5b: profile windows")
    runner = Runner(env, FleetConfig(n_envs=16, bank_size=17), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    traj = runner.orch.sample_fleet(runner.policy, gen)
    state, _ = env.reset_from_bank(runner.orch.bank, torch.arange(16,
                                                                  device=dev))
    action = traj.actions[0]
    profile_window("one hit_les_24dof RL step of 16 envs (env.step)",
                   lambda: env.step(state, action), card)
    adv, ret = ppo.gae(traj, runner.ppo_cfg.gamma, runner.ppo_cfg.lam)
    profile_window("one PPO epoch on 16 x 50 samples (update_epoch)",
                   lambda: ppo.update_epoch(runner.policy, runner.opt,
                                            runner.ppo_cfg, traj, adv, ret),
                   card)
    # the channel's RL step is timed in the fleet phase (its 8-env
    # sub-fleet) and one of its RK substeps profiled there: a trace of a
    # whole step's ~88,000 launches takes tens of seconds
    prompt = lm_batch(3, 4, 2048, lm_cfg.vocab)["tokens"].to(dev)
    params = api.init(serve_cfg, seed=0)
    profile_window("one hymba-1.5b prefill of 4 x 2048 tokens (api.prefill)",
                   lambda: api.prefill(params, serve_cfg, {"tokens": prompt},
                                       cache_len=2048 + n_new), card)
    logits, caches = api.prefill(params, serve_cfg, {"tokens": prompt},
                                 cache_len=2048 + n_new)
    tok = torch.argmax(logits, dim=-1)
    profile_window("one hymba-1.5b decode step of 4 sequences "
                   "(api.decode_step)",
                   lambda: api.decode_step(params, serve_cfg, tok, caches),
                   card)

    # --- 6. records ----------------------------------------------------------
    elapsed("phase 6: records")
    sources = {"fused_navier_stokes_rhs": ("ns_rhs_cluster.cu", "rhs.py:52"),
               "dg_derivative3": ("dg_derivative_tiled.cu",
                                  "dg_derivative.py:60"),
               "smagorinsky_nut": ("smagorinsky.cu", "smagorinsky.py:46"),
               "wall_model_tau": ("wall_model.cu", "wall_model.py:46"),
               "flash_attention": ("flash_attention_tc.cu",
                                   "flash_attention.py:99"),
               "linear_scan chunked": ("linear_scan_chunked.cu",
                                       "linear_scan.py:105"),
               "linear_scan step": ("linear_scan.cu", "linear_scan.py:105")}
    # dg_derivative3: the main path's tiled instance; the generic instance
    # (n > 8) beside it, timed at the same shapes
    errs["dg_derivative3"] = errs["dg_derivative3 tiled"]
    rec = record["dg_derivative3"]
    rec["extra"]["generic_instance"] = {
        "source": "src/repro_torch/kernels/csrc/dg_derivative.cu",
        "launches": dg_split["generic"],
        "max_abs_err": errs["dg_derivative3 generic"],
        "ms": rec["ms"]["kernel generic"],
        "call_ms": rec["call_ms"]["kernel generic"]}
    # flash attention: the main path's bf16 tensor-core instance; the
    # float32 CUDA-core instance beside it
    errs["flash_attention"] = errs["flash_attention bfloat16"]
    # the fused RHS: the main path's cluster instance; the two-pass instance
    # (meshes beyond a cluster of 16 CTAs) beside it
    errs["fused_navier_stokes_rhs"] = errs["fused_navier_stokes_rhs cluster"]
    rec = record["fused_navier_stokes_rhs"]
    rec["extra"] = {"two_pass_instance": {
        "source": "src/repro_torch/kernels/csrc/ns_rhs.cu",
        "max_abs_err": errs["fused_navier_stokes_rhs two_pass"],
        "ms": rec["ms"]["kernel two_pass"],
        "call_ms": rec["call_ms"]["kernel two_pass"]}}
    # the scan: prefill on the chunked instance, decode on the step one, each
    # timed at its path's shape; the step instance at the prefill beside
    rec = record["linear_scan chunked"]
    rec["extra"] = {"step_instance_at_prefill": {
        "ms": rec["ms"]["kernel step"],
        "call_ms": rec["call_ms"]["kernel step"]}}
    record["flash_attention"]["extra"] = {"float32_instance": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "max_abs_err": errs["flash_attention float32"],
        "ms": record["flash_attention"]["ms"]["kernel float32 (CUDA cores)"]},
        "training": {**train_fa, **training_errs(errs, "flash_attention")}}
    rec["extra"]["training"] = {**train_ls,
                                **training_errs(errs, "linear_scan")}
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources[name][0]}",
        "replaces": f"src/repro/kernels/{sources[name][1]}",
        "launches": launches[name],
        "launches_by_path": by_path[name],
        "max_abs_err": errs[name],
        "ms": rec["ms"]["kernel"],
        "plain_ms": rec["ms"]["plain"],
        "call_ms": rec["call_ms"]["kernel"],
        "plain_call_ms": rec["call_ms"]["plain"],
        "bound_ms": rec["bound"][0],
        "bound_by": rec["bound"][1],
        "library_ms": rec["library_ms"],
        **rec.get("extra", {}),
    } for name, rec in record.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(*sys.argv[2:]))
    sys.exit(main())
