#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, and any failure exits non-zero:
  1. prints the card's name and power limit, the torch and CUDA versions, and
     the TF32 flags (both set False for the whole run, so that float32
     convolutions and matmuls are full float32);
  2. builds every CUDA kernel of the main path from the sources in the
     checkout and prints the build time and nvcc's register report;
  3. holds each kernel to its plain PyTorch version on the card, on
     synthetic and real initial states, in float32 and bfloat16;
  4. times one RHS call at the main path's shape (24-DOF, 16 envs): its
     device time (torch.profiler over back-to-back calls, in turns plain,
     kernel, kernel, plain), which the kernels' record reports as `ms`, and
     one call alone with the wrapper's host work (CUDA events), `call_ms`;
     and the bound, from the bytes and operations the call needs;
  5. drives the main path: `repro_torch.launch.rl_train` trains 2 PPO
     iterations of `hit_les_24dof` with 16 envs and evaluates once, and the
     kernel's launch count over that run must be exactly what the episode
     arithmetic says (3 episodes x 50 steps x 13 substeps x 5 stages);
     then profiles one RL step and one PPO epoch (torch.profiler) to show
     where the main path's time goes;
  6. prints one JSON line per the kernels' record, then the last line
     `{"ok": true, "device": {...}}`.

It needs a CUDA device and the repository's `src/` beside it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# max |kernel - plain| / max |plain| allowed, by I/O dtype.
#   float32: both compute the same formulas in float32, in another summation
#     order (line contractions, quadrature partial sums); 1e-4 leaves two
#     orders of magnitude above the ~1e-6 that reordering gives.
#   bfloat16: both compute in float32 from the same bf16 inputs, but a
#     float32 difference of one ulp can flip the final rounding to bf16
#     (relative step 2^-8 = 3.9e-3 of the value); 4e-2 is the JAX package's
#     own bf16 gate (tests/test_kernel_parity.py).
TOL = {"float32": 1e-4, "bfloat16": 4e-2}


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


def rhs_bound_ms(u, cs, d_matrix, w) -> tuple[float, str]:
    """Least time for one call: each input read once, the output written once,
    against the operations at the float32 peak; the larger term bounds."""
    nbytes = (2 * u.numel() * u.element_size()
              + sum(t.numel() * t.element_size() for t in (cs, d_matrix, w)))
    kx, ky, kz, n = u.shape[-7], u.shape[-6], u.shape[-5], u.shape[-2]
    ops = ns_rhs_operations(u.numel() // (kx * ky * kz * n**3 * 5),
                            kx, ky, kz, n)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    print(f"bound: {nbytes} bytes -> {t_bytes * 1e3:.6f} ms; {ops} fp32 ops "
          f"-> {t_ops * 1e3:.6f} ms")
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def synthetic_state(gen, shape_prefix, cfg, device):
    """Physically plausible conservative state (as the JAX parity tests make
    them): rho ~ 1, subsonic velocity, pressure well clear of vacuum."""
    import torch

    n, k = cfg.n_poly + 1, cfg.n_elem
    mesh = tuple(shape_prefix) + (k, k, k, n, n, n)
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


def profile_window(label: str, fn, card: str) -> None:
    """Device busy time and the top kernels of one call of `fn`; "not
    measured" where the trace shows no device time."""
    wall_ms, rows = traced(fn)
    if not rows:
        print(f"profile {label}: wall {wall_ms:.3f} ms; device time not "
              f"measured (the trace shows none)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile {label} ({card}): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(r[1] for r in rows)} kernel launches")
    for dev_us, count, key in rows[:6]:
        print(f"  {dev_us / 1e3:9.3f} ms {count:6d} x {key[:90]}")


def device_ms(fn, calls: int) -> float:
    """Device time of one call of `fn`: the device time of every kernel in
    a profiler trace of `calls` back-to-back calls, summed, over `calls`.
    Where the trace shows no device time, CUDA events around the same loop
    (which then also count any gaps the host leaves)."""
    import torch

    _, rows = traced(lambda: [fn() for _ in range(calls)])
    if rows:
        return sum(r[0] for r in rows) / 1e3 / calls
    print("device time: the trace shows none; CUDA events around the loop")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's `-Xptxas -v` output: the
    kernel's (mangled) name, then its spills and its registers."""
    lines, name = [], None
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("spill" in line or "registers" in line):
            info = line.replace("ptxas info    : ", "")
            lines.append(f"{name}: {info}")
    return lines


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
    from repro_torch import envs
    from repro_torch.cfd import initial
    from repro_torch.cfd.solver import HITConfig
    from repro_torch.configs import relexi_hit
    from repro_torch.core import checkpoints, ppo
    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner
    from repro_torch.kernels import _build, rhs
    from repro_torch.launch import rl_train

    dev = torch.device("cuda", 0)
    # --- 1. the card and the numerics flags ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"TF32 off for the whole run: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load(rhs._SOURCE)
    print(f"built {rhs._SOURCE} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_logs.get(rhs._SOURCE, "")):
        print("  ptxas:", line)

    # --- 3. kernel vs plain on the card --------------------------------------
    gen = torch.Generator().manual_seed(0)
    cases = [("24-DOF", (16,), relexi_hit.HIT24),
             ("32-DOF", (4,), relexi_hit.HIT32),
             ("n_poly=2 K=3", (3,), HITConfig(n_poly=2, n_elem=3))]
    states = [(name, synthetic_state(gen, prefix, cfg, dev), cfg)
              for name, prefix, cfg in cases]
    bank_gen = torch.Generator(device=dev).manual_seed(1)
    states.append(("24-DOF bank", initial.make_state_bank(
        bank_gen, relexi_hit.HIT24, 4), relexi_hit.HIT24))
    main_err = None
    for name, u, cfg in states:
        ops, kw = rhs_kwargs(cfg, dev)
        n = cfg.n_poly + 1
        cs_elem = 0.5 * torch.rand(u.shape[:-4], generator=gen)
        cs = cs_elem[..., None, None, None].expand(u.shape[:-1]).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            ud, csd = u.to(dtype).contiguous(), cs.to(dtype).contiguous()
            d_mat, w = ops["D"].to(dtype), ops["w"].to(dtype)
            got = rhs.fused_navier_stokes_rhs(ud, csd, d_mat, w, **kw)
            torch.cuda.synchronize()
            want = rhs.navier_stokes_rhs_plain(ud, csd, d_mat, w, **kw)
            if got.dtype != dtype or got.shape != u.shape:
                raise AssertionError(f"kernel output {got.dtype} "
                                     f"{tuple(got.shape)}, want {dtype} "
                                     f"{tuple(u.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tname = str(dtype).split(".")[-1]
            ok = math.isfinite(err) and err <= TOL[tname] * scale
            print(f"parity {name:14s} n={n} B={u.shape[0]:2d} {tname:8s} "
                  f"max|d|={err:.3e} max|plain|={scale:.3e} "
                  f"rel={err / scale:.3e} (tol {TOL[tname]:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused RHS kernel disagrees ({name}, "
                                     f"{tname})")
            if name == "24-DOF" and dtype == torch.float32:
                main_err = err

    # one RL interval of a 24-DOF env: the kernel path vs the staged plain
    # assembly, both on the card
    env = envs.make("hit_les_24dof")
    state, _ = env.reset_from_bank(states[-1][1], torch.tensor([0], device=dev))
    action = torch.full((1, env.action_spec.n_elements), 0.17, device=dev)
    u_ker = env.step(state, action).state.u
    u_ref = envs.make("hit_les_24dof", use_kernels=False).step(
        state, action).state.u
    err = (u_ker - u_ref).abs().max().item()
    scale = u_ref.abs().max().item()
    print(f"parity one 24-DOF RL interval ({env.cfg.n_substeps * 5} RHS "
          f"calls), kernel path vs staged plain path: max|d|={err:.3e} "
          f"rel={err / scale:.3e} (tol {TOL['float32']:g})")
    if not err <= TOL["float32"] * scale:
        raise AssertionError("24-DOF env step on the kernel path disagrees")

    # --- 4. time one RHS call at the main path's shape ------------------------
    _, u24, cfg24 = states[0]
    ops, kw = rhs_kwargs(cfg24, dev)
    cs24 = torch.full(u24.shape[:-1], 0.17, device=dev)
    args = (u24, cs24, ops["D"], ops["w"])
    calls = {"plain": rhs.navier_stokes_rhs_plain,
             "kernel": rhs.fused_navier_stokes_rhs}
    for _ in range(3):  # warm-up
        for f in calls.values():
            f(*args, **kw)
    torch.cuda.synchronize()
    # one call alone, host work included: median of 25 CUDA-event windows
    call_times: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(25):
        for name, f in calls.items():  # in turns: plain, kernel
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f(*args, **kw)
            end.record()
            end.synchronize()
            call_times[name].append(start.elapsed_time(end))
    call_ms = {k: statistics.median(v) for k, v in call_times.items()}
    # device time per call: plain, kernel, kernel, plain; 50 calls a window
    dev_times: dict[str, list[float]] = {k: [] for k in calls}
    for name in ("plain", "kernel", "kernel", "plain"):
        dev_times[name].append(device_ms(
            lambda f=calls[name]: f(*args, **kw), 50))
    ms = {k: statistics.mean(v) for k, v in dev_times.items()}
    bound_ms, bound_by = rhs_bound_ms(*args)
    print(f"time per RHS call, 24-DOF B=16 float32 ({card}): device time "
          f"(profiler, 2 windows of 50 calls each) kernel {ms['kernel']:.6f} "
          f"ms ({', '.join(f'{t:.6f}' for t in dev_times['kernel'])}), "
          f"plain {ms['plain']:.6f} ms "
          f"({', '.join(f'{t:.6f}' for t in dev_times['plain'])}); one call "
          f"alone (median of 25 CUDA-event windows) kernel "
          f"{call_ms['kernel']:.6f} ms, plain {call_ms['plain']:.6f} ms; "
          f"bound {bound_ms:.6f} ms by {bound_by} -> device time at "
          f"{100 * bound_ms / ms['kernel']:.2f}% of the bound's speed")
    print("library call: none, no single PyTorch call computes this RHS")

    # --- 5. the main path ----------------------------------------------------
    cfg = env.cfg
    n_iter = 2
    expected = (n_iter + 1) * cfg.n_actions * cfg.n_substeps * 5
    if expected != 9750:  # 3 episodes x 50 steps x 13 substeps x 5 stages
        raise AssertionError(f"episode arithmetic gives {expected}")
    with tempfile.TemporaryDirectory() as ckpt:
        rhs.fused_navier_stokes_rhs.launches = 0
        t0 = time.perf_counter()
        history = rl_train.main([
            "--env", "hit_les_24dof", "--n-envs", "16", "--iterations",
            str(n_iter), "--eval-every", str(n_iter), "--checkpoint-dir",
            ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rhs.fused_navier_stokes_rhs.launches
        step = checkpoints.latest_step(ckpt)
    for rec in history:
        print(f"iteration {rec['iteration']}: t_sample_s={rec['t_sample_s']:.3f}"
              f" t_update_s={rec['t_update_s']:.3f} return_norm="
              f"{rec['return_norm']:.6f}"
              + (f" eval_return_norm={rec['eval_return_norm']:.6f}"
                 if "eval_return_norm" in rec else ""))
    print(f"main path: {wall:.2f} s wall, fused RHS kernel calls {launches} "
          f"(expected {expected}), checkpoint step {step}")
    if len(history) != n_iter:
        raise AssertionError(f"{len(history)} iterations, wanted {n_iter}")
    for rec in history:
        for key in ("return_norm",) + (("eval_return_norm",)
                                       if "eval_return_norm" in rec else ()):
            if not (math.isfinite(rec[key]) and -1.0 <= rec[key] <= 1.0):
                raise AssertionError(f"{key}={rec[key]} not in [-1, 1]")
    if "eval_return_norm" not in history[-1]:
        raise AssertionError("the evaluation episode did not run")
    if launches != expected:
        raise AssertionError(f"fused RHS kernel ran {launches} times on the "
                             f"main path, expected {expected}")
    if step != n_iter:
        raise AssertionError(f"no checkpoint of step {n_iter} (got {step})")

    # --- 5b. where the main path's time goes (after the count was read) ------
    runner = Runner(env, FleetConfig(n_envs=16, bank_size=17), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    traj = runner.orch.sample_fleet(runner.policy, gen)
    state, _ = env.reset_from_bank(runner.orch.bank, torch.arange(16,
                                                                  device=dev))
    action = traj.actions[0]
    profile_window("one RL step of 16 envs (env.step)",
                   lambda: env.step(state, action), card)
    adv, ret = ppo.gae(traj, runner.ppo_cfg.gamma, runner.ppo_cfg.lam)
    profile_window("one PPO epoch on 16 x 50 samples (update_epoch)",
                   lambda: ppo.update_epoch(runner.policy, runner.opt,
                                            runner.ppo_cfg, traj, adv, ret),
                   card)

    # --- 6. records ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_navier_stokes_rhs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ns_rhs.cu",
        "replaces": "src/repro/kernels/rhs.py:52",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "call_ms": call_ms["kernel"],
        "plain_call_ms": call_ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
