"""Dry run of every (arch x shape x mesh) cell on a fake H100 mesh (port of
`repro.launch.dryrun`): each rank's real program, recorded, never run.

For every cell this script:

    1. lays the cell's arguments out on a fake-backend mesh of 256 ranks
       (data 16, model 16) or 512 (pod 2, data 16, model 16)
       (`launch/mesh.make_production_mesh`) as DTensors of meta shards, by
       the reference's logical-axis rules (`specs.lower_cell`): nothing is
       allocated, and the 35B cells never materialize.  The HIT fleet cell
       takes the reference's pencil mesh instead, (data 16, mx 4, my 4) or
       (pod 2, data 16, mx 4, my 4) (`run_relexi_cell`);
    2. runs the cell's program once on rank 0's shards: the port's own
       `api.train_step` / `api.prefill` / `api.serve_step`, or one MDP
       step of an RL fleet, under a `hlo_analysis.Recorder`, which sees
       every op at the dispatch level on the rank's local shapes;
    3. records per-device memory (and whether it fits an 80 GB H100),
       FLOPs, bytes accessed, collective bytes by kind, the roofline terms
       against the H100 constants (`launch/mesh.py`), `model_flops` and
       `useful_flop_ratio`;
    4. writes one JSON artifact per cell, with the reference's keys and
       file names, under `torch_artifacts/dryrun/` at the repo root
       (`launch.DRYRUN_ARTIFACT_DIR`), where the fleet scheduler reads
       `flops_per_env` back (`fleet/scheduler.dryrun_step_cost`).

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --relexi [--no-elem-shard]
    python -m repro_torch.launch.dryrun --channel
Skipped cells (long_500k on full-attention archs, decode of an
encoder-only model) write SKIP artifacts with the reason.

An eager run counts every layer and every substep, so no figure is
extrapolated: the reference's calibration at 1 and 2 layer groups
(`calibrated_costs`, kept to show that the count is linear in the groups)
is not needed, and a record's `calibration` says `{"K": K, "eager":
true}`.  A reference field that an eager run cannot give is null, with its
reason under `null_reasons`.  The mesh stands for CUDA devices on any
host (DTensor picks its collectives by the mesh's device type; the
functions take `device_type="cpu"` for a CPU mesh's).  The LM cells run
the plain attention and scan forms (`attn_impl` / `scan_impl`
"chunked"), as the reference's own defaults and its host dry run do: a
meta tensor that reaches a kernel raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from .. import configs
from ..configs.shapes import SHAPES
from ..models import lm as lm_mod
from . import DRYRUN_ARTIFACT_DIR, hlo_analysis, specs
from . import mesh as mesh_lib

ARTIFACT_DIR = DRYRUN_ARTIFACT_DIR

_NULL_REASONS = {
    "t_compile_s": "eager: nothing is compiled",
    "memory_analysis.generated_code_size_in_bytes":
        "eager: no generated code",
    "hlo_op_counts.n_fusion": "eager: no fusions",
    "hlo_op_counts.n_while": "eager: no while loops",
}


def _dryrun_cfg(cfg):
    """The plain attention and scan forms, the reference's defaults."""
    return dataclasses.replace(cfg, attn_impl="chunked", scan_impl="chunked")


def _calibration_cfgs(cfg):
    """(cfg_k1, cfg_k2, K): the reference's configs at 1 and 2 layer groups
    (whose XLA cost analysis counts a while body once) and the groups K of
    the full model, for `calibrated_costs`."""
    if cfg.is_encdec:
        # whisper: encoder and decoder stacks both scale with k (4 == 4)
        K = cfg.n_layers
        mk = lambda k: dataclasses.replace(cfg, n_layers=k, encoder_layers=k,  # noqa: E731
                                           scan_layers=False,
                                           unroll_scans=True)
        return mk(1), mk(2), K
    g = lm_mod.group_size(cfg)
    p = lm_mod.n_prefix(cfg)
    K = lm_mod.n_groups(cfg)
    chunk = max(cfg.scan_chunk, 1024) if g >= 4 else cfg.scan_chunk
    mk = lambda k: dataclasses.replace(cfg, n_layers=p + k * g,  # noqa: E731
                                       scan_layers=False, unroll_scans=True,
                                       scan_chunk=chunk)
    return mk(1), mk(2), K


def _costs(rec: hlo_analysis.Recorder) -> dict:
    coll = hlo_analysis.collective_bytes(rec.records, rec.axis_sizes)
    return {"flops": float(rec.flops), "bytes": float(rec.bytes_accessed),
            "coll": float(coll.total_bytes),
            "coll_by_kind": coll.bytes_by_kind}


def calibrated_costs(cfg, shape, mesh, rule_overrides=None,
                     opt_rule_overrides=None) -> dict:
    """The reference's extrapolation from 1 and 2 layer groups,

        total(K groups) = f(1) + (K - 1) * (f(2) - f(1)),

    of the per-device flops / bytes / collective bytes, on the recorded
    runs.  An eager run counts every group, so `run_cell` does not need it;
    it equals the full count where the count is linear in the groups."""
    c1_cfg, c2_cfg, K = _calibration_cfgs(cfg)
    f1 = _costs(specs.lower_cell(c1_cfg, shape, mesh, rule_overrides,
                                 donate=False,
                                 opt_rule_overrides=opt_rule_overrides)[0]())
    f2 = _costs(specs.lower_cell(c2_cfg, shape, mesh, rule_overrides,
                                 donate=False,
                                 opt_rule_overrides=opt_rule_overrides)[0]())
    out = {}
    for key in ("flops", "bytes", "coll"):
        out[key] = f1[key] + (K - 1) * max(0.0, f2[key] - f1[key])
    out["coll_by_kind"] = {
        k: f1["coll_by_kind"][k]
        + (K - 1) * max(0, f2["coll_by_kind"][k] - f1["coll_by_kind"][k])
        for k in f1["coll_by_kind"]}
    out["calibration"] = {"K": K, "k1": f1, "k2": f2}
    return out


def _device_costs(rec: hlo_analysis.Recorder, n_chips: int) -> dict:
    """The record's per-device fields of a recorded run."""
    mem = rec.memory
    coll = hlo_analysis.collective_bytes(rec.records, rec.axis_sizes)
    fused = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
             + 2 * mem["temp_size_in_bytes"])
    cost = hlo_analysis.cost_analysis(rec)
    terms = hlo_analysis.roofline_terms(
        cost["flops"], cost["bytes accessed"], float(coll.total_bytes),
        n_chips, mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW,
        mesh_lib.LINK_BW, fused_bytes_per_dev=fused)
    return {
        "memory_analysis": mem,
        "peak_bytes_per_dev": rec.peak,
        "fits_hbm": rec.peak <= mesh_lib.HBM_BYTES,
        "hbm_bytes": mesh_lib.HBM_BYTES,
        "cost_analysis_raw": cost,
        "flops_per_dev": cost["flops"],
        "hbm_bytes_per_dev": cost["bytes accessed"],
        "collective_bytes_per_dev": coll.bytes_by_kind,
        "collective_counts_raw": coll.count_by_kind,
        "collective_total_per_dev": float(coll.total_bytes),
        "hlo_op_counts": hlo_analysis.op_counts(rec),
        "roofline": terms,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rule_overrides: dict | None = None, *, save: bool = True,
             tag: str = "", calibrate: bool = True,
             cfg_overrides: dict | None = None,
             opt_rule_overrides: dict | None = None,
             device_type: str = "cuda") -> dict:
    """One LM cell on the 256- (or 512-) rank production mesh.  The eager
    count is exact at full depth, so `calibrate` changes nothing (the CLI
    keeps `--no-calibrate` for parity)."""
    del calibrate
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    n_chips = 512 if multi_pod else 256

    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "status": "ok",
              "rules": rule_overrides or {}, "cfg": cfg_overrides or {},
              "device_type": device_type}

    for sh, runnable, reason in configs.cells(cfg):
        if sh.name == shape_name and not runnable:
            record.update(status="skip", reason=reason)
            if save:
                _save(record, tag)
            return record
    if shape.kind == "decode" and cfg.family == "encoder-only":
        record.update(status="skip", reason="encoder-only: no decode step")
        if save:
            _save(record, tag)
        return record

    record["opt_rules"] = opt_rule_overrides or {}
    try:
        with mesh_lib.make_production_mesh(
                multi_pod=multi_pod, device_type=device_type) as mesh:
            t0 = time.perf_counter()
            cell, _ = specs.lower_cell(_dryrun_cfg(cfg), shape, mesh,
                                       rule_overrides,
                                       opt_rule_overrides=opt_rule_overrides)
            t_lower = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec = cell()
            t_run = time.perf_counter() - t0
        mf = hlo_analysis.model_flops(cfg, shape)
        record.update({"t_lower_s": round(t_lower, 2), "t_compile_s": None,
                       "t_run_s": round(t_run, 2)})
        record.update(_device_costs(rec, n_chips))
        flops_dev = record["flops_per_dev"]
        record.update({
            "calibration": {"K": _calibration_cfgs(cfg)[2], "eager": True},
            "model_flops_global": mf,
            "model_flops_per_dev": mf / n_chips,
            "useful_flop_ratio": (mf / n_chips) / flops_dev
            if flops_dev else None,
            "null_reasons": _NULL_REASONS,
        })
    except Exception as e:  # noqa: BLE001 (a failed cell is a record)
        record.update(status="fail", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    if save:
        _save(record, tag)
    return record


def _fleet_cell(record: dict, mesh_shape, axes, device_type: str,
                make_env, u_axes, r_axes, pencil_axes: tuple[str, str] | None,
                n_envs: int, tag: str, save: bool) -> dict:
    """One synchronous MDP step (observe, the policy's mean action, the
    env's step with its reward) of a fleet of `n_envs` envs on a fake
    mesh, run shard-locally under `local_map`: the state's env axis split
    over the axes `u_axes[0]` (which must divide `n_envs`, as the
    reference's sharding must), its x- and y-element axes over the mesh
    dims `pencil_axes` (`core.collectives.pencil_split`) or not split
    (None).  `make_env()` -> (step(policy,
    u, e_dns, split) -> (u_next, reward), the policy, e_dns's shape or
    None, one env's state shape, substeps).  The record carries the
    split's `halo_bytes` / `gather_bytes` and the face rolls per mesh dim
    the Recorder saw (`rolls_by_dim`)."""
    from torch.distributed.tensor.experimental import local_map

    from ..core import collectives
    from ..parallel.sharding import placements

    n_chips = 1
    for n in mesh_shape:
        n_chips *= n
    try:
        with mesh_lib.fake_mesh(mesh_shape, axes, device_type) as mesh:
            t0 = time.perf_counter()
            env_step, policy, e_shape, state_shape, n_sub = make_env()
            rec = hlo_analysis.Recorder(mesh)
            specs.replace_params(
                policy, lambda name, p: rec.shard(p.shape, p.dtype))
            for name, b in list(policy.named_buffers()):
                owner, _, leaf = name.rpartition(".")
                mod = policy.get_submodule(owner) if owner else policy
                mod.register_buffer(leaf, rec.shard(b.shape, b.dtype),
                                    persistent=False)
            e_dns = rec.shard(e_shape, torch.float32) if e_shape else None
            env_ranks = 1
            for a in u_axes[0]:
                env_ranks *= mesh_shape[axes.index(a)]
            if n_envs % env_ranks:
                raise ValueError(f"{n_envs} envs do not split over the "
                                 f"{env_ranks} ranks of {u_axes[0]}")
            like = torch.empty((n_envs,) + tuple(state_shape),
                               device="meta")
            u = rec.distribute(like, u_axes, mesh)
            split = (collectives.pencil_split(mesh, *pencil_axes)
                     if pencil_axes else collectives.ElemSplit())

            def step(u_local):
                return env_step(policy, u_local, e_dns, split)

            fn = local_map(step, out_placements=(
                placements(u_axes, mesh), placements(r_axes, mesh)),
                in_placements=(placements(u_axes, mesh),), device_mesh=mesh)
            t_lower = time.perf_counter() - t0
            t0 = time.perf_counter()
            with torch.no_grad(), rec.run():
                out = fn(u)
            args = [u, list(policy.parameters()), list(policy.buffers()),
                    e_dns]
            rec.memory = hlo_analysis.memory_analysis(rec, args, list(out))
            t_run = time.perf_counter() - t0
        rolls = {}
        for dim, op, _ in rec.records:
            if op == "send":
                rolls[dim] = rolls.get(dim, 0) + 1
        record.update({"t_lower_s": round(t_lower, 2), "t_compile_s": None,
                       "t_run_s": round(t_run, 2), "n_substeps": n_sub,
                       "mesh_shape": list(mesh_shape),
                       "mesh_axes": list(axes),
                       "n_envs": n_envs, "halo_bytes": split.halo_bytes,
                       "gather_bytes": split.gather_bytes,
                       "rolls_by_dim": rolls})
        record.update(_device_costs(rec, n_chips))
        record["flops_per_env"] = record["flops_per_dev"] * n_chips / n_envs
        record["calibration"] = {"K": n_sub, "eager": True}
        record["null_reasons"] = _NULL_REASONS
    except Exception as e:  # noqa: BLE001 (a failed cell is a record)
        record.update(status="fail", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    if save:
        _save(record, tag)
    return record


def hit_mdp_step(policy, u: torch.Tensor, e_dns: torch.Tensor, cfg,
                 split=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One synchronous MDP step of HIT envs, the program of the HIT fleet
    cell: observe, the policy's mean action, `cfd/env.step` with its
    reward.  With `split` (`core.collectives.ElemSplit` or `PencilSplit`)
    u is this rank's block of every env, and the observation, the action
    and the reward are the whole envs'.  Returns (u_next, reward)."""
    from ..cfd import env as env_lib

    obs = env_lib.observe(u, cfg, split)
    action = policy.actor_mean(obs)
    state = env_lib.EnvState(u=u, t_step=torch.zeros(
        (u.shape[0],), dtype=torch.int32, device=u.device))
    res = env_lib.step(state, action, cfg, e_dns, split)
    return res.state.u, res.reward


def run_relexi_cell(dof: int = 24, n_envs: int = 256, multi_pod: bool = False,
                    *, elem_axis: str | None = "model", tag: str = "",
                    save: bool = True, env: str | None = None,
                    data: int | None = None,
                    pencil: tuple[int, int] | None = None,
                    device_type: str = "cuda") -> dict:
    """The paper's own cell: one synchronous MDP step of the HIT LES fleet
    (`hit_mdp_step`: the policy's mean action, the solver's Delta t_RL
    advance on the staged plain assembly (`use_kernels=False`, as the
    reference's host dry run counts it), the reward).  Envs split over
    (pod, data); with `elem_axis`, each env's element grid over the
    reference's (mx, my) pencil, x-slabs over "mx" and y-slabs over "my"
    (`core.collectives.PencilSplit`): mesh (16, 4, 4) ("data", "mx",
    "my"), or (2, 16, 4, 4) with the pod axis, so a 4^3-element env
    splits 16 ways (the paper's 16 ranks per FLEXI); without, envs over
    every axis of the production mesh.  `env` names another registered
    HIT env (default `hit_les_{dof}dof`); `data` the data axis's size
    (default: the 256 ranks over the pencil) and `pencil` the (mx, my)
    sizes (default min(4, K) each) make smaller meshes."""
    from .. import envs
    from ..cfd import spectra
    from ..core import policy as policy_lib

    name = env or f"hit_les_{dof}dof"
    cfg = dataclasses.replace(envs.make(name).cfg, use_kernels=False)
    mesh_name = "multi" if multi_pod else "single"
    pods = (2,) if multi_pod else ()
    record = {"arch": f"relexi-hit{dof}" if env is None else f"relexi-{env}",
              "shape": f"fleet_{n_envs}", "mesh": mesh_name,
              "kind": "rl_step", "status": "ok", "elem_axis": elem_axis,
              "variant": name, "device_type": device_type}
    n, k = cfg.n_poly + 1, cfg.n_elem
    env_axes = ("pod", "data") if multi_pod else ("data",)
    if elem_axis:
        mx, my = pencil or (min(4, k), min(4, k))
        if k % mx or k % my:
            raise ValueError(f"a pencil of {mx} x {my} ranks does not "
                             f"divide {k} elements a direction")
        shape = pods + (data or 256 // (mx * my), mx, my)
        axes = env_axes + ("mx", "my")
        u_axes, r_axes = (env_axes, "mx", "my"), (env_axes,)
        pencil_axes = ("mx", "my")
        record["elem_ranks"] = mx * my
    else:
        shape = pods + ((data, 1) if data else (16, 16))
        axes = env_axes + ("model",)
        u_axes = r_axes = (env_axes + ("model",),)
        pencil_axes = None

    def make_env():
        pcfg = policy_lib.PolicyConfig(n_nodes=n, cs_max=cfg.cs_max)
        policy = policy_lib.Policy(pcfg)

        def mdp(policy, u, e_dns, split):
            return hit_mdp_step(policy, u, e_dns, cfg, split)

        e_len = len(spectra.reference_spectrum(cfg))
        return mdp, policy, (e_len,), (k, k, k, n, n, n, 5), cfg.n_substeps

    record = _fleet_cell(record, shape, axes, device_type, make_env, u_axes,
                         r_axes, pencil_axes, n_envs, tag, False)
    if save:
        record["shape"] += (f"_elem{record['elem_ranks']}" if elem_axis
                            else "_noelem")
        _save(record, tag)
    return record


def run_channel_cell(n_envs: int = 256, multi_pod: bool = False, *,
                     variant: str = "channel_wm", tag: str = "",
                     save: bool = True, data: int | None = None,
                     device_type: str = "cuda") -> dict:
    """The channel-WMLES fleet cell: one synchronous MDP step (the policy's
    mean action, the wall-modeled solver's Delta t_RL advance on the
    staged plain assembly, the profile reward), envs over every mesh axis
    (the channel's small anisotropic grid is not split), with
    `flops_per_env`, which the fleet scheduler reads as its sub-fleet
    weight (`fleet/scheduler.dryrun_step_cost`).  `data` makes the mesh
    (data, 1) instead of the production one."""
    from .. import envs as envs_mod
    from ..core import policy as policy_lib
    from ..envs.base import EnvState

    mesh_name = "multi" if multi_pod else "single"
    record = {"arch": "channel-wm", "shape": f"fleet_{n_envs}",
              "mesh": mesh_name, "kind": "rl_step", "status": "ok",
              "variant": variant, "n_envs": n_envs,
              "device_type": device_type}
    env_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = ((2,) if multi_pod else ()) + ((data, 1) if data else (16, 16))

    def make_env():
        env = envs_mod.make(variant, use_kernels=False)
        cfg = env.cfg
        pcfg = policy_lib.PolicyConfig.from_specs(env.obs_spec,
                                                  env.action_spec)
        policy = policy_lib.Policy(pcfg)

        def mdp(policy, u, e_dns, split):
            state = EnvState(u=u, t_step=torch.zeros(
                (u.shape[0],), dtype=torch.int32, device=u.device))
            action = policy.actor_mean(env.observe(state))
            res = env.step(state, action)
            return res.state.u, res.reward

        kx, ky, kz = cfg.n_elem
        return mdp, policy, None, (kx, ky, kz, cfg.n, cfg.n, cfg.n, 5), \
            cfg.n_substeps

    return _fleet_cell(record, shape, env_axes, device_type, make_env,
                       (env_axes,), (env_axes,), None, n_envs, tag, save)


def _save(record: dict, tag: str = "") -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(
        ARTIFACT_DIR,
        f"{record['mesh']}_{record['arch']}_{record['shape']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def _summary(rec: dict) -> str:
    """GiB per device against the card's, FLOPs, collective bytes by kind
    and the bound of an ok record."""
    r = rec["roofline"]
    coll = " ".join(f"{k}={v:.3g}" for k, v in
                    rec["collective_bytes_per_dev"].items() if v)
    return (f"bound={r['bound']} frac={r['roofline_fraction']:.2f} "
            f"peak={rec['peak_bytes_per_dev'] / 2**30:.3f}GiB/"
            f"{mesh_lib.HBM_BYTES / 1e9:.0f}GB "
            f"flops={rec['flops_per_dev']:.4g} coll=[{coll or 'none'}] "
            f"run={rec['t_run_s']}s")


def _init_worker(artifact_dir: str) -> None:
    global ARTIFACT_DIR
    ARTIFACT_DIR = artifact_dir
    torch.set_num_threads(1)


def _timed_cell(cell: tuple, kw: dict) -> tuple[dict, float]:
    """(`run_cell`'s record of (multi_pod, arch, shape), its seconds)."""
    t0 = time.perf_counter()
    rec = run_cell(cell[1], cell[2], cell[0], **kw)
    return rec, time.perf_counter() - t0


def _report(rec: dict, dt: float, n_ok: int, n_skip: int,
            n_fail: int) -> tuple[int, int, int]:
    """Print a cell's line (the reference's, with `_summary`); the counts
    of ok, skipped and failed cells with this one."""
    status = rec["status"]
    if status == "ok":
        extra = _summary(rec)
    elif status == "skip":
        extra = rec["reason"]
    else:
        extra = rec["error"]
    print(f"[{rec['mesh']}] {rec['arch']:24s} {rec['shape']:12s} "
          f"{status.upper():5s} ({dt:5.1f}s) {extra}", flush=True)
    return (n_ok + (status == "ok"), n_skip + (status == "skip"),
            n_fail + (status == "fail"))


def main(argv: list[str] | None = None) -> None:
    global ARTIFACT_DIR
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--rules", default="",
                    help='JSON rule overrides, e.g. {"act_seq": null}')
    ap.add_argument("--opt-rules", default="",
                    help="JSON rule overrides for the Adam moments only "
                         "(ZeRO-1-style decoupled optimizer sharding)")
    ap.add_argument("--cfg", default="",
                    help='JSON ArchConfig overrides, e.g. '
                         '{"decode_combine": "flash"}')
    ap.add_argument("--no-calibrate", action="store_true",
                    help="kept for parity with the reference: the eager "
                         "count is exact, nothing is calibrated")
    ap.add_argument("--relexi", action="store_true",
                    help="run the paper's HIT fleet cell instead of LM cells")
    ap.add_argument("--channel", action="store_true",
                    help="run the channel-WMLES fleet cell (sizes the "
                         "channel sharding; feeds the fleet scheduler)")
    ap.add_argument("--variant", default="channel_wm",
                    help="registered channel scenario for --channel")
    ap.add_argument("--dof", type=int, default=24, choices=(24, 32))
    ap.add_argument("--n-envs", type=int, default=256)
    ap.add_argument("--no-elem-shard", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="LM cells run at once, each in a process of its "
                         "own")
    ap.add_argument("--artifact-dir", default=None,
                    help=f"where the records go (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)
    if args.artifact_dir:
        ARTIFACT_DIR = args.artifact_dir
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.channel or args.relexi:
        n_fail = 0
        for multi in meshes:
            if args.channel:
                rec = run_channel_cell(args.n_envs, multi,
                                       variant=args.variant, tag=args.tag)
            else:
                rec = run_relexi_cell(
                    args.dof, args.n_envs, multi,
                    elem_axis=None if args.no_elem_shard else "model",
                    tag=args.tag)
            status = rec["status"]
            n_fail += status == "fail"
            extra = (_summary(rec) + (f" flops/env={rec['flops_per_env']:.3g}"
                                      if args.channel else "")
                     if status == "ok" else rec.get("error", ""))
            print(f"[{rec['mesh']}] {rec['arch']:24s} {rec['shape']:12s} "
                  f"{status.upper():5s} {extra}", flush=True)
        if n_fail:
            raise SystemExit(1)
        return

    overrides = json.loads(args.rules) if args.rules else None
    cfg_overrides = json.loads(args.cfg) if args.cfg else None
    opt_overrides = json.loads(args.opt_rules) if args.opt_rules else None
    archs = configs.ARCH_NAMES if args.all or not args.arch else [args.arch]
    shapes = tuple(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(multi, arch, shape) for multi in meshes for arch in archs
             for shape in shapes]
    kw = dict(rule_overrides=overrides, tag=args.tag,
              cfg_overrides=cfg_overrides, calibrate=not args.no_calibrate,
              opt_rule_overrides=opt_overrides)

    n_ok = n_skip = n_fail = 0
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(ARTIFACT_DIR,))
        with pool:
            done = concurrent.futures.as_completed(
                [pool.submit(_timed_cell, cell, kw) for cell in cells])
            results = (f.result() for f in done)
            for rec, dt in results:
                n_ok, n_skip, n_fail = _report(rec, dt, n_ok, n_skip, n_fail)
    else:
        for cell in cells:
            rec, dt = _timed_cell(cell, kw)
            n_ok, n_skip, n_fail = _report(rec, dt, n_ok, n_skip, n_fail)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_fail} fail", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
