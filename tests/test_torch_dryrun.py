"""PyTorch port vs JAX reference: the dry run (`launch/dryrun.py`,
`launch/hlo_analysis.py`, `specs.lower_cell`, `launch/mesh.fake_mesh`).

Each cell runs its real program on meta shards laid out as DTensors on a
fake mesh of "cpu" devices, recorded at the dispatch level.  The
reference's side runs once, in one subprocess started when the module sets
up (`jax.sharding.Mesh` over 4 forced host devices, with Auto axes: the
mesh `jax.make_mesh` gives has Explicit axes under jax 0.9, which the
reference's `constrain` refuses), while this process runs the port's.

Pins:
  * argument bytes per device, to the byte, for h2o-danube-1.8b and
    whisper-tiny reduced, train / prefill / decode at ShapeConfig(64, 4),
    on (1, 1) and (2, 2).  Decode is 4 bytes short per KV cache layer: the
    reference's caches carry each layer's write position as an int32 on
    the device, the port's a Python int (ROADMAP queue C, C10);
  * the full-depth count of danube-reduced equals the reference's
    extrapolation from 1 and 2 layer groups, exactly;
  * the HIT cell's pencil halo, sums and gathers, worked out by hand in
    `test_reduced_fleet_cells_and_the_split_halo_by_hand`, and its
    production cell's mesh, name and u's argument bytes in
    `test_production_hit_cell_is_the_reference_pencil`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import configs
from repro_torch import envs as tenvs
from repro_torch.configs.shapes import SHAPES
from repro_torch.fleet import scheduler
from repro_torch.kernels import flash_attention, linear_scan, rhs
from repro_torch.launch import dryrun, hlo_analysis, specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("h2o-danube-1.8b", "whisper-tiny")
MESHES = ((1, 1), (2, 2))
KINDS = ("train", "prefill", "decode")

# the reference's per-device argument bytes of every (arch, mesh, kind)
REFERENCE = r"""
import json, sys
import numpy as np
import jax
from repro import configs
from repro.configs.shapes import ShapeConfig
from repro.launch import specs
out = {}
for arch in sys.argv[1].split(","):
    cfg = configs.get_reduced(arch)
    for shape in ((1, 1), (2, 2)):
        devices = np.array(jax.devices()[:shape[0] * shape[1]])
        mesh = jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))
        for kind in ("train", "prefill", "decode"):
            lowered, _ = specs.lower_cell(
                cfg, ShapeConfig("t", 64, 4, kind), mesh)
            ma = lowered.compile().memory_analysis()
            out[f"{arch} {shape[0]}x{shape[1]} {kind}"] = \
                ma.argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's argument bytes, from a subprocess started at module
    set-up (read by the test that needs them, last in the file)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE,
                             ",".join(ARCHS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result() -> dict:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _started(reference):
    """Every test starts the reference's subprocess (the first one to run
    does) and leaves no process group behind."""
    yield
    assert not dist.is_initialized()


_CELLS: dict = {}


def cell(arch: str, mesh_shape: tuple, kind: str, fresh: bool = False,
         **cfg_overrides):
    """The port's recorded cell (reduced config, ShapeConfig(64, 4)) on a
    fake "cpu" mesh, run once per argument set (again with `fresh`)."""
    key = (arch, mesh_shape, kind, tuple(sorted(cfg_overrides.items())))
    if key not in _CELLS or fresh:
        cfg = dataclasses.replace(configs.get_reduced(arch),
                                  attn_impl="chunked", scan_impl="chunked",
                                  **cfg_overrides)
        with mesh_lib.fake_mesh(mesh_shape, ("data", "model"), "cpu") as m:
            _CELLS[key] = specs.lower_cell(
                cfg, configs.ShapeConfig("t", 64, 4, kind), m)[0]()
    return _CELLS[key]


def n_positions(arch: str) -> int:
    """The KV caches' write positions (one a layer): an int32 each on the
    reference's device, a Python int in the port."""
    caches = api.abstract_caches(configs.get_reduced(arch), 4, 64)
    return sum(k.endswith(".pos") for k in lm.flat_names(caches))


# --- the reference's formulas and conventions ---------------------------------
def test_roofline_terms_and_model_flops_equal_the_reference():
    from repro import configs as jconfigs
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch import hlo_analysis as jhlo
    for arch in configs.ARCH_NAMES:
        for name, shape in SHAPES.items():
            assert hlo_analysis.model_flops(configs.get(arch), shape) == \
                jhlo.model_flops(jconfigs.get(arch), JSHAPES[name]), \
                (arch, name)
    for args in ((1e12, 4e9, 2e8, 256), (3e9, 5e11, 0.0, 512),
                 (0.0, 0.0, 7e10, 16)):
        kw = dict(peak_flops=mesh_lib.PEAK_FLOPS_BF16,
                  hbm_bw=mesh_lib.HBM_BW, link_bw=mesh_lib.LINK_BW)
        for fused in (None, 2.5e9):
            assert hlo_analysis.roofline_terms(
                *args, **kw, fused_bytes_per_dev=fused) == \
                jhlo.roofline_terms(*args, **kw, fused_bytes_per_dev=fused)


def test_collective_bytes_of_recorded_ops_equal_the_reference_parser():
    """An all-gather, an all-reduce and a collective-permute (a send) of
    f32[16, 128] over a 16-rank dim, recorded on a fake mesh, give the
    bytes and counts the reference's parser gives for the HLO of
    tests/test_sharding.py::test_collective_bytes_parser."""
    from repro.launch import hlo_analysis as jhlo
    hlo = """
  %p = f32[16,128]{1,0} parameter(0)
  %ag = f32[16,2048]{1,0} all-gather(%p), replica_groups={}
  %ar = f32[16,128]{1,0} all-reduce(%p), to_apply=%add
  %cp = f32[16,128]{1,0} collective-permute(%p), source_target_pairs={{0,1}}
"""
    want = jhlo.collective_bytes(hlo)
    with mesh_lib.fake_mesh((1, 16), ("data", "model"), "cpu") as mesh:
        rec = hlo_analysis.Recorder(mesh)
        gathered = rec.distribute(torch.empty(16, 2048, device="meta"),
                                  (None, "model"), mesh)
        summed = DTensor.from_local(rec.shard((16, 128), torch.float32),
                                    mesh, [Replicate(), Partial()])
        sent = rec.shard((16, 128), torch.float32)
        group = mesh.get_group("model")
        with rec.run():
            gathered.redistribute(mesh, [Replicate(), Replicate()])
            summed.redistribute(mesh, [Replicate(), Replicate()])
            dist.isend(sent, dist.get_global_rank(group, 1),
                       group=group).wait()
    assert [r[:2] for r in rec.records] == [
        ("model", "all_gather"), ("model", "all_reduce"), ("model", "send")]
    got = hlo_analysis.collective_bytes(rec.records, rec.axis_sizes)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind


def test_skip_reasons_equal_the_reference():
    from repro import configs as jconfigs
    from repro.configs.shapes import cells as jcells
    for arch in configs.ARCH_NAMES:
        want = [(s.name, ok, why) for s, ok, why in jcells(
            jconfigs.get(arch))]
        assert [(s.name, ok, why) for s, ok, why in configs.cells(
            configs.get(arch))] == want, arch
        for name, ok, why in want:
            if not ok:
                rec = dryrun.run_cell(arch, name, False, save=False)
                assert (rec["status"], rec["reason"]) == ("skip", why)


# --- per-device counts --------------------------------------------------------
def test_a_sharded_matmul_counts_its_share_and_a_replicated_one_whole():
    def flops(mesh_shape, x_spec, w_spec):
        with mesh_lib.fake_mesh(mesh_shape, ("data", "model"), "cpu") as m:
            rec = hlo_analysis.Recorder(m)
            x = rec.distribute(torch.empty(64, 32, device="meta"), x_spec, m)
            w = rec.distribute(torch.empty(32, 48, device="meta"), w_spec, m)
            with rec.run():
                x @ w
        return rec.flops, rec.records

    whole, none = flops((1, 1), ("data",), (None, "model"))
    assert whole == 2 * 64 * 32 * 48 and none == []
    quarter, records = flops((2, 2), ("data",), (None, "model"))
    assert quarter * 4 == whole and records == []
    replicated, records = flops((2, 2), (), ())
    assert replicated == whole and records == []
    # a shard-local function (the models' attention and scans) counts the
    # same local work
    with mesh_lib.fake_mesh((2, 2), ("data", "model"), "cpu") as m:
        rec = hlo_analysis.Recorder(m)
        x = rec.distribute(torch.empty(64, 32, device="meta"), ("data",), m)
        w = rec.distribute(torch.empty(32, 48, device="meta"), (), m)
        from torch.distributed.tensor.experimental import local_map
        fn = local_map(lambda a, b: (a @ b,),
                       out_placements=((Shard(0), Replicate()),),
                       in_placements=((Shard(0), Replicate()),
                                      (Replicate(), Replicate())),
                       device_mesh=m)
        with rec.run():
            fn(x, w)
    assert rec.flops * 2 == whole


def test_full_depth_equals_the_extrapolation_from_one_and_two_groups():
    """The reference calibrates at 1 and 2 layer groups because XLA counts
    a while body once; the eager count at full depth is what that
    extrapolation gives, to the FLOP, the byte and the collective byte."""
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              attn_impl="chunked", scan_impl="chunked")
    with mesh_lib.fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        cal = dryrun.calibrated_costs(
            cfg, configs.ShapeConfig("t", 64, 4, "train"), mesh)
    full = dryrun._costs(cell("h2o-danube-1.8b", (2, 2), "train"))
    assert cal["calibration"]["K"] == cfg.n_layers == 4
    for key in ("flops", "bytes", "coll", "coll_by_kind"):
        assert full[key] == cal[key], key
    assert full["coll"] > 0


def test_collectives_none_on_one_rank_alike_twice_and_split_on_four():
    assert cell("h2o-danube-1.8b", (1, 1), "train").records == []
    four = cell("h2o-danube-1.8b", (2, 2), "train")
    again = cell("h2o-danube-1.8b", (2, 2), "train", fresh=True)
    assert again is not four and again.records == four.records
    kinds = {op for _, op, _ in four.records}
    assert {"all_gather", "reduce_scatter"} <= kinds
    assert {dim for dim, _, _ in four.records} <= {"data", "model"}
    assert four.flops < cell("h2o-danube-1.8b", (1, 1), "train").flops / 3


def test_a_vocab_split_over_ranks_trains():
    """C9: with the vocab split over "model" the label's logit in the loss
    is a pending sum that DTensor's rules could not select from; it is
    reduced first (`lm._chunk_nll`)."""
    rec = cell("h2o-danube-1.8b", (1, 2), "train", vocab=496)
    assert rec.flops > 0
    assert ("model", "all_reduce") in {r[:2] for r in rec.records}


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_rwkv6_serves_where_its_five_mixes_do_not_split(kind):
    """C11: on (2, 2) DTensor splits the token-shift lora's 5 x lora dim
    over "model", where 5 mixes do not split in two; it is replicated
    before the view (`sharding.unflatten`)."""
    rec = cell("rwkv6-1.6b", (2, 2), kind)
    assert rec.flops > 0 and rec.records


# --- the fleet cells and the scheduler -----------------------------------------
def test_reduced_fleet_cells_and_the_split_halo_by_hand(tmp_path,
                                                        monkeypatch):
    """hit_les_reduced (N = 3: n = 4 nodes, 2^3 elements), 4 envs, on a
    (data 2, mx 2, my 2) mesh, the reference's pencil at its smallest:
    each rank holds 2 envs' block of 1 x 1 x 2 elements.  An RHS rolls
    five x-face slabs over "mx" and five y-face slabs over "my" (the
    gradient's traces and left faces of (v, T), 4 channels each; the
    divergence's traces of u and of the viscous flux and its left faces,
    5 channels each: 23 channel-slabs) of 2 envs x 1 x 2 elements x 4 x 4
    face nodes = 64 values each, in float32; an RL step runs 5 substeps
    of 5 stages.  A sum over the pencil is one all-reduce over each axis,
    each op counted once by the reference's convention (2 x its input);
    the whole velocity is gathered over "my", then over "mx"."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    split = dryrun.run_relexi_cell(env="hit_les_reduced", n_envs=4, data=2,
                                   device_type="cpu")
    assert split["status"] == "ok", split.get("traceback")
    assert split["mesh_shape"] == [2, 2, 2]
    assert split["mesh_axes"] == ["data", "mx", "my"]
    n_rhs = split["n_substeps"] * 5
    assert n_rhs == 25
    rolled = n_rhs * 23 * 64 * 4  # each axis
    assert split["rolls_by_dim"] == {"mx": n_rhs * 5, "my": n_rhs * 5}
    assert split["collective_bytes_per_dev"]["collective-permute"] == \
        2 * rolled
    assert split["collective_counts_raw"]["collective-permute"] == \
        2 * n_rhs * 5
    # over each axis, the forcing's all-reduce an RHS of (2 envs, 4 sums)
    # and the guard's of (2,) int32 once a step, each from the other rank
    summed = n_rhs * 2 * 4 * 4 + 2 * 4
    assert split["halo_bytes"] == 2 * (rolled + summed)
    assert split["collective_bytes_per_dev"]["all-reduce"] == 2 * 2 * summed
    assert split["collective_counts_raw"]["all-reduce"] == 2 * (n_rhs + 1)
    # observe's and the step's gathers of the velocity (3 channels of 4^3
    # nodes): 2 envs x 1 x 1 x 2 elements from "my", then 2 x 1 x 2 x 2
    # from "mx"
    vel = 3 * 64 * 4
    assert split["gather_bytes"] == 2 * (2 * 2 + 2 * 4) * vel
    assert split["collective_bytes_per_dev"]["all-gather"] == \
        2 * 2 * (2 * 2 + 2 * 4) * vel
    assert split["elem_ranks"] == 4 and split["shape"].endswith("_elem4")
    assert "reason" not in split
    chan = dryrun.run_channel_cell(4, variant="channel_wm_reduced", data=4,
                                   device_type="cpu")
    assert chan["status"] == "ok", chan.get("traceback")
    assert chan["flops_per_env"] == chan["flops_per_dev"] > 0
    for rec in (split, chan):
        assert rec["calibration"] == {"K": rec["n_substeps"], "eager": True}
        assert rec["peak_bytes_per_dev"] > rec["memory_analysis"][
            "argument_size_in_bytes"] > 0
    assert scheduler.dryrun_step_cost("channel_wm_reduced",
                                      artifact_dir=str(tmp_path)) == \
        chan["flops_per_env"]
    assert scheduler.dryrun_step_cost("hit_les_reduced",
                                      artifact_dir=str(tmp_path)) == \
        split["flops_per_env"]
    # envs that do not split over the env axes fail, as the reference's
    # sharding does (DTensor would hand the ranks unequal shares)
    uneven = dryrun.run_channel_cell(4, variant="channel_wm_reduced",
                                     data=8, save=False, device_type="cpu")
    assert uneven["status"] == "fail" and "do not split" in uneven["error"]


@pytest.mark.parametrize("multi_pod", (False, True), ids=("single", "multi"))
def test_production_hit_cell_is_the_reference_pencil(tmp_path, monkeypatch,
                                                     multi_pod):
    """`run_relexi_cell`'s production cell: hit_les_24dof x 256 envs on the
    reference's (16, 4, 4) ("data", "mx", "my") mesh, or (2, 16, 4, 4) with
    "pod", each env's 4^3 elements over 16 ranks, saved as
    fleet_256_elem16; u's argument bytes per device are the rank's 16 (8
    over two pods) envs x 4 elements x 6^3 nodes x 5 channels x 4 B.  The
    RL interval is cut to one substep for time (the mesh, the name and
    the argument bytes do not depend on it)."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    make = tenvs.make
    monkeypatch.setattr(tenvs, "make", lambda name, **kw: make(
        name, dt_rl=make(name).cfg.dt, **kw))
    u_bytes = []
    analysis = hlo_analysis.memory_analysis

    def kept(rec, args, out, donated=()):
        u = args[0]
        assert hlo_analysis.storage_keys(u) <= rec.read
        u_bytes.append(hlo_analysis.local_bytes(u))
        return analysis(rec, args, out, donated)

    monkeypatch.setattr(hlo_analysis, "memory_analysis", kept)
    rec = dryrun.run_relexi_cell(multi_pod=multi_pod, device_type="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_substeps"] == 1
    assert rec["mesh_shape"] == ([2] if multi_pod else []) + [16, 4, 4]
    assert rec["mesh_axes"] == (["pod"] if multi_pod else []) + [
        "data", "mx", "my"]
    assert rec["shape"] == "fleet_256_elem16" and rec["elem_ranks"] == 16
    assert rec["mesh"] == ("multi" if multi_pod else "single")
    assert "reason" not in rec
    assert u_bytes == [(8 if multi_pod else 16) * 4 * 6**3 * 5 * 4]
    assert u_bytes[0] == (138_240 if multi_pod else 276_480)
    assert rec["rolls_by_dim"] == {"mx": 5 * 5, "my": 5 * 5}
    assert (tmp_path / f"{rec['mesh']}_relexi-hit24_fleet_256_elem16.json"
            ).exists()


def test_cli_writes_the_reference_keys_and_leaves_no_group(tmp_path):
    dryrun.main(["--arch", "gemma2-27b", "--shape", "long_500k",
                 "--artifact-dir", str(tmp_path)])
    with open(tmp_path / "single_gemma2-27b_long_500k.json") as f:
        rec = json.load(f)
    assert rec["status"] == "skip" and rec["reason"]
    assert {"arch", "shape", "mesh", "kind", "status", "rules",
            "cfg"} <= set(rec)
    with mesh_lib.make_production_mesh(device_type="cpu") as mesh:
        assert mesh.shape == (16, 16) and dist.get_world_size() == 256
    with pytest.raises(RuntimeError, match="boom"):
        with mesh_lib.fake_mesh((2, 2), ("pod", "data"), "cpu"):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_a_meta_tensor_reaching_a_kernel_raises():
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        flash_attention.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="meta"):
        linear_scan.linear_scan(meta, meta, meta, meta)
    u = torch.empty(1, 2, 2, 2, 4, 4, 4, 5, device="meta")
    with pytest.raises(ValueError, match="meta"):
        rhs.fused_navier_stokes_rhs(
            u, torch.empty(1, 2, 2, 2, 4, 4, 4, device="meta"),
            torch.empty(4, 4, device="meta"), torch.empty(4, device="meta"),
            inv_w_end=(1.0, 1.0), jac=1.0, delta=1.0, mu=1.0, prandtl=0.7,
            prandtl_turb=0.6, forcing_a0=0.1, k_tke=1.0)
    cfg = configs.get_reduced("h2o-danube-1.8b")  # attn_impl "kernel"
    with mesh_lib.fake_mesh((1, 1), ("data", "model"), "cpu") as mesh:
        run, _ = specs.lower_cell(
            cfg, configs.ShapeConfig("t", 64, 4, "prefill"), mesh)
        with pytest.raises(ValueError, match="no flash attention kernel"):
            run()


# --- memory against the reference (its subprocess's result) ---------------------
@pytest.fixture(scope="module")
def port_cells():
    """Every cell the reference compiles, recorded before the first test
    below waits for the reference's result."""
    return {(a, m, k): cell(a, m, k) for a in ARCHS for m in MESHES
            for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference(port_cells, reference, arch,
                                            mesh_shape, kind):
    rec = port_cells[arch, mesh_shape, kind]
    want = reference()[f"{arch} {mesh_shape[0]}x{mesh_shape[1]} {kind}"]
    got = rec.memory["argument_size_in_bytes"]
    if kind == "decode":
        got += 4 * n_positions(arch)  # C10: the reference's int32 positions
    assert got == want
    assert rec.peak >= rec.memory["argument_size_in_bytes"]
