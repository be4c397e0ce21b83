"""PyTorch port vs JAX reference: the LM over a (data, model) mesh of ranks
(`parallel/sharding.py`, `launch/specs.py`, `launch/train.py`'s mesh,
`core/elastic.reshard` with specs, and `decode_attention`'s two
combines).

Ranks are processes on the CPU with the gloo backend and a file:// store:
this file, run as a script, is the worker (`_worker`).  Two worlds of two
ranks start when the module's first test sets up, one on a (1, 2) mesh
(tensor parallel: heads, FFN hidden and experts split over "model") and
one on a (2, 1) mesh (data parallel, the weights' d_model axis split over
"data"), while this process computes the one-process port runs and the
JAX reference's.  Every run is float32 at a reduced config: hymba-1.5b
(its 5 heads and 1 KV head do not split over 2 ranks, the fallback to
replicated; its SSM scan's plain path), whisper-tiny (enc-dec) and
deepseek-moe-16b (the "experts" axis).  Every run starts from the same
weights, the port's seeded init (`write_weights`): the port loads them
with `lm.load_leaves`, as `load_jax_params` does, and the reference's
processes stack them into its tree (`_reference_tree`, the inverse walk).
All read the same batches.  Ranks and this module run torch on one
thread.

Pins (measured on this CPU in the comment beside each):
  * training, against one process: loss and gradient norm of the first
    step within 1e-6 and 1e-5 (relative; the norm sums every gradient,
    each a few ulps off where a contraction splits over ranks), of the
    second within 1e-5 and 1e-4 (taken at params the first step's
    rounding moved), Adam's first moments within 1e-4 of the largest of any leaf
    (the clipped gradient's scale; the second step's gradient is taken
    at params that the first step's rounding already moved, see below;
    a leaf of small, nearly cancelling gradients, as hymba's SSM a_log,
    differs by 1.4e-4 of its own largest).  A float32 gradient of one
    step on the mesh is as far from a float64 one as one process's is
    (hymba, 2.4e-6 and 1.8e-6 of the largest).  Params after the 2 steps
    within one learning rate (the pin `test_torch_lm_train.py` holds one
    process to the reference with): Adam moves a value by about the
    learning rate whatever its gradient's size, so where a gradient entry
    is near rounding noise (below Adam's eps of 1e-8) two float32 sums
    move the value apart by a share of the learning rate; measured 0.61
    (hymba on (1, 2)).  The key biases get two learning rates: their gradient is zero
    in exact arithmetic (a softmax shift), so Adam moves them by the sign
    of rounding noise.
  * training, against the reference: loss and gradient norm within 1e-5,
    params within one learning rate (`test_torch_lm_train.py`'s pins).
  * decode: prefill + 4 teacher-forced decode steps, both combines, the
    logits within 2e-5 of the reference's dense path's largest logit.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("hymba-1.5b", "whisper-tiny", "deepseek-moe-16b")
MESHES = ("1x2", "2x1")
COMBINES = ("allgather", "flash")
STEPS = 2
LR = 3e-4
PROMPT, NEW = 32, 4          # a cache of 36 slots, which 2 ranks split
# what each world runs, in order: (mesh, job, arch).  World "a" writes the
# launcher's checkpoint on (1, 2), which world "b" resumes on (2, 1); the
# decode runs on (1, 2), where the cache splits over "model" (whisper's on
# (2, 1) too, its batch split over "data")
WORLDS = {
    "a": (("1x2", "train", "whisper-tiny"), ("1x2", "ckpt", None),
          ("1x2", "train", "hymba-1.5b"), ("1x2", "decode", "whisper-tiny"),
          ("1x2", "decode", "hymba-1.5b")),
    "b": (("2x1", "train", "deepseek-moe-16b"), ("2x1", "train", "hymba-1.5b"),
          ("2x1", "train", "whisper-tiny"), ("2x1", "ckpt", None),
          ("2x1", "decode", "whisper-tiny"),
          ("1x2", "train", "deepseek-moe-16b")),
}
HOME = {"a": "1x2", "b": "2x1"}   # the mesh of each world's other checks
DECODES = (("1x2", "hymba-1.5b"), ("1x2", "whisper-tiny"),
           ("2x1", "whisper-tiny"))


# loss and grad norm of each step; the second's after one Adam step whose
# rounding moved some params by part of a learning rate (see below)
PIN_LOSS = ({"loss": 1e-6, "grad_norm": 1e-5},    # measured 2.8e-7, 3.8e-6
            {"loss": 1e-5, "grad_norm": 1e-4})    # measured 1.0e-6
PIN_MOMENTS = 1e-4           # of the largest moment; measured <= 4.1e-5
PIN_PARAMS_LR = 1.0          # learning rates; measured <= 0.61
PIN_REF_LOSS = 1e-5          # measured <= 5.7e-7
PIN_DECODE = 2e-5            # of the reference's largest logit; <= 3.9e-6


def _cfg(arch: str):
    from repro_torch import configs
    return dataclasses.replace(configs.get_reduced(arch), dtype="float32")


def _shape(arch: str) -> tuple[int, int]:
    """(batch, seq): deepseek's 2 x 64 tokens make two MoE groups of 64, so
    the groups split over "data" too."""
    return (2, 64) if arch == "deepseek-moe-16b" else (2, 32)


def _batches(arch: str) -> list[dict]:
    from repro_torch.data import synthetic
    b, s = _shape(arch)
    return [synthetic.make_batch_for(_cfg(arch), 10 + k, b, s)
            for k in range(STEPS)]


def _decode_batch(arch: str) -> dict:
    from repro_torch.data import synthetic
    return synthetic.make_batch_for(_cfg(arch), 20, 2, PROMPT + NEW)


def _wait_for(path: str, procs=(), timeout: float = 240.0) -> None:
    """Wait for a file another process writes; raise if one of `procs`
    (the processes that may write it) failed first."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout or any(
                p.poll() not in (None, 0) for p in procs):
            raise TimeoutError(f"{path} never came")
        time.sleep(0.05)


def _port_params(arch: str, weights: str):
    """The port's parameters with the weights of <weights>/<arch>.npz, on
    the CPU."""
    from repro_torch.models import api, lm
    params = api.init(_cfg(arch), device="cpu")
    lm.load_leaves(params, np.load(f"{weights}/{arch}.npz").items())
    return params


def write_weights(weights: str) -> None:
    """Every arch's weights, the port's seeded float32 init, as
    port-named leaves in <weights>/<arch>.npz (the reference's processes
    stack them into its tree, `_reference_tree`)."""
    from repro_torch.models import api
    os.makedirs(weights, exist_ok=True)
    for arch in ARCHS:
        params = api.init(_cfg(arch), seed=0, device="cpu")
        np.savez(f"{weights}/{arch}.npz", **{
            n: p.detach().numpy() for n, p in params.named_parameters()})


def _adam():
    from repro_torch import optim
    return optim.AdamConfig(lr=LR, grad_clip=1.0)


def train_run(arch: str, weights: str, mesh=None) -> dict:
    """STEPS Adam steps: each step's loss and grad norm, then every
    parameter whole."""
    from repro_torch import optim
    from repro_torch.launch import specs, train
    cfg = _cfg(arch)
    params = _port_params(arch, weights)
    opt = optim.adam_init(list(params.parameters()))
    step = None
    if mesh is not None:
        step, p_sh, o_sh = train.build_train_fn(cfg, mesh, _adam())
        specs.place_params(params, p_sh, mesh)
        opt = specs.place_opt(opt, o_sh, mesh)
        _, b_sh = specs.batch_shardings(
            cfg, _train_shape(arch), "train", mesh, specs.rules_for(mesh))
    out = {"loss": [], "grad_norm": []}
    for batch in _batches(arch):
        if mesh is None:
            from repro_torch.models import api
            _, _, m = api.train_step(params, opt, batch, cfg, _adam())
        else:
            _, _, m = step(params, opt, specs.place_batch(batch, b_sh, mesh))
        for key in ("loss", "grad_norm"):
            out[key].append(float(specs.full(m[key])))
    names = [n for n, _ in params.named_parameters()]
    out["params"] = {n: specs.full(p).detach().clone()
                     for n, p in params.named_parameters()}
    out["m"] = {n: specs.full(m).clone() for n, m in zip(names, opt.m)}
    if mesh is not None:
        out["shards"] = specs.local_shapes(dict(params.named_parameters()))
        out["specs"] = p_sh
    return out


def _train_shape(arch: str):
    from repro_torch import configs
    b, s = _shape(arch)
    return configs.ShapeConfig("train", s, b, "train")


def decode_run(arch: str, weights: str, combine: str, mesh=None) -> list:
    """Prefill PROMPT tokens, then NEW teacher-forced decode steps, float32
    caches: the logits of each (prefill's last, then each step's)."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd
    cfg = dataclasses.replace(_cfg(arch), decode_combine=combine)
    params = _port_params(arch, weights)
    full = _decode_batch(arch)
    batch = {k: (v[:, :PROMPT] if k == "tokens" else v)
             for k, v in full.items() if k != "labels"}
    steps = [full["tokens"][:, PROMPT + i] for i in range(NEW)]
    if mesh is not None:
        rules = specs.rules_for(mesh)
        _, p_sh = specs.param_shardings(cfg, mesh, rules)
        specs.place_params(params, p_sh, mesh)
        shape = configs.ShapeConfig("prefill", PROMPT, 2, "prefill")
        _, b_sh = specs.batch_shardings(cfg, shape, "prefill", mesh, rules)
        batch = specs.place_batch(batch, b_sh, mesh)
        _, t_sh = specs.batch_shardings(cfg, shape, "decode", mesh, rules)
        steps = [specs.place_batch({"token": t}, t_sh, mesh)["token"]
                 for t in steps]
    with shd.on_mesh(mesh):
        logits, caches = api.prefill(params, cfg, batch,
                                     cache_len=PROMPT + NEW,
                                     cache_dtype=torch.float32)
        out = [specs.full(logits).clone()]
        for tok in steps:
            logits, caches = api.decode_step(params, cfg, tok, caches)
            out.append(specs.full(logits).clone())
    return out


# --- the tests ----------------------------------------------------------------
def _rel_leaf(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want))
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 1e-30))


def _key_bias(name: str) -> bool:
    return name.endswith("wk.b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_training_on_the_mesh_matches_one_process(runs, shape, arch):
    """2 Adam steps on the mesh against one process from the same weights
    and batches: loss and grad norm each step, Adam's first moments and
    the params after (the key biases to a learning rate, see the module
    docstring)."""
    got, want = runs.train(shape, arch), runs.one[arch]
    for step, pin in enumerate(PIN_LOSS):
        for key in ("loss", "grad_norm"):
            g, w = got[key][step], want[key][step]
            assert abs(g - w) <= pin[key] * abs(w), (step, key, g, w)
    scale = max(float(w.abs().max()) for w in want["m"].values())
    worst, name = max((float((got["m"][n] - w).abs().max()), n)
                      for n, w in want["m"].items() if not _key_bias(n))
    assert worst <= PIN_MOMENTS * scale, (name, worst / scale)
    for name, w in want["params"].items():
        err = float((got["params"][name] - w).abs().max())
        bound = STEPS * LR if _key_bias(name) else PIN_PARAMS_LR * LR
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_training_on_the_mesh_matches_reference(runs, shape, arch):
    """The same 2 steps against the reference's jitted `train_step`."""
    got, want = runs.train(shape, arch), runs.reference(arch)
    for key in ("loss", "grad_norm"):
        for g, w in zip(got[key], want[key]):
            assert abs(g - w) <= PIN_REF_LOSS * abs(w), (key, g, w)
    assert set(got["params"]) == set(want["params"])
    for name, w in want["params"].items():
        err = float((got["params"][name] - torch.as_tensor(np.array(w)))
                    .abs().max())
        assert err <= LR, (name, err)


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("shape,arch", DECODES)
def test_decode_on_the_mesh_matches_reference(runs, shape, arch, combine):
    """Prefill + NEW decode steps on the mesh, either combine, against the
    reference's dense decode path without a mesh."""
    got = runs.world(HOME["a"])["decode"].get((shape, arch, combine)) or \
        runs.world(HOME["b"])["decode"][shape, arch, combine]
    want = runs.reference(arch, "decode")["decode"]
    assert len(got) == len(want) == NEW + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel_leaf(g, w) <= PIN_DECODE, (i, _rel_leaf(g, w))


@pytest.mark.parametrize("shape", MESHES)
def test_parameters_are_laid_out_by_their_specs(runs, shape):
    """Every parameter's local shard on each rank has its spec's shape (a
    dim named by mesh axes divided by their sizes), and the specs are the
    logical rules' (`specs.param_shardings`)."""
    from repro_torch.parallel import sharding as shd
    sizes = dict(zip(("data", "model"), map(int, shape.split("x"))))
    for arch in ARCHS:
        for rank in range(2):
            got = runs.train(shape, arch, rank)
            for name, (local, spec) in got["shards"].items():
                want_spec = shd.trim(tuple(
                    e if e is None or sizes[e] > 1 else None
                    for e in got["specs"][name]))
                assert spec == want_spec, (name, spec, want_spec)
                full = tuple(runs.one[arch]["params"][name].shape)
                want = tuple(d // (sizes[e] if isinstance(e, str) else 1)
                             for d, e in zip(full, got["specs"][name] +
                                             (None,) * len(full)))
                assert local == want, (name, local, want)


def test_checkpoint_restores_on_another_mesh(runs):
    """`launch.train` writes a checkpoint on (1, 2); it resumes on (2, 1)
    and in one process: their third steps agree as two runs from one
    state (the first step's pins) and match an uninterrupted one-process
    run's as runs whose params Adam's rounding moved apart (the second
    step's)."""
    written = runs.world("1x2")["ckpt"]
    resumed = runs.world("2x1")["ckpt"]
    assert [h["step"] for h in written] == [0, 1]
    assert [h["step"] for h in resumed] == [2]
    assert [h["step"] for h in runs.launcher_resumed] == [2]
    full, one = runs.launcher_full, runs.launcher_resumed[0]
    for got in written:
        want, pin = full[got["step"]], PIN_LOSS[got["step"]]
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= pin[key] * want[key], key
    for key in ("loss", "grad_norm"):
        assert abs(resumed[0][key] - one[key]) <= PIN_LOSS[0][key] * one[key]
        for got in (resumed[0], one):
            assert abs(got[key] - full[2][key]) <= \
                PIN_LOSS[1][key] * full[2][key], key


def test_constrain_refuses_a_plain_tensor_under_a_mesh(runs):
    for shape in MESHES:
        msg = runs.world(shape)["constrain"]
        assert msg is not None and "left the mesh" in msg


@pytest.mark.parametrize("shape", MESHES)
def test_reshard_with_specs_gives_each_rank_its_shard(runs, shape):
    """`elastic.reshard(tree, mesh, specs)`: one spec for every leaf, or a
    tree of them; each rank holds its coordinate's block."""
    x = torch.arange(32.0).reshape(4, 8)
    sizes = dict(zip(("data", "model"), map(int, shape.split("x"))))
    for rank in range(2):
        out = runs.world(shape, rank)
        coord = dict(zip(("data", "model"), out["coordinate"]))

        def block(spec):
            y = x
            for dim, axis in enumerate(spec):
                if axis is not None and sizes[axis] > 1:
                    y = y.chunk(sizes[axis], dim=dim)[coord[axis]]
            return y

        for name, spec in (("one.a", ("data", "model")),
                           ("one.b", ("data", "model")),
                           ("tree.a", ("model", None)), ("tree.b", ())):
            _, local = out["reshard"][name]
            assert torch.equal(local, block(spec)), (name, rank)


def test_staged_group_all_to_all_sends_each_rank_its_chunk(runs):
    for shape in MESHES:
        for rank in range(2):
            got, (op, n_bytes) = runs.world(shape, rank)["all_to_all"]
            want = torch.cat([(torch.arange(24.0).reshape(4, 3, 2) + 100 * r)
                              .chunk(2)[rank] for r in range(2)])
            assert torch.equal(got, want) and op == "all_to_all"
            assert n_bytes == 24 * 4


def test_staged_groups_record_every_collective(runs):
    """The mesh's gloo groups (`collectives.StagedGroup`) ran the
    collectives DTensor issued, each with its bytes and seconds; a (1, 2)
    mesh's run reduces over "model" and a (2, 1) mesh's over "data"."""
    for shape, axis in (("1x2", "model"), ("2x1", "data")):
        records = runs.world(shape)["records"]
        ops = {(dim, op) for dim, op, _, _ in records}
        assert (axis, "all_reduce") in ops and (axis, "all_gather") in ops
        assert all(n >= 0 and s >= 0 for _, _, n, s in records)
        assert sum(n for d, _, n, _ in records if d == axis) > 0


# --- the processes (this file run as a script) -------------------------------
def _reference_tree(jcfg, leaves) -> dict:
    """The reference's parameter tree (`init`'s layout: block leaves
    stacked over the layer groups, the enc-dec's over its layers) holding
    the port-named `leaves`, the inverse of `lm.jax_param_leaves` /
    `encdec.jax_param_leaves`."""
    import jax
    import jax.numpy as jnp

    from repro.models import api as japi
    shapes = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    stacked = ("encoder", "decoder") if jcfg.is_encdec else ("layers",)

    def fill(tree, prefix: str, depth: int | None):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}{k}.", depth) for k, v in
                    tree.items()}
        if isinstance(tree, (list, tuple)):
            return [fill(v, f"{prefix}{i}.", depth)
                    for i, v in enumerate(tree)]
        name = prefix[:-1]
        if depth is None:
            leaf = leaves[name]
        else:  # top.<path> -> stack top.<i>.<path> over the layers
            top, rest = name.split(".", 1)
            leaf = np.stack([leaves[f"{top}.{i}.{rest}"]
                             for i in range(tree.shape[0])])
        assert leaf.shape == tree.shape, (name, leaf.shape, tree.shape)
        return jnp.asarray(leaf, tree.dtype)

    return {k: fill(v, f"{k}.", 0 if k in stacked else None)
            for k, v in shapes.items()}


def reference_run(weights: str, arch: str, part: str) -> dict:
    """The reference's run of `arch` on the weights every run here reads:
    part "train", STEPS jitted `train_step`s on `_batches`; part "decode",
    the dense decode path, prefill + NEW teacher-forced steps, with
    float32 caches."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.models import api as japi
    from repro_torch.models import encdec, lm
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
    params = _reference_tree(jcfg, dict(np.load(f"{weights}/{arch}.npz")))

    def port_named(tree) -> dict:
        host = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
        if jcfg.is_encdec:
            return dict(encdec.jax_param_leaves(host))
        groups = len(host["layers"]["b0"]["norm1"]["scale"])
        return dict(lm.jax_param_leaves(host, groups))

    out: dict = {}
    if part == "train":
        out.update(loss=[], grad_norm=[])
        adam = joptim.AdamConfig(lr=LR, grad_clip=1.0)
        step = jax.jit(lambda p, o, b: japi.train_step(p, o, b, jcfg, adam))
        p, opt = params, joptim.adam_init(params)
        for batch in _batches(arch):
            p, opt, m = step(p, opt, {k: jnp.asarray(v.numpy())
                                      for k, v in batch.items()})
            for key in ("loss", "grad_norm"):
                out[key].append(float(m[key]))
        out["params"] = port_named(p)
    else:
        full = _decode_batch(arch)
        batch = {k: jnp.asarray((v[:, :PROMPT] if k == "tokens" else v)
                                .numpy())
                 for k, v in full.items() if k != "labels"}
        prefill = jax.jit(lambda p, b: japi.prefill(
            p, jcfg, b, cache_len=PROMPT + NEW, cache_dtype=jnp.float32))
        decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
        logits, caches = prefill(params, batch)
        out["decode"] = [np.asarray(logits)]
        for i in range(NEW):
            tok = jnp.asarray(full["tokens"][:, PROMPT + i].numpy())
            logits, caches = decode(params, tok, caches)
            out["decode"].append(np.asarray(logits))
    return out


# the reference's runs, longest first (two threads of this process)
REFERENCE_JOBS = (("hymba-1.5b", "train"), ("deepseek-moe-16b", "train"),
                  ("whisper-tiny", "train"), ("hymba-1.5b", "decode"),
                  ("whisper-tiny", "decode"))


def launcher(ckpt: str, steps: int, *extra: str) -> list[dict]:
    """`launch.train.main` on whisper-tiny's reduced config, float32 as
    every run here (the launcher reads `configs.get_reduced`, patched for
    the call), at the training runs' batch shape; its checkpoints in
    `ckpt`."""
    from repro_torch import configs
    from repro_torch.launch import train
    b, s = _shape("whisper-tiny")
    get = configs.get_reduced
    configs.get_reduced = lambda name: dataclasses.replace(get(name),
                                                           dtype="float32")
    try:
        return train.main(["--arch", "whisper-tiny", "--reduced", "--batch",
                           str(b), "--seq", str(s), "--device", "cpu",
                           "--checkpoint-dir", ckpt, "--steps", str(steps),
                           *extra])
    finally:
        configs.get_reduced = get


def _copy_checkpoints(tmp: str, dest: str, procs=()) -> str:
    """The launcher's step-2 checkpoint (written by world "a") copied to
    <tmp>/<dest>, which a resumed run writes its own into."""
    import shutil
    _wait_for(f"{tmp}/ckpt_written", procs)
    if not os.path.exists(f"{tmp}/{dest}"):
        shutil.copytree(f"{tmp}/ckpt", f"{tmp}/{dest}.tmp")
        os.replace(f"{tmp}/{dest}.tmp", f"{tmp}/{dest}")
    return f"{tmp}/{dest}"


def _world(tmp: str, world: str, rank: int) -> None:
    """One rank of world `world`: its jobs (`WORLDS`), then the other
    checks on its home mesh."""
    import torch.distributed as dist

    from repro_torch.core import collectives, elastic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as shd
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    mesh_lib.init_distributed(init_method=f"file://{tmp}/store_{world}",
                              device="cpu")
    meshes = {s: mesh_lib.make_host_mesh(
        device="cpu", shape=tuple(int(n) for n in s.split("x")))
        for s in sorted({s for s, _, _ in WORLDS[world]})}
    weights = f"{tmp}/weights"
    out: dict = {"train": {}, "decode": {}, "seconds": {}}
    for shape, job, arch in WORLDS[world]:
        t0 = time.perf_counter()
        if job == "ckpt" and shape == "1x2":
            out["ckpt"] = launcher(f"{tmp}/ckpt", 2, "--mesh", shape)
            if rank == 0:
                open(f"{tmp}/ckpt_written", "w").close()
        elif job == "ckpt":
            ckpt = (_copy_checkpoints(tmp, "ckpt_2x1") if rank == 0
                    else f"{tmp}/ckpt_2x1")
            dist.barrier()
            out["ckpt"] = launcher(ckpt, 3, "--resume", "--mesh", shape)
        elif job == "train":
            out["train"][shape, arch] = train_run(arch, weights,
                                                  meshes[shape])
        else:
            for combine in COMBINES:
                out["decode"][shape, arch, combine] = decode_run(
                    arch, weights, combine, meshes[shape])
        out["seconds"][shape, job, arch] = time.perf_counter() - t0
    shape = HOME[world]
    mesh = meshes[shape]
    out["records"] = collectives.collective_records(mesh)
    with shd.on_mesh(mesh):
        try:
            shd.constrain(torch.ones(4, 8), "batch", "mlp")
            out["constrain"] = None
        except TypeError as e:
            out["constrain"] = str(e)
    x = torch.arange(32.0).reshape(4, 8)
    one = elastic.reshard({"a": x.clone(), "b": x.clone()}, mesh,
                          ("data", "model"))
    tree = elastic.reshard({"a": x.clone(), "b": x.clone()}, mesh,
                           {"a": ("model", None), "b": ()})
    out["reshard"] = {name: (t.placements, t.to_local().clone())
                      for name, t in (("one.a", one["a"]), ("one.b", one["b"]),
                                      ("tree.a", tree["a"]),
                                      ("tree.b", tree["b"]))}
    out["coordinate"] = tuple(mesh.get_coordinate())
    # an all-to-all on the mesh dim of two ranks (DTensor's CUDA path moves
    # a shard from one dim to another so; its CPU path gathers instead)
    group = mesh.get_group(0 if shape == "2x1" else 1)
    x = torch.arange(24.0).reshape(4, 3, 2) + 100 * rank
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x, group=group)
    out["all_to_all"] = (got, group.records[-1][:2])
    torch.save(out, f"{tmp}/world_{world}_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _start(tmp: str) -> list:
    """The two worlds' four ranks."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    procs = []
    for world in WORLDS:
        for r in range(2):
            log = f"{tmp}/world_{world}_{r}.log"
            with open(log, "w") as f:
                procs.append((log, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), tmp, world,
                     str(r)], env=env, stdout=f, stderr=subprocess.STDOUT)))
    return procs


class _Runs:
    """The worlds start when the module's first test sets up; this process
    meanwhile runs the reference's runs (in two threads: XLA compiles
    without the GIL), the one-process trainings and the launcher's
    one-process runs.  Results are awaited at first read."""

    def __init__(self, tmp: str):
        from concurrent.futures import ThreadPoolExecutor
        self.tmp = tmp
        weights = f"{tmp}/weights"
        write_weights(weights)
        self.procs = _start(tmp)
        self._done = False
        self._pool = ThreadPoolExecutor(2)
        self._refs = {(arch, part): self._pool.submit(
            reference_run, weights, arch, part)
            for arch, part in REFERENCE_JOBS}
        try:
            self.one = {arch: train_run(arch, f"{tmp}/weights")
                        for arch in ARCHS}
            self.launcher_full = launcher(f"{tmp}/ckpt_full", 3)
            self.launcher_resumed = launcher(
                _copy_checkpoints(tmp, "ckpt_one",
                                  [p for _, p in self.procs]), 3,
                "--resume")
        except BaseException:
            self.close()
            raise

    def _kill(self) -> None:
        for _, p in self.procs:
            p.kill()

    def close(self) -> None:
        self._kill()
        self._pool.shutdown(cancel_futures=True)

    def _wait(self) -> None:
        if self._done:
            return
        try:
            for _, p in self.procs:
                p.wait(timeout=300)
        finally:
            self._kill()
        for log, p in self.procs:
            with open(log) as f:
                assert p.returncode == 0, f.read()[-4000:]
        self._done = True

    def reference(self, arch: str, part: str = "train") -> dict:
        return self._refs[arch, part].result(timeout=300)

    def world(self, shape: str, rank: int = 0) -> dict:
        """The results of the world whose home mesh is `shape`."""
        self._wait()
        name = next(w for w, s in HOME.items() if s == shape)
        return torch.load(f"{self.tmp}/world_{name}_{rank}.pt",
                          weights_only=False)

    def train(self, shape: str, arch: str, rank: int = 0) -> dict:
        for name in HOME:
            got = self.world(HOME[name], rank)["train"].get((shape, arch))
            if got is not None:
                return got
        raise KeyError((shape, arch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("mesh")))
    yield r
    r.close()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _world(sys.argv[1], sys.argv[2], int(sys.argv[3]))
