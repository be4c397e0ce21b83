"""PyTorch port vs JAX reference: logical-axis sharding (`parallel/
sharding.py`) and every cell input's spec (`launch/specs.py`, the models'
`param_axes` / `cache_axes`), on shape-only meshes: no ranks.

A port spec is a tuple with one entry per dim, the reference's
PartitionSpec entry for entry.  The reference stacks each layer group's
leaves on a leading axis (None in its specs); the port keeps one tree per
layer, so a stacked reference spec compares without its first entry, once
per layer.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.parallel import sharding as jshd
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import api, lm
from repro_torch.parallel import sharding as shd

MESHES = ((1, 1), (1, 2), (2, 1), (2, 4), (16, 16))
NAMES = ("data", "model")
CELL = configs.ShapeConfig("cell", 1024, 32, "train")


def _meshes(sizes):
    return (jshd.abstract_mesh(sizes, NAMES), shd.abstract_mesh(sizes, NAMES))


def _cfgs(arch: str):
    return ((jconfigs.get(arch), configs.get(arch)),
            (jconfigs.get_reduced(arch), configs.get_reduced(arch)))


@functools.lru_cache(maxsize=None)
def _reference_trees(arch: str, reduced: bool):
    jcfg = (jconfigs.get_reduced if reduced else jconfigs.get)(arch)
    return (japi.abstract_params(jcfg),
            japi.abstract_caches(jcfg, CELL.global_batch, CELL.seq_len,
                                 jax.numpy.bfloat16))


def _port_named(cfg, tree, caches: bool = False) -> dict:
    """{port leaf name: spec} of a reference spec tree: stacked leaves
    (the decoder-only models' "layers", the enc-dec's "encoder" and
    "decoder", its caches' "self" and "cross") once per layer without
    their leading entry."""
    stacked = (("self", "cross") if caches else ("encoder", "decoder")) \
        if cfg.is_encdec else ("layers",)
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] in stacked:
            n = (cfg.encoder_layers if keys[0] == "encoder" else
                 cfg.n_layers if cfg.is_encdec else lm.n_groups(cfg))
            for i in range(n):
                out[".".join([keys[0], str(i)] + keys[1:])] = tuple(spec)[1:]
        else:
            out[".".join(keys)] = tuple(spec)
    return out


def test_default_rules_equal_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


def test_constrain_is_x_itself_without_rules_or_mesh():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", None) is x
    with shd.axis_rules(None):
        assert shd.constrain(x, "batch", None) is x
    with shd.axis_rules(shd.abstract_mesh((2, 4), NAMES)):
        assert shd.constrain(x, "batch", None) is x


_LOGICAL = st.sampled_from([None, "pod"] + sorted(jshd.DEFAULT_RULES))
_DIMS = st.sampled_from([1, 2, 3, 4, 5, 6, 8, 16, 25, 32, 48, 64, 256])


@settings(max_examples=300, deadline=None)
@given(mesh=st.sampled_from(MESHES), dims=st.lists(
    st.tuples(_DIMS, _LOGICAL), min_size=1, max_size=4),
    override=st.sampled_from([None, {"seq": "model"},
                              {"batch": ("data", "model")},
                              {"heads": ("model", "data")}]))
def test_logical_to_spec_equals_reference(mesh, dims, override):
    jm, pm = _meshes(mesh)
    shape = tuple(d for d, _ in dims)
    logical = tuple(name for _, name in dims)
    want = jshd.logical_to_spec(shape, logical, jshd.AxisRules(jm, override))
    got = shd.logical_to_spec(shape, logical, shd.AxisRules(pm, override))
    assert got == tuple(want)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_equal_reference(arch):
    """Every parameter leaf's spec, full and reduced config, on every
    mesh: the reference's `param_specs(api.abstract_params(cfg),
    api.param_axes(cfg), rules)` against `specs.param_shardings` of the
    port's parameters on the meta device."""
    for reduced, (jcfg, cfg) in enumerate(_cfgs(arch)):
        jparams = _reference_trees(arch, bool(reduced))[0]
        ap = api.abstract_params(cfg)
        assert all(p.device.type == "meta" for p in ap.parameters())
        for sizes in MESHES:
            jm, pm = _meshes(sizes)
            want = _port_named(cfg, jshd.param_specs(
                jparams, japi.param_axes(jcfg), jshd.AxisRules(jm)))
            _, got = specs.param_shardings(cfg, pm, specs.rules_for(pm), ap)
            assert got == want, (arch, reduced, sizes)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_equal_reference(kind):
    for arch in configs.ARCH_NAMES:
        for jcfg, cfg in _cfgs(arch):
            shape = dataclasses.replace(CELL, kind=kind)
            jb = jspecs.abstract_batch(jcfg, shape, kind)
            pb = specs.abstract_batch(cfg, shape, kind)
            assert {k: tuple(v.shape) for k, v in pb.items()} == \
                {k: tuple(v.shape) for k, v in jb.items()}
            for sizes in MESHES:
                jm, pm = _meshes(sizes)
                want = jshd.param_specs(jb, jspecs.batch_axes(jcfg, kind),
                                        jshd.AxisRules(jm))
                _, got = specs.batch_shardings(cfg, shape, kind, pm,
                                               specs.rules_for(pm))
                assert got == {k: tuple(v) for k, v in want.items()}, \
                    (arch, kind, sizes)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_specs_equal_reference(arch):
    """Every decode cache leaf's spec (the position, a Python int in the
    port, has none)."""
    for reduced, (jcfg, cfg) in enumerate(_cfgs(arch)):
        jcaches = _reference_trees(arch, bool(reduced))[1]
        for sizes in MESHES:
            jm, pm = _meshes(sizes)
            want = _port_named(cfg, jshd.param_specs(
                jcaches, japi.cache_axes(jcfg), jshd.AxisRules(jm)), True)
            want = {k: v for k, v in want.items() if not k.endswith("pos")}
            ac, got = specs.cache_shardings(cfg, CELL, pm,
                                            specs.rules_for(pm))
            assert got == want, (arch, reduced, sizes)
            flat = lm.flat_names(ac)
            assert all(flat[k].device.type == "meta" for k in got)


def test_opt_shardings_keep_the_moments_own_rules():
    """`opt_shardings`: the step replicated, the moments under the
    parameters' specs, or under `opt_rules` of their own (ZeRO-1: the
    parameters replicated, the moments sharded), as the reference's."""
    for arch in ("gemma2-27b", "deepseek-moe-16b", "hymba-1.5b"):
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        jparams = _reference_trees(arch, False)[0]
        names = [n for n, _ in api.abstract_params(cfg).named_parameters()]
        for sizes in ((2, 4), (16, 16)):
            jm, pm = _meshes(sizes)
            replicated = {k: None for k in jshd.DEFAULT_RULES}
            jrules = jspecs.rules_for(jm, replicated)
            ap, p_sh = specs.param_shardings(cfg, pm,
                                             specs.rules_for(pm, replicated))
            assert all(s == (None,) * len(s) for s in p_sh.values())
            for opt_rules in (None, specs.rules_for(pm)):
                _, o_sh = specs.opt_shardings(ap, p_sh, pm, cfg, opt_rules)
                jap, jp_sh = jspecs.param_shardings(jcfg, jm, jrules, jparams)
                _, jo_sh = jspecs.opt_shardings(
                    jap, jp_sh, jm, jcfg,
                    None if opt_rules is None else jspecs.rules_for(jm))
                assert o_sh.step == () and tuple(jo_sh.step.spec) == ()
                want = _port_named(cfg, jax.tree.map(
                    lambda s: s.spec, jo_sh.m,
                    is_leaf=lambda x: hasattr(x, "spec")))
                got = dict(zip(names, o_sh.m))
                assert o_sh.m == o_sh.v
                assert {k: shd.trim(v) for k, v in got.items()} == \
                    {k: shd.trim(v) for k, v in want.items()}
                if opt_rules is None:
                    assert got == p_sh
                else:
                    assert any(s != p_sh[n] for n, s in got.items())


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A process group of this process alone (gloo, a file store)."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_placements_on_a_one_by_one_mesh(one_rank):
    """Every spec of every arch's parameters and caches on a real 1 x 1
    `DeviceMesh`: each mesh dim is one rank, so each placement is
    `Replicate()`, and laying a tensor out by it changes no value."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=NAMES)
    rules = specs.rules_for(mesh)
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_reduced(arch)
        _, p_sh = specs.param_shardings(cfg, mesh, rules)
        _, c_sh = specs.cache_shardings(cfg, CELL, mesh, rules)
        for spec in list(p_sh.values()) + list(c_sh.values()):
            assert shd.placements(spec, mesh) == (Replicate(), Replicate())
    x = torch.arange(12.0).reshape(3, 4)
    placed = shd.distribute(x, ("data", "model"), mesh)
    assert torch.equal(placed.to_local(), x)
    assert shd.spec_of(placed) == ()


class _Mesh:
    """The two things `placements` reads of a `DeviceMesh`."""

    def __init__(self, sizes):
        self.mesh_dim_names, self.shape = NAMES, tuple(sizes)


@pytest.mark.parametrize("sizes", [(2, 4), (16, 16), (1, 2)])
def test_placements_shard_each_named_dim_on_its_mesh_dim(sizes):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(sizes)
    want_model = Shard(1) if sizes[1] > 1 else Replicate()
    want_data = Shard(0) if sizes[0] > 1 else Replicate()
    assert shd.placements(("data", "model"), mesh) == (want_data, want_model)
    assert shd.placements((None, "data"), mesh) == (
        Shard(1) if sizes[0] > 1 else Replicate(), Replicate())
    assert shd.placements((), mesh) == (Replicate(), Replicate())
    both = shd.placements((("data", "model"),), mesh)
    assert both == tuple(Shard(0) if n > 1 else Replicate() for n in sizes)
    with pytest.raises(ValueError):
        shd.placements((("model", "data"),), mesh)
