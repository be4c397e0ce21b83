"""The reduction of a profiler timeline (`bench.trace.reduce`) on a
timeline made by hand: busy seconds as the union of device intervals, the
ops by name, each idle gap named by the calling thread's innermost host
op, and what the readers make of it."""
from __future__ import annotations

import types

import pytest

from bench import trace
from bench.harness import Readings, reader


def _evt(name, start, end, device=False, thread=1):
    return types.SimpleNamespace(
        name=name, thread=thread,
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=start, end=end))


def _timeline():
    return [
        _evt(trace.SPAN, 0, 100),
        _evt("aten::step", 5, 60),
        _evt("aten::copy_", 40, 55),
        _evt("aten::stack", 70, 95),
        _evt("other thread", 0, 100, thread=2),
        _evt("ns_rhs_cluster_kernel<6>", 10, 30, device=True),
        _evt("ns_rhs_cluster_kernel<6>", 25, 40, device=True),
        _evt("elementwise", 60, 70, device=True),
        _evt(trace.SPAN, 0, 100, device=True),   # the span's annotation
    ]


def test_reduce_union_ops_and_gaps():
    t = trace.reduce(_timeline(), window_s=100e-6)
    assert t.busy_s == pytest.approx(40e-6)          # [10, 40] + [60, 70]
    assert t.ops["ns_rhs_cluster_kernel<6>"] == pytest.approx([35e-6, 2])
    assert t.mean_launch_s("ns_rhs_cluster") == pytest.approx(17.5e-6)
    # gaps [0, 10] (mid 5: aten::step), [40, 60] (mid 50: aten::copy_),
    # [70, 100] (mid 85: aten::stack)
    assert t.gaps == pytest.approx({"aten::step": 10e-6,
                                    "aten::copy_": 20e-6,
                                    "aten::stack": 30e-6})
    b = t.breakdown(top=2)
    assert [n for n, _ in b["device_ops"]] == ["ns_rhs_cluster_kernel<6>",
                                              "elementwise"]
    assert [n for n, _ in b["idle_gaps"]] == ["aten::stack", "aten::copy_"]


def test_readers_of_a_trace():
    t = trace.reduce(_timeline(), window_s=100e-6)
    config = {"hit_config": {
        "n_poly": 5, "n_elem": 4, "length": 6.283185307179586, "mach": 0.3,
        "nu": 0.0018, "rho0": 1.0, "u_rms": 1.0, "prandtl": 0.72,
        "prandtl_turb": 0.9, "forcing_a0": 0.3, "cfl": 0.35, "dt_rl": 0.1,
        "t_end": 5.0, "k_max": 9, "alpha": 0.4, "cs_max": 0.5,
        "k_peak": 4.0, "k_eta": 48.0}}
    r = Readings(config, {"n_envs": 16}, 1.0, {"env_steps": 0}, {}, t,
                 {"rl_steps": 1})
    assert reader("idle_share.rollout")(r) == pytest.approx(60.0)
    from bench.count import rhs
    assert reader("rhs_roofline.rollout")(r) == pytest.approx(
        100 * rhs.bound_s(16, 4, 4, 4, 6) / 17.5e-6)
    assert reader("nonrhs_ms.rollout")(r) == pytest.approx(
        (40e-6 - 65 * 17.5e-6) * 1e3)
    assert reader("mfu.rollout")(r) is None
    empty = Readings(config, {"n_envs": 16}, 1.0, {}, {}, None, {})
    for name in ("idle_share.train", "rhs_roofline.rollout",
                 "nonrhs_ms.rollout", "sample_s.train", "mfu.train"):
        assert reader(name)(empty) is None
