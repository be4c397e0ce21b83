"""The benchmark's counted work against independent counts: the fused
RHS's operations and bytes as the port's chip check printed them at 16
envs, and the policy's convolution FLOP against torch's flop counter."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.count import policy as conv, rhs, work
from bench.reference import hit


def test_rhs_counts_at_16_envs():
    assert rhs.operations(16, 4, 4, 4, 6) == 181_703_816      # 1.817e8
    assert rhs.bytes_moved(16, 4, 4, 4, 6) == 9_732_264
    assert round(rhs.operations(16, 4, 4, 4, 8), -6) == 536_000_000
    assert rhs.bound_s(16, 4, 4, 4, 6) * 1e3 == pytest.approx(0.0029052,
                                                              abs=1e-7)
    assert rhs.bound_s(16, 4, 4, 4, 8) * 1e3 == pytest.approx(0.0080023,
                                                              abs=1e-7)


def test_rhs_counts_are_linear_in_the_batch():
    one = rhs.operations(1, 4, 4, 4, 6) - 5 * 6**3
    assert rhs.operations(128, 4, 4, 4, 6) - 5 * 6**3 == 128 * one


@pytest.mark.parametrize("n_poly", [3, 5, 7])
def test_conv_flop_against_the_flop_counter(n_poly):
    from repro_torch.core import policy as policy_lib

    n, elems = n_poly + 1, 8
    pcfg = policy_lib.PolicyConfig(n_nodes=n, channels=3)
    pol = policy_lib.Policy(pcfg, torch.Generator().manual_seed(0))
    obs = torch.randn((2, elems, n, n, n, 3))
    with FlopCounterMode(display=False) as fc:
        mean, _ = pol.distribution(obs)
        pol.value(obs)
    assert fc.get_total_flops() == 2 * conv.forward(n, 3, elems)
    with FlopCounterMode(display=False) as fc:
        mean, _ = pol.distribution(obs)
        (mean.sum() + pol.value(obs).sum()).backward()
    assert fc.get_total_flops() == 2 * conv.forward_backward(n, 3, elems)


def test_work_of_the_paper_configurations():
    c24 = hit.Case.from_fields(_fields("hit_les_24dof"))
    c32 = hit.Case.from_fields(_fields("hit_les_32dof"))
    assert (work.rhs_calls_per_step(c24), work.rhs_calls_per_step(c32)) \
        == (65, 90)
    assert conv.forward(6, 3, 64) == 65_921_024          # 6.59e7
    assert conv.forward(8, 3, 64) == 210_575_360         # 2.11e8
    assert work.flop_per_env_step(c24) == pytest.approx(
        65 * rhs.operations(1, 4, 4, 4, 6) + 1.01 * 65_921_024)


def _fields(name):
    import json
    from bench.harness import BENCH

    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "hit_config"]
