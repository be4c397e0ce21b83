"""On the card (marked `cuda`, skipped without one): one short run of each
cell at its own size is correct, and the bfloat16 control at the same size
is not.  `python -m pytest -m cuda bench/tests -q` on the card's machine."""
from __future__ import annotations

import json

import pytest

from bench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    res = harness.run_cell(harness.resolve(SPEC, workload), seed=2**31 + 5,
                           seconds=1.0, trace=False)
    assert res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_bf16_control_on_the_card(card, workload):
    res = harness.run_cell(harness.resolve(SPEC, workload), seed=2**31 + 6,
                           seconds=1.0, trace=False,
                           overrides={"precision": "bf16"})
    assert not res["correct"], res["checks"]
