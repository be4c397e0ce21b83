"""The PyTorch port's examples (`examples/torch_*.py`), each run through its
`main` at its smallest setting on the CPU (`--device cpu`), from a
temporary directory (their checkpoints land there), and each shown to take
the GPU when no device is given.
"""
from __future__ import annotations

import os
import re
import runpy

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _main(name: str):
    return runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"))["main"]


def _run(name: str, argv: list, tmp_path, monkeypatch, capsys) -> str:
    """The example's `main` on the CPU with one intra-op thread (the suite
    runs its files side by side on the machine's cores)."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _main(name)(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return capsys.readouterr().out


def test_quickstart_trains_a_scenario_and_rolls_the_fleet(
        tmp_path, monkeypatch, capsys):
    out = _run("torch_quickstart", ["--env", "burgers_reduced"], tmp_path,
               monkeypatch, capsys)
    line = next(x for x in out.splitlines()
                if x.startswith("burgers_reduced:"))
    assert "obs (4, 4, 1) [u] act (4,) T=3" in line
    returns = [float(r) for r in line.split("returns")[1].split()]
    assert len(returns) == 3 and all(-1.0 <= r <= 1.0 for r in returns)
    assert "policy parameters: 1,558" in out
    assert "sampled fleet: T=3 steps x B=4 envs" in out
    assert os.path.isdir(tmp_path / "checkpoints"
                         / "torch_quickstart_burgers_reduced")


def test_scaling_demo_times_an_episode_per_fleet_size(
        tmp_path, monkeypatch, capsys):
    out = _run("torch_scaling_demo", [], tmp_path, monkeypatch, capsys)
    rows = [x.split() for x in out.splitlines()
            if re.fullmatch(r"\s*\d+( +[\d.]+){3}", x)]
    assert [int(r[0]) for r in rows] == [1, 2, 4, 8]
    for n, episode, per_env, speedup in rows:
        assert float(episode) > 0.0
        assert float(per_env) == pytest.approx(float(episode) / int(n),
                                               abs=1e-4)
    assert float(rows[0][3]) == 1.0


def test_serve_controller_trains_then_serves_from_the_checkpoint(
        tmp_path, monkeypatch, capsys):
    argv = ["--requests", "1", "--train-iters", "1", "--checkpoint-dir",
            str(tmp_path / "ckpt")]
    out = _run("torch_serve_controller", argv, tmp_path, monkeypatch, capsys)
    assert "training 1 reduced fleet iterations first" in out
    assert "serving scenarios ('hit_les_reduced', 'burgers_reduced') from " \
           "step 1 on cpu" in out
    assert len(re.findall(r"req \d+ \[hit_les_reduced\] -> action\[8 elems\]",
                          out)) == 1
    assert len(re.findall(r"req \d+ \[burgers_reduced\] -> action\[4 elems\]",
                          out)) == 1
    assert "'requests': 1, 'batches': 1" in out
    # a second run finds the checkpoint and trains nothing
    out = _run("torch_serve_controller", argv, tmp_path, monkeypatch, capsys)
    assert "training" not in out and "answered 2 requests" in out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_scaling_demo",
                                  "torch_serve_controller"])
def test_examples_take_the_gpu_by_default(name, tmp_path, monkeypatch):
    """Without `--device` an example asks for the GPU, and on a machine
    without one it raises before any work."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name)([])
