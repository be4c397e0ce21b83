"""The harness's comparison, driven through whole runs of small cells on
the CPU (`hit_les_reduced`, the look for a card skipped): a sound run is
correct, and each fault the cell can have, planted under the timed path,
and the bfloat16 control make it come out not correct."""
from __future__ import annotations

import dataclasses

import pytest

from bench import faults, harness

SEED = 2**31 + 21
ROLLOUT = ("state", "obs", "reward", "policy")
LIMIT = 1e-4
POLICY = {"mean_cs": 0.17, "actor_out_scale": 0.1, "log_std": -3.9}


def _cell(kind: str) -> harness.Cell:
    from repro_torch.configs import relexi_hit

    config = {"name": "hit_les_reduced", "env": "hit_les_reduced",
              "hit_config": dataclasses.asdict(relexi_hit.reduced())}
    if kind == "rollout":
        traffic = {"loop": "rollout", "n_envs": 4, "bank_size": 5,
                   "policy": POLICY}
        spec = {"samples_per_episode": 4,
                "limits": dict.fromkeys(ROLLOUT, LIMIT)}
        e2e = ["env_steps_per_s", "rl_step_p95_ms", "peak_mem_gib", "setup_s"]
        per_layer = ["mfu.rollout"]
    else:
        traffic = {"loop": "train", "n_envs": 4, "bank_size": 5,
                   "epochs": 2, "checked_iterations": 3, "policy": POLICY}
        spec = {"samples_per_iteration": 3, "limits": dict.fromkeys(
            ROLLOUT + ("loss", "grad", "update"), LIMIT)}
        e2e = ["iteration_s", "peak_mem_gib", "setup_s"]
        per_layer = ["sample_s.train", "update_s.train", "mfu.train"]
    return harness.Cell({"name": f"reduced.{kind}", "chips": 1}, config,
                        traffic, spec, [{"name": m, "unit": "x"} for m in e2e],
                        [{"name": m, "unit": "x"} for m in per_layer])


def _run(kind: str, **kw) -> dict:
    return harness.run_cell(_cell(kind), seed=SEED, seconds=0.5, trace=False,
                            device="cpu", **kw)


@pytest.mark.parametrize("kind", ["rollout", "train"])
def test_sound_run_is_correct(kind):
    res = _run(kind)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0
    assert all(m["value"] > 0 for m in res["metrics"].values()
               if m is not res["metrics"].get("peak_mem_gib"))


@pytest.mark.parametrize("kind,fault,caught", [
    ("rollout", "state_unchanged", "state"),
    ("rollout", "half_batch_rollout", "state"),
    ("rollout", "reward_altered", "reward"),
    ("train", "state_unchanged", "state"),
    ("train", "update_unchanged", "update"),
    ("train", "half_batch_update", "grad"),
    ("train", "reward_altered", "reward"),
])
def test_planted_fault_is_not_correct(kind, fault, caught):
    with faults.FAULTS[fault]():
        res = _run(kind)
    assert not res["correct"]
    assert res["checks"][caught]["value"] > 10 * LIMIT, res["checks"]


@pytest.mark.parametrize("kind", ["rollout", "train"])
def test_bf16_control_is_not_correct(kind):
    res = _run(kind, overrides={"precision": "bf16"})
    assert not res["correct"]
    assert res["checks"]["state"]["value"] > 10 * LIMIT, res["checks"]
