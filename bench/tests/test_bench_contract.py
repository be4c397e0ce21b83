"""The benchmark's files against the rules BENCHMARK.json keeps: every name in
BENCHMARK.json resolves to its file, names and units keep to their
characters, no module of the benchmark loads JAX or the JAX package, the
reference loads nothing of the program, and the command gives no result
without a card."""
from __future__ import annotations

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_texts():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    assert len(names) == len(set(names))
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [x["why"] for key in ("configs", "workloads") for x in SPEC[key]]
    texts += [m["layer"] for m in SPEC["per_layer"]]
    texts += [c["source"] for c in SPEC["configs"]] + SPEC["command"]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = harness.resolve(SPEC, workload)
    assert (BENCH / "loops" / f"{cell.traffic['loop']}.py").is_file()
    assert set(cell.spec["limits"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], workload)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric))


def test_every_config_file_is_its_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/")
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == [] and data["assumed"] == []
        assert data["precision"] == data["hit_config"]["precision"] == "fp32"


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of the modules a file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "out" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    assert "bench" not in _imports(path)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); import bench.harness as h;"
            " import bench.loops.rollout, bench.loops.train, bench.trace,"
            " bench.control, bench.faults;"
            " [h.reader(m['name']) for m in h.load_json(h.ROOT / "
            "'BENCHMARK.json')['per_layer']];"
            " import repro_torch.core.runner, repro_torch.envs;"
            " print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_command_gives_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(SPEC["command"] + [
        "--workload", SPEC["workloads"][0]["name"], "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_command_gives_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run(SPEC["command"] + [
        "--workload", SPEC["workloads"][0]["name"], "--seed", "3",
        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
