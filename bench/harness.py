"""The benchmark's harness: one cell of `BENCHMARK.json`, run once.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

    bench/configs/<config>.json     the configuration as it is run
    bench/traffic/<traffic>.json    the traffic mix; its "loop" names
                                    the loop that runs it
    bench/loops/<loop>.py       a loop over the program's entry point
    bench/workloads/<workload>.json the cell's samples and limits
    bench/metrics/<metric>.py       a per-layer metric's reader

A run: set-up (the program built from the seed, kernels loaded, one
warm-up), the measured window, the allocator's peak, the check that no
JAX module was loaded, with `--trace 1` one more traced segment, then the
program's state is freed and the reference judges the samples.  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "out"
# top-level module names the run may not hold once its window has closed:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that cannot give a result (no card, a missing file, JAX)."""


@dataclasses.dataclass
class Cell:
    workload: dict        # the BENCHMARK.json entry
    config: dict          # bench/configs/<config>.json
    traffic: dict         # bench/traffic/<traffic>.json
    spec: dict            # bench/workloads/<name>.json
    end_to_end: list      # the BENCHMARK.json metrics this cell reports
    per_layer: list


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads."""
    config: dict
    traffic: dict
    window_s: float
    counts: dict          # work done in the window
    spans: dict           # the program's own timings: name -> [seconds]
    trace: object | None  # bench.trace.Trace of the traced segment
    trace_counts: dict    # work done in the traced segment


def load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, name: str) -> Cell:
    """The files of cell `name`, found by the names in `bench`."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    work = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[work["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{work['traffic']}.json")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(work, config, traffic, spec, e2e, per_layer)


def reader(metric: str):
    """`read(readings)` of bench/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise Refused(f"no reader bench/metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card_power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return proc.stdout.strip().splitlines()[0] if proc.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def prepare_process() -> None:
    """The program on the path and its caches inside the checkout."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise Refused("the program (src/repro_torch) is not in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    cache = OUT / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of `cell` on `device`; returns the result with its checks.
    `overrides` replaces fields of the configuration (the control's lower
    precision); the benchmark's own runs pass none."""
    import torch

    started = time.perf_counter() if started is None else started
    loop_mod = importlib.import_module(
        f"bench.loops.{cell.traffic['loop']}")
    dev = torch.device(device)
    loop = loop_mod.Loop(cell, seed=seed, device=dev,
                         overrides=overrides or {})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - started
    loop.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loaded = forbidden_modules()
    if loaded:
        raise Refused(f"modules of JAX or the JAX package were loaded: "
                      f"{', '.join(loaded)}")
    traced = None
    trace_counts: dict = {}
    if trace:
        from . import trace as trace_lib
        fn, trace_counts = loop.trace_segment()
        traced = trace_lib.traced(fn, dev)
    readings = Readings(cell.config, cell.traffic, loop.window_s,
                        loop.counts, loop.spans, traced, trace_counts)
    loop.free()
    numbers, notes = loop.check()
    limits = cell.spec["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(loop.end_to_end(), setup_s=setup_s,
                      peak_mem_gib=peak / 2**30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": loop.attempted,
              "failed": loop.failed, "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["notes"] = notes
    result["checks"] = checks
    return result


def report(result: dict, power_limit: str) -> None:
    """The numbers compared on standard error, then the result line (the
    checks its last key)."""
    result["device"]["power_limit"] = power_limit
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: list[str] | None = None, started: float | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m bench.run",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one process with few threads: the program's host side is one thread
    # of dispatch, and the card's machine shares its cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell = resolve(bench, args.workload)
        prepare_process()
        import torch

        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs on a card only")
        chips = cell.workload["chips"]
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} present")
        result = run_cell(cell, seed=args.seed % 2**63, seconds=args.seconds,
                          trace=bool(args.trace), started=started)
        loaded = forbidden_modules()
        if loaded:
            raise Refused(f"modules of JAX or the JAX package were loaded: "
                          f"{', '.join(loaded)}")
    except Refused as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    report(result, card_power_limit())
    return 0
