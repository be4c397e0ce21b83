"""The readings that the limits of `correct` are set from, in one process:
sound runs of a cell on several seeds (the lower reading), the control
(the program's own bfloat16 path, `precision` "bf16") and planted faults
(`bench.faults`) on others (the upper reading).  The benchmark's own runs
do not run it.

    python3 -m bench.control --workload <name> --seconds <s> \\
        --seeds 1,2,3 --control-seeds 4,5,6 [--faults half_batch_update,...]

One JSON line per run on standard output: its kind, seed and numbers."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from . import faults, harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m bench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                           args.workload)
    harness.prepare_process()
    import torch

    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 2
    runs = [("sound", s, {}, None) for s in ints(args.seeds)]
    runs += [("bf16", s, {"precision": "bf16"}, None)
             for s in ints(args.control_seeds)]
    runs += [(f, s, {}, f) for f in args.faults.split(",") if f
             for s in ints(args.fault_seeds)]
    for kind, seed, overrides, fault in runs:
        t0 = time.perf_counter()
        plant = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
        with plant:
            res = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                                   trace=False, overrides=overrides)
        print(json.dumps({
            "workload": args.workload, "kind": kind, "seed": seed,
            "correct": res["correct"], "wall_s": time.perf_counter() - t0,
            "numbers": {k: c["value"] for k, c in res["checks"].items()},
            "notes": res["notes"], "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
