"""`repro-torch-lint`: run the port's static-analysis gate and write the
report.

    repro-torch-lint                         # AST + op + kernel layers
    repro-torch-lint --layers all            # + the trace certification
    repro-torch-lint --layers ast            # source lint only (fast)
    repro-torch-lint --device cpu            # the CPU layers alone
    repro-torch-lint --report torch_analysis_report.json

Exit status is 0 iff there are zero unsuppressed findings.  The JSON
report is written either way.

The default device is the card, as for the port's entry points: the
layers add there what only the card can say (each entry's host syncs
under `torch.cuda.set_sync_debug_mode` held to the CPU's count, each
kernel library's registers, spills and shared memory, the card's
shared-memory limit, the trace run's launches).  Without a card the gate
stops and asks for `--device cpu`, which runs the CPU layers alone (what
the tests run); it never falls back to the CPU by itself.  The `ast`
layer alone needs no device.
"""
from __future__ import annotations

import argparse
import sys
import time

from .dispatch import NoCard, device_of
from .report import Report

LAYERS = ("ast", "ops", "kernel", "trace")
DEFAULT_LAYERS = ("ast", "ops", "kernel")


def run_layers(layers: tuple[str, ...], root: str = ".",
               device: str = "cuda") -> Report:
    """Run `layers` in the order of LAYERS on `device` ("cuda", the
    default, or "cpu"); the report's meta holds each layer's seconds.
    Raises without a card unless `device="cpu"` or only `ast` runs."""
    from . import ast_rules, kernel_audit, op_audit, trace_audit

    if set(layers) - {"ast"}:
        device_of(device)

    runs = {"ast": lambda r: ast_rules.run(r, root=root),
            "ops": lambda r: op_audit.run(r, device=device),
            "kernel": lambda r: kernel_audit.run(r, device=device),
            "trace": lambda r: trace_audit.run(r, device=device)}
    report = Report()
    seconds = {}
    for layer in LAYERS:
        if layer in layers:
            t0 = time.perf_counter()
            runs[layer](report)
            seconds[layer] = round(time.perf_counter() - t0, 3)
    report.meta.update(layers=list(layers), device=device, seconds=seconds)
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", default=",".join(DEFAULT_LAYERS),
                    help="comma-separated subset of "
                         f"{','.join(LAYERS)}, or 'all' "
                         f"(default: {','.join(DEFAULT_LAYERS)}; 'trace' "
                         "runs a real reduced training run)")
    ap.add_argument("--report", default="torch_analysis_report.json",
                    help="path for the machine-readable report "
                         "(default: %(default)s)")
    ap.add_argument("--root", default=".",
                    help="repo root to lint (default: cwd)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="'cpu' runs the CPU layers alone (default: "
                         "%(default)s; without a card the gate stops)")
    args = ap.parse_args(argv)

    layers = (LAYERS if args.layers == "all"
              else tuple(l.strip() for l in args.layers.split(",")
                         if l.strip()))
    unknown = set(layers) - set(LAYERS)
    if unknown:
        ap.error(f"unknown layer(s) {sorted(unknown)}; choose from {LAYERS}")

    try:
        report = run_layers(layers, root=args.root, device=args.device)
    except NoCard as err:
        ap.error(str(err))
    report.save(args.report)
    print(report.summary())
    print(f"report: {args.report}")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
