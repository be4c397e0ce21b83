"""Findings, rules, suppressions and the `torch_analysis_report.json`
schema (the port's counterpart of `repro.analysis.report`).

Every layer of the gate (source lint, op audit, kernel audit, trace audit)
reduces to the same currency: a `Finding`, one rule violation pinned to a
location, collected into a `Report`.  The report serializes to
`torch_analysis_report.json` with the reference's schema (the same keys and
`SCHEMA_VERSION`, so the two reports read alike) and renders a human
summary; the exit code of `repro-torch-lint` is derived from
`Report.unsuppressed()`.

Suppressions
------------
Source findings can be suppressed inline at the offending line:

    x = np.tanh(y)  # repro-torch-lint: disable=AST001 -- host table build

The reason after ` -- ` is mandatory: a suppression without one is itself a
finding (AST007).  Program findings (OPS*/TRACE*/KERN* rules) are
suppressed, or pinned, on the entry point (`entrypoints.EntryPoint.
suppress`, `Built.syncs`), again with a reason, so every waiver is
reviewed code.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

SCHEMA_VERSION = 1

# The rule catalog: id -> (severity, one-line description).
# docs/torch_static_analysis.md carries the long form; tests/
# test_torch_analysis.py red-teams every id with a violating fixture.
RULES: dict[str, tuple[str, str]] = {
    # --- source lint (ast_rules.py) -----------------------------------------
    "AST001": ("error", "numpy call inside a function that takes a "
                        "torch.Tensor, in a hot module (host math on the "
                        "device path: a copy to the host and back)"),
    "AST002": ("error", "Python `random` in a hot module (draws outside "
                        "the explicit generators break replay)"),
    "AST003": ("error", "the global torch RNG in a hot module: "
                        "torch.manual_seed, or a random draw without "
                        "generator="),
    "AST004": ("error", "torch.float64 / torch.double / .double() in a hot "
                        "module (float64 doubles the bytes and runs at 1/64 "
                        "of the float32 rate on the card)"),
    "AST005": ("error", "kernel wrapper hides its kernel: an except that "
                        "falls back to the plain version or returns a "
                        "result, or an environment variable choosing the "
                        "route"),
    "AST006": ("error", "envs.make() called with a name missing from the "
                        "port's registry"),
    "AST007": ("error", "repro-torch-lint suppression without a ` -- "
                        "reason`"),
    "AST008": ("error", "import of jax, jaxlib or the JAX package `repro` "
                        "in the port's code"),
    # --- op audit (op_audit.py over dispatch.py's records) ------------------
    "OPS001": ("error", "float64 output of an op inside an entry point"),
    "OPS002": ("error", "state-sized float32 -> bfloat16 demote fed by an "
                        "elementwise op inside the declared bf16 interval "
                        "(dtype churn)"),
    "OPS003": ("error", "host syncs of device data beyond the entry's pin "
                        "(a device-to-host read or a blocking "
                        "host-to-device copy)"),
    "OPS004": ("error", "state declared in place is left in new storage "
                        "(the in-place update was lost)"),
    "OPS005": ("warning", "fresh output bytes of an in-place entry above "
                          "its declared budget"),
    # --- trace audit ----------------------------------------------------------
    "TRACE001": ("error", "one-time work, launches, RHS calls or syncs "
                          "beyond their pinned counts in a watched body"),
    # --- kernel audit ---------------------------------------------------------
    "KERN001": ("error", "kernel library spills registers to local memory"),
    "KERN002": ("error", "planned tile, chunk or cluster split does not "
                         "divide the extent it launches over, or a shape "
                         "routed to an instance whose preconditions it "
                         "breaks"),
    "KERN003": ("error", "shared memory of a planned launch above the "
                         "per-block opt-in limit"),
}


@dataclasses.dataclass
class Finding:
    """One rule violation pinned to a location."""

    rule: str
    message: str
    file: str = ""
    line: int = 0
    entrypoint: str = ""     # program findings: the registry entry
    suppressed: bool = False
    suppress_reason: str = ""

    @property
    def severity(self) -> str:
        return RULES.get(self.rule, ("error", ""))[0]

    @property
    def location(self) -> str:
        if self.file:
            return f"{self.file}:{self.line}" if self.line else self.file
        return self.entrypoint or "<program>"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "file": self.file,
            "line": self.line,
            "entrypoint": self.entrypoint,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclasses.dataclass
class Report:
    """All findings of one run, plus what each layer measured (sync counts,
    kernel resources, pinned counters) for the JSON artifact, clean or
    not."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def clean(self) -> bool:
        return not self.unsuppressed()

    def to_dict(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.unsuppressed():
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "schema_version": SCHEMA_VERSION,
            "clean": self.clean,
            "n_findings": len(self.unsuppressed()),
            "n_suppressed": sum(f.suppressed for f in self.findings),
            "findings_by_rule": by_rule,
            "findings": [f.to_dict() for f in self.findings],
            "meta": self.meta,
        }

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    def summary(self) -> str:
        """Human-readable digest: what `repro-torch-lint` prints."""
        lines = []
        live = self.unsuppressed()
        for f in sorted(live, key=lambda f: (f.rule, f.location)):
            lines.append(f"{f.severity.upper():7s} {f.rule} {f.location}: "
                         f"{f.message}")
        n_sup = sum(f.suppressed for f in self.findings)
        for f in (f for f in self.findings if f.suppressed):
            lines.append(f"supp.   {f.rule} {f.location}: "
                         f"{f.suppress_reason}")
        verdict = ("clean" if not live
                   else f"{len(live)} unsuppressed finding(s)")
        lines.append(f"repro-torch-lint: {verdict}"
                     + (f" ({n_sup} suppressed)" if n_sup else ""))
        return "\n".join(lines)
