"""Op audit: run each hot entry point under the recorder and check what its
ops do (the port's counterpart of `repro.analysis.jaxpr_audit`).

Rules
-----
OPS001  a float64 result of an op on device data.  The port never means
        float64 on the device: it doubles the bytes of everything
        downstream, and the card runs it at 1/64 of the float32 rate.
OPS002  dtype churn inside the declared bf16 interval: a state-sized
        float32 -> bfloat16 conversion whose input came from an
        elementwise op.  That shape of demote only appears when float32
        data (an operator matrix not cast, a float32 constant) promoted
        the bf16 carry and the result had to be demoted again, a full
        round trip per RK stage.  Demotes fed by reductions, products
        (`mm`, `bmm`, `addmm`, convolutions) and scans (`cumsum`) are
        exempt, as `_ACCUMULATING_PRIMS` is in the reference: they
        accumulate in float32 on purpose.  A kernel is one op
        (`dispatch.KERNELS`): its float32 math and final demote are
        inside it, as in the CUDA kernel.
OPS003  more host syncs of device data than the entry pins (0 unless the
        entry says why, `Built.sync_reason`).  With `device="cuda"` the
        entry runs again on the card under
        `torch.cuda.set_sync_debug_mode("warn")`, after a warm-up call,
        and the warnings are the card's count.  The card sees every
        device-to-host copy, which the CPU can only model; a card count
        other than the CPU's is an OPS003 finding of the audit itself.
OPS004  an entry declared in place (`Built.inplace`) that leaves a
        declared state tensor in new storage: its `data_ptr()` changed
        across the call, so the update landed in a copy.
OPS005  (warning) bytes of the entry's outputs in fresh storage (sharing
        no storage with the inputs or the declared state) above its
        budget `Built.max_fresh_mb`.

Each entry is called once to warm (caches, one-time tables, cuBLAS and
kernel loads) and then once under `dispatch.Recorder`, on the CPU at its
reduced shape.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten

from . import dispatch
from .entrypoints import ENTRYPOINTS, Built, EntryPoint
from .report import Finding, Report

# Demote producers that accumulate in float32 on purpose (reductions,
# products, scans): demoting their result to the carry dtype is the
# intended mixed-precision pattern, not churn.
_ACCUMULATING = frozenset(f"aten.{n}" for n in (
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot", "mv",
    "addmv", "convolution", "_convolution", "convolution_backward",
    "cudnn_convolution", "cumsum", "cumprod", "logcumsumexp",
))
_F64 = (torch.float64, torch.complex128)


def _leaves(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _ptrs(state: dict | None) -> dict[str, int]:
    return {k: t.data_ptr() for k, t in (state or {}).items()}


def _inplace_findings(built: Built, before: dict, out, add) -> None:
    """OPS004 / OPS005 for one call (`before`: the declared state's data
    pointers before it)."""
    if built.inplace is None:
        return
    after = _ptrs(built.inplace(out))
    moved = sorted(k for k, p in before.items() if after.get(k) != p)
    if moved:
        add("OPS004", f"{len(moved)} state tensor(s) declared in place "
                      f"left in new storage: {moved[:4]}")
    if built.max_fresh_mb is None:
        return
    held = {t.untyped_storage().data_ptr()
            for t in _leaves(built.args)}
    held |= {t.untyped_storage().data_ptr()
             for t in built.inplace(out).values()}
    fresh = sum(t.numel() * t.element_size() for t in _leaves(out)
                if t.untyped_storage().data_ptr() not in held)
    mb = fresh / 2**20
    if mb > built.max_fresh_mb:
        add("OPS005", f"{mb:.2f} MB of outputs in fresh storage (budget "
                      f"{built.max_fresh_mb} MB): an in-place update "
                      "became a copy?")


def _adder(entry: EntryPoint, findings: list):
    def add(rule: str, message: str, file: str = "", line: int = 0) -> None:
        reason = entry.suppress.get(rule, "")
        findings.append(Finding(
            rule=rule, message=message, file=file, line=line,
            entrypoint=entry.name, suppressed=bool(reason),
            suppress_reason=reason))
    return add


def _split_where(where: str) -> tuple[str, int]:
    file, _, line = where.rpartition(":")
    return (file, int(line)) if line.isdigit() else (where, 0)


def audit_entry(entry: EntryPoint, built: Built | None = None
                ) -> tuple[list[Finding], dict]:
    """All OPS* findings of one entry on the CPU (suppressions from
    `entry.suppress` applied), and what it counted."""
    built = built or entry.build(torch.device("cpu"))
    findings: list[Finding] = []
    add = _adder(entry, findings)
    built.fn(*built.args)          # warm
    before = _ptrs(built.inplace(None)) if built.inplace else {}
    with dispatch.Recorder(built.opaque) as rec:
        out = built.fn(*built.args)

    f64_hits = 0
    for op in rec.ops:
        if op.device and any(d in _F64 for d in op.out_dtypes) \
                and f64_hits < 5:
            f64_hits += 1
            add("OPS001", f"float64 result of `{op.name}`")
        if not built.bf16_interval or op.name not in (
                "aten._to_copy", "aten.copy_", "aten.to"):
            continue
        src = 1 if op.name == "aten.copy_" else 0
        if len(op.in_dtypes) <= src:
            continue
        prod = op.producers[src]
        if (op.in_dtypes[src] == torch.float32
                and torch.bfloat16 in (op.out_dtypes or op.in_dtypes[:1])
                and op.in_sizes[src] >= max(1, built.state_size // 4)
                and prod and prod not in _ACCUMULATING
                and not prod.startswith("kernel.")):
            add("OPS002",
                f"state-sized f32->bf16 demote (producer `{prod}`, "
                f"{op.in_sizes[src]} elems) inside the bf16 interval: "
                "float32 data is promoting the carry")

    n = len(rec.syncs)
    if n > built.syncs:
        file, line = _split_where(rec.syncs[0].where)
        add("OPS003",
            f"{n} host sync(s) of device data, pinned {built.syncs}: "
            + ", ".join(f"{s.op} at {s.where or '?'}"
                        for s in rec.syncs[:4]), file, line)
    _inplace_findings(built, before, out, add)
    return findings, {"syncs": n, "ops": len(rec.ops),
                      "sync_sites": sorted({s.where for s in rec.syncs})}


def _launch_counts() -> dict[str, int]:
    import importlib
    out = {}
    for mod, attr in dispatch.KERNELS:
        fn = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"),
                     attr)
        out[attr] = fn.launches
    return out


def card_syncs(entry: EntryPoint) -> tuple[list[Finding], dict]:
    """The entry on the card: a warm-up call, then one call under
    `set_sync_debug_mode("warn")`; returns OPS004/OPS005 findings and
    {"syncs": warnings counted, "launches": kernel launches of that
    call}."""
    findings: list[Finding] = []
    add = _adder(entry, findings)
    dev = torch.device("cuda", torch.cuda.current_device())
    built = entry.build(dev)
    built.fn(*built.args)          # warm
    torch.cuda.synchronize(dev)
    before = _ptrs(built.inplace(None)) if built.inplace else {}
    launches = _launch_counts()
    with dispatch.CardSyncs() as card:
        out = built.fn(*built.args)
    sites = list(card.sites)
    torch.cuda.synchronize(dev)
    after = _launch_counts()
    _inplace_findings(built, before, out, add)
    return findings, {"syncs": len(sites), "sync_sites": sites,
                      "launches": {k: after[k] - launches[k] for k in after
                                   if after[k] > launches[k]}}


def run(report: Report | None = None, names: tuple[str, ...] | None = None,
        device: str = "cuda") -> Report:
    """Audit every registered entry point (or the named subset) on the
    CPU, and on the card (`device="cuda"`, the default) each again, its
    sync count held to the CPU's; `device="cpu"` for the CPU alone."""
    dispatch.device_of(device)
    report = report or Report()
    audited, syncs, launches = [], {}, {}
    for entry in ENTRYPOINTS:
        if names and entry.name not in names:
            continue
        findings, meta = audit_entry(entry)
        report.extend(findings)
        audited.append(entry.name)
        syncs[entry.name] = {"cpu": meta["syncs"]}
        if meta["syncs"]:
            syncs[entry.name]["cpu_sites"] = meta["sync_sites"]
        if device != "cuda":
            continue
        card_findings, card = card_syncs(entry)
        report.extend(card_findings)
        syncs[entry.name]["card"] = card["syncs"]
        if card["syncs"]:
            syncs[entry.name]["card_sites"] = card["sync_sites"]
        launches[entry.name] = card["launches"]
        if card["syncs"] != meta["syncs"]:
            _adder(entry, report.findings)(
                "OPS003", f"the card counted {card['syncs']} host sync(s), "
                          f"the CPU audit {meta['syncs']}: the audit's model "
                          "of syncs misses what the card does here")
    out = report.meta.setdefault("op_audit", {})
    out["entrypoints"] = audited
    out["syncs"] = syncs
    if launches:
        out["launches"] = launches
    return report
