"""Kernel audit: the wrappers' launch plans, and on the card what each
built library uses (the port's counterpart of
`repro.analysis.kernel_audit`).

One case per ported kernel (`_kernel_cases`: the reference's six, and the
second instance of each kernel that has two).  A case calls the wrapper's
own host-side plan at the main path's shapes and at the parity phase's
corners and returns the launches it plans (`Launch`):

KERN001  (card) a library that spills registers to local memory: nvcc's
         `-Xptxas -v` spill counts where this process built it
         (`_build.build_logs`), else the local memory that
         `cuobjdump --dump-resource-usage` reports.  A spill is traffic
         to device memory on every launch that nobody asked for.
KERN002  a planned split (a tile, a chunk, a cluster's CTAs, a channel
         piece) that does not divide the extent it launches over, or a
         shape routed to an instance whose preconditions it breaks.
KERN003  dynamic plus static shared memory of a planned launch above the
         per-block opt-in limit.  On the CPU the dynamic part is the
         wrapper's own host-side plan where it has one (`rhs.cluster_plan`,
         `dg_derivative.tiled_smem_bytes`/`generic_smem_bytes`,
         `linear_scan.ChunkPlan.smem_bytes`), static shared memory is
         unknown (0) and the limit is `_build.SMEM_OPTIN_BYTES`.  On the
         card the dynamic part is the library's own number (each source
         exports a `*_smem_bytes` function built from the helpers its
         launch sizes itself with), a plan that differs from it is a
         finding, the static part is the library's and the limit the
         card's own (`shared_memory_per_block_optin`); a constant that
         differs from the card's limit is a finding too.

The card part needs `cuobjdump` beside `nvcc`; without it the audit
raises, it does not skip.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re
import subprocess
from typing import Callable

import torch

from ..kernels import _build
from .dispatch import device_of
from .report import Finding, Report


@dataclasses.dataclass
class Launch:
    """One launch a wrapper plans."""

    label: str
    source: str                    # csrc/ file of the instance
    smem: int | None = None        # the host plan's dynamic shared memory
    splits: tuple = ()             # (what, part, extent): part | extent
    checks: tuple = ()             # (precondition, holds)
    # the library's function that gives the launch's dynamic shared
    # memory, and its arguments; None: the launch asks for none
    card: tuple[str, tuple] | None = None
    bound: bool = False            # `smem` bounds the card's, not equals


# --- the cases ------------------------------------------------------------
def _fused_rhs(instance: str) -> list[Launch]:
    from ..configs import relexi_hit
    from ..kernels import rhs

    meshes = {(c.n_elem,) * 3 + (c.n_poly + 1,)
              for c in (relexi_hit.HIT24, relexi_hit.HIT32)}
    # the parity corners: the 24- and 32-DOF meshes at n = 2..8, the
    # reduced mesh, a non-cubic mesh, and meshes too large for a cluster
    for k in {m[0] for m in meshes}:
        meshes |= {(k, k, k, n) for n in range(2, rhs.N_MAX + 1)}
    meshes |= {(2, 2, 2, 4), (2, 3, 4, 4), (8, 8, 8, 8), (6, 6, 6, 8)}
    out = []
    for kx, ky, kz, n in sorted(meshes):
        for dtype in (torch.float32, torch.bfloat16):
            shape = (1, kx, ky, kz, n, n, n, 5)
            kind = rhs.pick_instance(shape, dtype)
            if kind != instance:
                continue
            label = f"{kx}x{ky}x{kz} n={n} {str(dtype)[6:]}"
            checks = (("2 <= n <= N_MAX", 2 <= n <= rhs.N_MAX),)
            if kind == "two_pass":
                out.append(Launch(label, rhs.SOURCES[kind], smem=0,
                                  checks=checks))
                continue
            plan = rhs.cluster_plan(kx, ky, kz, n, dtype)
            elems = kx * ky * kz // plan.ctas
            nodes = elems * n**3
            out.append(Launch(
                label, rhs.SOURCES[kind], smem=plan.smem_bytes,
                card=("ns_rhs_cluster_smem_bytes", (n, elems)),
                splits=(("px", plan.px, kx), ("py", plan.py, ky),
                        ("pz", plan.pz, kz), ("warp", 32, plan.threads)),
                checks=checks + (
                    ("CTAs <= MAX_CTAS", plan.ctas <= rhs.MAX_CTAS),
                    ("threads cover the nodes or MAX_THREADS",
                     plan.threads == min(rhs.MAX_THREADS,
                                         32 * -(-nodes // 32))),
                    ("smem_bytes == cluster_smem_bytes",
                     plan.smem_bytes == rhs.cluster_smem_bytes(n, elems)))))
    return out


def _dg_derivative3(instance: str) -> list[Launch]:
    from ..kernels import dg_derivative as dg

    shapes = {(n, c) for n in range(2, 10) for c in (1, 2, 3, 4, 5)}
    shapes |= {(4, 4), (6, 4), (8, 4), (8, 64)}   # the channel, HIT, 32-DOF
    out = []
    for n, c in sorted(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            kind = dg.pick_instance(n, c, dtype)
            if kind != instance:
                continue
            label = f"n={n} C={c} {str(dtype)[6:]}"
            is_bf16 = int(dtype == torch.bfloat16)
            if kind == "tiled":
                v = 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1
                out.append(Launch(
                    label, dg.SOURCES[kind],
                    smem=dg.tiled_smem_bytes(n, c, dtype.itemsize),
                    card=("dg_derivative3_tiled_smem_bytes", (n, c, is_bf16)),
                    splits=(("channel piece V", v, c),),
                    checks=(("n in TILED_N", n in dg.TILED_N),
                            ("C <= TILED_MAX_C", c <= dg.TILED_MAX_C))))
            else:
                out.append(Launch(
                    label, dg.SOURCES[kind],
                    smem=dg.generic_smem_bytes(n, c),
                    card=("dg_derivative3_smem_bytes", (n, c))))
    return out


def _smagorinsky_nut() -> list[Launch]:
    from ..kernels import smagorinsky

    out = []
    for p in (36_864, 1_007, 1):
        grad = torch.zeros((p, 4, 3))[:, 0:3, :]  # the channel's rows view
        cs = torch.zeros((p,))
        for label, g, c in ((f"P={p} rows view", grad, cs),
                            (f"P={p} stride-0 cs", grad.contiguous(),
                             torch.zeros(()).expand(p))):
            try:
                smagorinsky._check_inputs(g, c)
                ok = True
            except (TypeError, ValueError):
                ok = False
            for is_bf16 in (0, 1):   # a staged block, the most it asks for
                out.append(Launch(
                    f"{label} {('float32', 'bfloat16')[is_bf16]}",
                    smagorinsky._SOURCE,
                    card=("smagorinsky_smem_bytes", (g.stride(0), is_bf16)),
                    checks=(("the wrapper takes the view", ok),)))
    return out


def _wall_model_tau() -> list[Launch]:
    from ..kernels import wall_model

    out = []
    for shape in ((2, 8, 3, 3, 4, 4), (2, 2, 2, 4, 4), (2,)):
        try:
            wall_model._check_inputs(torch.ones(shape), torch.ones(shape))
            ok = True
        except (TypeError, ValueError):
            ok = False
        out.append(Launch(f"{shape}", wall_model._SOURCE, smem=0,
                          checks=(("the wrapper takes both walls", ok),)))
    return out


def _flash_attention(instance: str) -> list[Launch]:
    from ..kernels import flash_attention as fa

    out = []
    for d in (16, 64, 80, 128, 200, 256):
        dp = fa.padded_head_dim(d)
        if instance == "tensor_core":
            bq, bk = fa.TC_TILES[dp]
            out.append(Launch(
                f"D={d} (tile D {dp})", fa.SOURCES[instance],
                card=("flash_attention_tc_smem_bytes", (d,)),
                splits=(("query rows of a warpgroup", 64, bq),
                        ("wgmma K step", 16, dp), ("wgmma N step", 8, bk)),
                checks=(("bf16 -> tensor_core",
                         fa.instance(torch.bfloat16) == instance),
                        ("head dim fits its tile", d <= dp))))
        else:
            out.append(Launch(
                f"D={d} (tile D {dp})", fa.SOURCES[instance],
                card=("flash_attention_smem_bytes", (d,)),
                splits=(("float4 column groups", 64, dp),),
                checks=(("float32 -> cuda_core",
                         fa.instance(torch.float32) == instance),)))
    return out


def _linear_scan(instance: str) -> list[Launch]:
    from ..kernels import linear_scan as ls

    out = []
    for dk, dv in ((16, 64), (64, 64), (8, 4), (32, 16), (64, 128),
                   (128, 64)):
        for t in (1, 63, 64, 700, 2048):
            kind = ls.pick_instance(t, dk)
            if kind != instance:
                continue
            label = f"T={t} dk={dk} dv={dv}"
            want = ("chunked" if t >= ls.CHUNKED_MAX_CHUNK
                    and dk <= ls.CHUNKED_MAX_DK else "step")
            checks = (("routed by T and dk", kind == want),)
            if kind == "step":
                out.append(Launch(
                    label, ls.SOURCES[kind],
                    card=("linear_scan_smem_bytes", (t, dk, dv)),
                    checks=checks + (("dk <= 512", dk <= 512),)))
                continue
            plan = ls.chunked_plan(dk, dv)
            dkp = plan.groups * ls.CHUNKED_ROWS
            # the card's number for bf16 q, k, w and float32 v, the dtypes
            # whose tiles take the most
            out.append(Launch(
                label, ls.SOURCES[kind], smem=plan.smem_bytes, bound=True,
                card=("linear_scan_chunked_smem_bytes", (dk, dv, 1, 1, 0, 1)),
                splits=(("chunk", plan.chunk, ls.CHUNKED_MAX_CHUNK),
                        ("warp", 32, plan.groups * plan.cols)),
                checks=checks + (
                    ("threads <= 256",
                     plan.groups * plan.cols <= ls.CHUNKED_MAX_THREADS),
                    ("lanes cover dk", dkp >= dk))))
    return out


def _kernel_cases() -> dict[str, Callable[[], list[Launch]]]:
    """case name -> the launches its wrapper plans; the reference's six
    names, then the second instances."""
    return {
        "dg_derivative3": lambda: _dg_derivative3("tiled"),
        "smagorinsky_nut": _smagorinsky_nut,
        "wall_model_tau": _wall_model_tau,
        "fused_rhs": lambda: _fused_rhs("cluster"),
        "flash_attention": lambda: _flash_attention("tensor_core"),
        "linear_scan": lambda: _linear_scan("chunked"),
        "dg_derivative3.generic": lambda: _dg_derivative3("generic"),
        "fused_rhs.two_pass": lambda: _fused_rhs("two_pass"),
        "flash_attention.cuda_core": lambda: _flash_attention("cuda_core"),
        "linear_scan.step": lambda: _linear_scan("step"),
    }


def audit_launches(name: str, launches: list[Launch], *,
                   limit: int = _build.SMEM_OPTIN_BYTES,
                   static: dict[str, int] | None = None,
                   carved: Callable[[Launch], int] | None = None
                   ) -> tuple[list[Finding], dict]:
    """KERN002 / KERN003 findings for one case's planned launches, and
    {"launches": n, "max_smem": bytes}.  `carved` (the card) gives a
    launch's dynamic shared memory from its library (`library_smem`)."""
    findings: list[Finding] = []
    most = 0
    for ln in launches:
        for what, part, extent in ln.splits:
            if part <= 0 or extent % part:
                findings.append(Finding(
                    rule="KERN002", entrypoint=name,
                    message=f"{ln.label}: {what} {part} does not divide "
                            f"{extent}"))
        for what, holds in ln.checks:
            if not holds:
                findings.append(Finding(
                    rule="KERN002", entrypoint=name,
                    message=f"{ln.label}: routed to {ln.source}, whose "
                            f"precondition fails: {what}"))
        dynamic = ln.smem or 0
        if carved is not None and ln.card is not None:
            dynamic = carved(ln)
            if ln.smem is not None and (dynamic > ln.smem if ln.bound
                                        else dynamic != ln.smem):
                findings.append(Finding(
                    rule="KERN003", entrypoint=name,
                    message=f"{ln.label}: the launch asks for {dynamic} "
                            f"bytes of shared memory, its wrapper's plan "
                            f"{'at most ' if ln.bound else ''}{ln.smem}"))
        total = dynamic + (static or {}).get(ln.source, 0)
        most = max(most, total)
        if total > limit:
            findings.append(Finding(
                rule="KERN003", entrypoint=name,
                message=f"{ln.label}: {total} bytes of shared memory "
                        f"({dynamic} dynamic) above the {limit}-byte "
                        "per-block limit"))
    return findings, {"launches": len(launches), "max_smem": most}


# --- the card ---------------------------------------------------------------
def parse_resource_usage(text: str) -> dict[str, dict[str, int]]:
    """Per function: registers, static shared memory, stack, local memory
    and spills, from `cuobjdump --dump-resource-usage` or from nvcc's
    `-Xptxas -v` (whichever `text` is)."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        line = line.strip()
        m = re.match(r"Function (\S+?):?$", line)
        m = m or re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        rec = out[name]
        if line.startswith("REG:"):         # cuobjdump
            fields = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
            rec.update(registers=int(fields.get("REG", 0)),
                       shared=int(fields.get("SHARED", 0)),
                       stack=int(fields.get("STACK", 0)),
                       local=int(fields.get("LOCAL", 0)))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:                                # ptxas
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rec["shared"] = int(s.group(1)) if s else 0
    return {k: v for k, v in out.items() if v}


def spills(rec: dict[str, int]) -> int:
    """Spilled bytes of one function: ptxas's spill stores and loads where
    the record has them, else its local memory."""
    if "spill_stores" in rec:
        return rec["spill_stores"] + rec.get("spill_loads", 0)
    return rec.get("local", 0)


def _cuobjdump() -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path}): the "
                           "kernel audit's card part needs it")
    return path


def all_sources() -> tuple[str, ...]:
    from ..kernels import (dg_derivative, flash_attention, linear_scan, rhs,
                           smagorinsky, wall_model)
    return (*rhs.SOURCES.values(), *dg_derivative.SOURCES.values(),
            smagorinsky._SOURCE, wall_model._SOURCE,
            *flash_attention.SOURCES.values(), *linear_scan.SOURCES.values())


def library_resources(source: str) -> dict:
    """One built library: its functions' resource records (cuobjdump, with
    ptxas's spill counts where this process built it) and their maxima."""
    text = subprocess.run(
        [_cuobjdump(), "--dump-resource-usage",
         str(_build.library_path(source))],
        capture_output=True, text=True, check=True).stdout
    funcs = parse_resource_usage(text)
    for name, rec in parse_resource_usage(
            _build.build_logs.get(source, "")).items():
        if name in funcs and "spill_stores" in rec:
            funcs[name].update(spill_stores=rec["spill_stores"],
                               spill_loads=rec["spill_loads"])
    if not funcs:
        raise RuntimeError(f"cuobjdump reported no function for {source}")
    return summarize(funcs)


def summarize(funcs: dict[str, dict[str, int]]) -> dict:
    """A library's functions -> their count, the most registers, static
    shared memory and stack of any, the spilled bytes of all, and the
    functions that spill."""
    return {"functions": len(funcs),
            "registers": max(r.get("registers", 0) for r in funcs.values()),
            "shared": max(r.get("shared", 0) for r in funcs.values()),
            "stack": max(r.get("stack", 0) for r in funcs.values()),
            "spills": sum(spills(r) for r in funcs.values()),
            "spilling": sorted(n for n, r in funcs.items() if spills(r))}


# Spills measured and kept, by (source, a part of the function's mangled
# name): each goes away with `__launch_bounds__(threads, 1)`, which lets
# ptxas pass the register count it chose (128 and 64), but that halves the
# blocks a SM holds, and both spill-free builds ran slower than the
# spilling ones on an H100 80GB HBM3 at 700 W (two chip_smoke runs, one of
# each build; PERF.md section 6).
KEPT_SPILLS = {
    ("linear_scan.cu", "linear_scan_kernelILb1ELb1E"):
        "24 B of spill stores at 128 registers; spill-free at 142 "
        "registers the decode step took 0.0053987 ms, with the spills "
        "0.0035525",
    ("ns_rhs.cu", "div_pass"):
        "20 B (float32) and 8 B (bf16) of spill stores at 64 registers; "
        "spill-free at 72 the two-pass RHS took 0.1485511 ms (float32) "
        "and 0.1449789 (bf16) at 32-DOF B = 16, with the spills 0.0842651 "
        "and 0.1089864 (at 24-DOF 0.0510521 and 0.0516512 float32)",
}


def _kept(source: str, function: str) -> str:
    return next((why for (src, part), why in KEPT_SPILLS.items()
                 if src == source and part in function), "")


def resource_findings(libs: dict[str, dict]) -> list[Finding]:
    """KERN001 for each library (source -> `summarize`d record) with a
    spilling function, and one suppressed KERN001 for each spill kept
    (`KEPT_SPILLS`)."""
    findings = []
    for source, r in libs.items():
        fresh = [f for f in r["spilling"] if not _kept(source, f)]
        if fresh:
            findings.append(Finding(
                rule="KERN001", entrypoint=source,
                message=f"spills in {fresh[:3]} ({r['spills']} bytes in "
                        "the library)"))
        findings.extend(
            Finding(rule="KERN001", entrypoint=source,
                    message=f"spills in {f}", suppressed=True,
                    suppress_reason=_kept(source, f))
            for f in r["spilling"] if _kept(source, f))
    return findings


def library_smem(ln: Launch) -> int:
    """A launch's dynamic shared memory from its own library: the source's
    exported `*_smem_bytes` function, built from the helpers its launch
    sizes itself with."""
    fn, args = ln.card
    got = getattr(_build.load(ln.source), fn)(*args)
    if got < 0:
        raise RuntimeError(f"{ln.source}: {fn}{args} refused the shape of "
                           f"the launch {ln.label}")
    return got


def card_smem_limit() -> int:
    """The card's per-block opt-in shared memory."""
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).shared_memory_per_block_optin)


def run(report: Report | None = None, device: str = "cuda") -> Report:
    """Every case's planned launches; on the card (`device="cuda"`, the
    default) with each library's resources and shared memory, the card's
    limit; `device="cpu"` for the host plans alone."""
    device_of(device)
    report = report or Report()
    limit, static = _build.SMEM_OPTIN_BYTES, None
    meta: dict = {"smem_limit": limit}
    if device == "cuda":
        sources = all_sources()
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        libs = {s: library_resources(s) for s in sources}
        static = {s: r["shared"] for s, r in libs.items()}
        limit = card_smem_limit()
        meta.update(smem_limit=limit, libraries=libs)
        if limit != _build.SMEM_OPTIN_BYTES:
            report.findings.append(Finding(
                rule="KERN003", entrypoint="_build.SMEM_OPTIN_BYTES",
                message=f"the plans' limit {_build.SMEM_OPTIN_BYTES} bytes "
                        f"differs from the card's opt-in {limit}"))
        report.extend(resource_findings(libs))
    stats = {}
    for name, build in _kernel_cases().items():
        findings, stats[name] = audit_launches(
            name, build(), limit=limit, static=static,
            carved=library_smem if device == "cuda" else None)
        report.extend(findings)
    meta["kernels"] = stats
    report.meta.setdefault("kernel_audit", {}).update(meta)
    return report
