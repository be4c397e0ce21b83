"""Source lint: AST rules over the port's code (the counterpart of
`repro.analysis.ast_rules`; ids in `report.RULES`).

Scope: `src/repro_torch/`, `examples/torch_*.py` and `chip_smoke.py`.

AST001  `np.<fn>(...)` inside a function that takes a tensor (a parameter
        annotated `torch.Tensor`), or a closure nested in one, in a hot
        module.  On the card that is host math on the device path: a copy
        to the host and back.  Host table builders (no tensor parameter),
        `@property` config math and module-level tables are exempt.
AST002  Python `random` in a hot module: draws outside the explicit
        `torch.Generator`s break the bit-replayable checkpoint contract.
AST003  the global torch RNG in a hot module: `torch.manual_seed`, or a
        draw (`torch.rand`/`randn`/`randint`/`randperm`/`normal`/
        `bernoulli`/`multinomial`/`poisson`, `Tensor.uniform_`/`normal_`/
        ...) without `generator=`.  (The reference's float()-wrap rule has
        no counterpart: torch treats a numpy scalar as a weak Python
        scalar, which cannot promote a bf16 carry.)
AST004  `torch.float64`, `torch.double` or `.double()` in a hot module.
        Numpy host tables (`cfd/gll.py`, `spectra.py`) stay float64.
AST005  a kernel wrapper that hides its kernel (`kernels/*.py`): an
        `except` handler that calls a `*_plain` function or returns a
        result, or a read of an environment variable to choose a route
        (`_build.py`'s `CUDA_HOME`, the toolkit's location, is exempt).
AST006  `envs.make("<name>")` with a literal name missing from the
        port's registry.
AST007  a `# repro-torch-lint: disable=...` comment without a ` -- reason`.
AST008  an import of `jax`, `jaxlib` or `repro` (the JAX package; not
        `repro_torch`) anywhere in the scope.

Suppression: append `# repro-torch-lint: disable=AST001 -- <reason>` to
the offending line.  Several ids comma-separate; the reason is mandatory.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from .report import Finding, Report

# hot modules for AST001-AST004: the code that runs on the device path of
# the RL loop and its kernels.  Paths relative to the repo root.
HOT_PREFIXES = (
    "src/repro_torch/envs/",
    "src/repro_torch/cfd/",
    "src/repro_torch/kernels/",
    "src/repro_torch/fleet/",
    "src/repro_torch/optim/",
    "src/repro_torch/core/",
    "src/repro_torch/serve/",
)
# host-side orchestration inside those packages (the reference's
# exclusions, then the port's own host-only modules)
HOT_EXCLUDES = (
    "src/repro_torch/core/runner.py",      # checkpoint/metrics host loop
    "src/repro_torch/core/elastic.py",     # host-side pool management
    "src/repro_torch/fleet/pipeline.py",   # host loop around the programs
    "src/repro_torch/fleet/scheduler.py",  # schedule built once on the host
    "src/repro_torch/serve/batcher.py",    # host-side request queues
    "src/repro_torch/serve/loader.py",     # checkpoint restore on the host
    "src/repro_torch/kernels/_build.py",   # nvcc and ctypes, host only
    "src/repro_torch/core/checkpoints.py",  # file I/O on the host
)
KERNEL_PREFIX = "src/repro_torch/kernels/"

_SUPPRESS_RE = re.compile(
    r"#\s*repro-torch-lint:\s*disable=([A-Z0-9,\s]+?)(?:\s*--\s*(.*\S))?\s*$")

# torch functions that draw from the global generator unless handed one
_RNG_FUNCS = frozenset({"rand", "randn", "randint", "randperm", "normal",
                        "bernoulli", "multinomial", "poisson"})
# in-place draws on a tensor
_RNG_METHODS = frozenset({"uniform_", "normal_", "bernoulli_", "random_",
                          "exponential_", "cauchy_", "log_normal_",
                          "geometric_"})
# draws that take no generator at all
_RNG_ALWAYS_GLOBAL = frozenset({"rand_like", "randn_like", "randint_like",
                                "manual_seed", "seed"})
_FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")


def _suppressions(src: str) -> tuple[dict[int, tuple[set, str]], list]:
    """line -> (rule ids, reason); plus AST007 findings for missing reasons."""
    out: dict[int, tuple[set, str]] = {}
    bad: list[tuple[int, str]] = []
    for i, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        if not reason:
            bad.append((i, ", ".join(sorted(rules))))
        out[i] = (rules, reason)
    return out, bad


def _module_aliases(tree: ast.Module, module: str) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    names.add(a.asname or module)
    return names


def _takes_tensor(node) -> bool:
    """The port's device-function convention: >= 1 parameter annotated
    with torch.Tensor (or a bare `Tensor`)."""
    args = node.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is None:
            continue
        txt = ast.unparse(a.annotation)
        if "torch.Tensor" in txt or re.search(r"\bTensor\b", txt):
            return True
    return False


def _forbidden(module: str | None) -> bool:
    if not module:
        return False
    top = module.split(".")[0]
    return top in _FORBIDDEN_IMPORTS


def _is_plain_call(node: ast.AST) -> bool:
    """A call of a `*_plain` function (a kernel's plain version)."""
    return any(isinstance(n, ast.Call)
               and ((isinstance(n.func, ast.Name)
                     and n.func.id.endswith("_plain"))
                    or (isinstance(n.func, ast.Attribute)
                        and n.func.attr.endswith("_plain")))
               for n in ast.walk(node))


def _env_key(node: ast.AST) -> str | None:
    """The literal key of `os.environ[...]` / `os.environ.get(...)` /
    `os.getenv(...)`, "" for a non-literal key, None if not an env read."""
    def lit(x):
        return x.value if isinstance(x, ast.Constant) and isinstance(
            x.value, str) else ""

    if isinstance(node, ast.Subscript):
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "environ":
            return lit(node.slice)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        f = node.func
        if (f.attr in ("get", "pop") and isinstance(f.value, ast.Attribute)
                and f.value.attr == "environ"):
            return lit(node.args[0]) if node.args else ""
        if f.attr == "getenv":
            return lit(node.args[0]) if node.args else ""
    return None


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module, *, hot: bool,
                 kernel_module: bool, registry_names: frozenset[str]):
        self.path = path
        self.hot = hot
        self.kernel_module = kernel_module
        self.registry = registry_names
        self.np_names = _module_aliases(tree, "numpy")
        self.torch_names = _module_aliases(tree, "torch")
        self.findings: list[Finding] = []
        self._prop_depth = 0
        self._tensor_stack: list[bool] = []

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, message=message, file=self.path,
            line=getattr(node, "lineno", 0)))

    # --- function context ----------------------------------------------------
    def _visit_fn(self, node) -> None:
        is_prop = any(
            (isinstance(d, ast.Name) and d.id in ("property",
                                                  "cached_property"))
            or (isinstance(d, ast.Attribute) and d.attr == "cached_property")
            for d in node.decorator_list)
        self._prop_depth += is_prop
        self._tensor_stack.append(_takes_tensor(node))
        self.generic_visit(node)
        self._tensor_stack.pop()
        self._prop_depth -= is_prop

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    @property
    def _in_device_body(self) -> bool:
        """Inside a function that takes a tensor (or a closure nested in
        one) and is not config-time `@property` math."""
        return (self.hot and any(self._tensor_stack)
                and self._prop_depth == 0)

    # --- calls ---------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        base = (f.value.id if isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name) else None)
        if self._in_device_body and base in self.np_names:
            self.add("AST001", node,
                     f"`{base}.{f.attr}(...)` in a function that takes a "
                     "tensor, in a hot module: host math on the device "
                     "path; use torch, or hoist the table and cache it "
                     "on the device")
        if self._in_device_body and base == "random":
            self.add("AST002", node,
                     f"`random.{f.attr}(...)` in a hot module: draw from "
                     "an explicit torch.Generator")
        if self.hot and isinstance(f, ast.Attribute):
            kw = {k.arg for k in node.keywords}
            if base in self.torch_names and (
                    f.attr in _RNG_ALWAYS_GLOBAL
                    or (f.attr in _RNG_FUNCS and "generator" not in kw)):
                self.add("AST003", node,
                         f"`{base}.{f.attr}(...)` uses the global torch "
                         "RNG: pass generator= (an explicit "
                         "torch.Generator)")
            elif (f.attr in _RNG_METHODS and base not in self.torch_names
                    and "generator" not in kw):
                self.add("AST003", node,
                         f"`.{f.attr}(...)` without generator= draws from "
                         "the global torch RNG")
            elif (self.hot and f.attr == "double" and not node.args
                    and base not in self.np_names):
                self.add("AST004", node, "`.double()` in a hot module: "
                                         "float64 on the device path")
        if (isinstance(f, ast.Attribute) and f.attr == "make"
                and base in ("envs", "registry")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and self.registry
                and node.args[0].value not in self.registry):
            self.add("AST006", node,
                     f"envs.make({node.args[0].value!r}): not a registered "
                     "scenario name")
        self._check_env_read(node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self._check_env_read(node)
        self.generic_visit(node)

    def _check_env_read(self, node: ast.AST) -> None:
        if not self.kernel_module:
            return
        key = _env_key(node)
        if key is not None and key != "CUDA_HOME":
            self.add("AST005", node,
                     f"environment variable {key or '<expr>'!r} read in a "
                     "kernel module: the route is chosen by the tensor's "
                     "device and the config, never by the environment")

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self.kernel_module:
            body = ast.Module(body=node.body, type_ignores=[])
            returns = any(isinstance(n, ast.Return) and n.value is not None
                          for n in ast.walk(body))
            if _is_plain_call(body) or returns:
                self.add("AST005", node,
                         "an except handler in a kernel wrapper that "
                         + ("falls back to the plain version"
                            if _is_plain_call(body) else "returns a result")
                         + ": a failed launch must raise")
        self.generic_visit(node)

    # --- imports ---------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if self.hot and a.name == "random":
                self.add("AST002", node, "`import random` in a hot module: "
                                         "draw from a torch.Generator")
            if _forbidden(a.name):
                self.add("AST008", node, f"`import {a.name}`: the port "
                                         "imports neither jax nor repro")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if self.hot and node.module == "random" and not node.level:
            self.add("AST002", node, "`from random import ...` in a hot "
                                     "module: draw from a torch.Generator")
        if not node.level and _forbidden(node.module):
            self.add("AST008", node, f"`from {node.module} import ...`: the "
                                     "port imports neither jax nor repro")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (self.hot and node.attr in ("float64", "double")
                and isinstance(node.value, ast.Name)
                and node.value.id in self.torch_names):
            self.add("AST004", node, f"torch.{node.attr} in a hot module: "
                                     "float64 on the device path")
        self.generic_visit(node)


def _registry_names() -> frozenset[str]:
    from .. import envs
    return frozenset(envs.registered())


def is_hot(rel: str) -> bool:
    return (any(rel.startswith(p) or f"/{p}" in rel for p in HOT_PREFIXES)
            and not any(rel.endswith(e) for e in HOT_EXCLUDES))


def lint_source(path: str, src: str, *, hot: bool | None = None,
                kernel_module: bool | None = None,
                registry_names: frozenset[str] | None = None
                ) -> list[Finding]:
    """All AST findings for one file (suppressions applied)."""
    rel = path.replace(os.sep, "/")
    if hot is None:
        hot = is_hot(rel)
    if kernel_module is None:
        kernel_module = KERNEL_PREFIX in rel
    tree = ast.parse(src, filename=path)
    lint = _FileLint(path, tree, hot=hot, kernel_module=kernel_module,
                     registry_names=(_registry_names()
                                     if registry_names is None
                                     else registry_names))
    lint.visit(tree)

    supp, missing_reason = _suppressions(src)
    for line, rules in missing_reason:
        lint.findings.append(Finding(
            rule="AST007", file=path, line=line,
            message=f"suppression of {rules} has no ` -- reason`"))
    for f in lint.findings:
        rules, reason = supp.get(f.line, (set(), ""))
        if f.rule in rules and reason:
            f.suppressed, f.suppress_reason = True, reason
    return lint.findings


def iter_python_files(root: str) -> Iterable[str]:
    """The lint scope: the port's package, its examples, chip_smoke.py."""
    top = os.path.join(root, "src", "repro_torch")
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    examples = os.path.join(root, "examples")
    if os.path.isdir(examples):
        for fn in sorted(os.listdir(examples)):
            if fn.startswith("torch_") and fn.endswith(".py"):
                yield os.path.join(examples, fn)
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        yield smoke


def run(report: Report | None = None, root: str = ".") -> Report:
    report = report or Report()
    names = _registry_names()
    n_files = 0
    for path in iter_python_files(root):
        with open(path) as fh:
            src = fh.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        report.extend(lint_source(rel, src, registry_names=names))
        n_files += 1
    report.meta.setdefault("ast_rules", {})["files_scanned"] = n_files
    return report
