"""Red-team tests for the port's static-analysis gate
(`repro_torch.analysis`), and its parity with the JAX package's
(`repro.analysis`).

Every rule id in the port's `report.RULES` is exercised against
deliberately violating code (and, where the reference has one, its clean
twin); the repo itself is pinned at zero unsuppressed findings; the rules
the two gates share give the same findings on the same source; the
`cuda`-marked tests hold the CPU's sync count to the card's and read the
built libraries' resources.
"""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro.analysis import ast_rules as jast
from repro.analysis import entrypoints as jentry
from repro.analysis import kernel_audit as jkern
from repro.analysis import report as jreport
from repro_torch import envs as tenvs
from repro_torch.analysis import (ast_rules, cli, dispatch, entrypoints,
                                  kernel_audit, op_audit, trace_audit)
from repro_torch.analysis.entrypoints import Built, EntryPoint
from repro_torch.analysis.kernel_audit import Launch
from repro_torch.analysis.report import (RULES, SCHEMA_VERSION, Finding,
                                         Report)
from repro_torch.kernels import _build


def _rules(findings):
    return {f.rule for f in findings}


def _lint(src, **kw):
    kw.setdefault("hot", True)
    kw.setdefault("kernel_module", False)
    kw.setdefault("registry_names", frozenset({"good_env"}))
    return ast_rules.lint_source("fixture.py", src, **kw)


# --- source lint ----------------------------------------------------------
def test_ast001_numpy_in_a_function_that_takes_a_tensor():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def step(u: torch.Tensor):\n"
        "    return np.tanh(u)\n"
    )
    assert _rules(_lint(src)) == {"AST001"}


def test_ast001_exempt_host_table_builders_and_properties():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "TABLE = np.arange(4)\n"                     # module-level table
        "def table(cfg) -> np.ndarray:\n"           # no tensor parameter
        "    return np.arange(cfg.n)\n"
        "class C:\n"
        "    @property\n"
        "    def n_dof(self, u: torch.Tensor):\n"    # property math
        "        return np.prod(self.shape)\n"
    )
    assert _lint(src) == []


def test_ast001_silent_in_cold_modules():
    src = ("import numpy as np\nimport torch\n"
           "def f(u: torch.Tensor):\n    return np.abs(u)\n")
    assert _lint(src, hot=False) == []


def test_ast002_python_random():
    src = (
        "import random\n"
        "import torch\n"
        "def draw(u: torch.Tensor):\n"
        "    return random.random() + u\n"
    )
    assert _rules(_lint(src)) == {"AST002"}


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)",
    "torch.randn((3,))",
    "torch.randint(0, 4, (3,))",
    "torch.rand_like(u)",
    "u.normal_()",
    "u.uniform_(0.0, 1.0)",
])
def test_ast003_global_torch_rng(call):
    src = ("import torch\n"
           "def draw(u: torch.Tensor):\n"
           f"    return {call}\n")
    assert _rules(_lint(src)) == {"AST003"}


def test_ast003_explicit_generator_is_clean():
    src = ("import torch\n"
           "def draw(u: torch.Tensor, gen: torch.Generator):\n"
           "    a = torch.randn((3,), generator=gen, device=u.device)\n"
           "    return a + u.normal_(generator=gen)\n")
    assert _lint(src) == []
    assert _lint("import torch\ntorch.manual_seed(0)\n", hot=False) == []


@pytest.mark.parametrize("expr", ["torch.float64", "torch.double",
                                  "u.double()"])
def test_ast004_float64_in_a_hot_module(expr):
    src = f"import torch\ndef f(u: torch.Tensor):\n    return {expr}\n"
    assert _rules(_lint(src)) == {"AST004"}


def test_ast004_numpy_host_tables_stay_float64():
    src = ("import numpy as np\n"
           "W = np.zeros(4, dtype=np.float64)\n"
           "def table(n: int) -> np.ndarray:\n"
           "    return np.arange(n, dtype=np.float64)\n")
    assert _lint(src) == []


@pytest.mark.parametrize("body", [
    "    try:\n        return launch(u)\n"
    "    except RuntimeError:\n        return thing_plain(u)\n",
    "    try:\n        return launch(u)\n"
    "    except RuntimeError:\n        return u\n",
    "    if os.environ.get('REPRO_KERNELS') == 'ref':\n"
    "        return u\n    return launch(u)\n",
    "    if os.getenv('USE_PLAIN'):\n        return u\n    return launch(u)\n",
])
def test_ast005_kernel_wrapper_hides_its_kernel(body):
    src = f"import os\ndef thing(u):\n{body}"
    assert _rules(_lint(src, kernel_module=True)) == {"AST005"}
    assert _lint(src, kernel_module=False) == []


def test_ast005_raising_wrapper_and_cuda_home_are_clean():
    src = ("import os\n"
           "NVCC = os.environ.get('CUDA_HOME', '/usr/local/cuda')\n"
           "def thing(u):\n"
           "    try:\n        return launch(u)\n"
           "    except KeyError as e:\n"
           "        raise RuntimeError('launch failed') from e\n")
    assert _lint(src, kernel_module=True) == []


def test_ast006_unregistered_env_name():
    src = "from repro_torch import envs\nenv = envs.make('not_a_scenario')\n"
    assert _rules(_lint(src)) == {"AST006"}
    assert _lint("from repro_torch import envs\n"
                 "env = envs.make('good_env')\n") == []


def test_ast007_suppression_requires_reason():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def step(u: torch.Tensor):\n"
        "    return np.tanh(u)  # repro-torch-lint: disable=AST001\n"
    )
    rules = _rules(_lint(src))
    assert "AST007" in rules          # a reasonless suppression is a finding
    assert "AST001" in rules          # ...and does not suppress


def test_suppression_with_reason_suppresses():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def step(u: torch.Tensor):\n"
        "    return np.tanh(u)  # repro-torch-lint: disable=AST001 -- table\n"
    )
    findings = _lint(src)
    assert [f.rule for f in findings] == ["AST001"]
    assert findings[0].suppressed and findings[0].suppress_reason == "table"


@pytest.mark.parametrize("line", ["import jax", "import jax.numpy as jnp",
                                  "from jaxlib import xla_client",
                                  "import repro.cfd",
                                  "from repro import envs",
                                  "from repro.analysis import report"])
def test_ast008_jax_or_repro_import(line):
    findings = _lint(line + "\n", hot=False)
    assert _rules(findings) == {"AST008"}


def test_ast008_the_port_and_relative_imports_are_clean():
    src = ("import repro_torch\nfrom repro_torch import envs\n"
           "from . import report\nfrom ..cfd import solver\n"
           "import reprolib\n")
    assert _lint(src, hot=False) == []


# --- parity with the reference's source lint ------------------------------
_SHARED_FIXTURE = (
    "import random\n"
    "import torch\n"
    "import jax\n"
    "from repro_torch import envs\n"
    "def draw(u: jax.Array, v: torch.Tensor):\n"
    "    x = random.random()  # repro-torch-lint: disable=AST002\n"
    "    y = random.gauss(0.0, 1.0)  # repro-torch-lint: disable=AST002 -- ok\n"
    "    return x + y\n"
    "env = envs.make('gone_env')\n"
    "good = envs.make('good_env')\n"
)


def test_shared_rules_give_the_reference_findings():
    """AST002, AST006 and AST007 give the same (rule, line, suppressed)
    findings from both linters on one fixture (each in its own suppression
    spelling)."""
    shared = {"AST002", "AST006", "AST007"}
    kw = dict(hot=True, kernel_module=False,
              registry_names=frozenset({"good_env"}))
    port = ast_rules.lint_source("fixture.py", _SHARED_FIXTURE, **kw)
    ref = jast.lint_source(
        "fixture.py", _SHARED_FIXTURE.replace("repro-torch-lint:",
                                              "repro-lint:"), **kw)

    def key(findings):
        return sorted((f.rule, f.line, f.suppressed) for f in findings
                      if f.rule in shared)

    assert key(port) == key(ref)
    assert {r for r, _, _ in key(port)} == shared


def test_env_registries_are_equal():
    """AST006 reads the port's registry, which is the reference's."""
    assert ast_rules._registry_names() == frozenset(jenvs.registered())
    assert tenvs.registered() == jenvs.registered()


def test_report_has_the_reference_schema(tmp_path):
    findings = [dict(rule="AST002", message="m", file="f.py", line=3),
                dict(rule="AST007", message="s", file="g.py", line=1,
                     suppressed=True, suppress_reason="why")]
    port = Report(findings=[Finding(**f) for f in findings],
                  meta={"x": 1}).to_dict()
    ref = jreport.Report(findings=[jreport.Finding(**f) for f in findings],
                         meta={"x": 1}).to_dict()
    assert SCHEMA_VERSION == jreport.SCHEMA_VERSION
    assert port.keys() == ref.keys()
    assert port == ref
    assert set(Finding(rule="OPS001", message="m").to_dict()) == set(
        jreport.Finding(rule="JAX001", message="m").to_dict())


def test_every_reference_entry_point_and_kernel_case_has_a_counterpart():
    port_entries = {e.name for e in entrypoints.ENTRYPOINTS}
    assert {e.name for e in jentry.ENTRYPOINTS} <= port_entries
    port_cases = set(kernel_audit._kernel_cases())
    assert set(jkern._kernel_cases()) <= port_cases
    # both instances of each kernel that has two
    assert {"dg_derivative3.generic", "fused_rhs.two_pass",
            "flash_attention.cuda_core", "linear_scan.step"} <= port_cases


# --- op audit -----------------------------------------------------------------
def _audit(fn, args, **built_kw):
    built = Built(fn=fn, args=args, **built_kw)
    return op_audit.audit_entry(EntryPoint("fixture", lambda d: built),
                                built)[0]


def test_ops001_float64_result():
    findings = _audit(lambda u: u.to(torch.float64) * 2.0,
                      (torch.zeros((4,)),))
    assert "OPS001" in _rules(findings)
    # a float64 numpy table made into a float32 tensor on the host is not,
    # nor is float64 math on the host
    assert _audit(lambda u: u * torch.as_tensor(np.ones(4),
                                                dtype=torch.float32),
                  (torch.zeros((4,)),)) == []
    assert _audit(lambda u: u * float(torch.arange(
        4, dtype=torch.float64).sum()), (torch.zeros((4,)),)) == []


def test_ops002_bf16_interval_churn():
    def churned(u):
        d = torch.ones((8, 8))               # operator matrix not cast
        for _ in range(3):
            v = d @ u.to(torch.float32)
            rhs = v + 0.5 * v                # elementwise f32 chain
            u = u + rhs.to(torch.bfloat16) * 0.1
        return u

    u = torch.zeros((8, 64), dtype=torch.bfloat16)
    findings = _audit(churned, (u,), bf16_interval=True,
                      state_size=u.numel())
    assert "OPS002" in _rules(findings)


def test_ops002_reduction_upcast_is_clean():
    def accum(u):
        for _ in range(3):
            # a float32 accumulator of a bf16 sum, demoted back: the
            # intended mixed-precision pattern
            e = torch.sum(u.to(torch.float32) ** 2, dim=0)
            u = u * (1.0 - 1e-6 * e.to(torch.bfloat16))
        return u

    u = torch.zeros((8, 64), dtype=torch.bfloat16)
    assert _audit(accum, (u,), bf16_interval=True, state_size=8) == []


def test_ops002_a_kernel_is_one_op():
    """The fused RHS's plain version computes in float32 and demotes at the
    end, as the CUDA kernel does: inside a bf16 interval that is the
    kernel's business, not churn."""
    from repro_torch.cfd import initial
    from repro_torch.cfd.solver import HITConfig
    from repro_torch.kernels import rhs

    cfg = HITConfig(n_poly=2, n_elem=2)
    ops = cfg.operators("cpu", torch.bfloat16)
    u = initial.make_state_bank(torch.Generator().manual_seed(0), cfg,
                                1).to(torch.bfloat16)
    cs = torch.full(u.shape[:-1], 0.17, dtype=torch.bfloat16)
    kw = dict(inv_w_end=ops["inv_w_end"], jac=cfg.dg.jac,
              delta=cfg.delta_filter, mu=cfg.gas.mu, prandtl=cfg.prandtl,
              prandtl_turb=cfg.prandtl_turb, forcing_a0=cfg.forcing_a0,
              k_tke=cfg.k_tke)

    def step(u, cs, plain=False):
        # looked up at the call, as the solvers call their kernels
        fn = (rhs.navier_stokes_rhs_plain if plain
              else rhs.fused_navier_stokes_rhs)
        return u + 0.01 * fn(u, cs, ops["D"], ops["w"], **kw)

    built = Built(fn=step, args=(u, cs), bf16_interval=True,
                  state_size=u.numel())
    entry = EntryPoint("fixture", lambda d: built)
    assert op_audit.audit_entry(entry, built)[0] == []
    with dispatch.Recorder() as rec:
        step(u, cs)
    assert [op.name for op in rec.ops].count(
        "kernel.fused_navier_stokes_rhs") == 1
    # the same plain version called as a function, not as the kernel: its
    # final demote is churn
    plain = Built(fn=lambda u, cs: step(u, cs, plain=True),
                  args=(u, cs), bf16_interval=True, state_size=u.numel())
    assert "OPS002" in _rules(op_audit.audit_entry(
        EntryPoint("fixture", lambda d: plain), plain)[0])


@pytest.mark.parametrize("read", [
    lambda u: float(u.sum()),
    lambda u: u.sum().item(),
    lambda u: bool(u.sum() > 0),
    lambda u: u.tolist(),
    lambda u: u.cpu(),
    lambda u: u.numpy(),
    lambda u: torch.equal(u, u),
    lambda u: u.nonzero(),
    lambda u: u[u > 0],
    lambda u: u.to("cpu"),
    lambda u: torch.zeros(4).copy_(u),
    lambda u: torch.full((), 2.0, device=u.device).item(),
])
def test_ops003_reads_of_device_data_are_syncs(read):
    assert "OPS003" in _rules(_audit(read, (torch.ones((4,)),)))


@pytest.mark.parametrize("copy", [
    lambda u: u * torch.as_tensor(np.ones(4), dtype=u.dtype,
                                  device=u.device),
    lambda u: u * torch.tensor([1.0, 2.0, 3.0, 4.0], device=u.device),
    lambda u: u * torch.from_numpy(np.ones(4, np.float32)).to(u.device),
    lambda u: u.copy_(torch.ones(4)),
])
def test_ops003_blocking_host_to_device_copies_are_syncs(copy):
    assert "OPS003" in _rules(_audit(copy, (torch.ones((4,)),)))


def test_ops003_host_scalars_are_not_syncs():
    """The taint rule: a scalar made on the host and read back (as the RK
    constants' `_rounded`) waits for no device."""
    from repro_torch.cfd import solver

    def host_math(u):
        solver._rounded.cache_clear()
        a = solver._rounded(0.123, torch.bfloat16)
        b = torch.tensor(2.0).item() + float(torch.zeros(()))
        c = torch.as_tensor(np.ones(3)).sum().item()
        return u * (a + b + c)

    assert _audit(host_math, (torch.ones((4,)),)) == []
    # but the same read of device data is one
    assert "OPS003" in _rules(_audit(lambda u: u * float(u[0]),
                                     (torch.ones((4,)),)))


def test_ops003_pinned_syncs_pass():
    findings = _audit(lambda u: float(u.sum()), (torch.ones((4,)),),
                      syncs=1, sync_reason="the episode's return")
    assert findings == []


def test_ops004_lost_inplace_update():
    from repro_torch.fleet import broker

    item = {"x": torch.zeros((3,))}
    ring = broker.ring_init(item, 2)

    def copying_push(ring, item):   # a new ring instead of the same buffers
        return ring._replace(head=ring.head + 1, data={
            "x": ring.data["x"].index_copy(
                0, (ring.head % 2).reshape(1), item["x"][None])})

    def held(out):
        r = ring if out is None else out
        return {"head": r.head, **r.data}

    findings = _audit(copying_push, (ring, item), inplace=held)
    assert "OPS004" in _rules(findings)
    assert _audit(broker.push_donated, (ring, item), inplace=held,
                  max_fresh_mb=0.0) == []


def test_ops005_fresh_outputs_of_an_inplace_entry():
    state = torch.zeros((1 << 18,))
    findings = _audit(lambda s: s * 2.0, (state,),
                      inplace=lambda out: {"s": state}, max_fresh_mb=0.5)
    assert "OPS005" in _rules(findings)
    assert _audit(lambda s: s.mul_(2.0), (state,),
                  inplace=lambda out: {"s": state}, max_fresh_mb=0.5) == []


# --- the repairs the audit found --------------------------------------------
def test_operators_and_tables_are_made_once_per_device_and_dtype():
    from repro_torch.cfd import tables
    from repro_torch.cfd.burgers1d import BurgersConfig
    from repro_torch.cfd.channel import ChannelConfig
    from repro_torch.cfd.solver import HITConfig

    for cfg in (HITConfig(n_poly=3, n_elem=2), ChannelConfig(),
                BurgersConfig(n_poly=3, n_elem=4)):
        a, b = cfg.operators("cpu"), cfg.operators(torch.device("cpu"))
        assert a["D"] is b["D"] and a["w"] is b["w"]
        n0 = tables.builds()
        bf = cfg.operators("cpu", torch.bfloat16)
        assert tables.builds() - n0 in (0, 2)
        assert bf["D"] is cfg.operators("cpu", torch.bfloat16)["D"]
        # the same values as the float32 tables cast to bf16
        assert torch.equal(bf["D"], a["D"].to(torch.bfloat16))
        assert torch.equal(bf["w"], a["w"].to(torch.bfloat16))


@pytest.mark.parametrize("name", ["hit_les_reduced", "channel_wm_reduced",
                                  "burgers_reduced"])
def test_an_rl_step_copies_nothing_to_the_device(name):
    """After its first step, an env's step (advance, guard, reward,
    observation) makes no host sync: the operator matrices, spectra
    tables and reference spectra are made once (`cfd.tables`).  Each was
    a blocking host-to-device copy per RL step before, which no CUDA graph
    can hold."""
    env = tenvs.make(name)
    u = env.initial_state_bank(torch.Generator().manual_seed(0), 2)
    state = tenvs.init_state(u)
    action = torch.full((2,) + env.action_spec.shape, 0.1)
    state = env.step(state, action).state           # warm
    with dispatch.Recorder() as rec:
        env.step(state, action)
    assert rec.syncs == []


def test_a_runner_iteration_copies_no_state_to_the_host(tmp_path):
    """`Runner.run_iteration` keeps the state of before its update on the
    device: its only syncs are the stats it reads as floats (8).  It made
    one blocking copy to the host per state tensor (52) every iteration
    before."""
    from repro_torch.core.orchestrator import FleetConfig
    from repro_torch.core.runner import Runner, RunnerConfig

    runner = Runner(tenvs.make("hit_les_reduced", t_end=0.2),
                    FleetConfig(n_envs=2, bank_size=3),
                    run_cfg=RunnerConfig(checkpoint_dir=str(tmp_path)),
                    device="cpu")
    runner.run_iteration(0)
    with dispatch.Recorder(((runner.opt, "step", "adam"),)) as rec:
        runner.run_iteration(1)
    assert [s.op for s in rec.syncs] == ["aten._local_scalar_dense"] * 8


# --- kernel audit -----------------------------------------------------------
_PTXAS_SPILLS = """\
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1024 bytes smem
ptxas info    : Compiling entry function '_Z4fastPf' for 'sm_90a'
ptxas info    : Function properties for _Z4fastPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 400 bytes cmem[0]
"""
_CUOBJDUMP_SPILLS = """\
Fatbin elf code:
================
arch = sm_90a

Resource usage:
 Common:
  GLOBAL:0
 Function _Z6kernelPf:
  REG:255 STACK:16 SHARED:1024 LOCAL:16 CONSTANT[0]:400 TEXTURE:0 SURFACE:0
 Function _Z4fastPf:
  REG:32 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0
"""


@pytest.mark.parametrize("text", [_PTXAS_SPILLS, _CUOBJDUMP_SPILLS])
def test_kern001_spills_in_a_canned_report(text):
    funcs = kernel_audit.parse_resource_usage(text)
    assert funcs["_Z6kernelPf"]["registers"] == 255
    assert funcs["_Z6kernelPf"]["shared"] == 1024
    assert kernel_audit.spills(funcs["_Z6kernelPf"]) == 16
    assert kernel_audit.spills(funcs["_Z4fastPf"]) == 0
    findings = kernel_audit.resource_findings(
        {"lib.cu": kernel_audit.summarize(funcs)})
    assert [f.rule for f in findings] == ["KERN001"]
    assert "_Z6kernelPf" in findings[0].message and not findings[0].suppressed


def test_kern001_a_kept_spill_is_suppressed_with_its_reason():
    """A spill measured and kept (`KEPT_SPILLS`) shows as a suppressed
    finding with its reason; any other function of the same library that
    spills is a finding."""
    text = _PTXAS_SPILLS.replace("_Z6kernelPf", "_Z18div_passIfEvPKT_")
    libs = {"ns_rhs.cu": kernel_audit.summarize(
        kernel_audit.parse_resource_usage(text))}
    (kept,) = kernel_audit.resource_findings(libs)
    assert kept.rule == "KERN001" and kept.suppressed
    assert kept.suppress_reason == kernel_audit.KEPT_SPILLS[
        ("ns_rhs.cu", "div_pass")]
    text += text.replace("_Z18div_passIfEvPKT_", "_Z9grad_passPf")
    findings = kernel_audit.resource_findings(
        {"ns_rhs.cu": kernel_audit.summarize(
            kernel_audit.parse_resource_usage(text))})
    assert [f.suppressed for f in findings] == [False, True]


def test_kern002_split_that_does_not_divide_or_broken_precondition():
    findings, _ = kernel_audit.audit_launches("bad", [
        Launch("tile", "x.cu", splits=(("tile", 4, 10),))])
    assert _rules(findings) == {"KERN002"}
    findings, _ = kernel_audit.audit_launches("bad", [
        Launch("route", "x.cu", checks=(("n <= 8", False),))])
    assert _rules(findings) == {"KERN002"}


def test_kern002_a_wrong_route_is_caught(monkeypatch):
    """A routing rule that sends n = 9 to the tiled dg instance (outside
    its TILED_N) is a KERN002 finding of the dg case."""
    from repro_torch.kernels import dg_derivative as dg

    monkeypatch.setattr(dg, "pick_instance", lambda n, c, dtype: "tiled")
    findings, _ = kernel_audit.audit_launches(
        "dg_derivative3", kernel_audit._kernel_cases()["dg_derivative3"]())
    assert "KERN002" in _rules(findings)


def test_kern003_plan_above_the_shared_memory_limit():
    limit = _build.SMEM_OPTIN_BYTES
    findings, meta = kernel_audit.audit_launches("big", [
        Launch("plan", "x.cu", smem=limit + 1)])
    assert _rules(findings) == {"KERN003"} and meta["max_smem"] == 232_449
    assert kernel_audit.audit_launches("fits", [
        Launch("plan", "x.cu", smem=limit)])[0] == []
    # static shared memory counts on top of the dynamic
    findings, _ = kernel_audit.audit_launches(
        "static", [Launch("plan", "x.cu", smem=limit - 8)],
        static={"x.cu": 16})
    assert _rules(findings) == {"KERN003"}


def test_kern003_launch_that_differs_from_its_plan():
    """On the card a launch's dynamic shared memory is its library's own
    number: a wrapper's plan that differs from it is KERN003, a plan that
    only bounds it (`bound`) must not be below it, and the library's
    number is what the limit is held to."""
    exact = Launch("plan", "x.cu", smem=1000, card=("x_smem_bytes", (1,)))
    bound = dataclasses.replace(exact, bound=True)
    for ln, carved, rules in ((exact, 1000, set()), (exact, 992, {"KERN003"}),
                              (exact, 1016, {"KERN003"}),
                              (bound, 992, set()), (bound, 1016, {"KERN003"})):
        findings, meta = kernel_audit.audit_launches(
            "drift", [ln], carved=lambda _: carved)
        assert _rules(findings) == rules, (ln.bound, carved)
        assert meta["max_smem"] == carved
    unplanned = Launch("flash", "x.cu", card=("x_smem_bytes", (1,)))
    assert kernel_audit.audit_launches(
        "unplanned", [unplanned], carved=lambda _: 1024)[0] == []
    findings, _ = kernel_audit.audit_launches(
        "unplanned", [unplanned], carved=lambda _: 232_449)
    assert _rules(findings) == {"KERN003"}


def test_every_card_shared_memory_function_is_exported_by_its_source():
    """Each launch's `card` function is an `extern "C"` function of its
    own source, so that the card reads the number its launch uses."""
    asked = {}
    for build in kernel_audit._kernel_cases().values():
        for ln in build():
            if ln.card is not None:
                asked.setdefault(ln.source, set()).add(ln.card[0])
    assert set(asked) == set(kernel_audit.all_sources()) - {
        "ns_rhs.cu", "wall_model.cu"}          # no dynamic shared memory
    for source, names in asked.items():
        src = (_build.CSRC / source).read_text()
        exported = src[src.index('extern "C" {'):]
        for name in names:
            assert re.search(rf"\bint {name}\(", exported), (source, name)


def test_wrappers_route_by_their_own_shared_memory_plans(monkeypatch):
    """`dg_derivative.pick_instance` and `_check_inputs` and
    `linear_scan.chunked_plan` decide by the plan functions the kernel
    audit reads, so that the two cannot disagree."""
    from repro_torch.kernels import dg_derivative as dg
    from repro_torch.kernels import linear_scan as ls

    assert dg.pick_instance(6, 4, torch.float32) == "tiled"
    monkeypatch.setattr(dg, "tiled_smem_bytes",
                        lambda n, c, it: dg.SMEM_BYTES + 1)
    assert dg.pick_instance(6, 4, torch.float32) == "generic"
    monkeypatch.setattr(dg, "generic_smem_bytes",
                        lambda n, c: dg.SMEM_BYTES + 1)
    with pytest.raises(ValueError, match="does not fit"):
        dg._check_inputs(torch.zeros((1, 6, 6, 6, 4)), torch.zeros((6, 6)))
    for dk, dv in ((16, 64), (64, 64), (64, 128)):
        plan = ls.chunked_plan(dk, dv)
        assert plan.smem_bytes <= ls.CHUNKED_SMEM_BUDGET
        bigger = plan._replace(chunk=2 * plan.chunk)
        assert (plan.chunk == ls.CHUNKED_MAX_CHUNK
                or bigger.smem_bytes > ls.CHUNKED_SMEM_BUDGET)


def test_one_shared_memory_limit():
    """The wrappers' plans and the cluster kernel's source share one limit:
    `_build.SMEM_OPTIN_BYTES` (the card's own is checked on the card)."""
    from repro_torch.kernels import dg_derivative, rhs

    src = (_build.CSRC / "ns_rhs_cluster.cu").read_text()
    (value,) = re.findall(r"constexpr int kMaxSmemBytes = (\d+);", src)
    assert int(value) == _build.SMEM_OPTIN_BYTES == 232_448
    assert rhs.MAX_SMEM_BYTES is _build.SMEM_OPTIN_BYTES
    assert dg_derivative.SMEM_BYTES is _build.SMEM_OPTIN_BYTES


def test_flash_tc_tiles_mirror_the_source():
    """`TC_TILES`, which the wrapper passes to the launch and the kernel
    audit splits by, against `Tile<DP>` as the source has it."""
    from repro_torch.kernels import flash_attention as fa

    src = (_build.CSRC / "flash_attention_tc.cu").read_text()
    for dp, (bq, bk) in fa.TC_TILES.items():
        m = re.search(rf"struct Tile<{dp}> {{\s*static constexpr int NC = "
                      rf"(\d+), BN = (\d+), STAGES = (\d+);", src)
        nc, bn, _ = map(int, m.groups())
        assert (64 * nc, bn) == (bq, bk)


# --- trace audit --------------------------------------------------------------
def test_trace001_one_time_work_repeated_per_call():
    from repro_torch.cfd import tables

    def per_call_table(n):           # a table keyed by the call, not shape
        return tables.table(np.arange, n, device="cpu")

    with trace_audit.watch({"tables": tables.builds}) as w:
        for n in (1001, 1002, 1003):
            per_call_table(n)
    findings = w.check({"tables": 1})
    assert [f.rule for f in findings] == ["TRACE001"]
    assert "repeated per call" in findings[0].message

    with trace_audit.watch({"tables": tables.builds}) as w:
        per_call_table(1001)         # cached: no growth
    assert w.check({"tables": 0}) == []


def test_trace_certify_raises_on_mismatch():
    calls = []
    with pytest.raises(RuntimeError, match="trace certification failed"):
        trace_audit.certify({"n": lambda: len(calls)}, {"n": 1},
                            lambda: calls.extend([1, 2]))
    result, growth = trace_audit.certify({"n": lambda: len(calls)}, {"n": 1},
                                         lambda: calls.append(1) or "ok")
    assert (result, growth) == ("ok", {"n": 1})


def test_trace_watch_rejects_non_counters():
    with pytest.raises(TypeError, match="not a counter"):
        trace_audit.watch({"f": 3})


# --- the repo itself must be clean ------------------------------------------
def test_repo_ast_lint_clean():
    report = ast_rules.run(root=".")
    assert report.clean, report.summary()
    assert report.meta["ast_rules"]["files_scanned"] > 60


def test_repo_kernel_audit_clean():
    report = kernel_audit.run(device="cpu")
    assert report.clean, report.summary()
    stats = report.meta["kernel_audit"]["kernels"]
    assert all(s["launches"] > 0 for s in stats.values()), stats


def test_repo_op_audit_clean_and_bf16_interval_certified():
    report = op_audit.run(device="cpu")
    assert report.clean, report.summary()
    audited = report.meta["op_audit"]["entrypoints"]
    assert "hit_advance_bf16" in audited and "channel_advance_bf16" in audited
    assert {e.name for e in entrypoints.ENTRYPOINTS} == set(audited)
    syncs = report.meta["op_audit"]["syncs"]
    assert all(v["cpu"] == 0 for v in syncs.values()), syncs


def test_repo_trace_certification():
    report = trace_audit.run(device="cpu")
    assert report.clean, report.summary()
    counts = report.meta["trace_audit"]["reduced_hit_counts"]
    assert counts == trace_audit.expected_reduced_hit("cpu")
    assert counts["rhs_calls"] == 25 * counts["rl_steps"]


# --- report / CLI plumbing -----------------------------------------------------
def test_report_schema_roundtrip(tmp_path):
    rep = Report(findings=[
        Finding(rule="AST001", message="m", file="f.py", line=3),
        Finding(rule="OPS002", message="s", entrypoint="e",
                suppressed=True, suppress_reason="why"),
    ])
    data = json.loads(open(rep.save(str(tmp_path / "r.json"))).read())
    assert data["clean"] is False and data["n_findings"] == 1
    assert data["n_suppressed"] == 1
    assert data["findings_by_rule"] == {"AST001": 1}
    assert data["schema_version"] == SCHEMA_VERSION
    assert all(f["rule"] in RULES for f in data["findings"])


def test_cli_gates_on_findings(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "envs"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(
        "import numpy as np\nimport torch\n"
        "def step(u: torch.Tensor):\n    return np.tanh(u)\n")
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "torch_demo.py").write_text("import jax\n")
    (tmp_path / "examples" / "jax_demo.py").write_text("import jax\n")
    report_path = tmp_path / "torch_analysis_report.json"
    rc = cli.main(["--layers", "ast", "--root", str(tmp_path),
                   "--report", str(report_path), "--device", "cpu"])
    assert rc == 1
    data = json.loads(report_path.read_text())
    assert data["findings_by_rule"] == {"AST001": 1, "AST008": 1}
    (bad / "bad.py").write_text("import torch\n")
    (tmp_path / "examples" / "torch_demo.py").write_text("import torch\n")
    assert cli.main(["--layers", "ast", "--root", str(tmp_path),
                     "--report", str(report_path), "--device", "cpu"]) == 0


def test_cli_rejects_unknown_layer():
    with pytest.raises(SystemExit):
        cli.main(["--layers", "nope", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--layers", "jaxpr", "--device", "cpu"])


def test_gate_takes_the_card_unless_asked_for_the_cpu(monkeypatch, capsys,
                                                       tmp_path):
    """The CLI, `run_layers` and each device layer default to the card;
    without one they stop and name `--device cpu`, and never fall back to
    the CPU.  The source lint alone needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report_path = tmp_path / "r.json"
    with pytest.raises(SystemExit) as exit_:
        cli.main(["--report", str(report_path)])
    assert exit_.value.code == 2 and not report_path.exists()
    assert "--device cpu" in capsys.readouterr().err
    for run in (lambda: cli.run_layers(("ast", "kernel")),
                lambda: op_audit.run(names=("fused_rhs",)),
                kernel_audit.run, trace_audit.run):
        with pytest.raises(dispatch.NoCard, match="--device cpu"):
            run()
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        dispatch.device_of("tpu")
    assert cli.run_layers(("ast",), root=str(tmp_path)).meta["device"] \
        == "cuda"


def test_every_rule_has_a_red_team_test():
    """Meta-test: the assertions above cover the whole catalog."""
    covered = {
        "AST001", "AST002", "AST003", "AST004", "AST005", "AST006",
        "AST007", "AST008", "OPS001", "OPS002", "OPS003", "OPS004",
        "OPS005", "TRACE001", "KERN001", "KERN002", "KERN003",
    }
    assert covered == set(RULES)


# --- on the card ----------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_sync_counts_agree_with_the_card():
    """Each entry's host syncs on the card (`set_sync_debug_mode`) equal
    the CPU recorder's, and an entry that reads device data shows up in
    both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in ("rollout", "fleet_update", "broker_push", "fused_rhs",
                 "serve_step"):
        entry = entrypoints.get(name)
        _, cpu = op_audit.audit_entry(entry)
        _, card = op_audit.card_syncs(entry)
        assert card["syncs"] == cpu["syncs"] == 0, name
    reading = EntryPoint("reading", lambda d: Built(
        fn=lambda u: float(u.sum()) + u.tolist()[0],
        args=(torch.ones((4,), device=d),)))
    _, cpu = op_audit.audit_entry(reading)
    _, card = op_audit.card_syncs(reading)
    assert card["syncs"] == cpu["syncs"] == 2


@pytest.mark.cuda
def test_cuda_library_resources():
    """Every kernel library reports its registers, static shared memory,
    stack and spills, read back by cuobjdump from the built library."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    report = kernel_audit.run(device="cuda")
    libs = report.meta["kernel_audit"]["libraries"]
    assert set(libs) == set(kernel_audit.all_sources())
    for source, rec in libs.items():
        assert rec["functions"] >= 1 and rec["registers"] > 0, source
    assert report.meta["kernel_audit"]["smem_limit"] == \
        _build.SMEM_OPTIN_BYTES
    assert report.clean, report.summary()
