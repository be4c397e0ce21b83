"""The port's static-analysis gate (`repro-torch-lint`), the counterpart of
`repro.analysis` over `src/repro_torch/`.

Four layers over one finding/report currency (`report.py`):

* **Source lint** (`ast_rules`): no numpy on the device path, no Python or
  global torch RNG, no float64, kernel wrappers that never hide their
  kernel, registry-complete `envs.make` names, and no `jax`/`repro`
  import anywhere in the port.
* **Op audit** (`op_audit`, over `dispatch.Recorder`): each registered hot
  entry point (`entrypoints.py`) runs once under a `TorchDispatchMode`
  recorder; float64 results, bf16-interval dtype churn, host syncs of
  device data, lost in-place updates and fresh output bytes are findings.
  On the card the same entries run again under
  `torch.cuda.set_sync_debug_mode("warn")`.
* **Kernel audit** (`kernel_audit`): every wrapper's launch plan (tiles,
  chunks, cluster splits, shared memory) at the main path's shapes and
  the parity corners; on the card each library's registers, spills and
  static shared memory from `cuobjdump`.
* **Trace audit** (`trace_audit`): pinned counts of one-time work (kernel
  loads, plan caches, graph captures, device tables), launches, RHS calls
  and syncs over a reduced-HIT training run.

Run with ``repro-torch-lint`` or ``python -m repro_torch.analysis``; docs in
`docs/torch_static_analysis.md`.
"""
from .report import Finding, Report, RULES  # noqa: F401
