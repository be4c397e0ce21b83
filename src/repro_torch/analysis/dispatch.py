"""Record the aten ops of one call, and the host syncs it would make on
the card (the port's counterpart of the reference's jaxpr walk,
`repro/analysis/jaxpr_audit.py:_walk`).

Eager PyTorch has no trace without execution, so `Recorder` runs the call
under two modes:

* a `TorchDispatchMode` that records every aten op: its name, its inputs'
  and outputs' dtypes and sizes, and the op that produced each input
  (tracked by tensor identity; a view inherits its base's producer);
* a `TorchFunctionMode` that sees what the aten level does not show on
  the CPU: whether a tensor made from host data (`torch.tensor`,
  `as_tensor`) or a factory (`zeros`, `randn`, ...) was given a device,
  and the host reads that are no-ops on a CPU tensor (`.cpu()`,
  `.tolist()`, `.numpy()`).

Device data.  Every tensor is device data unless it is host data: made on
the host (from Python or numpy data, or by a factory, with no `device=`),
or computed from host data alone.  A sync is a read of device
data on the host (`.item()`, `float(t)`, `bool(t)`, `.tolist()`, `.cpu()`,
`.numpy()`, `torch.equal`, `nonzero`, `masked_select`, `unique`, boolean
indexing, a copy into a host tensor) or a blocking copy of host data to
the device (`torch.tensor(x, device=...)`, `.to(device)` of host data, a
`copy_` from a host tensor without `non_blocking`).  On the card each of
these waits for the device; `torch.cuda.set_sync_debug_mode` flags each
once, which is what `op_audit` holds this count to.  A scalar made on the
host and read back (`cfd/solver.py:_rounded`) is not a sync.

Kernels are one op.  While recording, each registered kernel wrapper
(`KERNELS`) is replaced by a stand-in that runs it with recording paused
and records one op `kernel.<name>`, as the jaxpr walk sees one
`pallas_call`: its plain version's float32 inner math and final demote
are the kernel's business, as they are in the CUDA kernel.  A caller may
name more such calls (`opaque`): the update entries name their torch
optimizer's `step`, whose CPU path reads its step count on the host while
the card's (`capturable`, `core/ppo.py:make_optimizer`) keeps it on the
device; the card's own count (`op_audit`) covers what runs inside.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import traceback
import warnings
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

class NoCard(RuntimeError):
    """The card's parts were asked for on a machine without one."""


def device_of(device: str) -> torch.device:
    """The device a layer of the gate runs its parts on: "cuda", its
    default, or "cpu" as asked.  Without a card "cuda" raises and never
    falls back to the CPU, whose layers leave out what only the card can
    say."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise NoCard(
            "no CUDA device: the gate's card parts (host syncs under "
            "set_sync_debug_mode, library resources, the card's "
            "shared-memory limit, launches) need one; pass --device cpu "
            "(device=\"cpu\") for the CPU layers alone")
    return torch.device(device)


# (module under repro_torch.kernels, wrapper name): the kernel wrappers
# that count as one op each
KERNELS = (
    ("rhs", "fused_navier_stokes_rhs"),
    ("dg_derivative", "dg_derivative3"),
    ("smagorinsky", "smagorinsky_nut"),
    ("wall_model", "wall_model_tau"),
    ("flash_attention", "flash_attention"),
    ("linear_scan", "linear_scan"),
)

# aten ops (overload packet names) that read device data on the host
_D2H_OPS = frozenset({
    "_local_scalar_dense", "is_nonzero", "equal", "nonzero", "argwhere",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive",
})
# function-level host reads that dispatch nothing on a CPU tensor
_D2H_METHODS = frozenset({"tolist", "numpy", "cpu", "__array__"})
# functions that make a tensor from host data
_FROM_DATA = frozenset({"tensor", "as_tensor", "asarray", "scalar_tensor"})
# factories: a tensor from nothing, on `device=` or on the host
_FACTORIES = frozenset({
    "zeros", "ones", "empty", "full", "arange", "linspace", "logspace",
    "eye", "rand", "randn", "randint", "randperm", "empty_strided",
    "tril_indices", "triu_indices",
}) | _FROM_DATA
_WATCHED = _D2H_METHODS | _FACTORIES | {"to", "cuda", "copy_"}
_PKG = os.sep + "repro_torch" + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__))


_MISSING = object()


def _restore(owner, attr: str, value) -> None:
    """Put back `owner.attr` (an instance's shadowing attribute is deleted,
    so the class's method shows again)."""
    if value is _MISSING:
        delattr(owner, attr)
    else:
        setattr(owner, attr, value)


@dataclasses.dataclass(slots=True)
class OpRecord:
    """One recorded op."""

    name: str                      # "aten.mul" or "kernel.<wrapper>"
    in_dtypes: tuple
    in_sizes: tuple
    out_dtypes: tuple
    out_sizes: tuple
    producers: tuple               # producer op of each tensor input ("" =
                                   # an input of the call or host data)
    device: bool                   # an output is device data


@dataclasses.dataclass
class SyncRecord:
    """One host sync the call would make on the card."""

    kind: str                      # "d2h" or "h2d"
    op: str
    where: str                     # file:line in the port's code


def _where() -> str:
    """The innermost frame in the port's code outside this package."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if _PKG in path and not path.startswith(_HERE):
            rel = path.split(_PKG, 1)[1]
            return f"src/repro_torch/{rel}:{frame.lineno}"
    return ""


def _caller(filename: str, lineno: int) -> str:
    """`filename:lineno` (where torch raised a warning), and the innermost
    frame outside torch that led there."""
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    for frame in reversed(traceback.extract_stack()[:-2]):
        path = os.path.abspath(frame.filename)
        if not path.startswith(torch_dir) and "warnings" not in path:
            return f"{filename}:{lineno} from {path}:{frame.lineno}"
    return f"{filename}:{lineno}"


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _op_tensors(args: tuple, kwargs: dict) -> list[torch.Tensor]:
    """The tensors among an aten op's arguments (one level of lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _target(name: str, args: tuple, kwargs: dict):
    """The device that `x.to(...)` / `x.cuda()` moves to: a string, a
    torch.device, a tensor (`x.to(other)`) or None (a dtype change)."""
    if name == "cuda":
        return "cuda"
    if kwargs.get("device") is not None:
        return kwargs["device"]
    for a in args[1:]:
        if isinstance(a, (str, torch.device, torch.Tensor)):
            return a
    return None


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.rec.paused:
            self.rec._on_op(func, args, kwargs, out)
        return out


class _Function(TorchFunctionMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in _WATCHED and not self.rec.paused:
            self.rec._on_function(name, args, kwargs, out)
        return out


class Recorder:
    """Context manager recording one call's ops and syncs.

        with Recorder() as rec:
            fn(*args)
        rec.ops, rec.syncs
    """

    def __init__(self, opaque: tuple = ()):
        self.ops: list[OpRecord] = []
        self.syncs: list[SyncRecord] = []
        self.paused = False
        self._host = WeakIdKeyDictionary()
        self._producer = WeakIdKeyDictionary()
        self._record = WeakIdKeyDictionary()   # tensor -> its OpRecord
        self._opaque = [*opaque, *(
            (importlib.import_module(f"repro_torch.kernels.{mod}"), attr,
             attr) for mod, attr in KERNELS)]
        self._stack = contextlib.ExitStack()

    # --- taint ---------------------------------------------------------------
    def is_device(self, t: torch.Tensor) -> bool:
        return t not in self._host

    def producer(self, t: torch.Tensor) -> str:
        return self._producer.get(t, "")

    def _note(self, kind: str, op: str) -> None:
        """Count one sync (`kind` "d2h" or "h2d") made by `op`."""
        self.syncs.append(SyncRecord(kind, op, _where()))

    def _mark_host(self, out) -> None:
        """`out` is host data (and so is what its op recorded)."""
        for t in _tensors(out):
            self._host[t] = True
            if t in self._record:
                self._record[t].device = False

    # --- mode callbacks --------------------------------------------------------
    def _on_op(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        ins = _op_tensors(args, kwargs)
        outs = ([out] if isinstance(out, torch.Tensor)
                else _op_tensors(out, {}) if isinstance(out, (list, tuple))
                else [])
        if name in ("lift_fresh", "lift_fresh_copy"):
            device = False          # data from the host
        elif name == "copy_" and ins:
            device = self.is_device(ins[0])   # stays where it is
        elif ins:
            device = any(self.is_device(t) for t in ins)
        else:
            device = True           # a factory: `_on_function` decides
        if func.is_view and ins:
            prod = self.producer(ins[0])
        else:
            prod = f"aten.{name}"
        for t in outs:
            if t in self._host and device:
                del self._host[t]
            if not device:
                self._host[t] = True
            self._producer[t] = prod
        rec = OpRecord(
            name=f"aten.{name}",
            in_dtypes=tuple(t.dtype for t in ins),
            in_sizes=tuple(t.numel() for t in ins),
            out_dtypes=tuple(t.dtype for t in outs),
            out_sizes=tuple(t.numel() for t in outs),
            producers=tuple(self.producer(t) for t in ins),
            device=device)
        self.ops.append(rec)
        for t in outs:
            self._record[t] = rec
        if not ins or not any(self.is_device(t) for t in ins):
            return
        if name in _D2H_OPS:
            self._note("d2h", f"aten.{name}")
        elif name in ("index", "index_put", "index_put_") and any(
                t.dtype == torch.bool for t in ins[1:]):
            self._note("d2h", f"aten.{name} (boolean mask)")
        elif name == "copy_" and not device:
            self._note("d2h", "aten.copy_ (into a host tensor)")

    def _on_function(self, name: str, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        src = ins[0] if ins else None
        if name in _D2H_METHODS:
            if src is not None and self.is_device(src):
                self._note("d2h", f"Tensor.{name}")
                self._mark_host(out)
        elif name in ("to", "cuda"):
            target = _target(name, args, kwargs)
            if src is None or target is None:
                return
            if self.is_device(src) and isinstance(target, str) \
                    and target.startswith("cpu"):
                self._note("d2h", "Tensor.to('cpu')")
                self._mark_host(out)
            elif not self.is_device(src) and not (
                    isinstance(target, str) and target.startswith("cpu")) \
                    and not (isinstance(target, torch.Tensor)
                             and not self.is_device(target)):
                self._note("h2d", f"Tensor.{name} of host data")
                for t in _tensors(out):
                    self._host.pop(t, None)
        elif name == "copy_" and len(ins) >= 2:
            non_blocking = (args[2] if len(args) > 2
                            else kwargs.get("non_blocking", False))
            if (self.is_device(ins[0]) and not self.is_device(ins[1])
                    and not non_blocking):
                self._note("h2d", "Tensor.copy_ from a host tensor")
        elif name in _FACTORIES and not (src is not None
                                         and self.is_device(src)):
            results = _tensors(out)
            if kwargs.get("device") is not None:
                if name in _FROM_DATA:
                    self._note("h2d", f"torch.{name}(..., device=)")
                for t in results:
                    self._host.pop(t, None)
            else:
                self._mark_host(results)

    # --- kernels as one op -------------------------------------------------------
    def _stand_in(self, label: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            if self.paused:
                return fn(*args, **kwargs)
            self.paused = True
            try:
                out = fn(*args, **kwargs)
            finally:
                self.paused = False
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            device = any(self.is_device(t) for t in ins)
            for t in outs:
                self._producer[t] = f"kernel.{label}"
                if device:
                    self._host.pop(t, None)
                else:
                    self._host[t] = True
            self.ops.append(OpRecord(
                name=f"kernel.{label}",
                in_dtypes=tuple(t.dtype for t in ins),
                in_sizes=tuple(t.numel() for t in ins),
                out_dtypes=tuple(t.dtype for t in outs),
                out_sizes=tuple(t.numel() for t in outs),
                producers=tuple(self.producer(t) for t in ins),
                device=device))
            return out

        return call

    def __enter__(self) -> "Recorder":
        for owner, attr, label in self._opaque:
            own = vars(owner).get(attr, _MISSING) if hasattr(
                owner, "__dict__") else _MISSING
            self._stack.callback(_restore, owner, attr, own)
            setattr(owner, attr, self._stand_in(label, getattr(owner, attr)))
        self._stack.enter_context(_Function(self))
        self._stack.enter_context(_Dispatch(self))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()




class CardSyncs:
    """The card's own count of host syncs inside a `with` block: every
    sync that `torch.cuda.set_sync_debug_mode("warn")` flags, by where it
    was made (`sites`: the port's innermost frame, else the Python frame
    that made it; live while the block runs)."""

    def __enter__(self) -> "CardSyncs":
        # torch's first switch of the mode in a process makes a sync of
        # its own (`torch/cuda/__init__.py`; H100, torch 2.11): switch it
        # once with nothing inside, uncounted
        with warnings.catch_warnings(record=True):
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode("default")
        self.sites: list[str] = []
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None,
                 line=None) -> None:
            if "synchroniz" in str(message):
                self.sites.append(_where() or _caller(filename, lineno))

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)
