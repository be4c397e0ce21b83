"""Roofline terms from a recorded eager run (port of
`repro.launch.hlo_analysis`; the name is kept so that a reader finds the
counterpart, but nothing here reads HLO).

The dry run (`launch/dryrun.py`) runs each rank's real program on meta
shards laid out as DTensors on a fake mesh (`launch/mesh.fake_mesh`), and a
`Recorder` sees every op at the dispatch level.  The local shards are
`MetaShard`s, meta tensors whose `__torch_dispatch__` records each op that
DTensor hands them, so an op counts once per rank on that rank's shapes:
the op on its shard, and a replicated op whole on each rank.  Ops on plain
meta tensors (a mask, a fresh cache) are recorded by the Recorder's
dispatch mode and their results become `MetaShard`s; a mode alone would
see DTensor's global ops, not each rank's (a (16, 16)-sharded product
reads as its global count).  What a `Recorder` holds:

    flops           matmul-class ops by `torch.utils.flop_counter`'s
                    formulas on the local shapes; every other arithmetic
                    op one FLOP per element of its largest operand or
                    result (per output element for an elementwise op, per
                    input element for a reduction), as XLA's
                    HloCostAnalysis counts them; data movement (views,
                    copies, casts, concatenation, indexing, fills) none
    bytes_accessed  each op's input and output bytes, unfused (views
                    none), as the reference's CPU backend reports its
                    "bytes accessed": an upper bound on HBM traffic
    read            the storages the run's ops read: the arguments it
                    uses (XLA drops the ones a program never reads from
                    its `argument_size_in_bytes`: a decode step reads no
                    encoder weight)
    peak / live     bytes of the local storages alive, arguments
                    included (each storage counted once, freed when its
                    last tensor dies); the peak over the run
    records         (mesh dim, op, bytes of this rank's input payload)
                    of every collective, the form of
                    `core.collectives.collective_records(mesh)`: the
                    functional collectives DTensor issues (its
                    all-to-all that moves a shard between dims on a
                    CUDA mesh included) and the c10d ones `ElemSplit`
                    calls (its face rolls' send and recv, its sums'
                    all-reduce, its gathers), each under the mesh dim
                    of its group: a `PencilSplit`'s x exchanges under
                    "mx", its y exchanges under "my", and a sum over the
                    pencil as one all-reduce on each.  Meta tensors
                    never reach a process group: the ops' meta kernels
                    return without calling it.

`collective_bytes` applies the reference's per-op convention to the
records (all-gather: its output; reduce-scatter: its input; all-reduce: 2 x
its input; all-to-all and collective-permute (a send): their input), and
`roofline_terms` / `model_flops` are the reference's, line for line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          return_and_correct_aliasing)
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# a recorded op (`StagedGroup`'s names) -> the reference's kind
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send": "collective-permute"}

# dispatcher collectives -> (recorded op, index of the input argument)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all_gather", 0),
    "all_gather_into_tensor_coalesced": ("all_gather", 0),
    "reduce_scatter_tensor": ("reduce_scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce_scatter", 0),
    "all_reduce": ("all_reduce", 0),
    "all_reduce_": ("all_reduce", 0),
    "all_reduce_coalesced": ("all_reduce", 0),
    "all_to_all_single": ("all_to_all", 0),
    "broadcast": ("broadcast", 0),
    "broadcast_": ("broadcast", 0),
    "allreduce_": ("all_reduce", 0),
    "allreduce_coalesced_": ("all_reduce", 0),
    "allgather_": ("all_gather", 1),
    "_allgather_base_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "reduce_scatter_": ("reduce_scatter", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "alltoall_base_": ("all_to_all", 1),
    "send": ("send", 0),
    "recv_": ("recv", 0),
    # DTensor's move of a shard between tensor dims on a non-CPU mesh
    "shard_dim_alltoall": ("all_to_all", 0),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")

# ops that move or make data and compute nothing
_MOVES = {
    "clone", "_to_copy", "copy", "copy_", "contiguous", "cat", "stack",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "index_select",
    "gather", "scatter", "scatter_", "index", "index_put", "index_put_",
    "_index_put_impl_", "slice_scatter", "select_scatter",
    "as_strided_scatter", "diagonal_scatter", "embedding", "repeat",
    "roll", "flip", "constant_pad_nd", "_unsafe_view", "expand_copy",
    "split_with_sizes_copy", "unbind_copy", "masked_scatter", "tril",
    "triu", "_local_scalar_dense", "set_", "resize_", "detach_",
    "_foreach_copy_", "alias_copy", "view_copy", "_reshape_copy",
    "_unsafe_index", "unfold_copy", "one_hot", "bernoulli_", "uniform_",
    "normal_", "randn", "rand", "randint",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(tree, out: list) -> list:
    """The leaves of nested tuples, lists and dicts, appended to `out`."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flat(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flat(x, out)
    else:
        out.append(tree)
    return out


def tensors(tree) -> list:
    """The tensors among a tree's leaves (nested tuples, lists, dicts)."""
    return [t for t in _flat(tree, []) if isinstance(t, torch.Tensor)]


def _map(fn, tree):
    """`tree` with `fn` applied to each leaf (nested tuples, lists and
    dicts)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    view: bool        # results alias inputs, nothing written
    functional: bool  # fresh results only: meta outputs can be cached
    name: str


_INFO: dict = {}


def _info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        returns = func._schema.returns
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in returns)
        functional = not func._schema.is_mutable and not view and all(
            str(r.type) in ("Tensor", "Tensor[]") for r in returns) and \
            bool(returns)
        info = _INFO[func] = _OpInfo(view, functional,
                                     func.overloadpacket.__name__)
    return info


def _sig(x):
    """A hashable stand-in of an argument for the meta-output cache."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple([_sig(y) for y in x])
    if isinstance(x, dict):
        return tuple([(k, _sig(v)) for k, v in x.items()])
    return x


def _unwrap(args, shards: list):
    """`args` (a tuple, list or dict of arguments) with each `MetaShard`
    replaced by its meta tensor, appended to `shards`."""
    if isinstance(args, dict):
        return {k: _unwrap(v, shards) if isinstance(v, (list, tuple))
                else _unwrap((v,), shards)[0] for k, v in args.items()}
    out = []
    for a in args:
        if isinstance(a, MetaShard):
            shards.append(a)
            out.append(a.elem)
        elif isinstance(a, (list, tuple)):
            out.append(_unwrap(a, shards))
        else:
            out.append(a)
    return out if isinstance(args, list) else tuple(out)


def op_cost(func, args, kwargs, out) -> tuple[int, int, bool]:
    """(FLOPs, bytes accessed, is a matmul-class op) of one op on its
    (local, unwrapped) operands; see the module docstring."""
    info = _info(func)
    if info.view:
        return 0, 0, False
    name = info.name
    if name.startswith("empty") or name.startswith("new_empty"):
        return 0, 0, False
    ins, outs = tensors((args, kwargs)), tensors(out)
    moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    packet = func.overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out)), \
            moved, True
    if name in _MOVES:
        return 0, moved, False
    if name.startswith("_foreach_"):
        lists = [a for a in args if isinstance(a, (list, tuple)) and a
                 and isinstance(a[0], torch.Tensor)]
        n = max((len(x) for x in lists), default=0)
        flops = sum(max(x[i].numel() for x in lists) for i in range(n))
        return flops, moved, False
    return max((t.numel() for t in ins + outs), default=0), moved, False


class MetaShard(torch.Tensor):
    """One rank's local shard in the dry run: a meta tensor (no storage)
    whose ops its `Recorder` records, and whose results are `MetaShard`s
    of the same Recorder."""

    @staticmethod
    def __new__(cls, elem: torch.Tensor, rec: "Recorder"):
        t = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=elem.requires_grad)
        t.elem, t.rec = elem, rec
        t.key = rec._track(t, elem)
        return t

    def __repr__(self):
        return f"MetaShard({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        shards: list = []
        u_args = _unwrap(args, shards)
        u_kwargs = _unwrap(kwargs, shards) if kwargs else {}
        rec = shards[0].rec
        out, info = rec._run(func, u_args, u_kwargs)
        if rec.on:
            rec.read.update([t.key for t in shards])
        if type(out) is torch.Tensor:
            wrapped = MetaShard(out, rec)
        else:
            wrapped = _map(lambda x: MetaShard(x, rec)
                           if type(x) is torch.Tensor else x, out)
        if info.functional:
            return wrapped
        return return_and_correct_aliasing(func, args, kwargs or {},
                                           wrapped)


class _Mode(TorchDispatchMode):
    """Records the ops whose operands are all plain tensors with a meta one
    among them (a mask, a fresh cache) and wraps their results as
    `MetaShard`s; an op with a `MetaShard` or DTensor operand passes on to
    that tensor's dispatch, and host work on real tensors is not the
    device's."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if types:  # a MetaShard or DTensor operand dispatches itself
            return func(*args, **kwargs)
        ins = [t for t in _flat((args, kwargs), [])
               if isinstance(t, torch.Tensor)]
        dev = kwargs.get("device")
        if not any(t.is_meta for t in ins) and (
                dev is None or torch.device(dev).type != "meta"):
            return func(*args, **kwargs)
        out, info = self.rec._run(func, args, kwargs)
        if not info.functional:
            return out
        return _map(lambda x: MetaShard(x, self.rec)
                    if type(x) is torch.Tensor and x.is_meta else x, out)


class Recorder:
    """What one rank's run did on its local shards (see the module
    docstring).  `shard` / `distribute` make the run's arguments; `run()`
    is the block whose ops count."""

    def __init__(self, mesh=None):
        self.flops = 0
        self.bytes_accessed = 0
        self.n_dot = 0
        self.n_ops = 0
        self.records: list[tuple[str, str, int]] = []
        self.read: set[int] = set()  # storages an op of the run read
        self.live = self.peak = self.start_live = 0
        self.memory: dict = {}
        self.axis_sizes: dict[str, int] = {}
        self._storages: dict[int, list[int]] = {}
        self._refs: dict = {}
        self._groups: dict[str, str] = {}
        self._cache: dict = {}
        self.on = False
        if mesh is not None and hasattr(mesh, "mesh_dim_names"):
            for name in mesh.mesh_dim_names:
                group = mesh.get_group(name)
                self._groups[group.group_name] = name
                self.axis_sizes[name] = dist.get_world_size(group)

    # --- memory -----------------------------------------------------------
    def _track(self, wrapper: torch.Tensor, elem: torch.Tensor) -> int:
        """Count `elem`'s storage live while `wrapper` is; its key."""
        storage = elem.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0, key]
            self.live += entry[0]
            if self.live > self.peak:
                self.peak = self.live
        entry[1] += 1
        self._refs[weakref.ref(wrapper, self._untrack)] = key
        return key

    def _untrack(self, ref) -> None:
        entry = self._storages[self._refs.pop(ref)]
        entry[1] -= 1
        if entry[1] == 0:
            del self._storages[entry[2]]
            self.live -= entry[0]

    # --- ops -------------------------------------------------------------
    def _group_label(self, func, args) -> str:
        """The mesh dim of a collective's group (the group's name if it is
        none of the mesh's dims); notes the group's size."""
        if func.namespace == "c10d":
            names = [a.name for a in func._schema.arguments]
            pg = dist.ProcessGroup.unbox(args[names.index("process_group")])
        else:  # the functional collectives: the group (name) last
            pg = args[-1]
            if not isinstance(pg, dist.ProcessGroup):
                pg = dist.distributed_c10d._resolve_process_group(pg)
        label = self._groups.get(pg.group_name, pg.group_name)
        self.axis_sizes.setdefault(label, pg.size())
        return label

    def _run(self, func, args, kwargs):
        """(`func` on meta operands, its `_OpInfo`), counted when the run
        is on.  A functional op's results are made from the shapes of an
        earlier call with the same signature, and its cost is that call's
        (the meta kernels, Python decompositions mostly, and the counting
        would cost more than the rest of the run)."""
        info = _info(func)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            out = func(*args, **kwargs)
            if self.on:
                self.read.update(storage_keys((args, kwargs)))
                self._collective(func, info.name, args)
            return out, info
        key = None
        if info.functional:
            try:
                key = (func, _sig(args), _sig(kwargs))
                hit = self._cache.get(key)
            except TypeError:  # an unhashable argument
                key = hit = None
            if hit is not None:
                many, specs, cost = hit
                outs = [torch.empty_strided(size, stride, dtype=dtype,
                                            device="meta")
                        for size, stride, dtype in specs]
                self._count(cost)
                return (outs if many else outs[0]), info
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        if key is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            if all(type(t) is torch.Tensor and t.is_meta for t in outs):
                self._cache[key] = (isinstance(out, (list, tuple)), [
                    (t.shape, t.stride(), t.dtype) for t in outs], cost)
        self._count(cost)
        return out, info

    def _count(self, cost: tuple) -> None:
        if self.on:
            flops, moved, dot = cost
            self.n_ops += 1
            self.flops += flops
            self.bytes_accessed += moved
            self.n_dot += dot

    def _collective(self, func, name: str, args) -> None:
        if name not in _COLLECTIVE_OPS:
            return  # wait_tensor, barrier, ...
        op, i = _COLLECTIVE_OPS[name]
        label = self._group_label(func, args)
        payload = args[i]
        items = payload if isinstance(payload, (list, tuple)) and \
            name.endswith("coalesced") else [payload]
        for item in items:
            self.records.append((label, op, sum(map(_nbytes, tensors(item)))))

    # --- arguments ---------------------------------------------------------
    def shard(self, shape, dtype) -> MetaShard:
        """A fresh local shard of `shape` and `dtype`."""
        return MetaShard(torch.empty(tuple(shape), dtype=dtype,
                                     device="meta"), self)

    def distribute(self, like: torch.Tensor, spec: tuple, mesh):
        """A DTensor of `like`'s global shape and dtype laid out by `spec`
        on `mesh` (`parallel.sharding.placements`), its local shard a
        `MetaShard`; a `MetaShard` of `like`'s shape without a device
        mesh."""
        if mesh is None or not hasattr(mesh, "mesh_dim_names"):
            return self.shard(like.shape, like.dtype)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        from ..parallel.sharding import placements
        pl = placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(like.shape, mesh,
                                                         pl)
        return DTensor.from_local(self.shard(local, like.dtype), mesh, pl,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    @contextlib.contextmanager
    def run(self):
        """Count the ops of the block; the peak starts from what is live
        at entry (the arguments)."""
        self.start_live = self.peak = self.live
        self.on = True
        try:
            with _Mode(self):
                yield self
        finally:
            self.on = False


def memory_analysis(rec: Recorder, args, out, donated=()) -> dict:
    """The reference's `memory_analysis()` fields of a recorded run on
    `args` that gave `out`: the arguments the run read (XLA drops the
    others), the outputs, the most the run held beyond what was live when
    it began (`temp`), and the outputs that alias a `donated` argument.
    An eager run generates no code: that field is None."""
    kept = storage_keys(donated)
    outs = tensors(out)
    return {"argument_size_in_bytes": local_bytes(
                [t for t in tensors(args) if storage_keys(t) <= rec.read]),
            "output_size_in_bytes": local_bytes(outs),
            "temp_size_in_bytes": rec.peak - rec.start_live,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": local_bytes(
                [t for t in outs if storage_keys(t) <= kept])}


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (a DTensor's local
    shard, a plain tensor whole), each storage once."""
    seen, total = set(), 0
    for t in tensors(tree):
        t = local_elem(t)
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


def local_elem(t: torch.Tensor) -> torch.Tensor:
    """The meta tensor under a DTensor's `MetaShard` (or under a
    `MetaShard`); `t` itself otherwise."""
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.elem if isinstance(t, MetaShard) else t


def storage_keys(tree) -> set:
    """The keys of the local storages of a tree's tensors."""
    return {local_elem(t).untyped_storage()._cdata for t in tensors(tree)}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_bytes(records, axis_sizes: dict) -> CollectiveStats:
    """Per-device collective traffic of recorded collectives ((mesh dim,
    op, input bytes[, ...]) each; `axis_sizes` the ranks of each dim's
    group) by the reference's per-op convention (module docstring).  A
    recv is its send's other end and a broadcast no kind of the
    reference's: neither counts."""
    bytes_by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    count_by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for dim, op, n_bytes, *_ in records:
        kind = _KIND.get(op)
        if kind is None:
            continue
        if kind == "all-gather":
            moved = n_bytes * axis_sizes[dim]
        elif kind == "all-reduce":
            moved = 2 * n_bytes
        else:  # reduce-scatter, all-to-all, collective-permute
            moved = n_bytes
        bytes_by_kind[kind] += moved
        count_by_kind[kind] += 1
    return CollectiveStats(bytes_by_kind, count_by_kind)


def cost_analysis(rec: Recorder) -> dict:
    """The recorded run's "flops" and "bytes accessed" (the counterpart of
    the reference's `cost_analysis_dict`)."""
    return {"flops": float(rec.flops),
            "bytes accessed": float(rec.bytes_accessed)}


def op_counts(rec: Recorder) -> dict:
    """The reference's `remat_duplication` counts: matmul-class ops; an
    eager run has no fusions and no while loops."""
    return {"n_dot": rec.n_dot, "n_fusion": None, "n_while": None,
            "reason": "eager: no fusion or while ops to count"}


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   coll_bytes_per_dev: float, n_chips: int,
                   peak_flops: float, hbm_bw: float, link_bw: float,
                   fused_bytes_per_dev: float | None = None) -> dict:
    """The three roofline terms in seconds + the bottleneck label.

    Two memory figures are reported (EXPERIMENTS.md §Roofline):
      memory_raw_s   = cost_analysis "bytes accessed" / HBM_bw — the brief's
                       formula verbatim.  On the CPU backend this counts
                       every op's unfused operand+result I/O and overstates
                       fused-TPU HBM traffic by orders of magnitude.
      memory_s       = (arguments + outputs + 2*temporaries) / HBM_bw — a
                       fused-execution traffic estimate from the compiled
                       buffer assignment; used for bottleneck selection.
    """
    t_compute = flops_per_dev / peak_flops
    t_mem_raw = hbm_bytes_per_dev / hbm_bw
    t_memory = (fused_bytes_per_dev / hbm_bw
                if fused_bytes_per_dev is not None else t_mem_raw)
    t_coll = coll_bytes_per_dev / link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "memory_raw_s": t_mem_raw, "collective_s": t_coll}
    sel = {"compute_s": t_compute, "memory_s": t_memory,
           "collective_s": t_coll}
    bound = max(sel, key=sel.get)
    terms["bound"] = bound.replace("_s", "")
    # roofline fraction: useful-compute time over the max term (how close the
    # dominant term lets compute run at peak)
    t_max = max(sel.values())
    terms["roofline_fraction"] = float(t_compute / t_max) if t_max > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D for a forward-only cell (prefill), 2*N_active per token for decode.
    D = tokens processed in the cell."""
    n_params = cfg.approx_params()
    if cfg.ffn == "moe":
        d, f = cfg.d_model, cfg.d_ff
        routed_all = cfg.n_experts * 3 * d * f
        routed_active = cfg.top_k * 3 * d * f
        per_layer_delta = routed_all - routed_active
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        n_params = n_params - n_moe_layers * per_layer_delta
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        return 2.0 * n_params * tokens
    return 2.0 * n_params * shape.global_batch  # decode: one token per seq
