"""Op-by-op cost model of the port (the reference's ``repro/launch/
hlo_cost.py``; PyTorch has no HLO, so the ops are counted as they run).

:func:`analyze_step` runs a step under a ``TorchDispatchMode`` and counts
each aten op that reaches it, by the reference's rules:

* flops   — a matmul-class op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
            ``_scaled_dot_product_*`` ops; ``einsum`` and ``matmul`` reach
            the mode as these) counts 2 x result elements x contraction, from
            ``torch.utils.flop_counter``'s registry, in the class of its
            input dtype (``bf16``, ``int8`` or ``f32``: ``launch.roofline``);
            an elementwise or reduction op counts 1 flop per output element,
            class ``f32`` (the CUDA cores, whatever the dtype);
* bytes   — each op's operand bytes plus its result bytes ("bytes
            accessed": the port runs unfused, so every op's traffic counts);
            views, ``detach``, ``empty*`` and other metadata ops count
            nothing (the reference's ``_SKIP_BYTES``);
* collectives — each ``c10d_functional`` / ``c10d`` collective counts its
            result bytes per kind (the reference's kind names), tagged with
            its group's size, and as ``net`` when the group spans hosts of
            ``roofline.HOST_GPUS`` ranks.

The reference multiplies a while-loop body by its trip count; there is no
counterpart here, because eager PyTorch runs (and the mode sees) every
layer.

The hand-written kernels are counted at ``kernels/dispatch.py``: each
dispatch entry records ``roofline.kernel_cost`` of the wrapper its call
is for, once, whichever route it takes (the CUDA kernel, its plain
version, ``set_force_ref``), and the aten ops of its body are not counted.
So a step's count is the same on the card and on the CPU. The attention
kernels' costs read context lengths on the host: counting raises inside a
CUDA-graph capture. Counting is off unless :func:`analyze_step` runs.

On ``meta`` tensors (the dry-run) each op's output metadata is memoised
by its inputs' shapes, strides and dtypes, so a repeated layer costs a
lookup, not a meta kernel.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dispatch
from repro_torch.launch.roofline import HOST_GPUS

__all__ = ["COLLECTIVES", "analyze_step", "top_bytes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

_COLL_KIND = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLL_NS = ("c10d", "c10d_functional", "_c10d_functional")

# ops that move no bytes: metadata, allocation, the functional collectives'
# bookkeeping
_SKIP = {"detach", "alias", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "resize_", "_wrap_tensor_autograd", "wait_tensor",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel", "set_",
         "_unsafe_view"}

# gathers read and write their result's rows; in-place scatters read and
# write their update's (the reference's dynamic-slice / gather and
# dynamic-update-slice rules)
_GATHER = {"index", "gather", "index_select", "embedding"}
_SCATTER = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_", "scatter_reduce_",
            "index_copy_", "index_add_", "copy_"}

_CLASS = {torch.bfloat16: "bf16", torch.float16: "bf16", torch.int8: "int8",
          torch.uint8: "int8"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(a):
    """A DTensor's local shard (its per-device traffic), else ``a``."""
    inner = getattr(a, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else a


def _group_ranks(flat) -> Optional[list]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in flat:
        try:
            if isinstance(a, str):
                return dist.get_process_group_ranks(_resolve_process_group(a))
            if isinstance(a, torch.ScriptObject):
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
        except (RuntimeError, ValueError, KeyError):
            continue
    return None


class _Count:
    def __init__(self, track: bool = False):
        self.flops = defaultdict(float)
        self.bytes = 0.0
        self.coll = defaultdict(float)
        self.coll_net = 0.0
        self.kernels: dict = {}
        self.ops = 0
        self.suspended = 0
        self.rows = [] if track else None

    # the dispatch entries' hook
    def kernel(self, name: str, cost) -> None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"op_cost: {name}'s cost reads context lengths on the host; "
                               "a step cannot be counted inside a CUDA-graph capture")
        ops, nbytes = cost()
        k = self.kernels.setdefault(name, {"calls": 0, "flops_by_class": {}, "bytes": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        for c, v in ops.items():
            k["flops_by_class"][c] = k["flops_by_class"].get(c, 0) + v
            self.flops[c] += v
        self.bytes += nbytes
        if self.rows is not None:
            self.rows.append((float(nbytes), name, "hand-written kernel"))

    @contextlib.contextmanager
    def suspend(self):
        self.suspended += 1
        try:
            yield
        finally:
            self.suspended -= 1

    def op(self, func, info, args, kwargs, flat, out) -> None:
        kind, skip, pointwise, in_place = info
        outs = [_local(o) for o in _leaves(out)]
        if kind is not None:
            res = outs if func.namespace != "c10d" else _leaves(args[0])
            nb = sum(_nbytes(t) for t in res if isinstance(t, torch.Tensor))
            ranks = _group_ranks(flat)
            size = len(ranks) if ranks else 0
            self.coll[kind] += nb
            self.coll["count_" + kind] += 1
            self.coll[f"{kind}@{size}"] += nb
            if ranks and len({r // HOST_GPUS for r in ranks}) > 1:
                self.coll_net += nb
            self.bytes += nb
            return
        if skip:
            return
        self.ops += 1
        tin = [a for a in flat if isinstance(a, torch.Tensor)]
        tout = [o for o in outs if isinstance(o, torch.Tensor)]
        name = func.__name__.split(".")[0]
        if name in _GATHER and tout:
            nb = 2 * _nbytes(tout[0])  # the rows read, then written
        elif in_place and name in _SCATTER and len(tin) > 1:
            nb = 2 * _nbytes(tin[-1])  # the update read, then written in place
        else:
            nb = sum(_nbytes(t) for t in tin) + sum(_nbytes(t) for t in tout)
        self.bytes += nb
        packet = func.overloadpacket
        if packet in flop_registry:
            largs, lkwargs, lout = tree_map(_local, (args, kwargs, out))
            fl = flop_registry[packet](*largs, **lkwargs, out_val=lout)
            cls = _CLASS.get(tin[0].dtype, "f32") if tin else "f32"
            self.flops[cls] += fl
        elif pointwise:
            self.flops["f32"] += sum(o.numel() for o in tout)
        if self.rows is not None:
            shapes = [tuple(t.shape) for t in tin[:3]]
            self.rows.append((float(nb), str(func), f"{shapes} -> "
                              f"{[tuple(t.shape) for t in tout[:2]]}"))

    def result(self, routed: int) -> dict:
        counted = sum(k["calls"] for k in self.kernels.values())
        coll_total = sum(self.coll[k] for k in COLLECTIVES)
        return {
            "flops": float(sum(self.flops.values())),
            "flops_by_class": {c: float(v) for c, v in sorted(self.flops.items())},
            "bytes": float(self.bytes),
            "coll_bytes": float(coll_total),
            "coll_net_bytes": float(self.coll_net),
            "coll_detail": dict(self.coll),
            "kernels": self.kernels,
            "ops": self.ops,
            "routed_calls": routed,
            "uncounted_calls": routed - counted,
        }


def _leaves(x) -> list:
    """The leaves of nested lists, tuples and dicts (a faster tree_flatten
    for an op's arguments)."""
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            if isinstance(y, (list, tuple, dict)):
                out.extend(_leaves(y))
            else:
                out.append(y)
        return out
    if isinstance(x, dict):
        return _leaves(list(x.values()))
    return [x]


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.memory_format,
             torch.layout)


def _key(x):
    """A hashable key of an op's arguments' metadata; TypeError if one is
    not a tensor, a plain value or a list / tuple / dict of them."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_key(y) for y in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _key(v)) for k, v in x.items()))
    if isinstance(x, _HASHABLE):
        return x
    raise TypeError(type(x))


def _op_info(func) -> tuple:
    """(collective kind or None, counts no bytes, counts a flop an output
    element, writes its first argument in place and returns it, memoisable
    on meta)."""
    name = func.__name__.split(".")[0]
    s = func._schema
    kind = _COLL_KIND.get(name) if func.namespace in _COLL_NS else None
    skip = func.namespace in _COLL_NS or name in _SKIP or func.is_view
    pointwise = (torch.Tag.pointwise in func.tags or torch.Tag.reduction in func.tags
                 or name == "_to_copy")
    aliased = (any(a.alias_info is not None for a in s.arguments)
               or any(r.alias_info is not None for r in s.returns))
    in_place = (len(s.returns) == 1 and s.returns[0].alias_info is not None and s.arguments
                and s.arguments[0].alias_info is not None and s.arguments[0].alias_info.is_write
                and sum(a.alias_info is not None for a in s.arguments) == 1)
    memo = func.namespace not in _COLL_NS and not func.is_view and (not aliased or in_place)
    return kind, skip, pointwise, bool(in_place), memo


class _Mode(TorchDispatchMode):
    def __init__(self, count: _Count):
        super().__init__()
        self.count = count
        self.memo: dict = {}
        self.info: dict = {}

    def _run(self, func, memo, in_place, args, kwargs, tensors):
        if not (memo and tensors and all(t.is_meta for t in tensors)):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self.memo.get(key)
        if hit is not None:
            if in_place:  # a meta in-place op only checks its shapes
                return args[0]
            if hit[0] == "T":
                return torch.empty_strided(*hit[1], dtype=hit[2], device="meta")
            return hit[1](torch.empty_strided(*m, dtype=d, device="meta") for m, d in hit[2])
        out = func(*args, **kwargs)
        if in_place:
            self.memo[key] = ("I",)
        elif type(out) is torch.Tensor:
            self.memo[key] = ("T", (out.shape, out.stride()), out.dtype)
        elif isinstance(out, (tuple, list)) and all(type(o) is torch.Tensor for o in out):
            self.memo[key] = ("S", type(out), [((o.shape, o.stride()), o.dtype) for o in out])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self.info.get(func)
        if info is None:
            info = self.info[func] = _op_info(func)
        flat = [_local(a) for a in _leaves(args) + _leaves(kwargs)]
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        out = self._run(func, info[4], info[3], args, kwargs, tensors)
        if not self.count.suspended:
            self.count.op(func, info[:4], args, kwargs, flat, out)
        return out


def _routed() -> int:
    return sum(v for k, v in dispatch.dispatch_counters().items() if "[" not in k)


def _analyze(fn, args, kw, track: bool):
    count = _Count(track)
    before = _routed()
    prev = dispatch.set_cost_sink(count)
    try:
        with _Mode(count):
            fn(*args, **kw)
    finally:
        dispatch.set_cost_sink(prev)
    return count, _routed() - before


def analyze_step(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once and count it: ``flops`` (total),
    ``flops_by_class``, ``bytes``, ``coll_bytes`` (``coll_net_bytes`` of
    them in groups that span hosts), ``coll_detail`` (bytes per kind, per
    ``<kind>@<group size>``, and ``count_<kind>``), ``kernels`` (per
    hand-written wrapper: calls, flops by class, bytes), ``ops`` (aten ops
    counted), ``routed_calls`` (dispatch decisions in the step) and
    ``uncounted_calls`` (decisions that recorded no kernel cost: 0 unless
    a dispatch entry lost its hook)."""
    count, routed = _analyze(fn, args, kw, track=False)
    return count.result(routed)


def top_bytes(fn, *args, n: int = 20, **kw) -> list[tuple[float, str, str]]:
    """The ``n`` ops of ``fn``'s step that move the most bytes, as (bytes,
    op, shapes); a hand-written kernel is one row."""
    count, _ = _analyze(fn, args, kw, track=True)
    return sorted(count.rows, key=lambda r: -r[0])[:n]
