"""Per-device FLOP, byte and collective counts of one eager PyTorch call.

Counterpart of src/repro/analysis/hlo_count.py, which counts the optimized
HLO of a jitted step.  There is no HLO here: the file keeps its name so a
reader finds the counterpart.  `count(fn, *args, **kwargs)` runs `fn` under
a `TorchDispatchMode` and returns the reference's dict, all per device:

* flops -- the matmul family only (mm, addmm, bmm, baddbmm, mv, dot: what
  `einsum`, `linear` and `matmul` decompose to), at 2 x output x contracted
  size, as the reference counts every `dot`; plus the hand-written kernels'
  own FLOP formulas (`register_flop_formula` in repro_torch.kernels), each
  equal to the matmul FLOPs of the kernel's plain version.
* bytes -- every op's operand and output bytes.  Views and allocations are
  free; a gather-like read (index, gather, index_select, embedding) is
  charged twice its output, and an in-place update of part of a tensor
  (copy_ into a view, index_put_, index_copy_, index_add_, scatter) twice
  its update, as the reference charges slices and dynamic-update-slices.
  Eager PyTorch fuses nothing, so every elementwise op reads and writes
  memory: these bytes are not comparable with XLA's fused count, only
  between runs of the port.
* collective_bytes / collective_ops -- by kind, for every
  `_c10d_functional` collective (what DTensor issues when it
  redistributes), on the reference's ring wire model
  (`_collective_wire_bytes`, copied) with the group size taken from the
  process group.

Per device means the ops one rank runs on its local tensors.  An op on
DTensors is handed back to DTensor's own dispatch (the mode returns
NotImplemented), which runs its redistributions and then the op on the
rank's shards with the mode still active: the counter sees the collectives
and the local products, not the logical op.  DTensor's sharding propagation
runs each new op once on global-shape fake tensors to learn its output's
metadata; that work is no rank's and is not counted.

`Counter` is the mode itself: `records` aggregates the ops by (kind, line),
with their count, for `profile_tools.top_contributors`; `peak_bytes` is the
most bytes held at once by storages that the counted ops allocated.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import KERNEL_OPS

_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")

# _c10d_functional op name -> the reference's collective kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FUNCTIONAL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

# ops that move no data: allocations, metadata and waits
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "wait_tensor",
         "lift_fresh", "_local_scalar_dense", "set_"}
# read only the gathered region: twice the output
_GATHERS = {"index", "gather", "index_select", "embedding",
            "_unsafe_index", "take_along_dim"}
# write only the updated region: twice the update
_UPDATES = {"copy_", "index_put_", "index_put", "_index_put_impl_",
            "index_copy_", "index_copy", "index_add_", "index_add",
            "scatter_", "scatter", "scatter_add_", "scatter_add",
            "scatter_reduce_", "scatter_reduce", "slice_scatter",
            "select_scatter", "masked_scatter_"}
_UPDATE_ARGS = ("src", "values", "source", "value")


def _collective_wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Per-device link bytes, ring-algorithm model, from the per-device
    SPMD result buffer size."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":          # result = gathered (full) buffer
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":      # result = scattered piece
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)        # collective-permute: one hop


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _matmul_flops(name: str, args: tuple) -> Optional[float]:
    """2 x output x contracted size of a matmul-family op, else None."""
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    elif name in ("mv", "dot"):
        a, b = args[0], args[1]
    else:
        return None
    k = a.shape[-1]
    out = math.prod(a.shape[:-1])
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        out *= b.shape[-1]
    return 2.0 * out * k


def _kernel_flops(func, args: tuple, kwargs: dict, out: Any
                  ) -> Optional[float]:
    """A hand-written kernel's registered FLOP formula, else None."""
    packet = func._overloadpacket
    if packet not in KERNEL_OPS:
        return None
    return float(flop_registry[packet](*args, **kwargs, out_val=out))


def _group_size(name: str, args: tuple) -> int:
    """The collective's group size, from its group name argument."""
    group = next((a for a in reversed(args) if isinstance(a, str)), None)
    if group is None:
        return 2
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size()


def _line(name: str, args: tuple, out: Any) -> str:
    def sig(ts):
        return ",".join(f"{str(t.dtype).replace('torch.', '')}"
                        f"{list(t.shape)}" for t in ts)
    return f"{name}({sig(_tensors(args))}) -> {sig(_tensors(out))}"


_LOCAL = threading.local()


@contextlib.contextmanager
def uncounted():
    """Ops run within are no rank's work: no Counter counts them."""
    depth = getattr(_LOCAL, "silent", 0)
    _LOCAL.silent = depth + 1
    try:
        yield
    finally:
        _LOCAL.silent = depth


@contextlib.contextmanager
def _uncounted_propagation():
    """DTensor's sharding propagation with the counter silenced: its fake
    run of each new op on global shapes is no rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def silenced(self, *a, **k):
        with uncounted():
            return orig(self, *a, **k)
    ShardingPropagator._propagate_tensor_meta_non_cached = silenced
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class Counter(TorchDispatchMode):
    """Counts the per-device work of what runs under it (see the module
    docstring).  Use as a context manager, then read `totals()`."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLLECTIVE_KINDS}
        self.coll_ops = {k: 0 for k in _COLLECTIVE_KINDS}
        # (kind, line) -> [bytes, count]
        self._records: Dict[Tuple[str, str], List[float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: "weakref.WeakSet" = weakref.WeakSet()
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_uncounted_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, out: Any) -> None:
        """Adds the new storages among `out` to the live bytes until they
        are freed."""
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages.add(st)
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor dispatches; its local ops
            # come back here
        out = func(*args, **kwargs)
        if getattr(_LOCAL, "silent", 0):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in _FUNCTIONAL_NAMESPACES and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            rb = sum(_nbytes(t) for t in _tensors(out))
            wire = _collective_wire_bytes(kind, rb, _group_size(name, args))
            self.coll[kind] += wire
            self.coll_ops[kind] += 1
            self._record("COLL:" + kind, _line(name, args, out), wire)
        if name in _FREE or func.is_view or (
                ns == "aten" and _returns_alias(func)):
            return
        if not any(r.alias_info is not None for r in func._schema.returns):
            self._track(out)            # a new allocation, not an in-place
            # op's self
        flops = _matmul_flops(name, args) if ns == "aten" else \
            _kernel_flops(func, args, kwargs, out)
        if flops:
            self.flops += flops
        if name in _GATHERS:
            nb = 2 * sum(_nbytes(t) for t in _tensors(out))
        elif name in _UPDATES:
            nb = 2 * _update_bytes(func, args, kwargs)
        else:
            nb = sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in _tensors(kwargs)) + \
                sum(_nbytes(t) for t in _tensors(out))
        self.bytes += nb
        self._record(name, _line(name, args, out), nb)

    def _record(self, kind: str, line: str, nb: float) -> None:
        rec = self._records.setdefault((kind, line), [0.0, 0])
        rec[0] += nb
        rec[1] += 1

    @property
    def records(self) -> List[Tuple[float, float, str, str]]:
        """[(bytes, count, kind, line)]: every distinct op, its bytes summed
        over its count of calls (collectives: their wire bytes)."""
        return [(nb, n, kind, line)
                for (kind, line), (nb, n) in self._records.items()]

    def totals(self) -> Dict[str, object]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": {k: int(v) for k, v in self.coll.items()},
                "collective_ops": dict(self.coll_ops)}


def _returns_alias(func) -> bool:
    """An op whose every output aliases an input without writing it (a
    view the overload does not flag, such as split or unbind)."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _update_bytes(func, args: tuple, kwargs: dict) -> int:
    """Bytes of the update an in-place partial write carries."""
    schema = func._schema.arguments
    for i, a in enumerate(schema):
        if a.name in _UPDATE_ARGS:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(v, torch.Tensor):
                return _nbytes(v)
            return 0
    return 0


def count(fn, *args, **kwargs) -> Dict[str, object]:
    """Per-device {'flops', 'bytes', 'collective_bytes', 'collective_ops'}
    of `fn(*args, **kwargs)`."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.totals()
