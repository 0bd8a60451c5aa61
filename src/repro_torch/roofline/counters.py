"""Counting a step's work on the eager program: the port's counterpart of
``repro.roofline.hlo``.

``repro`` reads its per-device totals from the optimized, SPMD-partitioned
HLO. The port has no compiled program: it runs a step once under
:class:`Counter`, a ``TorchDispatchMode`` that sees every aten op the step
dispatches, per device (an op on DTensors is let through to DTensor,
which runs it on the local shards and issues its collectives; the counter
sees those, and not the fake-tensor run of each op by which DTensor
propagates shapes):

* **flops** — 2·M·N·K for every ``mm``, ``bmm``, ``addmm`` and the ops
  ``einsum`` lowers to, by ``torch.utils.flop_counter``'s formulas; of
  them **flops_f32**, the work that runs at the card's float32 rate and
  not on the tensor cores: a product of float32 (or float64) operands,
  and every ported kernel's formula (``roofline.work`` counts float32
  operations outside the tensor cores);
* **bytes** — the bytes of every aten op's tensor inputs and outputs
  (each distinct element once: a broadcast input counts its storage, a
  view op moves nothing). Eager PyTorch fuses nothing, so this is the
  traffic of the port as it runs, unlike the reference's discount of
  fused layout ops;
* **collectives** — every functional collective DTensor issues, at the
  reference's ring accounting (:func:`collective_traffic`), the group
  size read from its process group;
* a per-op table (op name → calls, FLOPs, bytes, float32-rate FLOPs)
  and the peak of the live storage the step allocates (``temp_bytes``),
  with the largest storages live at that peak (``peak_tensors``: the op
  that made each, its shape, dtype and bytes);
* **strided_ops** — the DTensor ops that took an input laid out with a
  ``_StridedShard``, whose redistributions DTensor plans by its graph
  search (``sharding``'s module doc): 0 on the port's steps.

A ported kernel counts its formula once per call (``roofline.work``), and
none of the aten ops inside its wrapper, so the card (the kernel) and a
CPU or fake-tensor run (its plain version) count the same work.

The port's layers run in a Python loop, not a ``lax.scan``, so every layer
dispatches its own ops and no trip counts are needed: that is why the HLO
walk's loop logic has no counterpart here.
"""
from __future__ import annotations

import contextlib
import heapq
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import work

__all__ = ["Counter", "analyze_step", "collective_traffic", "tensor_bytes"]

# functional collectives (both namespaces) → the reference's kind names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
# allocations and bookkeeping that move no data
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "lift_fresh",
               "_unsafe_view", "detach", "alias", "wait_tensor",
               "_wrap_tensor_autograd"}
# operand types the tensor cores multiply at the bf16 peak or above
_TENSOR_CORE = {torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                torch.float8_e5m2}


def collective_traffic(kind: str, result_bytes: float, g: int) -> float:
    """Per-device ring-collective link bytes (the reference's ``_traffic``)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)  # result is the shard
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a stride-0 dim, a
    broadcast, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    """The tensors among an op's arguments or results: a tensor, or a
    tuple, list or dict of them one level deep (an aten op's nesting)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if not isinstance(tree, (tuple, list, dict)):
        return []
    items = tree.values() if isinstance(tree, dict) else tree
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list, dict)):
            out.extend(_tensors(x))
    return out


def _group_size(func, args, kwargs) -> int:
    sizes = [a for a in args if isinstance(a, int)]
    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    name = next((a for a in args if isinstance(a, str)
                 and a not in ("sum", "avg", "max", "min", "product")),
                kwargs.get("group_name"))
    if name is not None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name).size()
    return sizes[0] if sizes else 2


# ops whose result is their input: on real tensors a pending collective
# result wrapping it, on meta tensors (the dry run) a new empty one
_ALIASES = {"_wrap_tensor_autograd"}


def _alias(src: torch.Tensor, out: torch.Tensor) -> None:
    """Count ``out`` as ``src``'s storage: where it has one of its own (on
    meta tensors), ``src``'s is held, and counted live, until ``out``'s
    is freed."""
    st, held = _held(out).untyped_storage(), _held(src).untyped_storage()
    if id(st) != id(held):
        weakref.finalize(st, lambda *_: None, held)


def _held(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage ``t`` holds: a collective's pending
    result (an ``AsyncCollectiveTensor``, and a view of one, which stays
    one) holds it in ``elem``."""
    return t.elem if isinstance(t, AsyncCollectiveTensor) else t


class Counter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collective bytes, a per-op table and the
    peak of live storage, over every aten op dispatched while it is
    entered (module doc)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_f32 = 0.0
        self.bytes = 0.0
        self.by_kind: dict[str, float] = defaultdict(float)
        self.ops: dict[str, list] = {}
        self.live = 0
        self.peak = 0
        self._hidden = 0
        self._seen: dict[int, tuple] = {}  # live storage -> its maker
        self._top: list = []  # the largest of them at the peak
        self._stale = False  # the peak has grown since _top was taken
        self.strided_ops = 0

    # -- recording ---------------------------------------------------------
    def _row(self, name: str, flops: float, nbytes: float,
             flops_f32: float) -> None:
        row = self.ops.setdefault(name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += flops_f32
        self.flops += flops
        self.bytes += nbytes
        self.flops_f32 += flops_f32

    def record_kernel(self, name: str, ops: float, nbytes: float) -> None:
        """One call of a ported kernel at its formula (``roofline.work``),
        float32 operations all."""
        self._row(f"kernel.{name}", ops, nbytes, ops)

    @contextlib.contextmanager
    def hidden(self):
        """Count no aten op inside (a kernel wrapper's body); allocations
        are still tracked."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def _track(self, func, args, kwargs, out) -> None:
        """Count each new storage among ``out`` as allocated until it is
        freed (an output that shares an input's storage, a view or an
        in-place result, is not new; :func:`_held`)."""
        ins = {id(_held(t).untyped_storage())
               for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = _held(t).untyped_storage()
            key = id(st)
            if key in self._seen or key in ins:
                continue
            n = st.nbytes()
            self._seen[key] = (n, str(func), list(t.shape), str(t.dtype))
            self.live += n
            if self.live > self.peak:
                self.peak, self._stale = self.live, True
            weakref.finalize(st, self._free, key, n)

    def _snapshot(self) -> None:
        """The makers of the largest live storages, taken at a new peak
        when it ends: at the first free after it, or at the record."""
        if self._stale:
            # (a free the copy's allocation sets off finds it taken)
            self._stale = False
            self._top = heapq.nlargest(4, list(self._seen.values()))

    def _free(self, key: int, n: int) -> None:
        self._snapshot()
        self._seen.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.strided_ops += any(
                isinstance(q, _StridedShard) for t in _tensors((args, kwargs))
                if isinstance(t, DTensor) for q in t.placements)
            return NotImplemented  # DTensor runs it on the local shards
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs each op once on fake
            # tensors for its output's shape: not the step's work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out  # a fake tensor that propagation built (no inputs)
        packet = func.overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if name in _ALIASES:
            _alias(args[0], out)
        else:
            self._track(func, args, kwargs, out)
        if self._hidden:
            return out
        kind = _COLLECTIVES.get(name) if ns in _COLLECTIVE_NS else None
        if kind is not None:
            res = sum(tensor_bytes(t) for t in _tensors(out))
            self.by_kind[kind] += collective_traffic(
                kind, res, _group_size(func, args, kwargs))
        flops = flops_f32 = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            if _tensors(args)[0].dtype not in _TENSOR_CORE:
                flops_f32 = flops
        nbytes = 0
        if not (func.is_view or name in _NO_TRAFFIC):
            ins = {k: v for k, v in kwargs.items() if k != "out"}
            nbytes = sum(tensor_bytes(t) for t in
                         _tensors(args) + _tensors(ins) + _tensors(out))
        self._row(f"{ns}.{name}", flops, nbytes, flops_f32)
        return out

    def __enter__(self):
        work._push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            work._pop(self)

    # -- results -----------------------------------------------------------
    @property
    def collective_bytes(self) -> float:
        return float(sum(self.by_kind.values()))

    def result(self) -> dict:
        self._snapshot()
        return {"flops": self.flops, "flops_f32": self.flops_f32,
                "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "by_kind": dict(self.by_kind), "temp_bytes": self.peak,
                "peak_tensors": [
                    {"op": op, "shape": shape, "dtype": dtype, "bytes": n}
                    for n, op, shape, dtype in self._top],
                "strided_ops": self.strided_ops,
                "ops": {k: list(v) for k, v in sorted(self.ops.items())}}


def analyze_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Counter`: its
    per-device ``flops`` (of them ``flops_f32`` at the float32 rate),
    ``bytes``, ``collective_bytes``, ``by_kind``, ``temp_bytes`` (the peak
    of the storage the step allocated and held) and ``ops`` (name →
    [calls, flops, bytes, flops_f32]); ``out`` is what ``fn`` returned."""
    counter = Counter()
    with counter:
        out = fn(*args, **kwargs)
    return {**counter.result(), "out": out}
